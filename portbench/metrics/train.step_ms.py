"""Device-busy ms a step: the union of the device operations launched
inside the benchmark's span around each training step (its backward's
included), a step."""


def read(s):
    n = s.count("train.step")
    return 1e3 * s.busy_in_s("train.step") / n if n else None
