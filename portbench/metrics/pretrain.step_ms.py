"""Device-busy ms a pre-training step: the union of the device operations
launched inside the benchmark's span around each step (its backward's
included), a step."""


def read(s):
    n = s.count("pretrain.step")
    return 1e3 * s.busy_in_s("pretrain.step") / n if n else None
