"""Device-busy ms a batch of the eval step: the union of the device
operations launched inside the spans around `gfs_eval_multi_step`."""


def read(s):
    n = s.count("eval.step")
    return 1e3 * s.busy_in_s("eval.step") / n if n else None
