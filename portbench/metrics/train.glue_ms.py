"""Device ms a step of the torch glue: operations launched outside every
op span of spans/ (the port's kernel entries and their autograd nodes)
that are not cuBLAS/CUTLASS GEMMs: elementwise, reductions, copies,
fills, the optimizer."""


def read(s):
    n = s.count("train.step")
    return 1e3 * s.glue_s() / n if n else None
