"""Device kernel launches a step in the traced stretch."""


def read(s):
    n = s.count("train.step")
    return s.launches() / n if n else None
