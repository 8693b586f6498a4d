"""K1 (`fused_edgeconv_infer`): the least time of its calls
(counts/k1.py) / the device time of every operation launched inside its
span, in %."""


def read(s):
    return s.roofline("k1")
