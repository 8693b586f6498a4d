"""K4b (the backward of `fused_edgeconv_train`) in the pre-training step:
the least time of the backward of every traced forward call
(counts/k4b.py) / the device time of every operation launched inside its
autograd node, in %."""


def read(s):
    return s.roofline("k4b")
