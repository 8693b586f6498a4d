"""K2 (`fused_attention`): as eval.k1_roofline, by counts/k2.py."""


def read(s):
    return s.roofline("k2")
