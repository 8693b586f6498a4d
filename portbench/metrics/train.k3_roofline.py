"""K3 (`knn_with_stats`): as eval.k1_roofline, by counts/k3.py."""


def read(s):
    return s.roofline("k3")
