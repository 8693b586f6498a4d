"""Device ms a pre-training step inside the span `seg_head` around the
segmenter head's forward (models/dgcnnseg.py::seg_head: the global max,
its broadcast and concatenation, the segmenter's convs, BatchNorms,
LeakyReLUs and dropout); None where no call of it was traced."""


def read(s):
    n = s.count("pretrain.step")
    if not n or not s.count("seg_head"):
        return None
    return 1e3 * s.device_s("seg_head") / n
