"""Products (2 FLOPs a multiply-add) of one n-point block through the
DGCNNSeg pre-training pass (models/dgcnn.py, models/dgcnnseg.py): the
encoder as counts/eval_block.py counts it (each EdgeConv's kNN Gram
matrix, its neighbour and centre tables and further per-edge convs, the
point MLP), the segmenter head over the EdgeConv features and the
broadcast global feature (convs to 256, 128 and the classes; the global
max is no product), and the backward at twice the forward's products,
the kNN Gram matrices (no gradient) left out, as counts/train_block.py
counts the GFS pass. No product is counted twice for recomputation.
`cfg["num_classes"]` is the segmenter's classes (the fold's base classes
and background). At the published widths and 8 classes (S3DIS fold 0)
this is 3.78 GFLOP forward, 9.03 GFLOP in all."""
import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "eval_block", os.path.join(os.path.dirname(__file__), "eval_block.py"))
eval_block = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(eval_block)

SEGMENTER = (256, 128)          # the segmenter's hidden widths


def forward_flops(cfg, n):
    k, mac = cfg["dgcnn_k"], 0
    widths = [list(w) for w in cfg["edgeconv_widths"]]
    cins = [len(cfg["pc_attribs"])] + [w[-1] for w in widths[:-1]]
    for cin, w in zip(cins, widths):
        mac += n * n * cin
        mac += 2 * n * cin * w[0]
        for prev, wi in zip(w, w[1:]):
            mac += n * k * prev * wi
    prev = sum(w[-1] for w in widths)
    for wi in cfg["dgcnn_mlp_widths"]:
        mac += n * prev * wi
        prev = wi
    prev = sum(w[-1] for w in widths) + cfg["dgcnn_mlp_widths"][-1]
    for wi in SEGMENTER + (cfg["num_classes"],):
        mac += n * prev * wi
        prev = wi
    return 2.0 * mac


def flops(cfg, n):
    forward = forward_flops(cfg, n)
    return forward + 2.0 * (forward - eval_block.knn_flops(cfg, n))
