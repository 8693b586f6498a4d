"""Products (2 FLOPs a multiply-add) of one n-point block through the GFS
training pass: the features of the evaluation pass (counts/eval_block.py
without its evaluation heads), the training heads (the fake prototypes'
class sums over the half batch that builds them, the two cosine
predictions and the refinement's prediction and pooling, over the
classes and background), and the backward at twice the forward's
products, the kNN Gram matrices (no gradient) left out. No product is
counted twice for recomputation."""
import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "eval_block", os.path.join(os.path.dirname(__file__), "eval_block.py"))
eval_block = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(eval_block)


def flops(cfg, n):
    c, cls = cfg["main_dim"], cfg["total_classes"] + 1
    heads_eval = 2.0 * (3 * n * c * cfg["total_classes"]
                        + n * cfg["num_gw"] * cfg["total_classes"])
    forward = (eval_block.flops(cfg, n) - heads_eval
               + 2.0 * (0.5 * n * c * cls + 4 * n * c * cls))
    return forward + 2.0 * (forward - eval_block.knn_flops(cfg, n))
