"""The whole pre-training step's share of the card's TF32 peak: the
pass's products a block (counts/pretrain_block.py: the encoder, the
segmenter head, the backward at twice the forward's products, the kNN
Gram matrices' backward left out) x blocks stepped in the traced stretch
/ its seconds / the peak, in %."""
import os

from tracer import HERE, load_module, load_peaks


def read(s):
    if not s.blocks or s.window_s <= 0:
        return None
    block = load_module(os.path.join(HERE, "counts", "pretrain_block.py"),
                        "counts_pretrain_block")
    flops = block.flops(s.cfg, s.cfg["pc_npts"]) * s.blocks
    return 100.0 * flops / s.window_s / load_peaks()["tf32_flops_per_s"]
