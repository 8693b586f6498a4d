"""The wide K4 gradient check of chip_smoke.py (check_fused_train at
(16, 2048, 128 -> 128), k = 40) on another draw of its inputs: the one it
gets when the copied-points kNN check (check_knn_ties, which draws its
tables from the same generator) runs before the wide kernels instead of
after them.

    PYTHONPATH=. python3 tools/k4_wide_draw.py

Draws the generator of chip_smoke.main through main's kernel checks in
main's order (timing cut to one repetition: the draws do not depend on
it), then check_knn_ties, then check_wide_kernels, whose K4 line with
draw=in place is that draw (both gradient measures and both slot-flip
counts are printed). Needs one CUDA device.
"""
from __future__ import annotations

import torch

import chip_smoke as cs


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    cs.check_edgeconv(dev, 9, gen, reps=1)
    cs.check_edgeconv(dev, 64, gen, reps=1)
    cs.check_attention(dev, gen, reps=1)
    cs.check_knn_stats(dev, 9, gen, reps=1)
    cs.check_knn_stats(dev, 64, gen, reps=1)
    cs.check_fused_train(dev, gen, timing=False)
    cs.check_attention_train(dev, gen, reps=1)
    cs.check_knn_indices(dev, 9, gen, reps=1)
    cs.check_knn_indices(dev, 64, gen, reps=1)
    cs.check_scatter(dev, gen, reps=1)
    cs.check_gather_conv(dev, gen, reps=1)
    cs.check_knn_fold(dev, 9, gen)
    cs.check_knn_fold(dev, 64, gen)
    cs.check_knn_ties(dev, gen)
    cs.check_wide_kernels(dev, gen)


if __name__ == "__main__":
    main()
