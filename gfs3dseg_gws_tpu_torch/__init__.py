"""gfs3dseg_gws_tpu_torch — the PyTorch/CUDA port of gfs3dseg_gws_tpu.

Generalized few-shot 3D point-cloud segmentation via geometric words
(ICCV 2023, arXiv 2309.11222) on one NVIDIA Hopper GPU. The JAX package
`gfs3dseg_gws_tpu` stays beside this one as the reference that every ported
module is tested against.

This package covers the GFS evaluation path (`train.py --only_evaluate`):

  ops/        kernel wrappers (hand-written CUDA for sm_90a, csrc/) and
              their plain-PyTorch versions; kNN, coding, metrics
  models/     eval-mode DGCNN, self-attention and the GW/CAPL head
  parallel/   single-device eval steps
  pipelines/  coding collection, prototype registration, the eval sweep
  utils/      config, logging, checkpoint loading and the JAX-weight converter
  cli/        `python -m gfs3dseg_gws_tpu_torch.cli.train_cli --only_evaluate`

It imports torch and numpy, never jax or flax. The host data layer
(`data.py`: the JAX package's numpy-only `gfs3dseg_gws_tpu.data`) is
shared with the JAX package.

A kernel wrapper decides by the tensor's device alone: a CPU tensor goes to
the plain version, a CUDA tensor to the kernel (or the wrapper raises).
"""

__version__ = "0.1.0"
