"""gfs3dseg_gws_tpu_torch — the PyTorch/CUDA port of gfs3dseg_gws_tpu.

Generalized few-shot 3D point-cloud segmentation via geometric words
(ICCV 2023, arXiv 2309.11222) on one NVIDIA Hopper GPU. The JAX package
`gfs3dseg_gws_tpu` stays beside this one as the reference that every ported
module is tested against.

This package covers GFS base-stage training and evaluation (`train.py`,
with and without `--only_evaluate`), geometric-word extraction
(`get_basis.py`), backbone pre-training (`pretrain/main.py --phase
pretrain`) and the few-shot baselines (its phases prototrain, protoeval,
mptitrain, mptieval, mptigfs and finetune):

  data/       host data layer: datasets, registries, samplers, synthetic
              blocks, the native C++ batch loader (ctypes)
  ops/        kernel wrappers (hand-written CUDA for sm_90a, csrc/) and
              their plain-PyTorch versions; kNN, coding, metrics
  models/     DGCNN, self-attention, the GW/CAPL head, the segmentors,
              ProtoNet and MPTI
  parallel/   single-device train and eval steps, optimizers
  pipelines/  GFS training and evaluation, pre-training, geometric words,
              the few-shot baselines
  utils/      config, logging, checkpoints and the JAX-weight converters
  cli/        `python -m gfs3dseg_gws_tpu_torch.cli.train_cli`,
              `python -m gfs3dseg_gws_tpu_torch.cli.pretrain_cli`

It imports torch and numpy, never jax, flax or any module of the JAX
package: where it needs one of that package's numpy-only modules (the host
data layer), it keeps its own copy.

A kernel wrapper decides by the tensor's device alone: a CPU tensor goes to
the plain version, a CUDA tensor to the kernel (or the wrapper raises).
"""

__version__ = "0.1.0"
