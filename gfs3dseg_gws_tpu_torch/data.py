"""The port's host data layer.

This is the JAX package's numpy-only `gfs3dseg_gws_tpu.data` (block
datasets, registries, samplers, synthetic data and the native C++ batch
loader reached through ctypes), shared as it is: it imports neither jax nor
flax, and its on-disk formats are the reference's. The port reaches it only
through this module.
"""
from gfs3dseg_gws_tpu.data import native_loader
from gfs3dseg_gws_tpu.data.datasets import (PretrainBlockDataset,
                                            TestingDataset, ValSuppDataset)
from gfs3dseg_gws_tpu.data.pipeline import batch_iterator
from gfs3dseg_gws_tpu.data.registry import make_registry
from gfs3dseg_gws_tpu.data.synthetic import make_synthetic_blocks

__all__ = ["PretrainBlockDataset", "TestingDataset", "ValSuppDataset",
           "batch_iterator", "make_registry", "make_synthetic_blocks",
           "native_loader"]
