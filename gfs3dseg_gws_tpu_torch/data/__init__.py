"""The port's host data layer: block datasets, registries, samplers,
synthetic data and the native C++ batch loader reached through ctypes.

These are the port's own copies of the numpy-only modules of the JAX
package's `gfs3dseg_gws_tpu.data` (registry, sampler, datasets, pipeline,
synthetic, native_loader): the port imports nothing of that package. The
on-disk formats are the reference's, and the same seed gives the same
arrays in both packages (tests/test_torch_port_train.py holds them to it).
The C++ loader's source, `native/blockloader.cc`, sits at the root of the
checkout and is shared by both.
"""
from gfs3dseg_gws_tpu_torch.data import native_loader
from gfs3dseg_gws_tpu_torch.data.datasets import (PretrainBlockDataset,
                                                  TestingDataset,
                                                  ValSuppDataset)
from gfs3dseg_gws_tpu_torch.data.pipeline import batch_iterator
from gfs3dseg_gws_tpu_torch.data.registry import make_registry
from gfs3dseg_gws_tpu_torch.data.synthetic import make_synthetic_blocks

__all__ = ["PretrainBlockDataset", "TestingDataset", "ValSuppDataset",
           "batch_iterator", "make_registry", "make_synthetic_blocks",
           "native_loader"]
