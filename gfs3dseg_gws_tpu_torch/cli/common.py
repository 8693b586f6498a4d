"""Shared argparse groups and config construction (counterpart of the JAX
package's cli/common.py; flags mirror reference train.py:733-817)."""
from __future__ import annotations

import argparse
import os

from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                 parse_widths)


def disable_tf32() -> None:
    """Full fp32 matmuls and convolutions: TF32 keeps about three decimal
    digits, enough to reorder kNN neighbours and break parity with the
    JAX reference."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def add_data_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset", type=str, default="s3dis",
                   help="Dataset name: s3dis|scannet")
    p.add_argument("--cvfold", type=int, default=0,
                   help="Fold left-out for testing. Options:{0,1}")
    p.add_argument("--data_path", type=str, default="datasets/S3DIS/"
                   "blocks_bs1.0_s1.0", help="Directory to the source data")
    p.add_argument("--testing_data_path", type=str,
                   default="datasets/S3DIS/blocks_bs1.0_s1.0_test")
    p.add_argument("--total_classes", type=int, default=13,
                   help="number of classes to be evaluated in the gfs")
    p.add_argument("--k_shot", type=int, default=5,
                   help="Number of samples/shots for each class: 1|5")
    p.add_argument("--n_workers", type=int, default=16,
                   help="number of workers to load data")


def add_pc_args(p: argparse.ArgumentParser):
    p.add_argument("--pc_npts", type=int, default=2048,
                   help="Number of input points.")
    p.add_argument("--pc_attribs", default="xyzrgbXYZ",
                   help="Point attributes: xyz, rgb, XYZ (normalised)")
    p.add_argument("--pc_augm", action="store_true",
                   help="Training augmentation")
    p.add_argument("--pc_augm_scale", type=float, default=0)
    p.add_argument("--pc_augm_rot", type=int, default=1)
    p.add_argument("--pc_augm_mirror_prob", type=float, default=0)
    p.add_argument("--pc_augm_jitter", type=int, default=1)


def add_model_args(p: argparse.ArgumentParser,
                   attention_action: str = "store_false"):
    p.add_argument("--dgcnn_k", type=int, default=20,
                   help="Number of nearest neighbors in Edgeconv")
    p.add_argument("--edgeconv_widths", default="[[64,64], [64,64], "
                   "[64,64]]", help="DGCNN Edgeconv widths")
    p.add_argument("--dgcnn_mlp_widths", default="[512, 256]",
                   help="DGCNN MLP widths")
    p.add_argument("--base_widths", default="[128, 64]",
                   help="BaseLearner widths")
    p.add_argument("--output_dim", type=int, default=64,
                   help="attention learner output dim")
    # the reference CLIs disagree on the polarity: the GFS CLI stores false
    # (attention ON unless flagged, train.py:807-808), the pretrain and
    # baseline CLI stores true (OFF unless flagged, pretrain/main.py:79)
    p.add_argument("--use_attention", action=attention_action,
                   help="use attention learner (default "
                        f"{attention_action == 'store_false'})")


def add_dispatch_args(p: argparse.ArgumentParser):
    """Flags of the JAX CLIs that steer only the TPU (batch transfer,
    dispatch chaining, Pallas on/off). They are accepted so that its launch
    commands run unchanged, and have no effect here. Returns the group."""
    g = p.add_argument_group("accepted for compatibility with the JAX CLI "
                             "(no effect in the port)")
    g.add_argument("--h2d", choices=("auto", "exact", "packed"),
                   default="auto")
    g.add_argument("--steps_per_dispatch", type=int, default=1)
    g.add_argument("--no_pallas", action="store_true")
    return g


def add_tpu_compat_args(p: argparse.ArgumentParser):
    """`add_dispatch_args` plus the device-mesh flags of the GFS CLI."""
    g = add_dispatch_args(p)
    p.add_argument("--mesh", type=str, default="data",
                   choices=["data", "dxp"], dest="mesh_shape",
                   help="the mesh of a run over several ranks (torchrun): "
                        "'data' = data parallelism; 'dxp' (data x points) "
                        "is not ported yet and raises")
    g.add_argument("--mesh_sp", type=int, default=2,
                   help="the JAX dxp mesh's points axis; ignored until dxp "
                        "is ported (ROADMAP.md §8b)")


def mesh_from_env(device: str, mesh_shape: str = "data"):
    """The data-parallel mesh (parallel/mesh.py) of a run that torchrun
    launched (WORLD_SIZE is set), as the JAX pipelines build theirs when
    jax.device_count() > 1; None for one process. NCCL on `device` cuda
    (a card a rank), gloo on the CPU. The 2-D data x points mesh (`--mesh
    dxp`) raises under more than one rank: it is not ported yet."""
    if "WORLD_SIZE" not in os.environ:
        return None
    if mesh_shape == "dxp" and int(os.environ["WORLD_SIZE"]) > 1:
        raise NotImplementedError(
            "--mesh dxp (the data x points mesh) is not ported to "
            "PyTorch/CUDA yet (ROADMAP.md §8b); use --mesh data")
    from gfs3dseg_gws_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(device=device)


def model_config_from_args(args) -> ModelConfig:
    return ModelConfig(
        pc_attribs=args.pc_attribs,
        pc_npts=args.pc_npts,
        dgcnn_k=args.dgcnn_k,
        edgeconv_widths=parse_widths(args.edgeconv_widths),
        dgcnn_mlp_widths=parse_widths(args.dgcnn_mlp_widths),
        base_widths=parse_widths(args.base_widths),
        output_dim=args.output_dim,
        use_attention=args.use_attention,
    )


def data_config_from_args(args) -> DataConfig:
    return DataConfig(
        dataset=args.dataset,
        cvfold=args.cvfold,
        data_path=args.data_path,
        testing_data_path=args.testing_data_path,
        # the pretrain CLI has no --total_classes
        total_classes=getattr(args, "total_classes", 13),
        k_shot=args.k_shot,
        pc_npts=args.pc_npts,
        pc_attribs=args.pc_attribs,
        pc_augm=args.pc_augm,
        pc_augm_scale=args.pc_augm_scale,
        pc_augm_rot=args.pc_augm_rot,
        pc_augm_mirror_prob=args.pc_augm_mirror_prob,
        pc_augm_jitter=args.pc_augm_jitter,
        n_workers=args.n_workers,
    )
