"""Configuration dataclasses (counterpart of gfs3dseg_gws_tpu/utils/config.py).

Same fields and defaults as the JAX package, so launch commands carry over,
minus the TPU-only knobs (`use_pallas`, `h2d`, `steps_per_dispatch`,
`mesh_shape`, `mesh_sp`), plus the torch `device` the pipelines run on.
"""
from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Backbone + head architecture (reference defaults: train.py:799-808)."""

    pc_attribs: str = "xyzrgbXYZ"
    pc_npts: int = 2048
    dgcnn_k: int = 20
    edgeconv_widths: Tuple[Tuple[int, ...], ...] = ((64, 64), (64, 64), (64, 64))
    dgcnn_mlp_widths: Tuple[int, ...] = (512, 256)
    base_widths: Tuple[int, ...] = (128, 64)
    output_dim: int = 64          # self-attention output channels
    attn_dropout: float = 0.1     # dropout on attention weights (training only)
    use_attention: bool = True
    main_dim: int = 128           # prototype dimension
    cosine_scale: float = 10.0    # logits scaling

    @property
    def pc_in_dim(self) -> int:
        return len(self.pc_attribs)

    @property
    def feat_dim(self) -> int:
        """Semantic feature dim = edgeconv1 + attention + base-learner outputs."""
        return self.edgeconv_widths[0][-1] + self.output_dim + self.base_widths[-1]

    @property
    def edgeconv_out_dim(self) -> int:
        """Concatenated EdgeConv output dim, every block (geometric-word
        feature space)."""
        return sum(w[-1] for w in self.edgeconv_widths)


@dataclass(frozen=True)
class DataConfig:
    """Dataset + episode configuration (reference: train.py:750-797)."""

    dataset: str = "s3dis"        # s3dis | scannet
    cvfold: int = 0
    data_path: str = ""
    testing_data_path: str = ""
    total_classes: int = 13
    k_shot: int = 5
    pc_npts: int = 2048
    pc_attribs: str = "xyzrgbXYZ"
    pc_augm: bool = False
    pc_augm_scale: float = 0.0
    pc_augm_rot: int = 1
    pc_augm_mirror_prob: float = 0.0
    pc_augm_jitter: int = 1
    n_workers: int = 8
    support_seeds: Tuple[int, ...] = (10, 20, 30, 40, 50)

    @property
    def augment_config(self) -> dict:
        return {
            "scale": self.pc_augm_scale,
            "rot": self.pc_augm_rot,
            "mirror_prob": self.pc_augm_mirror_prob,
            "jitter": self.pc_augm_jitter,
        }


@dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule and run settings (reference: train.py:738-816)."""

    batch_size: int = 16
    eval_batch_size: int = 0       # 0 = batch_size
    base_lr: float = 0.01
    encoder_lr_scale: float = 0.1
    epochs: int = 150
    start_epoch: int = 0
    step_size: int = 50
    gamma: float = 0.5
    weight_decay: float = 0.0
    energy: float = 0.9            # GW coding energy threshold (0.9 S3DIS / 0.95 ScanNet)
    eval_weight: float = 1.0       # beta reweighting (1.0 val / 1.2 test)
    num_cnt: int = 150             # geometric words (150 S3DIS / 180 ScanNet)
    seed: int = 321
    save_path: str = "log_s3dis/S0_K5/debug"
    print_freq: int = 20
    eval_interval: int = 5
    coding_interval: int = 5
    evaluate: bool = True
    only_evaluate: bool = False
    use_pretrain_weight: bool = False
    pretrain_checkpoint_path: str = ""
    model_checkpoint_path: str = ""
    basis_path: str = ""
    device: str = "cuda"           # torch device the pipelines run on
    trace_dir: str = ""            # a profiler trace of the first steps or
                                   # of the evaluation sweep goes here


@dataclass(frozen=True)
class PretrainConfig:
    """Backbone pre-training schedule (reference:
    pretrain/pretrain_segmentor.sh)."""

    batch_size: int = 16
    lr: float = 0.001
    weight_decay: float = 1e-4
    n_iters: int = 100            # epochs
    step_size: int = 50
    gamma: float = 0.5
    eval_interval: int = 3
    dropout: float = 0.3
    seed: int = 321
    log_dir: str = "log_pretrain"
    device: str = "cuda"          # torch device the pipeline runs on


def parse_widths(text: str) -> Tuple:
    """Parse list-valued CLI flags like '[[64,64], [64, 64], [64, 64]]'
    (reference: train.py:819-821)."""
    value = ast.literal_eval(text)

    def _tup(v):
        return tuple(_tup(x) for x in v) if isinstance(v, (list, tuple)) else v

    return _tup(value)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
