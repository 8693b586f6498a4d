"""Pre-training / baselines CLI (counterpart of the JAX package's
cli/pretrain_cli.py; reference pretrain/main.py:14-136).

    python -m gfs3dseg_gws_tpu_torch.cli.pretrain_cli --phase pretrain \\
        --dataset s3dis --cvfold 0 --data_path <blocks> --save_path <dir> \\
        --batch_size 16 --pc_npts 2048 --pc_augm --pretrain_lr 0.001 \\
        --pretrain_weight_decay 1e-4 --device cuda

Same flags as the JAX CLI, plus `--device`. Only `--phase pretrain` is
ported; the baseline phases raise NotImplementedError.
"""
from __future__ import annotations

import argparse
import os

from gfs3dseg_gws_tpu_torch.cli.common import (
    add_dispatch_args,
    add_model_args,
    add_pc_args,
    data_config_from_args,
    disable_tf32,
    model_config_from_args,
)
from gfs3dseg_gws_tpu_torch.utils.config import PretrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Backbone pre-training and few-shot baselines "
                    "(PyTorch/CUDA port: --phase pretrain)")
    p.add_argument("--phase", type=str, default="pretrain",
                   choices=["pretrain", "finetune", "prototrain", "protoeval",
                            "mptitrain", "mptieval", "mptigfs"])
    p.add_argument("--dataset", type=str, default="s3dis")
    p.add_argument("--cvfold", type=int, default=0)
    p.add_argument("--data_path", type=str,
                   default="./datasets/S3DIS/blocks_bs1_s1")
    p.add_argument("--pretrain_checkpoint_path", type=str, default=None)
    p.add_argument("--model_checkpoint_path", type=str, default=None)
    p.add_argument("--save_path", type=str, default="./log_s3dis/")
    p.add_argument("--eval_interval", type=int, default=1500)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--n_workers", type=int, default=16)
    p.add_argument("--n_iters", type=int, default=30000)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--step_size", type=int, default=5000)
    p.add_argument("--gamma", type=float, default=0.5)
    p.add_argument("--pretrain_lr", type=float, default=0.001)
    p.add_argument("--pretrain_weight_decay", type=float, default=0.0)
    p.add_argument("--pretrain_step_size", type=int, default=50)
    p.add_argument("--pretrain_gamma", type=float, default=0.5)
    p.add_argument("--n_way", type=int, default=2)
    p.add_argument("--k_shot", type=int, default=1)
    p.add_argument("--n_queries", type=int, default=1)
    p.add_argument("--n_episode_test", type=int, default=100)
    add_pc_args(p)
    add_model_args(p, attention_action="store_true")
    p.add_argument("--dist_method", default="euclidean",
                   help="cosine|euclidean")
    p.add_argument("--n_subprototypes", type=int, default=100)
    p.add_argument("--k_connect", type=int, default=200)
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--triplet_loss_weight", type=float, default=-1)
    p.add_argument("--testing_data_path", type=str, default="")
    p.add_argument("--log_dir", type=str, default="")
    p.add_argument("--seed", type=int, default=321)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the CUDA kernels) or cpu (their "
                        "plain PyTorch versions); cuda without a GPU raises")
    add_dispatch_args(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.phase != "pretrain":
        raise NotImplementedError(
            f"--phase {args.phase} is not ported yet (ROADMAP.md queue 1 "
            "§10, baselines); the port runs --phase pretrain")
    disable_tf32()
    model_cfg = model_config_from_args(args)
    data_cfg = data_config_from_args(args)
    log_dir = os.path.join(
        args.save_path, f"log_pretrain_{args.dataset}_S{args.cvfold}_LongTail")
    pre_cfg = PretrainConfig(
        batch_size=args.batch_size, lr=args.pretrain_lr,
        weight_decay=args.pretrain_weight_decay, n_iters=args.n_iters,
        step_size=args.pretrain_step_size, gamma=args.pretrain_gamma,
        eval_interval=args.eval_interval, seed=args.seed, log_dir=log_dir,
        device=args.device)

    from gfs3dseg_gws_tpu_torch.pipelines.gfs import resolve_device
    from gfs3dseg_gws_tpu_torch.pipelines.pretrain import pretrain

    resolve_device(args.device)     # fail before any data is touched
    return pretrain(model_cfg, data_cfg, pre_cfg)


if __name__ == "__main__":
    main()
