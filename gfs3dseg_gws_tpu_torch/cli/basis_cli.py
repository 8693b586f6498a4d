"""Geometric-word extraction CLI (counterpart of the JAX package's
cli/basis_cli.py; reference get_basis.py:226-313).

    python -m gfs3dseg_gws_tpu_torch.cli.basis_cli --dataset s3dis \\
        --cvfold 0 --data_path <blocks> --pretrain_checkpoint_path \\
        <log_pretrain dir or checkpoint.tar or .npz> --num_cnt 150 \\
        --save_path <dir> --device cuda

Same flags as the JAX CLI, plus `--device`. Writes
`<save_path>/GlobalKmeans_EdgeConv123_cnt=<num_cnt>_energy=095_`
`SVDReconstruct.pkl`.
"""
from __future__ import annotations

import argparse
import os

from gfs3dseg_gws_tpu_torch.cli.common import (
    add_data_args,
    add_model_args,
    add_pc_args,
    data_config_from_args,
    disable_tf32,
    model_config_from_args,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Geometric-word extraction (PyTorch/CUDA port)")
    add_data_args(p)
    p.add_argument("--pretrain_checkpoint_path", type=str, default="",
                   help="pretrain weight (torch checkpoint.tar dir or our "
                        ".npz)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--n_iters", type=int, default=100)
    p.add_argument("--pretrain_lr", type=float, default=0.001)
    p.add_argument("--pretrain_weight_decay", type=float, default=0.0001)
    p.add_argument("--pretrain_step_size", type=int, default=50)
    p.add_argument("--pretrain_gamma", type=float, default=0.5)
    p.add_argument("--n_way", type=int, default=2)
    p.add_argument("--n_queries", type=int, default=1)
    p.add_argument("--n_episode_test", type=int, default=100)
    add_pc_args(p)
    add_model_args(p)
    p.add_argument("--dist_method", default="gaussian")
    p.add_argument("--n_subprototypes", type=int, default=100)
    p.add_argument("--k_connect", type=int, default=200)
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--num_cnt", type=int, default=10,
                   help="number of geometric words (global k-means centres)")
    p.add_argument("--seed", default=123, type=int)
    p.add_argument("--save_path", type=str, default="log_s3dis/S0_K5",
                   help="path to save the basis")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the CUDA kernels) or cpu (their "
                        "plain PyTorch versions); cuda without a GPU raises")
    p.add_argument_group("accepted for compatibility with the JAX CLI (no "
                         "effect in the port)").add_argument(
        "--no_pallas", action="store_true")
    return p


def main(argv=None):
    """Parse `argv`, extract the basis, return it (num_cnt, D) float32."""
    args = build_parser().parse_args(argv)
    disable_tf32()
    model_cfg = model_config_from_args(args)
    data_cfg = data_config_from_args(args)

    from gfs3dseg_gws_tpu_torch.pipelines.basis import extract_basis
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import resolve_device

    resolve_device(args.device)     # fail before any data is touched
    os.makedirs(args.save_path, exist_ok=True)
    return extract_basis(
        model_cfg, data_cfg, num_cnt=args.num_cnt,
        pretrain_checkpoint_path=args.pretrain_checkpoint_path,
        save_dir=args.save_path, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
