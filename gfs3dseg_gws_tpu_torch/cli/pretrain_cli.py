"""Pre-training / baselines CLI (counterpart of the JAX package's
cli/pretrain_cli.py; reference pretrain/main.py:14-136).

    python -m gfs3dseg_gws_tpu_torch.cli.pretrain_cli --phase pretrain \\
        --dataset s3dis --cvfold 0 --data_path <blocks> --save_path <dir> \\
        --batch_size 16 --pc_npts 2048 --pc_augm --pretrain_lr 0.001 \\
        --pretrain_weight_decay 1e-4 --device cuda

    python -m gfs3dseg_gws_tpu_torch.cli.pretrain_cli --phase prototrain \
        --data_path <blocks> --save_path <dir>/ --pretrain_checkpoint_path \
        <log_pretrain dir> --n_way 2 --k_shot 1 --use_attention

Same flags as the JAX CLI, plus `--device`. Launched by torchrun,
`--phase pretrain` runs data-parallel, one rank a process (NCCL on
`--device cuda`, gloo on `--device cpu`); the baseline phases run on one
process. Phases: `pretrain` (backbone
pre-training), `prototrain` / `mptitrain` (episodic training of the
ProtoNet / MPTI baselines), `protoeval` / `mptieval` (their test banks
from `--model_checkpoint_path`), `mptigfs` (MPTI in the GFS setting,
`--testing_data_path`) and `finetune` (the FineTune baseline;
`--n_iters` is its inner loop's length). Log directories are named as
the JAX CLI names them.
"""
from __future__ import annotations

import argparse
import os

from gfs3dseg_gws_tpu_torch.cli.common import (
    add_dispatch_args,
    add_model_args,
    add_pc_args,
    data_config_from_args,
    mesh_from_env,
    disable_tf32,
    model_config_from_args,
)
from gfs3dseg_gws_tpu_torch.utils.config import PretrainConfig, replace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Backbone pre-training and few-shot baselines "
                    "(PyTorch/CUDA port)")
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


def main(argv=None, **limits):
    """Run one phase. `limits` cut a run short, for tests and smoke runs:
    `max_iters` and `bank_episodes` (prototrain, mptitrain),
    `bank_episodes` (protoeval, mptieval), `max_episodes` and
    `bank_episodes` (finetune), `max_base_blocks` and `max_query_blocks`
    (mptigfs)."""
    args = build_parser().parse_args(argv)
    disable_tf32()
    model_cfg = model_config_from_args(args)
    data_cfg = data_config_from_args(args)

    from gfs3dseg_gws_tpu_torch.pipelines.gfs import resolve_device

    resolve_device(args.device)     # fail before any data is touched
    if args.phase == "pretrain":
        from gfs3dseg_gws_tpu_torch.pipelines.pretrain import pretrain

        log_dir = os.path.join(
            args.save_path,
            f"log_pretrain_{args.dataset}_S{args.cvfold}_LongTail")
        pre_cfg = PretrainConfig(
            batch_size=args.batch_size, lr=args.pretrain_lr,
            weight_decay=args.pretrain_weight_decay, n_iters=args.n_iters,
            step_size=args.pretrain_step_size, gamma=args.pretrain_gamma,
            eval_interval=args.eval_interval, seed=args.seed,
            log_dir=log_dir, device=args.device)
        from gfs3dseg_gws_tpu_torch.parallel.mesh import close_mesh

        mesh = mesh_from_env(args.device)
        try:
            return pretrain(model_cfg, data_cfg, pre_cfg, mesh=mesh,
                            **limits)
        finally:
            close_mesh(mesh)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            f"--phase {args.phase} runs on one process; of pretrain_cli "
            "only --phase pretrain runs data-parallel")

    from gfs3dseg_gws_tpu_torch.pipelines.baselines import (
        FewShotConfig, episodic_eval, episodic_train, finetune,
        mpti_test_gfs)

    fs_cfg = FewShotConfig(
        n_way=args.n_way, k_shot=args.k_shot, n_queries=args.n_queries,
        n_iters=args.n_iters, lr=args.lr, step_size=args.step_size,
        gamma=args.gamma, eval_interval=args.eval_interval,
        n_episode_test=args.n_episode_test, dist_method=args.dist_method,
        n_subprototypes=args.n_subprototypes, k_connect=args.k_connect,
        sigma=args.sigma, use_attention=args.use_attention, seed=args.seed,
        h2d=args.h2d, device=args.device)
    pretrained = args.pretrain_checkpoint_path or ""
    model_ckpt = args.model_checkpoint_path or ""
    if args.phase == "prototrain":
        log_dir = args.save_path + (
            f"log_proto_{args.dataset}_S{args.cvfold}_N{args.n_way}"
            f"_K{args.k_shot}_TL{int(args.triplet_loss_weight > 0)}"
            f"_Att{int(args.use_attention)}")
        return episodic_train("proto", model_cfg, data_cfg,
                              replace(fs_cfg, log_dir=log_dir), pretrained,
                              model_ckpt, **limits)
    if args.phase == "mptitrain":
        log_dir = os.path.join(
            args.save_path,
            f"log_mpti_S{args.cvfold}_N{args.n_way}_K{args.k_shot}"
            f"_Att{int(args.use_attention)}_{args.log_dir}")
        return episodic_train("mpti", model_cfg, data_cfg,
                              replace(fs_cfg, log_dir=log_dir), pretrained,
                              model_ckpt, **limits)
    if args.phase in ("protoeval", "mptieval"):
        kind = "proto" if args.phase == "protoeval" else "mpti"
        log_dir = model_ckpt or args.save_path
        if os.path.isfile(log_dir):
            log_dir = os.path.dirname(log_dir)
        return episodic_eval(kind, model_cfg, data_cfg,
                             replace(fs_cfg, log_dir=log_dir), model_ckpt,
                             **limits)
    if args.phase == "mptigfs":
        return mpti_test_gfs(model_cfg, data_cfg,
                             replace(fs_cfg, log_dir=args.save_path),
                             model_ckpt, args.testing_data_path, **limits)
    log_dir = args.save_path + (
        f"log_finetune_{args.dataset}_S{args.cvfold}_N{args.n_way}"
        f"_K{args.k_shot}")
    return finetune(model_cfg, data_cfg, replace(fs_cfg, log_dir=log_dir),
                    pretrained, inner_iters=args.n_iters, **limits)


if __name__ == "__main__":
    main()
