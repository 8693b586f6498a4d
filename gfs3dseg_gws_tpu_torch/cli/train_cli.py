"""GFS train/evaluate CLI (counterpart of the JAX package's
cli/train_cli.py; reference train.py:733-831).

    python -m gfs3dseg_gws_tpu_torch.cli.train_cli \\
        --basis_path gw.pkl --data_path ... --testing_data_path ... \\
        --use_pretrain_weight --pretrain_checkpoint_path checkpoint.tar \\
        --save_path run --device cuda
    python -m gfs3dseg_gws_tpu_torch.cli.train_cli --only_evaluate \\
        --phase test --model_checkpoint_path run/train_epoch_....npz \\
        --basis_path gw.pkl --data_path ... --testing_data_path ... \\
        --eval_weight 1.2 --device cuda

Same flags as the JAX CLI, plus `--device` and `--trace_dir` (a profiler
trace of the first epoch's steps LOSS_LAG ... LOSS_LAG + 23, or of the
evaluation sweep; README, "Tracing"). Without --only_evaluate it
trains (`pipelines/gfs.py::train_gfs`), with it it evaluates
(`evaluate_gfs`). Launched by torchrun it runs data-parallel, one rank a
process (`--mesh data`; NCCL on `--device cuda`, one card a rank; gloo on
`--device cpu`):

    torchrun --nproc_per_node 2 -m gfs3dseg_gws_tpu_torch.cli.train_cli ...

`--mesh dxp --mesh_sp S` lays the ranks out as a data x points mesh: the
evaluation splits the blocks over R / S ranks and each block's points
over S (sequence parallelism; N and the rank count must divide by S);
training runs the data mesh of all the ranks, as in JAX:

    torchrun --nproc_per_node 4 -m gfs3dseg_gws_tpu_torch.cli.train_cli \
        --only_evaluate --mesh dxp --mesh_sp 2 ...
"""
from __future__ import annotations

import argparse

from gfs3dseg_gws_tpu_torch.cli.common import (
    add_data_args,
    add_model_args,
    add_pc_args,
    add_tpu_compat_args,
    data_config_from_args,
    disable_tf32,
    mesh_from_env,
    model_config_from_args,
)
from gfs3dseg_gws_tpu_torch.utils.config import TrainConfig, replace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="GFS 3D segmentation via Geometric Words "
                    "(PyTorch/CUDA port)")
    # kept-for-compatibility flags (unused, like the reference's)
    p.add_argument("--train_gpu", default=[0])
    p.add_argument("--ngpus_per_node", type=int, default=1)
    p.add_argument("--batch_size_val", type=int, default=1)
    p.add_argument("--save_freq", type=int, default=5)
    p.add_argument("--start_val_epoch", type=int, default=25)
    p.add_argument("--n_iters", type=int, default=100)

    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--manual_seed", type=int, default=321)
    p.add_argument("--print_freq", type=int, default=20)
    p.add_argument("--save_path", type=str, default="log_s3dis/S0_K5/debug")
    p.add_argument("--evaluate", type=bool, default=True)
    p.add_argument("--phase", type=str, default="train",
                   choices=["train", "test"])

    add_data_args(p)
    p.add_argument("--use_pretrain_weight", action="store_true")
    p.add_argument("--pretrain_checkpoint_path", type=str, default="")
    p.add_argument("--model_checkpoint_path", type=str, default="")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--eval_batch_size", type=int, default=0,
                   help="validation sweep batch (0 = --batch_size; results "
                        "are batch-invariant)")
    p.add_argument("--step_size", type=int, default=50)
    p.add_argument("--gamma", type=float, default=0.5)
    add_pc_args(p)
    add_model_args(p)
    p.add_argument("--seed", default=321, type=int)
    p.add_argument("--only_evaluate", action="store_true", default=False)
    p.add_argument("--basis_path", type=str, default="")
    p.add_argument("--base_class_gp_coding_path", type=str, default="")
    p.add_argument("--energy", type=float, default=0.9,
                   help="coding energy threshold, must be <= 1")
    p.add_argument("--eval_weight", type=float, default=1.0,
                   help="beta re-weighting; validation=1.0, testing > 1.0")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the CUDA kernels) or cpu (their "
                        "plain PyTorch versions); cuda without a GPU raises")
    p.add_argument("--trace_dir", type=str, default="",
                   help="write a profiler trace (Chrome-trace JSON, with the "
                        "port's gfs3d.* spans) of training steps 16-39 of "
                        "the first epoch, or of the evaluation sweep, here")
    add_tpu_compat_args(p)
    return p


def main(argv=None, **overrides):
    """Parse `argv` and train or evaluate. `overrides` replace fields of the
    TrainConfig that the JAX CLI has no flag for (e.g. eval_interval,
    coding_interval, weight_decay), or `max_steps_per_epoch` of training,
    for callers in Python."""
    args = build_parser().parse_args(argv)
    if args.energy > 1:
        raise ValueError(f"--energy must be <= 1, got {args.energy}")
    disable_tf32()

    model_cfg = model_config_from_args(args)
    data_cfg = data_config_from_args(args)
    train_cfg = TrainConfig(
        batch_size=args.batch_size,
        eval_batch_size=args.eval_batch_size,
        base_lr=args.base_lr,
        epochs=args.epochs,
        start_epoch=args.start_epoch,
        step_size=args.step_size,
        gamma=args.gamma,
        energy=args.energy,
        eval_weight=args.eval_weight,
        seed=args.seed,
        save_path=args.save_path,
        print_freq=args.print_freq,
        evaluate=args.evaluate,
        only_evaluate=args.only_evaluate,
        use_pretrain_weight=args.use_pretrain_weight,
        pretrain_checkpoint_path=args.pretrain_checkpoint_path,
        model_checkpoint_path=args.model_checkpoint_path,
        basis_path=args.basis_path,
        device=args.device,
        trace_dir=args.trace_dir,
    )
    max_steps = overrides.pop("max_steps_per_epoch", None)
    train_cfg = replace(train_cfg, **overrides)

    from gfs3dseg_gws_tpu_torch.pipelines.gfs import (evaluate_gfs,
                                                      resolve_device,
                                                      train_gfs)

    from gfs3dseg_gws_tpu_torch.parallel.mesh import close_mesh

    resolve_device(args.device)     # fail before any data is touched
    mesh = mesh_from_env(args.device, args.mesh_shape, args.mesh_sp)
    try:
        if args.only_evaluate:
            return evaluate_gfs(model_cfg, data_cfg, train_cfg, mesh=mesh)
        return train_gfs(model_cfg, data_cfg, train_cfg,
                         max_steps_per_epoch=max_steps, mesh=mesh)
    finally:
        close_mesh(mesh)


if __name__ == "__main__":
    main()
