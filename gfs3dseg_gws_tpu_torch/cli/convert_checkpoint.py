"""Convert checkpoints between the reference's torch formats and the npz
layout the port's CLIs write (counterpart of the JAX package's
scripts/convert_checkpoint.py: the same eight modes, arguments, carried
metadata and final line, at any encoder depth).

    # reference GFS model .pth -> npz (train_cli --model_checkpoint_path)
    python -m gfs3dseg_gws_tpu_torch.cli.convert_checkpoint gfs-to-npz \
        model.pth out.npz
    # GFS npz -> reference-format .pth
    ... npz-to-gfs ckpt.npz out.pth
    # reference pretrain checkpoint.tar (or its dir) -> encoder npz
    ... pretrain-to-npz log_pretrain_dir out.npz
    # pretrain npz -> reference checkpoint.tar (written into OUT_DIR)
    ... npz-to-pretrain checkpoint.npz out_dir
    # reference base_class_gp_coding_energy={e}.pth -> npz (and back)
    ... coding-to-npz coding.pth out.npz
    ... npz-to-coding coding.npz out.pth
    # reference episodic-baseline (ProtoNet/MPTI) checkpoint.tar (or its
    # dir) -> npz; and a few-shot npz -> reference checkpoint.tar dir
    ... fewshot-to-npz log_proto_dir out.npz
    ... npz-to-fewshot ckpt.npz out_dir
"""
from __future__ import annotations

import argparse

MODES = ["gfs-to-npz", "npz-to-gfs", "pretrain-to-npz", "npz-to-pretrain",
         "coding-to-npz", "npz-to-coding", "fewshot-to-npz", "npz-to-fewshot"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=MODES)
    p.add_argument("src")
    p.add_argument("dst")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from gfs3dseg_gws_tpu_torch.utils import checkpoint as ck

    src, dst = args.src, args.dst
    if args.mode == "coding-to-npz":
        np.savez(dst, coding=ck.load_torch_coding(src))
    elif args.mode == "npz-to-coding":
        with np.load(src) as z:
            ck.save_torch_coding(z["coding"], dst)
    elif args.mode == "gfs-to-npz":
        ckpt = ck.torch_load(src)
        ck.save_checkpoint(dst, ck.gfs_flat_from_state_dict(
            ckpt["state_dict"]), {"epoch": int(ckpt.get("epoch", 0)),
                                  "max_iou": float(ckpt.get("max_iou", 0.0))})
    elif args.mode == "npz-to-gfs":
        flat, meta = ck.load_checkpoint(src)
        ck.save_torch_gfs_checkpoint(ck.state_dict_from_jax(flat), dst,
                                     epoch=int(meta.get("epoch", 0)),
                                     max_iou=float(meta.get("max_iou", 0.0)))
    elif args.mode == "pretrain-to-npz":
        enc = ck.load_pretrained_encoder(src)
        ck.save_checkpoint(dst, ck.pretrain_flat_from_state_dict(
            {f"encoder.{k}": v for k, v in enc.items()}))
    elif args.mode == "npz-to-pretrain":
        flat, _ = ck.load_checkpoint(src)
        ck.save_torch_pretrain_checkpoint(
            ck.pretrain_state_dict_from_jax(flat), dst)
    elif args.mode == "fewshot-to-npz":
        ckpt = ck.load_torch_fewshot_tar(src)
        meta = {k: int(ckpt[k]) if k == "iteration" else float(ckpt[k])
                for k in ("iteration", "IoU", "loss") if k in ckpt}
        ck.save_checkpoint(dst, ck.fewshot_flat_from_state_dict(
            ckpt["model_state_dict"]), meta)
    else:  # npz-to-fewshot
        flat, meta = ck.load_checkpoint(src)
        ck.save_torch_fewshot_checkpoint(
            ck.fewshot_state_dict_from_jax(flat), dst,
            iteration=int(meta.get("iteration", 0)),
            iou=float(meta.get("IoU", meta.get("best_iou", 0.0))),
            loss=float(meta.get("loss", 0.0)))
    print(f"{args.mode}: {src} -> {dst}")


if __name__ == "__main__":
    main()
