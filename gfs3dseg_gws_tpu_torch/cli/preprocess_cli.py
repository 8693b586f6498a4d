"""Preprocessing CLI: scene collection + room -> block splitting
(counterpart of the JAX package's cli/preprocess_cli.py; reference
pretrain/preprocess/{collect_s3dis_data,collect_scannet_data,
room2blocks}.py with their hard-coded ROOT_DIR paths made flags).

    python -m gfs3dseg_gws_tpu_torch.cli.preprocess_cli collect_s3dis \
        --data_path <Stanford3dDataset_v1.2_Aligned_Version> \
        --out_root <dataset root> [--train]
    python -m gfs3dseg_gws_tpu_torch.cli.preprocess_cli collect_scannet \
        --data_path <scans> --out_root <dataset root>
    python -m gfs3dseg_gws_tpu_torch.cli.preprocess_cli room2blocks \
        --data_path <dataset root>/scenes [--train] [--device cuda|cpu]

The subcommands and flags are the JAX CLI's; `room2blocks` adds
`--device` (default cuda), where the block selection runs.
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="[Preprocessing] collect scenes "
                                "and split rooms into blocks")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("collect_s3dis",
                       help="Aggregate S3DIS room annotations into npy "
                            "scenes (reference collect_s3dis_data.py)")
    c.add_argument("--data_path", required=True,
                   help="Stanford3dDataset_v1.2_Aligned_Version directory")
    c.add_argument("--out_root", required=True,
                   help="destination dataset root (gets scenes/, meta/)")
    c.add_argument("--train", action="store_true",
                   help="Areas 1-5 (train) instead of Area 6 (test)")

    c = sub.add_parser("collect_scannet",
                       help="ply+json -> npy scenes (reference "
                            "collect_scannet_data.py)")
    c.add_argument("--data_path", required=True, help="scans directory")
    c.add_argument("--out_root", required=True)
    c.add_argument("--tsv_path", default=None,
                   help="scannetv2-labels.combined.tsv (default: the "
                        "vendored canonical copy)")
    c.add_argument("--val_list", default=None,
                   help="scannetv2_val.txt (default: the vendored "
                        "canonical v2 split)")

    b = sub.add_parser("room2blocks",
                       help="Split scenes into 1m XY blocks (reference "
                            "room2blocks.py)")
    b.add_argument("--data_path", required=True, help="scenes/ directory")
    b.add_argument("--dataset", default="s3dis")
    b.add_argument("--block_size", type=float, default=1.0)
    b.add_argument("--stride", type=float, default=1.0)
    b.add_argument("--min_npts", type=int, default=1000)
    b.add_argument("--train", action="store_true")
    b.add_argument("--device", default="cuda",
                   help="torch device of the block selection: cuda (the "
                        "default) or cpu")
    return p


def _write_classnames(out_root: str, dataset: str, classnames) -> None:
    os.makedirs(os.path.join(out_root, "meta"), exist_ok=True)
    with open(os.path.join(out_root, "meta", f"{dataset}_classnames.txt"),
              "w") as f:
        f.write("\n".join(classnames) + "\n")


def main(argv=None):
    args = build_parser().parse_args(argv)
    from gfs3dseg_gws_tpu_torch.data import preprocess as pp
    from gfs3dseg_gws_tpu_torch.data.registry import (S3DIS_CLASSNAMES,
                                                      SCANNET_CLASSNAMES)

    if args.cmd == "collect_s3dis":
        _write_classnames(args.out_root, "s3dis", S3DIS_CLASSNAMES)
        written = pp.collect_s3dis(args.data_path, args.out_root,
                                   S3DIS_CLASSNAMES, train=args.train)
        print(f"collected {len(written)} scenes")
    elif args.cmd == "collect_scannet":
        _write_classnames(args.out_root, "scannet", SCANNET_CLASSNAMES)
        val = pp.load_scannet_val_scenes(args.val_list)
        written = pp.collect_scannet(args.data_path, args.out_root,
                                     SCANNET_CLASSNAMES, args.tsv_path, val)
        print(f"collected {len(written)} scenes")
    else:
        from gfs3dseg_gws_tpu_torch.pipelines.gfs import resolve_device

        device = resolve_device(args.device)
        count = pp.split_rooms_to_blocks(
            args.data_path, os.path.dirname(args.data_path.rstrip("/")),
            train=args.train, block_size=args.block_size, stride=args.stride,
            min_npts=args.min_npts, device=device)
        print(f"Total samples: {count}")


if __name__ == "__main__":
    main()
