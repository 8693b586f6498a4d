"""Geometric-word extraction (counterpart of the JAX package's
pipelines/basis.py; reference get_basis.py:112-222).

One eval pass of the pre-trained DGCNN over every base-class block collects
the EdgeConv 1-3 features per class (at most 300,000 points per class, a
random subsample beyond that), then a global k-means (k-means++ seeding on
the host, Lloyd on the device), the cluster means and an SVD reconstruction
that keeps 0.95 of the singular-value energy. The basis is pickled under the
reference's file name, which GFS training and evaluation read.
"""
from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from gfs3dseg_gws_tpu_torch.data import (PretrainBlockDataset, batch_iterator,
                                         make_registry)
from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
from gfs3dseg_gws_tpu_torch.ops.kmeans import cluster_means, kmeans
from gfs3dseg_gws_tpu_torch.ops.linalg import svd_energy_reconstruct
from gfs3dseg_gws_tpu_torch.pipelines.gfs import resolve_device
from gfs3dseg_gws_tpu_torch.utils.checkpoint import (load_pretrained_encoder,
                                                     save_basis)

MAX_PTS_PER_CLASS = 300_000  # reference get_basis.py:189
BATCH_SIZE = 8               # blocks per forward of the feature sweep
KMEANS_ITERS = 100           # Lloyd iterations
SVD_ENERGY = 0.95            # singular-value energy the basis keeps


def basis_file_name(num_cnt: int) -> str:
    return (f"GlobalKmeans_EdgeConv123_cnt={num_cnt}_energy=095_"
            f"SVDReconstruct.pkl")


def extract_basis(model_cfg, data_cfg, num_cnt: int,
                  pretrain_checkpoint_path: str, save_dir: str,
                  seed: int = 123, device: str = "cuda") -> np.ndarray:
    """Write `save_dir/basis_file_name(num_cnt)` and return the basis
    (num_cnt, sum of the EdgeConv output widths) float32. The encoder runs
    and Lloyd iterates on `device`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    reg = make_registry(data_cfg.dataset, data_cfg.cvfold, data_cfg.data_path)
    classes = sorted(reg.train_classes)
    num_classes = len(classes) + 1
    c2s = {c: reg.class2scans[c] for c in classes}
    ds = PretrainBlockDataset(
        data_cfg.data_path, classes, c2s, mode="train",
        num_point=data_cfg.pc_npts, pc_attribs=data_cfg.pc_attribs)

    model = DGCNNSeg(num_classes, in_features=model_cfg.pc_in_dim,
                     edgeconv_widths=model_cfg.edgeconv_widths,
                     mlp_widths=model_cfg.dgcnn_mlp_widths,
                     k=model_cfg.dgcnn_k, device=dev)
    model.encoder.load_state_dict(
        _load_encoder(pretrain_checkpoint_path), strict=True)
    model.eval()

    # keep everything up to the cap, then subsample like the reference
    per_class: Dict[int, list] = {c: [] for c in range(1, num_classes)}
    for batch in batch_iterator(ds, BATCH_SIZE, shuffle=False,
                                pad_final=True):
        points, labels, valid = batch[0], batch[1], int(batch[-1])
        with torch.inference_mode():
            feats = model(torch.from_numpy(np.asarray(points, np.float32))
                          .to(dev), return_feat=True)[1].cpu().numpy()
        for b in range(valid):
            lb = labels[b]
            for c in np.unique(lb):
                if c == 0:
                    continue
                per_class[int(c)].append(feats[b][lb == c])

    pooled = []
    for c in range(1, num_classes):
        if not per_class[c]:
            continue
        feat = np.concatenate(per_class[c], axis=0)
        print(f"cls : {c} has {feat.shape[0]} features")
        if feat.shape[0] > MAX_PTS_PER_CLASS:
            idx = rng.choice(feat.shape[0], MAX_PTS_PER_CLASS, replace=False)
            feat = feat[idx]
        pooled.append(feat)
        per_class[c] = []
    point_feat = np.concatenate(pooled, axis=0)

    t0 = time.time()
    _, labels_km = kmeans(point_feat, num_cnt, n_iters=KMEANS_ITERS,
                          seed=seed, device=dev)
    print(f"kmean : {time.time() - t0:.1f}s")
    protos = cluster_means(point_feat, labels_km, num_cnt)
    basis = svd_energy_reconstruct(protos, energy=SVD_ENERGY)

    os.makedirs(save_dir, exist_ok=True)
    out = os.path.join(save_dir, basis_file_name(num_cnt))
    save_basis(out, basis)
    print(out)
    return basis


def _load_encoder(path: str) -> Dict[str, torch.Tensor]:
    """The encoder state dict from a pre-training `.npz`, a directory that
    holds `checkpoint.npz` and no `checkpoint.tar`, or a `checkpoint.tar`
    (the file, or the directory that holds it) (JAX: _load_encoder)."""
    if path.endswith(".npz") or (os.path.isdir(path) and os.path.exists(
            os.path.join(path, "checkpoint.npz")) and not os.path.exists(
            os.path.join(path, "checkpoint.tar"))):
        return load_pretrained_encoder(
            path if path.endswith(".npz")
            else os.path.join(path, "checkpoint.npz"))
    return load_pretrained_encoder(
        os.path.join(path, "checkpoint.tar") if os.path.isdir(path) else path)
