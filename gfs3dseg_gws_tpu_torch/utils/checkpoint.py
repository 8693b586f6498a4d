"""Checkpoint loading for the eval path, and the JAX-weight converter.

The port's modules carry the reference PyTorch state-dict keys
(`encoder.edge_convs.{i}.layer.{j}`, `fusion.0`, `main_proto`, ...), so a
reference `.pth` (or one written by the JAX package's
`save_torch_gfs_checkpoint`) loads with `load_state_dict(strict=True)`.
The JAX package's native `.npz` checkpoints go through
`state_dict_from_jax`, which follows the key map of the JAX package's
`_export_feat_state` / `save_torch_gfs_checkpoint`
(gfs3dseg_gws_tpu/utils/checkpoint.py:355-422). Nothing here imports jax.
"""
from __future__ import annotations

import json
import pickle
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """A JAX-package `.npz` checkpoint -> (flat "/"-keyed arrays, metadata)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in \
            z.files else {}
    return flat, meta


def load_basis(path: str) -> np.ndarray:
    """Pickled geometric-word basis (reference get_basis.py:219-222)."""
    with open(path, "rb") as f:
        return np.asarray(pickle.load(f), dtype=np.float32)


def torch_load(path: str):
    """torch.load with weights_only=True.

    Reference checkpoints carry numpy scalar metadata (`max_iou` is an
    np.float64, train.py:561), which the weights-only unpickler refuses
    unless the numpy scalar-reconstruction globals are allowed; the retry
    allows exactly those and no arbitrary code.
    """
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        import importlib

        allow = [np.dtype]
        for mod in ("numpy._core.multiarray", "numpy.core.multiarray"):
            try:
                allow.append(importlib.import_module(mod).scalar)
            except (ImportError, AttributeError):
                continue
        allow.extend([np.dtypes.Float64DType, np.dtypes.Float32DType])
        with torch.serialization.safe_globals(allow):
            return torch.load(path, map_location="cpu", weights_only=True)


def load_torch_gfs_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Reference GFS `.pth` ({'epoch','state_dict','optimizer','max_iou'},
    reference train.py:561) -> its state dict."""
    return torch_load(path)["state_dict"]


def load_torch_coding(path: str) -> np.ndarray:
    """Reference base_class_gp_coding_energy={e}.pth (a torch.save of the
    (n_base, num_gw) multi-hot coding, reference train.py:563)."""
    t = torch_load(path)
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t, np.float32)


# --------------------------------------------------------------------------- #
# JAX variables -> port state dict
# --------------------------------------------------------------------------- #

def _unflatten(flat: Mapping[str, Any]) -> Dict:
    tree: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _put_conv(sd: Dict, key: str, kernel, conv2d: bool = False,
              bias=None) -> None:
    """Dense kernel (in, out) -> torch conv1x1 weight (out, in, 1[, 1])."""
    w = np.asarray(kernel, np.float32).T
    w = w.reshape(w.shape + ((1, 1) if conv2d else (1,)))
    sd[key + ".weight"] = torch.from_numpy(np.ascontiguousarray(w))
    if bias is not None:
        sd[key + ".bias"] = torch.from_numpy(np.array(bias, np.float32))


def _put_bn(sd: Dict, key: str, p: Mapping, s: Mapping) -> None:
    sd[key + ".weight"] = torch.from_numpy(np.array(p["scale"], np.float32))
    sd[key + ".bias"] = torch.from_numpy(np.array(p["bias"], np.float32))
    sd[key + ".running_mean"] = torch.from_numpy(np.array(s["mean"],
                                                          np.float32))
    sd[key + ".running_var"] = torch.from_numpy(np.array(s["var"],
                                                         np.float32))
    sd[key + ".num_batches_tracked"] = torch.tensor(0)


def state_dict_from_jax(params: Mapping,
                        batch_stats: Optional[Mapping] = None
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's GWCAPL variables -> the port's `GWCAPL` state dict.

    Accepts `(params, batch_stats)` as nested dicts of arrays, one
    `{"params": ..., "batch_stats": ...}` dict, or the flat `params/...`,
    `batch_stats/...` keys that the JAX package's `save_checkpoint` writes
    (as returned by `load_checkpoint`). Leaves may be numpy arrays or
    anything `np.asarray` accepts.
    """
    if batch_stats is None:
        tree = params
        if any("/" in k for k in tree):
            tree = _unflatten(tree)
        params, batch_stats = tree["params"], tree["batch_stats"]

    sd: Dict[str, torch.Tensor] = {}
    enc_p, enc_s = params["encoder"], batch_stats["encoder"]
    i = 0
    while f"edgeconv{i}" in enc_p:
        base = f"encoder.edge_convs.{i}.layer"
        blk_p, blk_s = enc_p[f"edgeconv{i}"], enc_s[f"edgeconv{i}"]
        _put_conv(sd, f"{base}.0", blk_p["layer0_kernel"], conv2d=True)
        _put_bn(sd, f"{base}.1", blk_p["layer0_bn"], blk_s["layer0_bn"])
        j = 1
        while f"layer{j}" in blk_p:
            _put_conv(sd, f"{base}.{3 * j}",
                      blk_p[f"layer{j}"]["conv"]["kernel"], conv2d=True)
            _put_bn(sd, f"{base}.{3 * j + 1}", blk_p[f"layer{j}"]["bn"],
                    blk_s[f"layer{j}"]["bn"])
            j += 1
        i += 1
    j = 0
    while f"layer{j}" in enc_p["mlp"]:
        _put_conv(sd, f"encoder.conv.layer.{3 * j}",
                  enc_p["mlp"][f"layer{j}"]["conv"]["kernel"])
        _put_bn(sd, f"encoder.conv.layer.{3 * j + 1}",
                enc_p["mlp"][f"layer{j}"]["bn"],
                enc_s["mlp"][f"layer{j}"]["bn"])
        j += 1

    bl_p, bl_s = params["base_learner"], batch_stats["base_learner"]
    i = 0
    while f"conv{i}" in bl_p:
        _put_conv(sd, f"base_learner.convs.{i}.0", bl_p[f"conv{i}"]["kernel"],
                  bias=bl_p[f"conv{i}"]["bias"])
        _put_bn(sd, f"base_learner.convs.{i}.1", bl_p[f"bn{i}"],
                bl_s[f"bn{i}"])
        i += 1

    for name in ("q_map", "k_map", "v_map"):
        _put_conv(sd, f"att_learner.{name}",
                  params["att_learner"][name]["kernel"])
    _put_conv(sd, "fusion.0", params["fusion"]["kernel"],
              bias=params["fusion"]["bias"])
    _put_bn(sd, "fusion.1", params["fusion_bn"], batch_stats["fusion_bn"])
    sd["main_proto"] = torch.from_numpy(np.array(params["main_proto"],
                                                 np.float32))
    sd["bg_proto"] = torch.from_numpy(np.array(params["bg_proto"],
                                               np.float32))
    return sd
