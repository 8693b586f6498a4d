"""Checkpoint I/O and the JAX-weight converters.

The port's modules carry the reference PyTorch state-dict keys
(`encoder.edge_convs.{i}.layer.{j}`, `fusion.0`, `main_proto`,
`segmenter.{0,1,3,4,7}`, ...), so a reference `.pth` (or one written by the
JAX package's `save_torch_gfs_checkpoint`) loads with
`load_state_dict(strict=True)`. The JAX package's native `.npz` checkpoints
go through `state_dict_from_jax` / `pretrain_state_dict_from_jax`, which
follow the key map of the JAX package's `_export_feat_state`,
`save_torch_gfs_checkpoint` and `convert_torch_segmenter`
(gfs3dseg_gws_tpu/utils/checkpoint.py:179-196, 355-422).

Pre-training writes both of the JAX package's files: `checkpoint.tar`
({"params": encoder state dict}, the reference layout that `get_basis.py`
and `train.py --use_pretrain_weight` read) and `checkpoint.npz` (the flat
`params/...`, `batch_stats/...` layout of its `save_checkpoint`). GFS
training writes its `GWCAPL` in that flat layout too (`save_gfs_npz`, read
by the JAX package's `load_checkpoint` + `restore_into`), and beside it the
optimizer and step in the port's own format (`save_train_state`), for
resume. The few-shot baselines (ProtoNet, MPTI) write the reference's
episodic `checkpoint.tar` ({'iteration', 'model_state_dict', 'loss',
'IoU'}) and the JAX package's `checkpoint.npz`, whose variables nest the
feature extractor under `feat` (`fewshot_state_dict_from_jax`,
`save_fewshot_npz`).

The way back works on state dicts at any encoder depth (the JAX package's
torch-tar reader takes two-layer blocks only): `gfs_flat_from_state_dict`,
`pretrain_flat_from_state_dict` and `fewshot_flat_from_state_dict` invert
the three `*_state_dict_from_jax`, `save_checkpoint` writes their arrays
as the JAX package's npz, and `save_torch_gfs_checkpoint`,
`save_torch_pretrain_checkpoint`, `save_torch_fewshot_checkpoint` and
`save_torch_coding` write the reference's `.pth` / `.tar` files
(`cli/convert_checkpoint.py` converts between the two). Nothing here
imports jax.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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


def save_basis(path: str, basis: np.ndarray) -> None:
    """Pickle a geometric-word basis as `load_basis` (and the JAX package's)
    reads it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(np.asarray(basis), f)


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


# one layout entry: (torch key prefix, JAX variable path, kind, has_bias);
# kind "bn" is a BatchNorm, "conv2d"/"conv1d" a 1x1 conv whose Dense kernel
# is the leaf at `path` (`path/../bias` its bias)
_Entry = Tuple[str, str, str, bool]


def _encoder_layout(block_depths: Sequence[int], n_mlp: int) -> List[_Entry]:
    """The DGCNN encoder's key map (JAX DGCNN -> reference DGCNN)."""
    out: List[_Entry] = []
    for i, depth in enumerate(block_depths):
        base, jb = f"encoder.edge_convs.{i}.layer", f"encoder/edgeconv{i}"
        out += [(f"{base}.0", f"{jb}/layer0_kernel", "conv2d", False),
                (f"{base}.1", f"{jb}/layer0_bn", "bn", False)]
        for j in range(1, depth):
            out += [(f"{base}.{3 * j}", f"{jb}/layer{j}/conv/kernel",
                     "conv2d", False),
                    (f"{base}.{3 * j + 1}", f"{jb}/layer{j}/bn", "bn", False)]
    for j in range(n_mlp):
        out += [(f"encoder.conv.layer.{3 * j}",
                 f"encoder/mlp/layer{j}/conv/kernel", "conv1d", False),
                (f"encoder.conv.layer.{3 * j + 1}", f"encoder/mlp/layer{j}/bn",
                 "bn", False)]
    return out


def _head_layout(n_base_convs: int) -> List[_Entry]:
    """The base learner's and the self-attention's key map."""
    out: List[_Entry] = []
    for i in range(n_base_convs):
        out += [(f"base_learner.convs.{i}.0", f"base_learner/conv{i}/kernel",
                 "conv1d", True),
                (f"base_learner.convs.{i}.1", f"base_learner/bn{i}", "bn",
                 False)]
    return out + [(f"att_learner.{m}", f"att_learner/{m}/kernel", "conv1d",
                   False) for m in ("q_map", "k_map", "v_map")]


_FUSION_LAYOUT: List[_Entry] = [
    ("fusion.0", "fusion/kernel", "conv1d", True),
    ("fusion.1", "fusion_bn", "bn", False),
]
_PROTOS = ("main_proto", "bg_proto")

_SEGMENTER_LAYOUT: List[_Entry] = [
    ("segmenter.0", "segmenter/conv0/kernel", "conv1d", False),
    ("segmenter.1", "segmenter/bn0", "bn", False),
    ("segmenter.3", "segmenter/conv1/kernel", "conv1d", True),
    ("segmenter.4", "segmenter/bn1", "bn", False),
    ("segmenter.7", "segmenter/conv2/kernel", "conv1d", True),
]


def _jax_encoder_depths(enc_p: Mapping) -> Tuple[List[int], int]:
    depths = []
    while f"edgeconv{len(depths)}" in enc_p:
        blk = enc_p[f"edgeconv{len(depths)}"]
        depths.append(1 + sum(1 for key in blk if key.startswith("layer")
                              and key[5:].isdigit()))
    return depths, sum(1 for key in enc_p["mlp"] if key.startswith("layer"))


def _get(tree: Mapping, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _put_layout(sd: Dict, layout: Sequence[_Entry], params: Mapping,
                batch_stats: Mapping) -> None:
    for key, path, kind, has_bias in layout:
        if kind == "bn":
            _put_bn(sd, key, _get(params, path), _get(batch_stats, path))
        else:
            bias = (_get(params, path.rsplit("/", 1)[0] + "/bias")
                    if has_bias else None)
            _put_conv(sd, key, _get(params, path), conv2d=kind == "conv2d",
                      bias=bias)


def _split_variables(params: Mapping, batch_stats: Optional[Mapping]):
    if batch_stats is None:
        tree = params
        if any("/" in k for k in tree):
            tree = _unflatten(tree)
        params, batch_stats = tree["params"], tree["batch_stats"]
    return params, batch_stats


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
    params, batch_stats = _split_variables(params, batch_stats)
    sd: Dict[str, torch.Tensor] = {}
    layout = (_encoder_layout(*_jax_encoder_depths(params["encoder"]))
              + _head_layout(_jax_base_convs(params)) + _FUSION_LAYOUT)
    _put_layout(sd, layout, params, batch_stats)
    for name in _PROTOS:
        sd[name] = torch.from_numpy(np.array(params[name], np.float32))
    return sd


def _jax_base_convs(params: Mapping) -> int:
    return sum(1 for key in params["base_learner"] if key.startswith("conv"))


def segatt_state_dict_from_jax(params: Mapping,
                               batch_stats: Optional[Mapping] = None
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's DGCNNSegAtt variables -> the port's `DGCNNSegAtt`
    state dict (reference model/dgcnn.py:155-202 keys; same argument forms
    as `state_dict_from_jax`)."""
    params, batch_stats = _split_variables(params, batch_stats)
    sd: Dict[str, torch.Tensor] = {}
    layout = (_encoder_layout(*_jax_encoder_depths(params["encoder"]))
              + _head_layout(_jax_base_convs(params)) + _SEGMENTER_LAYOUT)
    _put_layout(sd, layout, params, batch_stats)
    return sd


def pretrain_state_dict_from_jax(params: Mapping,
                                 batch_stats: Optional[Mapping] = None
                                 ) -> Dict[str, torch.Tensor]:
    """The JAX package's DGCNNSeg variables -> the port's `DGCNNSeg` state
    dict (same argument forms as `state_dict_from_jax`). Variables that
    hold the encoder alone (the JAX package's converted `checkpoint.tar`)
    give the encoder's keys alone."""
    params, batch_stats = _split_variables(params, batch_stats)
    sd: Dict[str, torch.Tensor] = {}
    layout = _encoder_layout(*_jax_encoder_depths(params["encoder"]))
    if "segmenter" in params:
        layout += _SEGMENTER_LAYOUT
    _put_layout(sd, layout, params, batch_stats)
    return sd


def _fewshot_layout(block_depths: Sequence[int], n_mlp: int,
                    n_base_convs: int, attention: bool) -> List[_Entry]:
    """The few-shot feature extractor's key map: the port's (and the
    reference's) top-level keys, the JAX package's paths under `feat`
    (its utils/checkpoint.py::_export_feat_state)."""
    layout = _encoder_layout(block_depths, n_mlp) + [
        entry for entry in _head_layout(n_base_convs)
        if attention or not entry[0].startswith("att_learner.")]
    if not attention:
        layout.append(("linear_mapper", "linear_mapper/kernel", "conv1d",
                       False))
    return [(key, f"feat/{path}", kind, bias)
            for key, path, kind, bias in layout]


def fewshot_state_dict_from_jax(params: Mapping,
                                batch_stats: Optional[Mapping] = None
                                ) -> Dict[str, torch.Tensor]:
    """The JAX package's ProtoNet / MPTI variables ({'feat': {encoder,
    base_learner, att_learner | linear_mapper}}) -> the port's `ProtoNet` /
    `MPTI` state dict (the reference's keys; same argument forms as
    `state_dict_from_jax`)."""
    params, batch_stats = _split_variables(params, batch_stats)
    feat = params["feat"]
    sd: Dict[str, torch.Tensor] = {}
    _put_layout(sd, _fewshot_layout(*_jax_encoder_depths(feat["encoder"]),
                                    _jax_base_convs(feat),
                                    "att_learner" in feat),
                params, batch_stats)
    return sd


# --------------------------------------------------------------------------- #
# port state dict -> JAX variables (the inverses, at any encoder depth)
# --------------------------------------------------------------------------- #

def _convs(sd: Mapping, fmt: str) -> int:
    """How many layers a module list holds: the n with `fmt.format(n)` in
    `sd` for n = 0, 1, ... (a conv_bn_stack holds [conv, BatchNorm,
    activation] a layer, so its n-th conv weight is `{3 n}.weight`)."""
    n = 0
    while fmt.format(n=n, i=3 * n) in sd:
        n += 1
    return n


def _sd_depths(sd: Mapping) -> Tuple[List[int], int]:
    """The EdgeConv block depths and MLP depth of the DGCNN whose
    `encoder.` keys `sd` holds."""
    depths = []
    while f"encoder.edge_convs.{len(depths)}.layer.0.weight" in sd:
        depths.append(_convs(
            sd, f"encoder.edge_convs.{len(depths)}.layer.{{i}}.weight"))
    return depths, _convs(sd, "encoder.conv.layer.{i}.weight")


def _sd_base_convs(sd: Mapping) -> int:
    return _convs(sd, "base_learner.convs.{n}.0.weight")


def gfs_flat_from_state_dict(sd: Mapping) -> Dict[str, np.ndarray]:
    """A `GWCAPL` state dict (the reference's GFS keys) -> the JAX
    package's flat `params/...`, `batch_stats/...` arrays: the inverse of
    `state_dict_from_jax`."""
    layout = (_encoder_layout(*_sd_depths(sd))
              + _head_layout(_sd_base_convs(sd)) + _FUSION_LAYOUT)
    return _flat_from_state_dict(sd, layout, _PROTOS)


def pretrain_flat_from_state_dict(sd: Mapping) -> Dict[str, np.ndarray]:
    """A `DGCNNSeg` state dict, or its `encoder.` keys alone -> flat JAX
    arrays (the encoder, and the segmenter where `sd` has one): the
    inverse of `pretrain_state_dict_from_jax`."""
    layout = _encoder_layout(*_sd_depths(sd))
    if "segmenter.0.weight" in sd:
        layout += _SEGMENTER_LAYOUT
    return _flat_from_state_dict(sd, layout, ())


def fewshot_flat_from_state_dict(sd: Mapping) -> Dict[str, np.ndarray]:
    """A `ProtoNet` / `MPTI` state dict -> flat JAX arrays under
    `params/feat/...`, `batch_stats/feat/...`: the inverse of
    `fewshot_state_dict_from_jax`."""
    return _flat_from_state_dict(sd, _fewshot_layout(
        *_sd_depths(sd), _sd_base_convs(sd),
        "att_learner.q_map.weight" in sd), ())


def _flat_from_state_dict(sd: Mapping, layout: Sequence[_Entry],
                          extra: Sequence[str]) -> Dict[str, np.ndarray]:
    """`sd` through `layout` (plus the parameters named in `extra`, kept at
    the top level) as flat npz arrays (copies, on the host)."""
    def host(name):
        return np.array(sd[name].detach().cpu())

    flat: Dict[str, np.ndarray] = {f"params/{name}": host(name)
                                   for name in extra}
    for key, path, kind, has_bias in layout:
        if kind == "bn":
            flat[f"params/{path}/scale"] = host(key + ".weight")
            flat[f"params/{path}/bias"] = host(key + ".bias")
            flat[f"batch_stats/{path}/mean"] = host(key + ".running_mean")
            flat[f"batch_stats/{path}/var"] = host(key + ".running_var")
            continue
        w = host(key + ".weight")
        flat[f"params/{path}"] = np.ascontiguousarray(
            w.reshape(w.shape[0], w.shape[1]).T)
        if has_bias:
            flat[f"params/{path.rsplit('/', 1)[0]}/bias"] = host(key + ".bias")
    return flat


def save_checkpoint(path: str, flat: Mapping[str, np.ndarray],
                    meta: Optional[Dict] = None) -> None:
    """Write flat arrays and JSON metadata as the JAX package's `.npz`
    checkpoint (its `save_checkpoint` layout; `load_checkpoint` reads it
    back)."""
    arrays = dict(flat)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                       dtype=np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_gfs_npz(model, path: str, meta: Optional[Dict] = None) -> None:
    """Write a `GWCAPL` in the JAX package's flat checkpoint layout: the
    JAX package's `load_checkpoint` + `restore_into` read it into its
    GWCAPL, and so does the port's `load_checkpoint` +
    `state_dict_from_jax`."""
    save_checkpoint(path, gfs_flat_from_state_dict(model.state_dict()), meta)


def save_pretrain_npz(model, path: str, meta: Optional[Dict] = None) -> None:
    """Write a `DGCNNSeg` as the JAX package's `checkpoint.npz`: flat
    `params/...` and `batch_stats/...` arrays plus a JSON `__meta__`, the
    layout its `save_checkpoint` writes and `restore_into` reads."""
    save_checkpoint(path, pretrain_flat_from_state_dict(model.state_dict()),
                    meta)


def save_fewshot_npz(model, path: str, meta: Optional[Dict] = None) -> None:
    """Write a `ProtoNet` / `MPTI` as the JAX package's few-shot
    `checkpoint.npz` (flat `params/feat/...`, `batch_stats/feat/...`),
    which its `FewShotLearner` restores strictly."""
    save_checkpoint(path, fewshot_flat_from_state_dict(model.state_dict()),
                    meta)


# --------------------------------------------------------------------------- #
# the reference's torch formats
# --------------------------------------------------------------------------- #

def _host_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def save_torch_gfs_checkpoint(sd: Mapping, path: str, epoch: int = 0,
                              max_iou: float = 0.0) -> None:
    """Write a `GWCAPL` state dict as the reference's GFS `.pth`
    ({'epoch', 'state_dict', 'optimizer', 'max_iou'}, reference
    train.py:561), which `load_torch_gfs_state_dict` and the JAX package's
    `load_torch_gfs_checkpoint` read."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"epoch": int(epoch), "state_dict": _host_state_dict(sd),
                "optimizer": {}, "max_iou": float(max_iou)}, path)


def save_torch_coding(coding: np.ndarray, path: str) -> None:
    """Write a base-class coding as the reference's
    base_class_gp_coding_energy={e}.pth (a torch.save of the float32
    (n_base, num_gw) tensor, reference train.py:563)."""
    torch.save(torch.from_numpy(np.asarray(coding, np.float32)), path)


def save_torch_fewshot_checkpoint(sd: Mapping, out_dir: str,
                                  iteration: int = 0, iou: float = 0.0,
                                  loss: float = 0.0) -> str:
    """Write a `ProtoNet` / `MPTI` state dict as `out_dir/checkpoint.tar`
    in the reference's episodic-baseline format ({'iteration',
    'model_state_dict', 'loss', 'IoU'}, pretrain/runs/proto_train.py:72-78).
    Returns the path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "checkpoint.tar")
    torch.save({"iteration": int(iteration),
                "model_state_dict": _host_state_dict(sd),
                "loss": float(loss), "IoU": float(iou)}, path)
    return path


def load_torch_fewshot_tar(path: str) -> Dict[str, Any]:
    """A reference episodic-baseline checkpoint, given as its directory
    (the reference appends `checkpoint.tar`) or the file, as saved. A
    pre-training tar ({'params': encoder}) is refused: it belongs to
    `pretrain_checkpoint_path`."""
    p = path if path.endswith(".tar") else os.path.join(path,
                                                        "checkpoint.tar")
    ckpt = torch_load(p)
    if "model_state_dict" not in ckpt:
        if "params" in ckpt:
            raise ValueError(
                f"{p} is a pre-training encoder checkpoint ({{'params': "
                "...}}); pass it as the pretrain checkpoint, not as an "
                "episodic-baseline model checkpoint")
        raise ValueError(f"{p} has no 'model_state_dict' key; not an "
                         "episodic-baseline checkpoint.tar")
    return ckpt


def load_torch_fewshot_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of `load_torch_fewshot_tar(path)`."""
    return dict(load_torch_fewshot_tar(path)["model_state_dict"])


def save_torch_pretrain_checkpoint(sd: Mapping, out_dir: str) -> str:
    """Write the `encoder.` keys of a `DGCNNSeg` (or any model's) state
    dict as `out_dir/checkpoint.tar` = {"params": encoder state dict}, the
    reference layout (JAX: save_torch_pretrain_checkpoint). Returns the
    path."""
    enc = {k[len("encoder."):]: v for k, v in sd.items()
           if k.startswith("encoder.")}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "checkpoint.tar")
    torch.save({"params": _host_state_dict(enc)}, path)
    return path


# --------------------------------------------------------------------------- #
# GFS training: the pre-trained encoder in, the optimizer state out
# --------------------------------------------------------------------------- #

def load_pretrained_encoder(path: str) -> Dict[str, torch.Tensor]:
    """A pre-trained encoder as a state dict of `DGCNN` keys (no `encoder.`
    prefix), from the pre-training `checkpoint.npz` (the JAX package's or
    the port's) or the reference `checkpoint.tar` ({"params": encoder state
    dict}, or the directory holding it) (JAX
    pipelines/gfs.py::_load_encoder_any)."""
    if os.path.isdir(path):
        path = os.path.join(path, "checkpoint.tar")
    if path.endswith(".npz"):
        sd = pretrain_state_dict_from_jax(load_checkpoint(path)[0])
        return {k[len("encoder."):]: v for k, v in sd.items()
                if k.startswith("encoder.")}
    return torch_load(path)["params"]


def train_state_path(npz_path: str) -> str:
    """Where `save_train_state` keeps the optimizer next to a checkpoint."""
    return os.path.splitext(npz_path)[0] + ".train_state.pt"


def save_train_state(npz_path: str, opt: torch.optim.Optimizer, sched,
                     step: int) -> str:
    """The optimizer's moments, the schedule and the step count, in the
    port's own format (torch.save) next to `npz_path`, for resume. The JAX
    package keeps its optax state inside the npz; the two do not read each
    other's. Returns the path."""
    path = train_state_path(npz_path)
    tmp = path + ".tmp"
    torch.save({"optimizer": opt.state_dict(),
                "scheduler": sched.state_dict(), "step": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def load_train_state(npz_path: str, opt: torch.optim.Optimizer,
                     sched) -> int:
    """Restore what `save_train_state` wrote beside `npz_path` into `opt`
    and `sched`; returns the step count."""
    state = torch.load(train_state_path(npz_path), map_location="cpu",
                       weights_only=True)
    opt.load_state_dict(state["optimizer"])
    sched.load_state_dict(state["scheduler"])
    return int(state["step"])
