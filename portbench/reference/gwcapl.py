"""The plain reference of the GW-CAPL model: its evaluation pass and its
base-stage training step, in plain PyTorch on a dictionary of tensors
keyed as the reference's state dict.

It follows the published model (reference model/dgcnn.py, model/capl.py,
model/attention.py; the paper arXiv 2309.11222) in the way the original
code writes it: every EdgeConv builds the (B, N, k, 2C) edge tensor
[x_j - x_i, x_i] from a top-k of pairwise distances and runs its 1x1
convs on it, every BatchNorm is the textbook one, attention materialises
its (B, N, N) weights. It imports nothing of the programs it judges.

Departures, each also the measured program's: the attention's dropout
acts on the normalised weights with the counter-based hash mask of
`dropout_keep_mask` (a frozen copy of its definition; the reference draws
torch's dropout stream instead), and the fake classes are drawn from a
device generator as documented in `fake_prototypes`. Float32 throughout;
`precision("tf32")` lowers every product to TF32 for the control.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

LEAKY_SLOPE = 0.2
BN_EPS = 1e-5
IGNORE_INDEX = 255
Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------- #
# precision: float32 with TF32 off, or the control's TF32
# --------------------------------------------------------------------------- #

_TF32_EMULATE = [False]


@contextlib.contextmanager
def precision(mode: str):
    """'fp32': float32 products with TF32 off. 'tf32': every product in
    TF32 (on a CUDA device the hardware's TF32; on the CPU an emulation:
    the forward's operands rounded to 10 mantissa bits, products summed
    in float32)."""
    if mode not in ("fp32", "tf32"):
        raise ValueError(f"precision {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, _TF32_EMULATE[0])
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    _TF32_EMULATE[0] = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _TF32_EMULATE[0]) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits, to nearest, ties
    away from zero as the tensor cores' conversion does); the gradient
    passes through unrounded (the emulation rounds the forward's
    products only)."""
    v = x.detach().contiguous()
    bits = (v.view(torch.int32) + 0x1000) & ~0x1FFF
    return x + (bits.view(torch.float32) - v)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, its operands rounded to TF32 where the control emulates it."""
    if _TF32_EMULATE[0] and a.device.type == "cpu":
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    if _TF32_EMULATE[0] and ops[0].device.type == "cpu":
        ops = tuple(round_tf32(o) for o in ops)
    return torch.einsum(eq, *ops)


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #

def l2norm(x: torch.Tensor) -> torch.Tensor:
    return F.normalize(x, dim=-1, eps=1e-12)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def conv(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 Conv1d/Conv2d on channel-last x."""
    w = p[key + ".weight"]
    y = mm(x, w.reshape(w.shape[0], -1).t())
    bias = p.get(key + ".bias")
    return y if bias is None else y + bias


def batchnorm(p: Params, key: str, x: torch.Tensor, train: bool
              ) -> torch.Tensor:
    """BatchNorm over the trailing channel axis: batch statistics (biased
    variance) in training, the running ones in evaluation."""
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dims)
        var = x.var(dims, unbiased=False)
    else:
        mean, var = p[key + ".running_mean"], p[key + ".running_var"]
    return (x - mean) / torch.sqrt(var + BN_EPS) * p[key + ".weight"] \
        + p[key + ".bias"]


class Graphs:
    """kNN graphs that another run chose, to be taken where they differ
    from the reference's own only by a near-tie, and the count of rows
    where they differ by more.

    `given` holds the (B, N, k) graphs in the order the EdgeConvs build
    them, one per block and pass. A row of a given graph whose neighbour
    set differs from the reference's is a near-tie when, by the
    reference's float64 distances, its farthest neighbour lies no more
    than TIE_RTOL x (|x_i|^2 + |x_j|^2) beyond the reference's k-th: the
    float32 rounding of that expanded distance can order them either way.
    Such a row is taken, so that a flipped neighbour, which moves a point's
    features and every gradient downstream of it, does not stand in for
    the rounding the comparison is to see. Any other differing row is
    counted in `untied` and the reference's own row is kept. Without
    `given` the reference's own graphs are recorded in `used`."""

    TIE_RTOL = 1e-5

    def __init__(self, given: Optional[Sequence[torch.Tensor]] = None):
        self.given = None if given is None else list(given)
        self.used: List[torch.Tensor] = []     # the graphs taken, in order
        self.rows = self.differing = self.untied = 0

    def take(self, d: torch.Tensor, sq: torch.Tensor, own: torch.Tensor
             ) -> torch.Tensor:
        if self.given is None:                 # record the reference's own
            self.used.append(own)
            return own
        g = self.given.pop(0).to(own.device).long()
        self.rows += own.shape[0] * own.shape[1]
        if g.shape != own.shape:               # not a graph of these points
            self.differing += own.shape[0] * own.shape[1]
            self.untied += own.shape[0] * own.shape[1]
            self.used.append(own)
            return own
        same = (own.sort(-1).values == g.sort(-1).values).all(-1)
        scale = (sq[:, :, None] + sq[:, None, :]).gather(-1, g).amax(-1)
        excess = d.gather(-1, g).amax(-1) - d.gather(-1, own).amax(-1)
        tied = excess <= self.TIE_RTOL * scale
        self.differing += int((~same).sum())
        self.untied += int((~same & ~tied).sum())
        self.used.append(torch.where((~same & tied)[..., None], g, own))
        return self.used[-1]


def knn(x: torch.Tensor, k: int, graphs: Optional[Graphs] = None
        ) -> torch.Tensor:
    """(B, N, k) indices of each point's k nearest points (itself
    included) by squared euclidean distance, worked out in float64: in
    float32 the expanded |x_i|^2 - 2 x_i.x_j + |x_j|^2 of coordinates in
    metres rounds by more than the gap between neighbours and reorders
    them. With `graphs`, a given graph is taken at near-ties."""
    xd = x.double()
    sq = (xd * xd).sum(-1)
    d = sq[:, :, None] - 2.0 * (xd @ xd.transpose(1, 2)) + sq[:, None, :]
    own = d.topk(k, dim=-1, largest=False).indices
    return own if graphs is None else graphs.take(d, sq, own)


def edge_features(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[x_j - x_i, x_i] for the k neighbours j of every point i:
    (B, N, k, 2C)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    nbr = x[b, idx]
    centre = x[:, :, None, :].expand_as(nbr)
    return torch.cat([nbr - centre, centre], dim=-1)


def edgeconv(p: Params, i: int, x: torch.Tensor, widths: Sequence[int],
             k: int, train: bool, graphs: Optional[Graphs] = None
             ) -> torch.Tensor:
    h = edge_features(x, knn(x.detach(), k, graphs))
    for j in range(len(widths)):
        key = f"encoder.edge_convs.{i}.layer."
        h = leaky(batchnorm(p, f"{key}{3 * j + 1}",
                            conv(p, f"{key}{3 * j}", h), train))
    return h.amax(dim=2)


# --------------------------------------------------------------------------- #
# the attention's dropout mask (frozen copy of its definition)
# --------------------------------------------------------------------------- #

MASK32 = 0xFFFFFFFF
_MIX1, _MIX2, _GOLDEN = 0x7FEB352D, 0x846CA68B, 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX2)
    return x ^ (x >> 16)


def dropout_keep_mask(seed: torch.Tensor, batch: int, n: int,
                      rate: float) -> torch.Tensor:
    """(batch, n, n) keep mask: h = mix(mix(mix(seed + b G) + i G) + j G)
    in uint32 arithmetic, kept iff (h >> 8) >= ceil(rate 2^24)."""
    thr = math.ceil(rate * (1 << 24))
    s = seed.reshape(-1)[:1].to(torch.int64) & MASK32
    dev = s.device
    cols = _mul32(torch.arange(n, dtype=torch.int64, device=dev), _GOLDEN)
    b = torch.arange(batch, dtype=torch.int64, device=dev)
    bkey = _mix32((s + _mul32(b, _GOLDEN)) & MASK32)
    rkey = _mix32((bkey[:, None] + cols[None, :]) & MASK32)
    keep = torch.empty((batch, n, n), dtype=torch.bool, device=dev)
    for i in range(batch):          # one row of the batch at a time: the
        h = _mix32((rkey[i, :, None] + cols[None, :]) & MASK32)  # int64
        keep[i] = (h >> 8) >= thr   # hash of (N, N) is 8 N^2 bytes
    return keep


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #

def features(p: Params, cfg: dict, x: torch.Tensor, gp: torch.Tensor,
             train: bool = False, dropout_seed: Optional[torch.Tensor] = None,
             graphs: Optional[Graphs] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(point_feat (B, N, main_dim), one-hot word assignment (B, N, K))."""
    widths = cfg["edgeconv_widths"]
    edges, h = [], x
    for i, w in enumerate(widths):
        h = edgeconv(p, i, h, w, cfg["dgcnn_k"], train, graphs)
        edges.append(h)
    f = torch.cat(edges, dim=-1)
    for j in range(len(cfg["dgcnn_mlp_widths"])):
        f = leaky(batchnorm(p, f"encoder.conv.layer.{3 * j + 1}",
                            conv(p, f"encoder.conv.layer.{3 * j}", f), train))
    base = f
    n_base = len(cfg["base_widths"])
    for j in range(n_base):
        base = batchnorm(p, f"base_learner.convs.{j}.1",
                         conv(p, f"base_learner.convs.{j}.0", base), train)
        if j != n_base - 1:
            base = torch.relu(base)
    q, k, v = (conv(p, f"att_learner.{m}_map", f) for m in "qkv")
    attn = torch.softmax(einsum("bmc,bnc->bmn", q, k)
                         / math.sqrt(cfg["output_dim"]), dim=-1)
    if train and cfg["attn_dropout"] > 0:
        rate = cfg["attn_dropout"]
        keep = dropout_keep_mask(dropout_seed, x.shape[0], x.shape[1], rate)
        attn = torch.where(keep, attn / (1.0 - rate), torch.zeros_like(attn))
    att = einsum("bmn,bnc->bmc", attn, v)
    semantic = torch.cat([edges[0], att, base], dim=-1)
    cos = einsum("bnd,kd->bnk", l2norm(torch.cat(edges, dim=-1)),
                 l2norm(gp))
    cosine_feat = torch.softmax(cfg["cosine_scale"] * cos, dim=-1)
    onehot = F.one_hot(cosine_feat.argmax(-1), gp.shape[0]).to(x.dtype)
    point_feat = leaky(batchnorm(p, "fusion.1", conv(
        p, "fusion.0", torch.cat([cosine_feat, semantic], dim=-1)), train))
    return point_feat, onehot


def pred(cfg: dict, x: torch.Tensor, proto: torch.Tensor) -> torch.Tensor:
    """Cosine logits x cosine_scale; proto (cls, C) or (..., B, cls, C)."""
    xn, pn = l2norm(x), l2norm(proto)
    if proto.dim() == 2:
        return cfg["cosine_scale"] * einsum("bnc,kc->bnk", xn, pn)
    return cfg["cosine_scale"] * einsum("bnc,...bkc->...bnk", xn, pn)


def refine(cfg: dict, proto: torch.Tensor, point_feat: torch.Tensor,
           bg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transductive refinement (CAPL eqn. 6): a softmax over the points of
    each class's logits pools the features; each refined prototype is
    blended with the learned one by their cosine, clamped at 0."""
    full = proto if bg is None else torch.cat([bg, proto], dim=0)
    weights = torch.softmax(pred(cfg, point_feat, full), dim=1)
    pooled = einsum("bnk,bnc->bkc", weights, point_feat)
    if bg is not None:
        pooled = pooled[:, 1:]
    w = torch.clamp_min((l2norm(pooled) * l2norm(proto)[None]).sum(
        -1, keepdim=True), 0.0)
    return w * pooled + (1.0 - w) * proto[None]


def eval_logits(p: Params, cfg: dict, x: torch.Tensor, gp: torch.Tensor,
                gened: torch.Tensor, codings: torch.Tensor, base_num: int
                ) -> torch.Tensor:
    """Evaluation logits of S prototype sets (reference capl.py:170-192):
    gened (S, cls, C) registered prototypes, codings (S, cls, K) the
    classes' word multi-hots. Returns (S, B, N, cls)."""
    point_feat, onehot = features(p, cfg, x, gp)
    ref = refine(cfg, p["main_proto"], point_feat)            # (B, cls, C)
    s, b = gened.shape[0], x.shape[0]
    merged = torch.cat([
        ref[None, :, :base_num] + gened[:, None, :base_num],
        gened[:, None, base_num:].expand(s, b, -1, -1)], dim=2)
    logits = pred(cfg, point_feat, merged)                    # (S, B, N, cls)
    score = torch.einsum("skw,bnw->sbnk", codings, onehot)
    return logits * torch.where(score == 1.0,
                                torch.full_like(score, cfg["eval_weight"]),
                                torch.ones_like(score))


def fake_prototypes(p: Params, feats: torch.Tensor, y: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
    """CAPL eqn. 8: half of the classes present (background left out),
    the highest `noise` first, take the mean of their points' normalised
    features as prototype; the rest keep the normalised learned one."""
    proto = p["main_proto"]
    n_cls = proto.shape[0]
    onehot = (y.long()[..., None] == torch.arange(
        n_cls + 1, device=y.device)).to(feats.dtype)
    counts = onehot.sum((0, 1))
    present = counts[1:] > 0
    score = torch.where(present, noise, torch.full_like(noise, -1.0))
    rank = torch.argsort(torch.argsort(-score))
    fake = (present & (rank < present.sum() // 2)).to(feats.dtype)[:, None]
    means = einsum("bnk,bnc->kc", onehot, l2norm(feats))[1:] \
        / (counts[1:, None] + 1e-12)
    return (1.0 - fake) * l2norm(proto) + fake * means


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1).long(), ignore_index=IGNORE_INDEX)


def train_loss(p: Params, cfg: dict, x: torch.Tensor, y: torch.Tensor,
               gp: torch.Tensor, base_num: int, generator: torch.Generator,
               graphs: Optional[Graphs] = None) -> torch.Tensor:
    """The base-stage loss 0.5 CE2 + 0.5 CE1 (reference capl.py:194-242)
    in training mode. `generator` (on x's device, seeded for this step)
    draws, in this order, the attention's dropout seed (one int32 in
    [0, 2^31 - 1)) and the fake classes' noise (cls uniforms)."""
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=x.device, dtype=torch.int32)
    point_feat, _ = features(p, cfg, x, gp, train=True, dropout_seed=seed,
                             graphs=graphs)
    noise = torch.rand(p["main_proto"].shape[0], generator=generator,
                       device=x.device)
    half = x.shape[0] // 2
    ori = fake_prototypes(p, point_feat[half:], y[half:], noise)
    bg = p["bg_proto"]
    ce1 = cross_entropy(pred(cfg, point_feat, torch.cat([bg, ori])), y)
    ref = refine(cfg, p["main_proto"], point_feat, bg)        # (B, cls, C)
    post = torch.cat([ref[:, :base_num] + ori[None, :base_num],
                      ori[None, base_num:].expand(ref.shape[0], -1, -1)],
                     dim=1)
    bgs = bg[None].expand(ref.shape[0], -1, -1)
    ce2 = cross_entropy(pred(cfg, point_feat, torch.cat([bgs, post], 1)), y)
    return 0.5 * ce2 + 0.5 * ce1


class Adam:
    """torch.optim.Adam's update written out (betas 0.9, 0.999, eps 1e-8,
    no weight decay); `lrs` gives each parameter's learning rate."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 lrs: Dict[str, float], betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lrs = params, lrs
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = {n: torch.zeros_like(t) for n, t in params.items()}
        self.v = {n: torch.zeros_like(t) for n, t in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[n].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-self.lrs[n] / c1)


def train_steps(state: Params, trainable: List[str], cfg: dict,
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                gp: torch.Tensor, base_num: int, step_seeds: Sequence[int],
                graphs: Optional[Graphs] = None
                ) -> Tuple[List[float], Dict[str, torch.Tensor],
                           Dict[str, torch.Tensor]]:
    """len(batches) base-stage steps from `state` under Adam in two
    groups (`encoder.*` at encoder_lr_scale x base_lr, the rest at
    base_lr; StepLR's factor is 1 this early), the kNN graphs through
    `graphs`. Returns (each step's loss, the first step's gradients, the
    parameters after the last step)."""
    p = {n: t.detach().clone() for n, t in state.items()}
    params = {n: p[n] for n in trainable}
    lr = cfg["base_lr"]
    opt = Adam(params, {n: lr * (cfg["encoder_lr_scale"]
                                 if n.startswith("encoder.") else 1.0)
                        for n in trainable})
    gen = torch.Generator(device=gp.device)
    losses, first = [], None
    for (x, y), seed in zip(batches, step_seeds):
        for t in params.values():
            t.requires_grad_(True)
        gen.manual_seed(seed)
        loss = train_loss(p, cfg, x, y, gp, base_num, gen, graphs)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        for t in params.values():
            t.requires_grad_(False)
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(grads)
        del loss, grads
    return losses, first, {n: t.detach().clone() for n, t in params.items()}
