"""The pre-training segmentor `DGCNNSeg` against the benchmark's plain
reference (portbench/reference/dgcnnseg.py, plain torch in float32 with
TF32 off, kNN distances in float64), on the CPU: the port's plain twins
at a small size on seeded random weights, with two-layer and one-layer
third EdgeConv blocks. Logits and loss, every leaf's gradient, and the
parameters after three steps of Adam with L2 weight decay, the dropout
mask at rate 0.3 drawn by both from one generator seed. Also: the
pre-training step stays eager on the CPU and records its spans. No JAX.
"""
import ast
import importlib.util
import os
import statistics

import pytest
import torch

from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
from gfs3dseg_gws_tpu_torch.models.layers import random_init_, train_init_
from gfs3dseg_gws_tpu_torch.parallel.optim import make_pretrain_optimizer
from gfs3dseg_gws_tpu_torch.parallel.steps import pretrain_step
from gfs3dseg_gws_tpu_torch.utils import observability as obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "portbench")
WIDTHS = {"two_layer": ((8, 8), (8, 8), (8, 8)),
          "one_layer": ((8, 8), (8, 8), (8,))}
CLASSES, B, N, K = 6, 3, 128, 5
RATE, LR, WD = 0.3, 1e-3, 1e-4
# the gradient of a leaf within GRAD_RTOL of the larger of its norm and
# the median leaf's (the first EdgeConv's weight gradient is
# ill-conditioned in float32: portbench/tests/test_portbench_reference.py)
GRAD_RTOL = 2e-3
# Adam's first steps move a leaf by about +-lr whatever the size of its
# gradient, so in float32 an element whose gradient is rounding (the bias
# of the segmenter's second conv, whose shift its BatchNorm removes) or a
# kNN neighbour flipped at a near-tie turns rounding into a step's sign.
# The three steps are compared in float64 on both sides: the losses
# within LOSS64_RTOL, each leaf's change within CHANGE64_RTOL of the larger
# of its change and the median leaf's. The reference without weight decay
# parts from the port by more than 1e-2 in some leaf.
LOSS64_RTOL = 1e-10
CHANGE64_RTOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    """The reference module, loaded by path with the benchmark's folder on
    sys.path (it imports `reference.gwcapl`), on one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.syspath_prepend(BENCH)
    spec = importlib.util.spec_from_file_location(
        "reference_dgcnnseg", os.path.join(BENCH, "reference", "dgcnnseg.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from reference import gwcapl
    mod.gwcapl = gwcapl
    yield mod
    mp.undo()
    torch.set_num_threads(threads)


def _cfg(widths):
    return {"edgeconv_widths": [list(w) for w in widths], "dgcnn_k": K,
            "dgcnn_mlp_widths": [16, 16], "dropout": RATE, "lr": LR,
            "weight_decay": WD}


def _model(widths, seed=3, init=random_init_):
    m = DGCNNSeg(CLASSES, edgeconv_widths=widths, mlp_widths=(16, 16), k=K,
                 dropout=RATE)
    init(m, torch.Generator().manual_seed(seed))
    return m


def _batch(seed=4):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((B, N, 9), generator=g),
            torch.randint(0, CLASSES, (B, N), generator=g))


def _fp32(ref):
    return ref.gwcapl.precision("fp32")


@pytest.mark.parametrize("config", sorted(WIDTHS))
def test_logits_and_loss_match_the_reference(ref, config):
    """Train mode (batch statistics, the shared dropout mask) and eval mode
    (random running statistics): logits within 1e-4; the train loss within
    1e-5 relative."""
    widths = WIDTHS[config]
    m = _model(widths)
    state = {n: t.clone() for n, t in m.state_dict().items()}
    x, y = _batch()
    cfg = _cfg(widths)
    m.eval()
    with torch.no_grad():
        got = m(x)
        with _fp32(ref):
            want = ref.logits(state, cfg, x, False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    m.train()
    with torch.no_grad():
        got = m(x, torch.Generator().manual_seed(9))
        with _fp32(ref):
            keep = ref.dropout_keep(torch.Generator().manual_seed(9),
                                    (B, N, 128), RATE, x.device)
            want = ref.logits(state, cfg, x, True, keep)
            want_loss = ref.loss(state, cfg, x, y, keep)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    got_loss = torch.nn.functional.cross_entropy(
        got.reshape(-1, CLASSES), y.reshape(-1))
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)


@pytest.mark.parametrize("config", sorted(WIDTHS))
def test_every_gradient_matches_the_reference(ref, config):
    """Every leaf's gradient of the train loss (dropout at 0.3, one mask)."""
    widths = WIDTHS[config]
    m = _model(widths)
    state = {n: t.clone() for n, t in m.state_dict().items()}
    x, y = _batch()
    m.train()
    logits = m(x, torch.Generator().manual_seed(9))
    torch.nn.functional.cross_entropy(logits.reshape(-1, CLASSES),
                                      y.reshape(-1)).backward()
    names = [n for n, _ in m.named_parameters()]
    p = dict(state)
    for n in names:
        p[n] = p[n].clone().requires_grad_(True)
    with _fp32(ref):
        keep = ref.dropout_keep(torch.Generator().manual_seed(9),
                                (B, N, 128), RATE, x.device)
        value = ref.loss(p, _cfg(widths), x, y, keep)
    grads = dict(zip(names, torch.autograd.grad(value, [p[n] for n in names])))
    params = dict(m.named_parameters())
    median = statistics.median(float(g.norm()) for g in grads.values())
    for n, g in grads.items():
        scale = max(float(g.norm()), median)
        assert float((params[n].grad - g).norm()) <= GRAD_RTOL * scale, n


@pytest.mark.parametrize("config", sorted(WIDTHS))
def test_three_weight_decayed_adam_steps_match_the_reference(ref, config):
    """Three `pretrain_step`s (Adam at lr 1e-3 with L2 weight decay 1e-4,
    StepLR, dropout 0.3 from one generator seeded once) against the
    reference's three steps from the same weights, batches and seed, in
    float64 (LOSS64_RTOL's comment): the losses and every leaf's change;
    the reference without weight decay misses the change's bound by far,
    so the comparison sees the decay."""
    widths = WIDTHS[config]
    m = _model(widths, init=train_init_).double()
    initial = {n: t.clone() for n, t in m.state_dict().items()}
    batches = [(x.double(), y) for x, y in (_batch(s) for s in (4, 5, 6))]
    opt, sched = make_pretrain_optimizer(m.parameters(), LR, 10, WD)
    gen = torch.Generator().manual_seed(11)
    losses = [float(pretrain_step(m, opt, x, y, gen, sched))
              for x, y in batches]
    names = [n for n, _ in m.named_parameters()]
    after = dict(m.named_parameters())

    def compare(cfg):
        ref_losses, _, ref_afters = ref.train_steps(initial, names, cfg,
                                                    batches, 11)
        ref_after = ref_afters[-1]
        change = {n: float((ref_after[n] - initial[n]).norm())
                  for n in names}
        median = statistics.median(change.values())
        gaps = {n: float((after[n].detach() - ref_after[n]).norm())
                / max(c, median) for n, c in change.items()}
        return ref_losses, max(gaps.values())

    ref_losses, gap = compare(_cfg(widths))
    assert losses == pytest.approx(ref_losses, rel=LOSS64_RTOL)
    assert gap <= CHANGE64_RTOL, gap
    _, undecayed = compare(dict(_cfg(widths), weight_decay=0.0))
    assert undecayed > 1e-2, undecayed


def test_pretrain_step_on_the_cpu_stays_eager_and_records_its_spans():
    """On CPU tensors the step runs eagerly (no graph counted) and opens
    `pretrain_step` > `forward` (> `seg_head`), `backward`, `optimizer`;
    the optimizer's LR stays a float."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.reset()
    try:
        m = _model(WIDTHS["one_layer"], init=train_init_)
        opt, sched = make_pretrain_optimizer(m.parameters(), LR, 10, WD)
        assert isinstance(opt.param_groups[0]["lr"], float)
        assert not opt.param_groups[0]["capturable"]
        gen = torch.Generator().manual_seed(1)
        x, y = _batch()
        for _ in range(5):
            loss = pretrain_step(m, opt, x, y, gen, sched)
        assert loss.dim() == 0
        snap = obs.snapshot()["plain"]
        spans = {p: e["calls"] for p, e in snap["spans"].items()}
        assert spans == {"pretrain_step": 5, "pretrain_step/forward": 5,
                         "pretrain_step/forward/seg_head": 5,
                         "pretrain_step/backward": 5,
                         "pretrain_step/optimizer": 5}
        assert not snap["counters"]
    finally:
        obs.reset()
        torch.set_num_threads(threads)


def test_the_reference_imports_nothing_of_the_port_or_jax():
    path = os.path.join(BENCH, "reference", "dgcnnseg.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] in ("__future__", "typing", "torch",
                                          "reference"), name
