"""PyTorch port, GFS base-stage training slice, against the JAX package on
the CPU: the training attention (K5's twins and autograd Function), the
GW/CAPL training pass, the fake-novel prototypes, the base learner in
training, the GFS optimizer, the attention segmentor, and `train_gfs` end
to end with its checkpoints, resume and CLI.

Inputs are drawn with numpy; JAX models use use_pallas=False (the XLA
path), and JAX's Pallas attention op runs in interpret mode as its own
tests run it. Tolerances are max |got - ref| / max |ref| unless stated.
"""
import copy
import glob
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gfs3dseg_gws_tpu.ops.attention_train import (
    attention_train as jax_attention_train)
from gfs3dseg_gws_tpu_torch.ops.attention_train import (
    attention_train, attention_train_plain, dropout_keep_mask)
from torch_port_util import TINY, jax_capl, one_thread, set_fp32, t, torch_capl

pytestmark = pytest.mark.usefixtures("one_thread")

B, N, D = 2, 128, 8
TEMP = float(D) ** 0.5
NUM_GW = 10


def _rel(got, ref, floor=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), floor)


def _qkv(seed, shape=(B, N, D), dtype=np.float32):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(dtype) for _ in range(4)]


def _port_run(fn, q, k, v, cot, seed, rate, temp=TEMP):
    ins = [t(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ins, seed, temp, rate)
    grads = torch.autograd.grad((out * t(cot)).sum(), ins)
    return out.detach().numpy(), [g.numpy() for g in grads]


# --------------------------------------------------------------------------- #
# (a) K5: the twins and the Function
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("port", ["function", "plain"])
def test_attention_train_matches_jax_at_rate0(port):
    """Forward within 1e-5 and dq/dk/dv within 2e-4 of the JAX op in
    interpret mode (the tolerances of tests/test_attention_train.py)."""
    set_fp32()
    q, k, v, cot = _qkv(0)
    seed = jnp.asarray([7], jnp.int32)

    def loss(q_, k_, v_):
        return jnp.sum(jax_attention_train(q_, k_, v_, seed,
                                           temperature=TEMP, rate=0.0,
                                           tile_q=64) * cot)

    with pltpu.force_tpu_interpret_mode():
        ref = jax_attention_train(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), seed, temperature=TEMP,
                                  rate=0.0, tile_q=64)
        ref_grads = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    fn = attention_train if port == "function" else attention_train_plain
    out, grads = _port_run(fn, q, k, v, cot, 7, 0.0)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)
    for name, g, r in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(g, np.asarray(r), rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_attention_train_dropout_twin(rate):
    """At rate > 0: the same seed gives the same output, another seed
    another; the keep share is within 5 sigma of 1 - rate; the Function
    (its twin stages, the mask regenerated in the backward) equals the
    plain twin under autograd within 1e-5 (forward) and 1e-4 (gradients);
    and the output stays unbiased (mean within 0.05 of the rate-0 one)."""
    q, k, v, cot = _qkv(3)
    outs = {s: _port_run(attention_train, q, k, v, cot, s, rate)
            for s in (11, 12)}
    again = _port_run(attention_train, q, k, v, cot, 11, rate)
    np.testing.assert_array_equal(again[0], outs[11][0])
    assert not np.allclose(outs[11][0], outs[12][0])

    keep = dropout_keep_mask(11, B, N, rate)
    share = keep.double().mean().item()
    sigma = np.sqrt(rate * (1 - rate) / keep.numel())
    assert abs(share - (1 - rate)) <= 5 * sigma, share

    plain = _port_run(attention_train_plain, q, k, v, cot, 11, rate)
    assert _rel(outs[11][0], plain[0]) < 1e-5
    for g, r in zip(outs[11][1], plain[1]):
        assert _rel(g, r) < 1e-4
    base = _port_run(attention_train_plain, q, k, v, cot, 11, 0.0)[0]
    assert abs((outs[11][0] - base).mean()) < 0.05


def test_attention_train_gradcheck_regenerates_the_mask():
    """torch.autograd.gradcheck of the Function in float64 at rate 0.1: the
    forward's mask is a function of the seed, so the backward has to
    regenerate the very same one."""
    q, k, v, _ = _qkv(5, (1, 12, 4), np.float64)
    ins = [t(a).requires_grad_() for a in (q, k, v)]
    assert not dropout_keep_mask(3, 1, 12, 0.1).all()
    assert torch.autograd.gradcheck(
        lambda a, b, c: attention_train(a, b, c, 3, 2.0, 0.1), ins)


def test_attention_train_refuses_bad_rates():
    q = torch.zeros((1, 4, 4))
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match="rate"):
            attention_train(q, q, q, 0, 2.0, rate)


# --------------------------------------------------------------------------- #
# (b) the GW/CAPL training pass
# --------------------------------------------------------------------------- #

NB, NPTS = 4, 64


def _train_batch(seed, n_base=7):
    r = np.random.default_rng(seed)
    x = r.standard_normal((NB, NPTS, 9)).astype(np.float32)
    y = r.integers(0, n_base + 1, (NB, NPTS)).astype(np.int32)
    y[0, :5] = 255                               # ignored by both losses
    gp = r.standard_normal((NUM_GW, 24)).astype(np.float32)
    fake = np.zeros(13, np.float32)
    fake[[1, 4, 6]] = 1.0
    return x, y, gp, fake


def _check_grads(port, ref_sd, tol):
    """Every parameter's gradient within `tol` of the reference's: max
    |diff| over the larger of max |ref| and 1e-3 of the model's largest
    gradient. A gradient that is zero in exact arithmetic (a conv bias
    before a train-mode BatchNorm removes its shift) is rounding noise in
    both frameworks: where the reference's is below 1e-5 of the model's
    largest, both must stay below that bound instead."""
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert all(g is not None for g in grads.values())
    top = max(ref_sd[n].abs().max().item() for n in grads)
    for name, g in grads.items():
        ref = ref_sd[name].numpy()
        if np.abs(ref).max() < 1e-5 * top:
            assert np.abs(g.numpy()).max() < 1e-5 * top, name
            continue
        assert _rel(g.numpy(), ref, 1e-3 * top) < tol, name


def test_gwcapl_train_pass_matches_jax():
    """GWCAPL.forward in training against JAX model.apply(..., train=True,
    fake_row=..., mutable=["batch_stats"]) with attn_dropout=0: loss within
    1e-5 relative, pred equal, every gradient within 1e-4 (see
    _check_grads), the new running statistics within 1e-5."""
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import state_dict_from_jax

    set_fp32()
    model, variables = jax_capl(num_gw=NUM_GW, npts=NPTS, seed=4,
                                attn_dropout=0.0)
    port = torch_capl(variables, num_gw=NUM_GW, attn_dropout=0.0)
    x, y, gp, fake = _train_batch(6)

    def loss_fn(params):
        (pred, loss), upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(gp), True,
            fake_row=jnp.asarray(fake), mutable=["batch_stats"])
        return loss, (pred, upd["batch_stats"])

    (ref_loss, (ref_pred, ref_stats)), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])

    port.train()
    pred, loss = port(t(x), t(y), t(gp), fake_row=t(fake))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(ref_pred))

    _check_grads(port, state_dict_from_jax(jax.device_get(ref_grads),
                                           jax.device_get(ref_stats)), 1e-4)
    new_sd = state_dict_from_jax(jax.device_get(variables["params"]),
                                 jax.device_get(ref_stats))
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), new_sd[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_generate_fake_proto_matches_jax_and_draws_present_classes():
    """With fake_row fixed: equal to JAX within 1e-6. The port's own draw
    picks n_present // 2 rows, all of them among the classes present in
    the labels (background excluded), and different draws for different
    generator states."""
    model, variables = jax_capl(num_gw=NUM_GW, npts=NPTS, seed=5)
    port = torch_capl(variables, num_gw=NUM_GW)
    r = np.random.default_rng(8)
    feats = r.standard_normal((2, NPTS, 16)).astype(np.float32)
    y = r.choice([0, 2, 3, 5, 7], (2, NPTS)).astype(np.int32)
    proto = r.standard_normal((13, 16)).astype(np.float32)
    fake = np.zeros(13, np.float32)
    fake[[2, 5]] = 1.0
    ref, ref_fake = model.apply(variables, jnp.asarray(feats), jnp.asarray(y),
                                jnp.asarray(proto), fake_row=jnp.asarray(fake),
                                method=model.generate_fake_proto)
    got, got_fake = port.generate_fake_proto(t(feats), t(y), t(proto),
                                             fake_row=t(fake))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got_fake.numpy(), np.asarray(ref_fake))

    present = {1, 2, 4, 6}                       # rows of labels 2, 3, 5, 7
    draws = set()
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        rows = port.generate_fake_proto(t(feats), t(y), t(proto),
                                        generator=gen)[1]
        picked = set(np.flatnonzero(rows.numpy()).tolist())
        assert len(picked) == len(present) // 2 and picked <= present
        draws.add(frozenset(picked))
    assert len(draws) > 1


def test_base_learner_train_matches_jax():
    """BaseLearner in training (batch statistics) against JAX: output and
    the new running statistics within 1e-5."""
    from gfs3dseg_gws_tpu.models.dgcnn import BaseLearner as JaxBaseLearner
    from gfs3dseg_gws_tpu_torch.models.dgcnn import BaseLearner
    from torch_port_util import randomize_bn

    jax_bl = JaxBaseLearner((8, 8))
    x = np.random.default_rng(9).standard_normal((2, 32, 16)).astype(
        np.float32)
    variables = randomize_bn(jax_bl.init(jax.random.PRNGKey(1),
                                         jnp.asarray(x), True), 2)
    ref, upd = jax_bl.apply(variables, jnp.asarray(x), True,
                            mutable=["batch_stats"])
    port = BaseLearner(16, (8, 8))
    p, s = jax.device_get(variables["params"]), jax.device_get(
        variables["batch_stats"])
    with torch.no_grad():
        for i, seq in enumerate(port.convs):
            seq[0].weight.copy_(t(np.asarray(p[f"conv{i}"]["kernel"]).T[
                ..., None]))
            seq[0].bias.copy_(t(p[f"conv{i}"]["bias"]))
            seq[1].weight.copy_(t(p[f"bn{i}"]["scale"]))
            seq[1].bias.copy_(t(p[f"bn{i}"]["bias"]))
            seq[1].running_mean.copy_(t(s[f"bn{i}"]["mean"]))
            seq[1].running_var.copy_(t(s[f"bn{i}"]["var"]))
    port.train()
    got = port(t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    new = jax.device_get(upd["batch_stats"])
    for i, seq in enumerate(port.convs):
        np.testing.assert_allclose(seq[1].running_mean.numpy(),
                                   new[f"bn{i}"]["mean"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(seq[1].running_var.numpy(),
                                   new[f"bn{i}"]["var"], rtol=1e-5,
                                   atol=1e-6)


# --------------------------------------------------------------------------- #
# (c) the optimizer
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_gfs_optimizer_steps_match_jax(weight_decay):
    """Three Adam steps on the same gradients against optax.multi_transform
    (encoder at 0.1x), steps_per_epoch=1 and step_size=2 so that StepLR
    halves the LR before the third step: every parameter within 1e-6."""
    import optax

    from gfs3dseg_gws_tpu.parallel.optim import (
        make_gfs_optimizer as jax_make_gfs_optimizer)
    from gfs3dseg_gws_tpu_torch.parallel.optim import make_gfs_optimizer
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import state_dict_from_jax

    _, variables = jax_capl(num_gw=NUM_GW, npts=NPTS, seed=6)
    port = torch_capl(variables, num_gw=NUM_GW)
    lr = 0.01
    tx = jax_make_gfs_optimizer(lr, 1, step_size=2, gamma=0.5,
                                weight_decay=weight_decay)
    params = variables["params"]
    state = tx.init(params)
    opt, sched = make_gfs_optimizer(port, lr, 1, step_size=2, gamma=0.5,
                                    weight_decay=weight_decay)
    assert [g["lr"] for g in opt.param_groups] == [lr * 0.1, lr]
    r = np.random.default_rng(10)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(r.standard_normal(a.shape).astype(
                np.float32)), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        g_sd = state_dict_from_jax(jax.device_get(grads),
                                   jax.device_get(variables["batch_stats"]))
        for name, p in port.named_parameters():
            p.grad = g_sd[name].clone()
        opt.step()
        sched.step()
    ref = state_dict_from_jax(jax.device_get(params),
                              jax.device_get(variables["batch_stats"]))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert sched.get_last_lr() == [lr * 0.1 * 0.5, lr * 0.5]


def _tiny_capl(seed=0):
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL

    return GWCAPL(classes=13, base_num=7, num_gw=NUM_GW, **TINY).train_init(
        torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_gfs_optimizer_lr_in_tensors_matches_the_float_lr(weight_decay):
    """make_gfs_optimizer with each group's LR held in a tensor that the
    scheduler writes (hold_lr_in_tensors, as on the card, where a CUDA
    graph of the step reads it; float64 on the CPU, the float LR's own
    precision), over three steps with StepLR halving the LR before the
    third: the parameters of the float-LR Adam bit for bit, and the
    groups keep their tensors, which hold the halved LR."""
    from gfs3dseg_gws_tpu_torch.parallel.optim import (hold_lr_in_tensors,
                                                       make_gfs_optimizer)

    lr = 0.01
    runs = []
    for held in (False, True):
        port = _tiny_capl()
        opt, sched = make_gfs_optimizer(port, lr, 1, step_size=2, gamma=0.5,
                                        weight_decay=weight_decay)
        if held:
            hold_lr_in_tensors(opt, torch.device("cpu"))
        tensors = [g["lr"] for g in opt.param_groups]
        r = np.random.default_rng(10)
        for _ in range(3):
            for p in port.parameters():
                p.grad = t(r.standard_normal(p.shape).astype(np.float32))
            opt.step()
            sched.step()
        assert [g["lr"] for g in opt.param_groups] == [lr * 0.1 * 0.5,
                                                       lr * 0.5]
        if held:
            assert all(g["lr"] is lr_t for g, lr_t in zip(opt.param_groups,
                                                          tensors))
        runs.append(dict(port.named_parameters()))
    for name, p in runs[0].items():
        assert torch.equal(p, runs[1][name]), name


def test_train_state_keeps_the_optimizers_lr_tensors(tmp_path):
    """A train state saved with float LRs, restored into an optimizer that
    holds its LRs in tensors (a resume on the card of a run saved on the
    CPU): the tensors stay the groups' own and take the saved LRs, and
    Adam stays as the optimizer was built (`capturable`)."""
    from gfs3dseg_gws_tpu_torch.parallel.optim import (hold_lr_in_tensors,
                                                       make_gfs_optimizer)
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import (load_train_state,
                                                         save_train_state)

    port = _tiny_capl()
    opt, sched = make_gfs_optimizer(port, 0.01, 1, step_size=1, gamma=0.5)
    for p in port.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    sched.step()
    path = str(tmp_path / "ckpt.npz")
    save_train_state(path, opt, sched, 1)
    new_opt, new_sched = make_gfs_optimizer(_tiny_capl(), 0.01, 1,
                                            step_size=1, gamma=0.5)
    hold_lr_in_tensors(new_opt, torch.device("cpu"))
    tensors = [g["lr"] for g in new_opt.param_groups]
    assert load_train_state(path, new_opt, new_sched) == 1
    assert [g["lr"] for g in new_opt.param_groups] == [0.001 * 0.5,
                                                       0.01 * 0.5]
    assert all(g["lr"] is lr_t and not g["capturable"]
               for g, lr_t in zip(new_opt.param_groups, tensors))


def _graph_book(calls, counters, steps):
    """Every call an eager step: `steps` calls of train_step and of its
    forward, backward and optimizer spans, and no graph captured or
    replayed."""
    for path in ("train_step", "train_step/forward", "train_step/backward",
                 "train_step/optimizer"):
        assert calls.get(path) == steps, (path, calls.get(path))
    assert not {p: n for p, n in counters.items() if "graph" in p and n}


def test_gfs_train_step_stays_eager_on_the_cpu():
    """Six calls at one key on CPU tensors: six eager steps."""
    from gfs3dseg_gws_tpu_torch.parallel.optim import make_gfs_optimizer
    from gfs3dseg_gws_tpu_torch.parallel.steps import gfs_train_step
    from gfs3dseg_gws_tpu_torch.utils.observability import snapshot

    port = _tiny_capl()
    opt, sched = make_gfs_optimizer(port, 0.01, 10)
    x, y, gp, _ = _train_batch(7)
    gen = torch.Generator()
    before = snapshot()["plain"]
    for step in range(6):
        gen.manual_seed(step)
        gfs_train_step(port, opt, t(x), t(y), t(gp), gen, sched)
    after = snapshot()["plain"]
    calls = {p: e["calls"] - before["spans"].get(p, {"calls": 0})["calls"]
             for p, e in after["spans"].items()}
    _graph_book(calls, after["counters"], 6)


def test_gfs_train_step_stays_eager_under_a_mesh():
    """Six calls at one key on each of two gloo ranks (a model with a
    mesh): six eager steps on each rank."""
    import torch_port_dp_ranks as ranks
    from gfs3dseg_gws_tpu_torch.parallel.dryrun import run_ranks

    x, y, gp, _ = _train_batch(8)
    state = _tiny_capl().state_dict()
    kwargs = dict(classes=13, base_num=7, num_gw=NUM_GW, **TINY)
    for book in run_ranks(ranks.train_steps_book, 2, "cpu", threads=1,
                          args=(kwargs, state, t(x), t(y), t(gp), 6)):
        _graph_book(book["calls"], book["counters"], 6)


# --------------------------------------------------------------------------- #
# (d) the attention segmentor
# --------------------------------------------------------------------------- #

def test_dgcnnsegatt_train_step_matches_jax(monkeypatch):
    """DGCNNSegAtt's train step (attention and segmenter dropout at 0)
    against the JAX package's: logits and loss within 1e-4, every
    gradient within 1e-3 (see _check_grads), running statistics within
    1e-4; the weights come through segatt_state_dict_from_jax."""
    import functools

    from gfs3dseg_gws_tpu.models import dgcnnseg as jax_dgcnnseg
    from gfs3dseg_gws_tpu.models.layers import cross_entropy as jax_ce
    from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSegAtt
    from gfs3dseg_gws_tpu_torch.models.layers import cross_entropy
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
        segatt_state_dict_from_jax)
    from torch_port_util import randomize_bn

    set_fp32()
    # the JAX segmentor has no dropout knobs: build its parts at rate 0
    monkeypatch.setattr(jax_dgcnnseg, "SelfAttention", functools.partial(
        jax_dgcnnseg.SelfAttention, attn_dropout=0.0))
    monkeypatch.setattr(jax_dgcnnseg, "Segmenter", functools.partial(
        jax_dgcnnseg.Segmenter, dropout=0.0))
    widths = dict(edgeconv_widths=TINY["edgeconv_widths"],
                  mlp_widths=TINY["mlp_widths"],
                  base_widths=TINY["base_widths"],
                  output_dim=TINY["output_dim"], k=TINY["k"])
    model = jax_dgcnnseg.DGCNNSegAtt(num_classes=5, use_pallas=False,
                                     **widths)
    r = np.random.default_rng(12)
    pts = r.standard_normal((2, NPTS, 9)).astype(np.float32)
    lbl = r.integers(0, 5, (2, NPTS)).astype(np.int32)
    rng = jax.random.PRNGKey(0)
    variables = randomize_bn(model.init({"params": rng, "dropout": rng},
                                        jnp.asarray(pts), True), 13)

    def loss_fn(params):
        logits, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(pts), True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(lbl)), (logits, upd["batch_stats"])

    (ref_loss, (ref_logits, ref_stats)), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])

    port = DGCNNSegAtt(5, dropout=0.0, attn_dropout=0.0, **widths)
    port.load_state_dict(segatt_state_dict_from_jax(
        jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"])), strict=True)
    port.train()
    logits = port(t(pts))
    loss = cross_entropy(logits, t(lbl))
    loss.backward()
    assert _rel(logits.detach().numpy(), ref_logits) < 1e-4
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    _check_grads(port, segatt_state_dict_from_jax(
        jax.device_get(ref_grads), jax.device_get(ref_stats)), 1e-3)
    new_sd = segatt_state_dict_from_jax(jax.device_get(variables["params"]),
                                        jax.device_get(ref_stats))
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), new_sd[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


# --------------------------------------------------------------------------- #
# (e) train_gfs end to end, its checkpoints, resume and the CLI
# --------------------------------------------------------------------------- #

GFS_NPTS = 96
WIDTHS = dict(edgeconv_widths=TINY["edgeconv_widths"],
              dgcnn_mlp_widths=TINY["mlp_widths"],
              base_widths=TINY["base_widths"], output_dim=TINY["output_dim"],
              main_dim=TINY["main_dim"], dgcnn_k=TINY["k"], pc_npts=GFS_NPTS)


@pytest.fixture(scope="module")
def gfs_data(tmp_path_factory):
    """Synthetic blocks, a basis and a pre-trained encoder (checkpoint.tar
    and checkpoint.npz of a port DGCNNSeg at the tiny widths)."""
    from gfs3dseg_gws_tpu_torch.data import make_synthetic_blocks
    from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
        save_pretrain_npz, save_torch_pretrain_checkpoint)

    root = str(tmp_path_factory.mktemp("gfs_train"))
    train_dir, test_dir = make_synthetic_blocks(
        root, n_train_blocks=24, n_test_blocks=13, points_per_block=500,
        seed=31)
    basis = np.random.default_rng(32).standard_normal((NUM_GW, 24)).astype(
        np.float32)
    basis_path = os.path.join(root, "basis.pkl")
    with open(basis_path, "wb") as f:
        pickle.dump(basis, f)
    seg = DGCNNSeg(8, edgeconv_widths=WIDTHS["edgeconv_widths"],
                   mlp_widths=WIDTHS["dgcnn_mlp_widths"], k=WIDTHS["dgcnn_k"],
                   generator=torch.Generator().manual_seed(33))
    pre_dir = os.path.join(root, "pretrain")
    save_torch_pretrain_checkpoint(seg.state_dict(), pre_dir)
    save_pretrain_npz(seg, os.path.join(pre_dir, "checkpoint.npz"))
    return dict(root=root, train_dir=train_dir, test_dir=test_dir,
                basis_path=basis_path, pre_dir=pre_dir, encoder=seg.encoder)


def _cfgs(gfs_data, save, **train):
    from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                     TrainConfig)

    data = DataConfig(dataset="s3dis", cvfold=0,
                      data_path=gfs_data["train_dir"],
                      testing_data_path=gfs_data["test_dir"],
                      pc_npts=GFS_NPTS, k_shot=2, pc_augm=True)
    cfg = dict(basis_path=gfs_data["basis_path"], batch_size=4, epochs=2,
               eval_interval=1, coding_interval=5, device="cpu", seed=5,
               save_path=os.path.join(gfs_data["root"], save),
               use_pretrain_weight=True,
               pretrain_checkpoint_path=os.path.join(gfs_data["pre_dir"],
                                                     "checkpoint.tar"))
    cfg.update(train)
    return ModelConfig(**WIDTHS), data, TrainConfig(**cfg)


@pytest.fixture(scope="module")
def two_epochs(gfs_data):
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import train_gfs

    set_fp32()
    return train_gfs(*_cfgs(gfs_data, "run2"), max_steps_per_epoch=2)


def test_train_gfs_trains_and_writes_checkpoints(gfs_data, two_epochs):
    """Two short epochs: finite losses and accuracies, validation after
    each, the pre-trained encoder loaded, the checkpoint and both coding
    files written under the JAX package's names."""
    hist = two_epochs["history"]
    assert [h["steps"] for h in hist] == [2, 2] and two_epochs["step"] == 4
    for h in hist:
        assert np.isfinite(h["loss"]) and 0.0 <= h["accuracy"] <= 1.0
        assert np.isfinite(h["mean_iou"]) and np.isfinite(h["hm_iou"])
    save = os.path.join(gfs_data["root"], "run2")
    assert glob.glob(os.path.join(save, "train_epoch_0_*.npz"))
    assert glob.glob(os.path.join(save, "train_epoch_0_*.train_state.pt"))
    assert os.path.exists(os.path.join(
        save, "base_class_gp_coding_energy=0.9.npz"))
    assert os.path.exists(os.path.join(
        save, "hm_base_class_gp_coding_energy=0.9.npz"))
    for name in ("log_train.txt", "metrics.jsonl"):
        assert os.path.exists(os.path.join(save, name))


@pytest.mark.parametrize("ckpt", ["checkpoint.tar", "checkpoint.npz"])
def test_train_gfs_loads_the_pretrained_encoder(gfs_data, ckpt):
    """--use_pretrain_weight from either pre-training file: with no epoch
    to run, the model's encoder is the pre-trained one."""
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import train_gfs

    res = train_gfs(*_cfgs(gfs_data, "pre_" + ckpt, epochs=0,
                           pretrain_checkpoint_path=os.path.join(
                               gfs_data["pre_dir"], ckpt)))
    ref = gfs_data["encoder"].state_dict()
    for name, value in res["model"].encoder.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(value, ref[name], rtol=0, atol=0,
                                       msg=name)


def test_train_gfs_checkpoint_is_read_by_jax(gfs_data, two_epochs):
    """The newest npz restores (strict) into the JAX GWCAPL, and JAX
    `evaluate` gives the logits of the port's trained model within 1e-4
    (of the largest logit)."""
    from gfs3dseg_gws_tpu.utils.checkpoint import (load_checkpoint,
                                                   restore_into)

    set_fp32()
    path = sorted(glob.glob(os.path.join(gfs_data["root"], "run2",
                                         "train_*.npz")),
                  key=os.path.getmtime)[-1]
    model, variables = jax_capl(num_gw=NUM_GW, npts=GFS_NPTS, seed=0,
                                eval_weight=1.0)
    flat, meta = load_checkpoint(path)
    assert set(meta) == {"epoch", "max_iou"}
    restored = restore_into(
        {"params": jax.device_get(variables["params"]),
         "batch_stats": jax.device_get(variables["batch_stats"])}, flat,
        strict=True)
    port = copy.deepcopy(two_epochs["model"])
    if meta["epoch"] != 1:              # the newest file is not the last
        from gfs3dseg_gws_tpu_torch.pipelines.gfs import load_model_weights
        load_model_weights(port, path)
    port.eval()
    r = np.random.default_rng(40)
    x = r.standard_normal((2, GFS_NPTS, 9)).astype(np.float32)
    gp = np.asarray(pickle.load(open(gfs_data["basis_path"], "rb")))
    gened = r.standard_normal((13, 16)).astype(np.float32)
    bc = (r.random((7, NUM_GW)) < 0.3).astype(np.float32)
    nc = (r.random((6, NUM_GW)) < 0.3).astype(np.float32)
    ref = model.apply(restored, *map(jnp.asarray, (x, gp, gened, bc, nc)),
                      method=model.evaluate)[0]
    with torch.no_grad():
        got = port.evaluate(*map(t, (x, gp, gened, bc, nc)))[0]
    assert _rel(got.numpy(), ref) < 1e-4


def test_train_gfs_resume_equals_one_run(gfs_data, two_epochs):
    """One epoch, then a resume of one more from its checkpoint (weights,
    Adam moments, schedule, step), ends where two epochs in one run end."""
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import train_gfs

    set_fp32()
    train_gfs(*_cfgs(gfs_data, "run1", epochs=1), max_steps_per_epoch=2)
    ckpt = glob.glob(os.path.join(gfs_data["root"], "run1",
                                  "train_epoch_0_*[0-9].npz"))
    assert len(ckpt) == 1
    res = train_gfs(*_cfgs(gfs_data, "run1", start_epoch=1,
                           model_checkpoint_path=ckpt[0]),
                    max_steps_per_epoch=2)
    assert res["step"] == two_epochs["step"] == 4
    ref = two_epochs["model"].state_dict()
    for name, value in res["model"].state_dict().items():
        if not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(value, ref[name], rtol=1e-6,
                                       atol=1e-6, msg=name)


def test_train_cli_trains_without_only_evaluate(gfs_data):
    from gfs3dseg_gws_tpu_torch.cli import train_cli

    res = train_cli.main(
        ["--dataset", "s3dis", "--cvfold", "0",
         "--data_path", gfs_data["train_dir"],
         "--testing_data_path", gfs_data["test_dir"],
         "--basis_path", gfs_data["basis_path"],
         "--save_path", os.path.join(gfs_data["root"], "cli"),
         "--pc_npts", str(GFS_NPTS), "--k_shot", "2", "--batch_size", "4",
         "--epochs", "1", "--dgcnn_k", str(TINY["k"]),
         "--edgeconv_widths", "[[8,8],[8,8],[8,8]]",
         "--dgcnn_mlp_widths", "[16,16]", "--base_widths", "[8,8]",
         "--output_dim", "8", "--device", "cpu"],
        eval_interval=1, max_steps_per_epoch=1)
    assert res["step"] == 1 and np.isfinite(res["history"][0]["loss"])
    assert "mean_iou" in res["history"][0]
