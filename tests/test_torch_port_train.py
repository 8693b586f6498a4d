"""PyTorch port, pre-training slice, against the JAX package on the CPU:
train-mode BatchNorm, the kNN with neighbour statistics (K3's twin), the
fused training EdgeConv (K4's Function on its twin stages), the DGCNNSeg
train step, the optimizer, pretrain() end to end and the CLI's flags.

Inputs are drawn with numpy; JAX models use use_pallas=False (the XLA
path), and JAX's Pallas op runs in interpret mode as its own tests run it.
"""
import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gfs3dseg_gws_tpu.models.dgcnnseg import DGCNNSeg as JaxDGCNNSeg
from gfs3dseg_gws_tpu.models.layers import (BatchNorm as JaxBN, ManualBN,
                                            cross_entropy as jax_ce)
from gfs3dseg_gws_tpu.ops import fused_edgeconv_train as jax_fet
from gfs3dseg_gws_tpu.ops.knn import _knn_xla
from gfs3dseg_gws_tpu.ops.knn import knn_with_stats as jax_knn_with_stats
from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
from gfs3dseg_gws_tpu_torch.models.layers import (BatchNorm, Conv1x1,
                                                  cross_entropy, train_init_)
from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv_train import (
    fused_edgeconv_train, fused_edgeconv_train_plain)
from gfs3dseg_gws_tpu_torch.ops.knn import knn_with_stats
from gfs3dseg_gws_tpu_torch.parallel.optim import make_pretrain_optimizer
from gfs3dseg_gws_tpu_torch.parallel.steps import pretrain_step
from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
    pretrain_state_dict_from_jax)
from torch_port_util import TINY, one_thread, randomize_bn, set_fp32, t

pytestmark = pytest.mark.usefixtures("one_thread")

B, N, NCLS = 2, 128, 8
SEG_WIDTHS = dict(edgeconv_widths=TINY["edgeconv_widths"],
                  mlp_widths=TINY["mlp_widths"], k=TINY["k"])


def _rel(got, ref, floor=1e-12):
    """max |got - ref| over max |ref| (at least `floor`)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), floor)


# --------------------------------------------------------------------------- #
# (a) layers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["BatchNorm", "ManualBN"])
def test_train_batchnorm_matches_jax(kind):
    """Output and running statistics after two train-mode calls on an edge
    tensor (B, N, K, C), with the unbiased running-variance EMA; 1e-5."""
    from flax import linen as nn

    r = np.random.default_rng(1)
    xs = [(1.5 * r.standard_normal((2, 16, 5, 8)) + 0.3).astype(np.float32)
          for _ in range(2)]

    class Wrap(nn.Module):
        @nn.compact
        def __call__(self, x):
            if kind == "BatchNorm":
                return JaxBN(use_running_average=False, name="bn")(x)
            return ManualBN(8, name="bn")(x, use_running_average=False)

    variables = Wrap().init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    bn = BatchNorm(8)
    with torch.no_grad():
        bn.weight.copy_(t(1.0 + 0.1 * r.standard_normal(8)))
        bn.bias.copy_(t(0.1 * r.standard_normal(8)))
    params = {"bn": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                     "bias": jnp.asarray(bn.bias.detach().numpy())}}
    stats = variables["batch_stats"]
    for x in xs:
        ref, upd = Wrap().apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), mutable=["batch_stats"])
        stats = upd["batch_stats"]
        got = bn(t(x))
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               stats["bn"]["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               stats["bn"]["var"], rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 2
    # record_batch_stats (the fused EdgeConv's side channel) moves the
    # running averages exactly as forward does
    rec = BatchNorm(8)
    for x in xs:
        xt = t(x).reshape(-1, 8)
        mu = xt.mean(0)
        rec.record_batch_stats(mu, (xt * xt).mean(0) - mu * mu, xt.shape[0])
    torch.testing.assert_close(rec.running_mean, bn.running_mean)
    torch.testing.assert_close(rec.running_var, bn.running_var)


@pytest.mark.parametrize("ignore_index", [None, 255])
def test_cross_entropy_matches_jax(ignore_index):
    r = np.random.default_rng(2)
    logits = r.standard_normal((2, 32, 5)).astype(np.float32)
    labels = r.integers(0, 5, (2, 32))
    labels[0, :7] = 255 if ignore_index is not None else labels[0, :7]
    ref = jax_ce(jnp.asarray(logits), jnp.asarray(labels), ignore_index)
    got = cross_entropy(t(logits), t(labels), ignore_index)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


def test_train_init_follows_the_jax_initialisers():
    """LeCun-normal (normal truncated at 2 sigma, variance 1/fan_in) conv
    kernels, zero biases, BN at 1/0 with statistics 0/1."""
    model = DGCNNSeg(NCLS, generator=torch.Generator().manual_seed(0))
    conv = model.segmenter[0]
    w = conv.weight.detach().reshape(conv.weight.shape[0], -1)
    fan_in = w.shape[1]
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.02
    assert w.abs().max().item() <= 2 / np.sqrt(fan_in) / 0.87962566 + 1e-6
    assert model.segmenter[3].bias.abs().max().item() == 0.0
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            assert torch.all(mod.weight == 1) and torch.all(mod.bias == 0)
            assert torch.all(mod.running_mean == 0)
            assert torch.all(mod.running_var == 1)
    again = train_init_(DGCNNSeg(NCLS),
                        torch.Generator().manual_seed(0))
    for (k1, v1), (_, v2) in zip(model.state_dict().items(),
                                 again.state_dict().items()):
        torch.testing.assert_close(v1, v2, rtol=0, atol=0, msg=k1)
    assert any(isinstance(m, Conv1x1) for m in model.modules())


# --------------------------------------------------------------------------- #
# (b) K3's twin
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("c,k", [(3, 5), (9, 20), (16, 11)])
def test_knn_with_stats_twin_matches_jax(c, k):
    """idx and cnt exact, scb within 1e-5."""
    r = np.random.default_rng(c + k)
    x = r.standard_normal((B, N, c)).astype(np.float32)
    btab = r.standard_normal((B, N, 8)).astype(np.float32)
    ref = jax_knn_with_stats(jnp.asarray(x), jnp.asarray(btab), k,
                             use_pallas=False)
    idx, cnt, scb = knn_with_stats(t(x), t(btab), k)
    assert idx.dtype == torch.int32 and cnt.shape == (B, 1, N)
    np.testing.assert_array_equal(idx.numpy(), ref[0])
    np.testing.assert_array_equal(cnt.numpy(), ref[1])
    np.testing.assert_allclose(scb.numpy(), ref[2], rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# (c) K4's Function on its twin stages
# --------------------------------------------------------------------------- #

NAMES = ("a", "b", "gamma1", "beta1", "w2", "gamma2", "beta2")


def _fet_inputs(n, c=8, w1=6, k=5, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, n, 3)).astype(np.float32)
    args = dict(
        a=r.standard_normal((B, n, c)), b=r.standard_normal((B, n, c)),
        gamma1=0.5 + r.uniform(0, 1, c), beta1=0.3 * r.standard_normal(c),
        w2=0.4 * r.standard_normal((c, w1)),
        # one negative bn2 scale at least: the min branch of the selection
        gamma2=np.concatenate([0.5 + r.uniform(0, 1, w1 - 2),
                               -0.7 - r.uniform(0, 1, 2)]),
        beta2=0.3 * r.standard_normal(w1))
    args = {key: v.astype(np.float32) for key, v in args.items()}
    cot = r.standard_normal((B, n, w1)).astype(np.float32)
    return x, args, cot


def _torch_run(fn, args, idx, cot, **kw):
    ins = [t(args[n]).requires_grad_() for n in NAMES]
    outs = fn(*ins, idx, **kw)
    grads = torch.autograd.grad((outs[0] * t(cot)).sum(), ins)
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _jax_run(fn, args, idx, cot, interpret=False, **kw):
    vals = [jnp.asarray(args[n]) for n in NAMES]

    def loss(vs):
        return jnp.sum(fn(*vs, idx, **kw)[0] * cot)

    if interpret:
        with pltpu.force_tpu_interpret_mode():
            return fn(*vals, idx, **kw), jax.grad(loss)(vals)
    return fn(*vals, idx, **kw), jax.grad(loss)(vals)


@pytest.mark.parametrize("port", ["function", "plain"])
@pytest.mark.parametrize("ref", ["xla", "pallas_f32"])
def test_fused_edgeconv_train_matches_jax(port, ref):
    """Forward, its four batch statistics and all seven gradients, each
    within 1e-4 of the reference's largest magnitude (fp32 sums in other
    orders; the statistics come from cnt/scb in both fused versions)."""
    set_fp32()
    x, args, cot = _fet_inputs(N)
    idx = _knn_xla(jnp.asarray(x), 5)
    if ref == "xla":
        r_out, r_grads = _jax_run(jax_fet.fused_edgeconv_train_xla, args,
                                  idx, cot)
    else:
        r_out, r_grads = _jax_run(jax_fet.fused_edgeconv_train, args, idx,
                                  cot, interpret=True, tile_q=64,
                                  mxu_dtype=jnp.float32)
    tidx = t(idx).to(torch.int32)
    if port == "function":
        knn = knn_with_stats(t(x), t(args["b"]), 5)
        assert torch.equal(knn[0], tidx)
        g_out, g_grads = _torch_run(fused_edgeconv_train, args, tidx, cot,
                                    cnt=knn[1], scb=knn[2])
    else:
        g_out, g_grads = _torch_run(fused_edgeconv_train_plain, args, tidx,
                                    cot)
    for name, got, want in zip(("out", "mu1", "var1", "mu2", "var2"), g_out,
                               r_out):
        assert _rel(got, want) < 1e-4, (name, _rel(got, want))
    for name, got, want in zip(NAMES, g_grads, r_grads):
        assert _rel(got, want) < 1e-4, (name, _rel(got, want))


@pytest.mark.parametrize("n,c,w1,k", [(100, 8, 6, 5), (37, 5, 9, 7)])
def test_fused_edgeconv_train_ragged_n_matches_plain(n, c, w1, k):
    """Ragged N (no tile multiple) and W0 != W1, against the port's own
    unfused composition: forward, statistics and gradients within 1e-4."""
    set_fp32()
    x, args, cot = _fet_inputs(n, c, w1, k, seed=n)
    idx, cnt, scb = knn_with_stats(t(x), t(args["b"]), k)
    f_out, f_grads = _torch_run(fused_edgeconv_train, args, idx, cot,
                                cnt=cnt, scb=scb)
    p_out, p_grads = _torch_run(fused_edgeconv_train_plain, args, idx, cot)
    for name, got, want in zip(("out", "mu1", "var1", "mu2", "var2") + NAMES,
                               f_out + f_grads, p_out + p_grads):
        assert _rel(got, want) < 1e-4, (name, _rel(got, want))


def test_fused_edgeconv_train_stats_carry_no_gradient():
    x, args, _ = _fet_inputs(64)
    idx = knn_with_stats(t(x), t(args["b"]), 5)[0]
    outs = fused_edgeconv_train(*[t(args[n]).requires_grad_()
                                  for n in NAMES], idx)
    assert outs[0].requires_grad
    assert not any(o.requires_grad for o in outs[1:])


# --------------------------------------------------------------------------- #
# (d), (e) the DGCNNSeg train step and the optimizer
# --------------------------------------------------------------------------- #

def _seg_pair(seed=0, n=N, widths=SEG_WIDTHS):
    model = JaxDGCNNSeg(num_classes=NCLS, use_pallas=False, dropout=0.0,
                        edgeconv_widths=widths["edgeconv_widths"],
                        mlp_widths=widths["mlp_widths"], k=widths["k"])
    rng = jax.random.PRNGKey(seed)
    variables = model.init({"params": rng, "dropout": rng},
                           jnp.zeros((2, n, 9)), True)
    variables = randomize_bn(variables, seed + 7)
    port = DGCNNSeg(NCLS, dropout=0.0, **widths)
    port.load_state_dict(pretrain_state_dict_from_jax(
        jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"])), strict=True)
    return model, variables, port


def _batch(seed, n=N):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, n, 9)).astype(np.float32),
            r.integers(0, NCLS, (B, n)).astype(np.int32))


@pytest.mark.parametrize("edgeconv_widths", [
    SEG_WIDTHS["edgeconv_widths"],
    # blocks one and three layers deep: the plain composition in training,
    # BatchNorm statistics over (B, N, K)
    ((8,), (8, 8, 8), (8, 8)),
], ids=["fused", "mixed_depths"])
def test_dgcnnseg_train_step_matches_jax(edgeconv_widths):
    """Train-mode logits and loss (1e-4), every gradient mapped to the
    reference keys (1e-3 of its largest magnitude, or of 1e-3 x the model's
    largest gradient where a tensor's gradient is below that: some are
    rounding noise around 0 in both) and the updated running statistics
    (1e-4)."""
    set_fp32()
    model, variables, port = _seg_pair(
        widths={**SEG_WIDTHS, "edgeconv_widths": edgeconv_widths})
    pts, lbl = _batch(5)

    def loss_fn(params):
        logits, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(pts), True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(lbl)), (logits, upd["batch_stats"])

    (ref_loss, (ref_logits, ref_stats)), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])

    port.train()
    logits = port(t(pts))
    loss = cross_entropy(logits, t(lbl))
    loss.backward()
    assert _rel(logits.detach().numpy(), ref_logits) < 1e-4
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)

    ref_sd = pretrain_state_dict_from_jax(jax.device_get(ref_grads),
                                          jax.device_get(ref_stats))
    new_sd = pretrain_state_dict_from_jax(
        jax.device_get(variables["params"]), jax.device_get(ref_stats))
    floor = 1e-3 * max(ref_sd[name].abs().max().item()
                       for name, _ in port.named_parameters())
    checked = 0
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        assert _rel(p.grad.numpy(), ref_sd[name].numpy(), floor) < 1e-3, name
        checked += 1
    assert checked == len(ref_sd) - 3 * sum(
        1 for key in ref_sd if key.endswith("running_mean"))
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), new_sd[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_pretrain_optimizer_steps_match_jax():
    """Three Adam + L2 steps with steps_per_epoch=1 and step_size=2, so the
    LR halves before the third. After each step at least 99.9% of every
    parameter's elements agree within 2e-5 (2% of the LR) and all within
    2 LR per step taken: Adam divides each gradient by its own magnitude,
    so an element whose gradient is rounding noise around 0 may move by up
    to the LR in either framework. The conv bias before the segmenter's
    second BatchNorm has a zero gradient (a train-mode BatchNorm removes
    it), so all of its elements are such noise: it is held to the bound
    only."""
    from gfs3dseg_gws_tpu.parallel import TrainState, make_pretrain_step
    from gfs3dseg_gws_tpu.parallel.optim import (
        make_pretrain_optimizer as jax_opt)

    set_fp32()
    model, variables, port = _seg_pair(seed=1)
    lr, wd = 1e-3, 1e-4
    state = TrainState.create(variables["params"], variables["batch_stats"],
                              jax_opt(lr, 1, wd, 2, 0.5))
    step = make_pretrain_step(model, None, donate=False)
    opt, sched = make_pretrain_optimizer(port.parameters(), lr, 1, wd, 2, 0.5)
    for i in range(3):
        pts, lbl = _batch(10 + i)
        state, ref_loss = step(state, jnp.asarray(pts), jnp.asarray(lbl),
                               jax.random.PRNGKey(0))
        loss = pretrain_step(port, opt, t(pts), t(lbl).long(), None, sched)
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
        ref_sd = pretrain_state_dict_from_jax(
            jax.device_get(state.params), jax.device_get(state.batch_stats))
        for name, p in port.named_parameters():
            diff = np.abs(p.detach().numpy() - ref_sd[name].numpy())
            if name != "segmenter.3.bias":
                assert np.mean(diff <= 2e-5) >= 0.999, (i, name)
            assert diff.max() <= 2 * lr * (i + 1), (i, name, diff.max())
    assert sched.get_last_lr() == [lr * 0.5]


@pytest.mark.parametrize("native", [True, False])
def test_train_batches_match_jax(tmp_path, monkeypatch, native):
    """The port's host training loader, on its own copy of the data layer,
    gives the JAX package's batches, exactly, for the same seed and epoch:
    through the native pool and through the Python iterator
    (GFS3D_NO_NATIVE=1), augmentation on."""
    from gfs3dseg_gws_tpu.data import datasets as jax_datasets
    from gfs3dseg_gws_tpu.data import registry as jax_registry
    from gfs3dseg_gws_tpu.data.synthetic import make_synthetic_blocks
    from gfs3dseg_gws_tpu.pipelines.gfs import (
        train_batches as jax_train_batches)
    from gfs3dseg_gws_tpu_torch.data import datasets, registry
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import train_batches

    monkeypatch.setenv("GFS3D_NO_NATIVE", "0" if native else "1")
    train_dir, _ = make_synthetic_blocks(str(tmp_path), n_train_blocks=20,
                                         n_test_blocks=1,
                                         points_per_block=600, seed=2)

    def dataset(reg_mod, ds_mod):
        reg = reg_mod.make_registry("s3dis", 0, train_dir)
        classes = reg.train_classes
        return ds_mod.PretrainBlockDataset(
            train_dir, classes, {c: reg.class2scans[c] for c in classes},
            mode="train", num_point=64, pc_augm=True, split_ratio=0.1)

    ds = dataset(registry, datasets)
    got = list(train_batches(ds, 4, seed=7, epoch=1))
    ref = list(jax_train_batches(dataset(jax_registry, jax_datasets), 4,
                                 seed=7, epoch=1))
    assert len(got) == len(ref) == len(ds) // 4
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_data_layer_copy_matches_jax(tmp_path):
    """The port's copy of the host data layer gives the JAX package's
    arrays for the same seed: the synthetic blocks on disk, the static
    test sweep (TestingDataset) and one support seed (ValSuppDataset), each
    materialised by its own package in its own directory."""
    from gfs3dseg_gws_tpu import data as jax_data
    from gfs3dseg_gws_tpu_torch import data as port_data

    dirs = {}
    for name, mod in (("jax", jax_data), ("port", port_data)):
        dirs[name] = mod.make_synthetic_blocks(
            str(tmp_path / name), n_train_blocks=12, n_test_blocks=4,
            points_per_block=500, seed=5)
    for split in (0, 1):
        files = sorted(os.listdir(os.path.join(dirs["jax"][split], "data")))
        assert files == sorted(os.listdir(
            os.path.join(dirs["port"][split], "data")))
        for f in files:
            np.testing.assert_array_equal(
                np.load(os.path.join(dirs["jax"][split], "data", f)),
                np.load(os.path.join(dirs["port"][split], "data", f)))

    def views(mod, train_dir, test_dir):
        reg_test = mod.registry.make_registry("s3dis", 0, test_dir)
        order = sorted(reg_test.train_classes) + sorted(reg_test.test_classes)
        names = sorted(order)
        test = mod.TestingDataset(
            test_dir, names, order,
            {c: reg_test.class2scans[c] for c in names}, num_point=64)
        supp = mod.ValSuppDataset(train_dir, "s3dis", cvfold=0, k_shot=2,
                                  num_point=64, seed=10, learning_order=order)
        return test, supp

    ref, got = views(jax_data, *dirs["jax"]), views(port_data, *dirs["port"])
    for r_ds, g_ds in zip(ref, got):
        assert len(r_ds) == len(g_ds) > 0
        for i in range(len(r_ds)):
            for a, b in zip(g_ds[i], r_ds[i]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------- #
# (f) pretrain() end to end; the JAX package reads what it writes
# --------------------------------------------------------------------------- #

def test_pretrain_end_to_end_writes_checkpoints_jax_reads(tmp_path):
    from gfs3dseg_gws_tpu.data.synthetic import make_synthetic_blocks
    from gfs3dseg_gws_tpu.models.dgcnn import DGCNN as JaxDGCNN
    from gfs3dseg_gws_tpu.utils.checkpoint import (
        load_checkpoint, load_torch_pretrain_checkpoint, restore_into)
    from gfs3dseg_gws_tpu_torch.pipelines.pretrain import pretrain
    from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                     PretrainConfig)

    set_fp32()
    train_dir, _ = make_synthetic_blocks(str(tmp_path / "data"),
                                         n_train_blocks=40, n_test_blocks=2,
                                         points_per_block=1000, seed=3)
    log_dir = str(tmp_path / "log")
    model_cfg = ModelConfig(edgeconv_widths=SEG_WIDTHS["edgeconv_widths"],
                            dgcnn_mlp_widths=SEG_WIDTHS["mlp_widths"],
                            dgcnn_k=SEG_WIDTHS["k"], pc_npts=N)
    data_cfg = DataConfig(data_path=train_dir, pc_npts=N, pc_augm=True)
    cfg = PretrainConfig(batch_size=4, n_iters=2, eval_interval=1,
                         log_dir=log_dir, device="cpu", seed=4)
    res = pretrain(model_cfg, data_cfg, cfg, max_steps_per_epoch=3)

    assert [h["steps"] for h in res["history"]] == [3, 3]
    assert all(np.isfinite(h["loss"]) and "miou" in h
               for h in res["history"])
    assert res["best_iou"] == max(h["miou"] for h in res["history"])
    for name in ("checkpoint.tar", "checkpoint.npz", "metrics.jsonl",
                 "log_pretrain.txt"):
        assert os.path.exists(os.path.join(log_dir, name)), name

    # checkpoint.tar -> the JAX eval encoder gives the port's features
    enc_p, enc_s = load_torch_pretrain_checkpoint(log_dir)
    jax_enc = JaxDGCNN(SEG_WIDTHS["edgeconv_widths"],
                       SEG_WIDTHS["mlp_widths"], k=SEG_WIDTHS["k"],
                       use_pallas=False)
    pts, _ = _batch(30)
    ref_edges, ref_out = jax_enc.apply(
        {"params": enc_p, "batch_stats": enc_s}, jnp.asarray(pts), False)
    classes = res["model"].segmenter[7].weight.shape[0]
    best = DGCNNSeg(classes, **SEG_WIDTHS)
    best.encoder.load_state_dict(
        torch.load(os.path.join(log_dir, "checkpoint.tar"))["params"],
        strict=True)
    best.eval()
    with torch.no_grad():
        edges, out = best.encoder(t(pts))
    assert _rel(out.numpy(), ref_out) < 1e-4
    for got, want in zip(edges, ref_edges):
        assert _rel(got.numpy(), want) < 1e-4

    # checkpoint.npz -> restore_into(strict=True) on the JAX DGCNNSeg tree,
    # and back: the same encoder as checkpoint.tar
    jax_model = JaxDGCNNSeg(num_classes=classes, use_pallas=False,
                            edgeconv_widths=SEG_WIDTHS["edgeconv_widths"],
                            mlp_widths=SEG_WIDTHS["mlp_widths"],
                            k=SEG_WIDTHS["k"])
    rng = jax.random.PRNGKey(0)
    target = jax_model.init({"params": rng, "dropout": rng},
                            jnp.zeros((2, N, 9)), True)
    flat, meta = load_checkpoint(os.path.join(log_dir, "checkpoint.npz"))
    assert set(meta) == {"epoch", "miou"}
    assert len(flat) == len(jax.tree_util.tree_leaves(target))
    restored = restore_into(jax.device_get(target), flat, strict=True)
    back = DGCNNSeg(classes, **SEG_WIDTHS)
    back.load_state_dict(pretrain_state_dict_from_jax(
        restored["params"], restored["batch_stats"]), strict=True)
    for name, value in best.encoder.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(back.encoder.state_dict()[name], value,
                                       rtol=0, atol=0, msg=name)

    # init_state_dict warm-starts the model (no epochs: nothing trains)
    warm = pretrain(model_cfg, data_cfg,
                    dataclasses.replace(cfg, n_iters=0,
                                        log_dir=str(tmp_path / "warm")),
                    init_state_dict=res["model"].state_dict())
    assert warm["history"] == [] and warm["best_iou"] == -1.0
    for name, value in res["model"].state_dict().items():
        torch.testing.assert_close(warm["model"].state_dict()[name], value,
                                   rtol=0, atol=0, msg=name)


# --------------------------------------------------------------------------- #
# (g) the port's CLIs take the JAX CLIs' flags
# --------------------------------------------------------------------------- #

def _flags(parser: argparse.ArgumentParser):
    """{option: (action kind, default, type, choices, dest)} of a parser."""
    return {opt: (type(a).__name__, a.default, a.type, a.choices, a.dest)
            for a in parser._actions for opt in a.option_strings}


@pytest.mark.parametrize("argv,error,match", [
    (["--phase", "finetune", "--data_path", "does_not_exist"], RuntimeError,
     "CUDA is not available"),
    (["--phase", "pretrain", "--data_path", "does_not_exist"], RuntimeError,
     "CUDA is not available"),
], ids=["baseline_phase", "cuda_without_gpu"])
def test_pretrain_cli_refuses_what_it_cannot_run(monkeypatch, tmp_path, argv,
                                                 error, match):
    """`--device cuda` without a GPU raises before any data is read or any
    directory is made, for a baseline phase as for pre-training."""
    from gfs3dseg_gws_tpu_torch.cli import pretrain_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match=match):
        pretrain_cli.main(argv + ["--device", "cuda",
                                  "--save_path", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def _parsers(parser: argparse.ArgumentParser, name: str = ""):
    """{name: parser} of a parser and, recursively, its subcommands."""
    out = {name: parser}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for sub, p in a.choices.items():
                out.update(_parsers(p, f"{name}/{sub}"))
    return out


# where each port CLI takes `--device` (its parser or subcommand)
DEVICE_AT = {"pretrain_cli": "", "train_cli": "", "basis_cli": "",
             "preprocess_cli": "/room2blocks"}


@pytest.mark.parametrize("cli", ["pretrain_cli", "train_cli", "basis_cli",
                                 "preprocess_cli"])
def test_cli_flags_match_jax(cli):
    """Every flag of the JAX CLI (and of each of its subcommands) parses in
    the port's with the same action, default, type, choices and
    destination; the port adds `--device` only (and `-h`), on the parser
    that does the device work (preprocess_cli: room2blocks), and train_cli
    `--trace_dir` (a profiler trace of its first steps or its sweep)."""
    import importlib

    ours = _parsers(importlib.import_module(
        f"gfs3dseg_gws_tpu_torch.cli.{cli}").build_parser())
    refs = _parsers(importlib.import_module(
        f"gfs3dseg_gws_tpu.cli.{cli}").build_parser())
    assert set(ours) == set(refs)
    for name, parser in refs.items():
        ref, mine = _flags(parser), _flags(ours[name])
        added = {"--device"} if name == DEVICE_AT[cli] else set()
        if cli == "train_cli":
            added.add("--trace_dir")
        assert set(mine) - set(ref) == added, name
        assert set(ref) <= set(mine)
        for opt, spec in ref.items():
            assert mine[opt] == spec, (name, opt, mine[opt], spec)
