"""PyTorch port, fifth slice, against the JAX package on the CPU: K8's twin
(the fold-merge kNN) against the JAX package's real Pallas body in interpret
mode and against K6's twin; every twin whose kernel gained widths (K1, K3,
K4, K6, K9 at C = W = 72 and k = 40; K2 and K5 at rate 0 at D = 30 and 72)
against the JAX XLA path; and a model of four one-layer EdgeConv blocks
(the DGCNN classification encoder's depth at narrow widths) against JAX:
the pre-training step, a GWCAPL train step, evaluate_multi, the
converters and basis_cli end to end.

Inputs are drawn with numpy; JAX models use use_pallas=False (the XLA
path). Tolerances are stated per test.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gfs3dseg_gws_tpu.ops import fused_edgeconv as jax_fec
from gfs3dseg_gws_tpu.ops import fused_edgeconv_train as jax_fet
from gfs3dseg_gws_tpu.ops.attention_kernel import _attention_xla
from gfs3dseg_gws_tpu.ops.knn import _knn_pallas_fold, _knn_xla
from gfs3dseg_gws_tpu.ops.knn import knn_with_stats as jax_knn_with_stats
from gfs3dseg_gws_tpu_torch.ops.attention_kernel import (attention_plain,
                                                         fused_attention)
from gfs3dseg_gws_tpu_torch.ops.attention_train import (
    attention_train, attention_train_plain)
from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import (
    fused_edgeconv_infer, fused_edgeconv_plain, gather_conv,
    gather_conv_plain)
from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv_train import (
    fused_edgeconv_train, fused_edgeconv_train_plain)
from gfs3dseg_gws_tpu_torch.ops.knn import (knn_indices, knn_indices_fold,
                                            knn_indices_fold_plain,
                                            knn_indices_plain,
                                            knn_with_stats,
                                            pairwise_sq_dists)
from torch_port_util import jax_capl, one_thread, set_fp32, t, torch_capl

pytestmark = pytest.mark.usefixtures("one_thread")

B, N = 2, 128
WIDE, WIDE_K = 72, 40               # past the fast kernels' 64 and 32
# the DGCNN classification encoder's depth (four one-layer blocks), narrow
FOUR = ((8,), (8,), (16,), (32,))
FOUR_K = 12
FOUR_FEAT = sum(w[-1] for w in FOUR)


@pytest.fixture(autouse=True)
def _fp32():
    set_fp32()


def _rel(got, ref, floor=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), floor)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# --------------------------------------------------------------------------- #
# (a) K8: the fold-merge kNN
# --------------------------------------------------------------------------- #

TRUNC = 2.0 ** -12   # the TPU kernel's packed keys keep 12 mantissa bits


@pytest.mark.parametrize("folds", [2, 4])
def test_knn_fold_twin_matches_interpreted_pallas(folds):
    """The twin against the JAX package's `_knn_fold_kernel` (its Pallas
    body, interpret mode) at (1, 2048, 9), k = 20. The TPU kernel packs
    distance and index into 32 bits and so orders keys whose distances
    agree to 2^-12 relative as it likes: neighbour sets equal on >= 99% of
    the rows, and on every row that differs (set or order) the twin's and
    the kernel's distances, slot by slot, within 2^-12 of the row's k-th
    distance (plus 1e-6 for the two frameworks' rounding)."""
    x = _normal(folds, 1, 2048, 9)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_knn_pallas_fold(jnp.asarray(x), 20, folds=folds))
    got = knn_indices_fold_plain(t(x), 20, folds).numpy()
    sets = (np.sort(got, -1) == np.sort(ref, -1)).all(-1)
    assert sets.mean() >= 0.99, sets.mean()
    d2 = pairwise_sq_dists(t(x), t(x)).clamp_min(0).double().numpy()[0]
    for i in np.nonzero((got[0] != ref[0]).any(-1))[0]:
        dg, dr = d2[i, got[0, i]], d2[i, ref[0, i]]
        assert np.abs(dg - dr).max() <= (TRUNC + 1e-6) * dr.max(), i


@pytest.mark.parametrize("b,n,c,k,folds", [
    (2, 128, 9, 20, 2), (2, 128, 9, 20, 4), (2, 128, 9, 20, 8),
    (2, 37, 5, 7, 4),       # ragged N: not a multiple of the folds
    (1, 64, 3, 1, 8),       # k = 1
    (1, 33, 4, 33, 2),      # k = N
    (1, 50, WIDE, WIDE_K, 4),
])
def test_knn_fold_twin_equals_knn_indices_plain(b, n, c, k, folds):
    """The fold-merge tournament gives K6's twin's indices exactly, order
    included; the dispatcher takes the twin on a CPU tensor, no launch."""
    x = t(_normal(n + k + folds, b, n, c))
    ref = knn_indices_plain(x, k)
    before = knn_indices_fold.launches
    for got in (knn_indices_fold_plain(x, k, folds),
                knn_indices_fold(x, k, folds)):
        assert got.dtype == torch.int32 and got.shape == (b, n, k)
        assert torch.equal(got, ref)
    assert knn_indices_fold.launches == before


def test_knn_fold_refuses_what_jax_would_not_run():
    x = torch.zeros((1, 16, 3))
    with pytest.raises(ValueError, match="k must lie in"):
        knn_indices_fold_plain(x, 17)
    with pytest.raises(ValueError, match="folds"):
        knn_indices_fold_plain(x, 5, folds=3)


# --------------------------------------------------------------------------- #
# (b) the twins of the kernels that gained widths, against JAX's XLA path
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("c,k", [(WIDE, WIDE_K), (9, 70)])
def test_wide_knn_twins_match_jax(c, k):
    """K6's and K3's twins (the dispatchers on CPU tensors) at a width past
    64 and at k = 40, and at k > 64: idx and cnt exactly as the JAX XLA
    path gives them, scb within 1e-5."""
    x, btab = _normal(c + k, B, N, c), _normal(c + k + 1, B, N, WIDE)
    ref = jax_knn_with_stats(jnp.asarray(x), jnp.asarray(btab), k,
                             use_pallas=False)
    np.testing.assert_array_equal(knn_indices(t(x), k).numpy(), ref[0])
    idx, cnt, scb = knn_with_stats(t(x), t(btab), k)
    np.testing.assert_array_equal(idx.numpy(), ref[0])
    np.testing.assert_array_equal(cnt.numpy(), ref[1])
    np.testing.assert_allclose(scb.numpy(), ref[2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,w0,w1", [(WIDE, WIDE, WIDE), (9, WIDE, 130)])
def test_wide_edgeconv_twins_match_jax(c, w0, w1):
    """K1's twin and K9's twin (on JAX's graph) against the JAX
    _fused_edgeconv_xla at k = 40, within 1e-5; the dispatchers on CPU
    tensors equal the twins exactly."""
    r = np.random.default_rng(c + w1)
    args = (r.standard_normal((B, N, c)), r.standard_normal((B, N, w0)),
            r.standard_normal((B, N, w0)),
            r.standard_normal((w0, w1)) * 0.2, r.standard_normal(w1) * 0.1)
    args = [a.astype(np.float32) for a in args]
    ref = np.asarray(jax_fec._fused_edgeconv_xla(
        *map(jnp.asarray, args), k=WIDE_K, neg_slope=0.2))
    got = fused_edgeconv_plain(*map(t, args), WIDE_K).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        fused_edgeconv_infer(*map(t, args), WIDE_K).numpy(), got)
    idx = t(np.asarray(_knn_xla(jnp.asarray(args[0]), WIDE_K)))
    conv = gather_conv_plain(idx, *map(t, args[1:])).numpy()
    np.testing.assert_allclose(conv, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gather_conv(idx, *map(t, args[1:])).numpy(),
                                  conv)


@pytest.mark.parametrize("c,w1,k", [(WIDE, WIDE, WIDE_K), (WIDE, 130, 20),
                                    (9, 24, 70)])
def test_wide_fused_edgeconv_train_matches_jax(c, w1, k):
    """K4's Function (on its twin stages) and the unfused twin against the
    JAX fused_edgeconv_train_xla past C, W1 = 64 and at k > 64: forward,
    the four batch statistics and all seven gradients within 1e-4 of the
    reference's largest magnitude (fp32 sums in other orders)."""
    from test_torch_port_train import NAMES, _fet_inputs, _jax_run, _torch_run

    x, args, cot = _fet_inputs(N, c, w1, k, seed=c + w1 + k)
    idx = _knn_xla(jnp.asarray(x), k)
    r_out, r_grads = _jax_run(jax_fet.fused_edgeconv_train_xla, args, idx,
                              cot)
    tidx = t(idx).to(torch.int32)
    knn = knn_with_stats(t(x), t(args["b"]), k)
    assert torch.equal(knn[0], tidx)
    for fn, kw in ((fused_edgeconv_train, dict(cnt=knn[1], scb=knn[2])),
                   (fused_edgeconv_train_plain, {})):
        g_out, g_grads = _torch_run(fn, args, tidx, cot, **kw)
        for name, got, want in zip(("out", "mu1", "var1", "mu2", "var2")
                                   + NAMES, g_out + g_grads,
                                   list(r_out) + list(r_grads)):
            assert _rel(got, want) < 1e-4, (fn.__name__, name)


@pytest.mark.parametrize("d", [30, WIDE])
def test_wide_attention_twins_match_jax(d):
    """K2's twin and K5's Function at rate 0 (on its twin stages) at a head
    width that is not a multiple of 4 and one past 64, against the JAX
    _attention_xla and its gradients: forward within 1e-5, dq/dk/dv within
    2e-4 (the tolerances of the D = 64 tests); the temperature is
    sqrt(D) of the true D."""
    r = np.random.default_rng(d)
    q, k, v, cot = (r.standard_normal((B, N, d)).astype(np.float32)
                    for _ in range(4))
    temp = float(d) ** 0.5
    ref = np.asarray(_attention_xla(*map(jnp.asarray, (q, k, v)), temp))
    for fn in (attention_plain, fused_attention):
        np.testing.assert_allclose(fn(t(q), t(k), t(v), temp).numpy(), ref,
                                   rtol=1e-5, atol=1e-5)
    ref_grads = jax.grad(lambda *a: jnp.sum(_attention_xla(*a, temp) * cot),
                         argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for fn in (attention_train, attention_train_plain):
        ins = [t(a).requires_grad_() for a in (q, k, v)]
        out = fn(*ins, 5, temp, 0.0)
        grads = torch.autograd.grad((out * t(cot)).sum(), ins)
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5)
        for name, g, want in zip("qkv", grads, ref_grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"d{name}")


# --------------------------------------------------------------------------- #
# (c) four one-layer blocks: the classification encoder's depth
# --------------------------------------------------------------------------- #

NPTS, NUM_GW = 64, 10
FOUR_CFG = dict(edgeconv_widths=FOUR, k=FOUR_K)


def test_four_block_pretrain_step_matches_jax():
    """The DGCNNSeg train step at four one-layer blocks (K6 and the gather
    Function in every block): logits within 1e-4, loss within 1e-4
    relative, every gradient within 1e-3 and the running statistics within
    1e-4, as test_torch_port_train's step test holds them."""
    from gfs3dseg_gws_tpu.models.layers import cross_entropy as jax_ce
    from gfs3dseg_gws_tpu_torch.models.layers import cross_entropy
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
        pretrain_state_dict_from_jax)
    from test_torch_port_train import SEG_WIDTHS, _batch, _seg_pair

    model, variables, port = _seg_pair(
        widths={**SEG_WIDTHS, "edgeconv_widths": FOUR, "k": FOUR_K})
    pts, lbl = _batch(9)

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
    floor = 1e-3 * max(ref_sd[name].abs().max().item()
                       for name, _ in port.named_parameters())
    for name, p in port.named_parameters():
        assert _rel(p.grad.numpy(), ref_sd[name].numpy(), floor) < 1e-3, name
    new_sd = pretrain_state_dict_from_jax(
        jax.device_get(variables["params"]), jax.device_get(ref_stats))
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), new_sd[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def _gfs_batch(seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((4, NPTS, 9)).astype(np.float32)
    y = r.integers(0, 8, (4, NPTS)).astype(np.int32)
    y[0, :5] = 255
    gp = r.standard_normal((NUM_GW, FOUR_FEAT)).astype(np.float32)
    fake = np.zeros(13, np.float32)
    fake[[1, 4, 6]] = 1.0
    return x, y, gp, fake


def test_four_block_gwcapl_train_pass_matches_jax():
    """GWCAPL.forward in training at four one-layer blocks against JAX
    (attn_dropout 0, fake_row fixed; the basis is FOUR_FEAT = 64 wide, every
    block's output): loss within 1e-5 relative, pred equal, every gradient
    within 1e-4, running statistics within 1e-5."""
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import state_dict_from_jax
    from test_torch_port_gfs_train import _check_grads

    model, variables = jax_capl(num_gw=NUM_GW, npts=NPTS, seed=21,
                                attn_dropout=0.0, **FOUR_CFG)
    port = torch_capl(variables, num_gw=NUM_GW, attn_dropout=0.0, **FOUR_CFG)
    x, y, gp, fake = _gfs_batch(22)

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


def test_four_block_evaluate_multi_matches_jax():
    """Eval-mode evaluate_multi at four one-layer blocks against JAX:
    logits, predictions and coding within 1e-3 (the cosine x 10 logits'
    tolerance of test_torch_port_models)."""
    model, variables = jax_capl(num_gw=NUM_GW, npts=NPTS, seed=23,
                                **FOUR_CFG)
    port = torch_capl(variables, num_gw=NUM_GW, **FOUR_CFG)
    r = np.random.default_rng(24)
    args = [r.standard_normal((2, NPTS, 9)).astype(np.float32),
            r.standard_normal((NUM_GW, FOUR_FEAT)).astype(np.float32),
            r.standard_normal((3, 13, 16)).astype(np.float32),
            (r.random((7, NUM_GW)) < 0.4).astype(np.float32),
            (r.random((3, 6, NUM_GW)) < 0.4).astype(np.float32),
            r.integers(0, 13, (2, NPTS))]
    ref = model.apply(variables, *map(jnp.asarray, args), None,
                      method="evaluate_multi")
    with torch.no_grad():
        got = port.evaluate_multi(*map(t, args), None)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("model_kind", ["gwcapl", "dgcnnseg", "dgcnnsegatt"])
def test_four_block_converters_round_trip(tmp_path, model_kind):
    """At four one-layer blocks and the classification widths
    ((64,),(64,),(128,),(256,)): each converter loads the JAX variables into
    the port's model with strict=True (no layer 1 in any block); the port's
    npz writer gives the same state dict back through the converter; and
    load_pretrained_encoder reads the encoder from that npz."""
    from gfs3dseg_gws_tpu.models.dgcnnseg import DGCNNSeg as JaxSeg
    from gfs3dseg_gws_tpu.models.dgcnnseg import DGCNNSegAtt as JaxSegAtt
    from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg, DGCNNSegAtt
    from gfs3dseg_gws_tpu_torch.utils import checkpoint as ck

    widths = ((64,), (64,), (128,), (256,))
    rng = jax.random.PRNGKey(1)
    x0 = jnp.zeros((2, 48, 9))
    if model_kind == "gwcapl":
        _, variables = jax_capl(num_gw=150, npts=48, edgeconv_widths=widths,
                                mlp_widths=(512, 256), base_widths=(128, 64),
                                output_dim=64, main_dim=128, k=FOUR_K)
        port = torch_capl(variables, num_gw=150, edgeconv_widths=widths,
                          mlp_widths=(512, 256), base_widths=(128, 64),
                          output_dim=64, main_dim=128, k=FOUR_K)
        convert, save = ck.state_dict_from_jax, ck.save_gfs_npz
    elif model_kind == "dgcnnseg":
        seg = JaxSeg(num_classes=8, edgeconv_widths=widths, k=FOUR_K,
                     use_pallas=False)
        variables = seg.init({"params": rng, "dropout": rng}, x0, True)
        port = DGCNNSeg(8, edgeconv_widths=widths, k=FOUR_K)
        convert, save = ck.pretrain_state_dict_from_jax, ck.save_pretrain_npz
    else:
        seg = JaxSegAtt(num_classes=8, edgeconv_widths=widths, k=FOUR_K,
                        use_pallas=False)
        variables = seg.init({"params": rng, "dropout": rng}, x0, True)
        port = DGCNNSegAtt(8, edgeconv_widths=widths, k=FOUR_K)
        convert, save = ck.segatt_state_dict_from_jax, None
    sd = convert(jax.device_get(variables["params"]),
                 jax.device_get(variables["batch_stats"]))
    port.load_state_dict(sd, strict=True)
    assert sd["encoder.edge_convs.3.layer.0.weight"].shape == (256, 256, 1, 1)
    assert not any(f"edge_convs.{i}.layer.3" in key for key in sd
                   for i in range(4))
    if save is None:
        return
    path = str(tmp_path / "model.npz")
    save(port, path)
    flat, _ = ck.load_checkpoint(path)
    back = convert(flat)
    for key, val in port.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(back[key], val), key
    enc = ck.load_pretrained_encoder(path)
    port.encoder.load_state_dict(enc, strict=True)


BASIS_NPTS, BASIS_CNT = 96, 12


def test_four_block_basis_cli_matches_jax(tmp_path, monkeypatch):
    """pretrain() then basis_cli at four one-layer blocks, k = 12: the basis
    is as wide as every block's output together (64), and agrees within
    1e-4 of its largest entry, at the same rank, with the JAX
    extract_basis from the same checkpoint.npz when JAX's feature sweep
    also takes every block (its own takes EdgeConv 1-3, `edge_feats[:3]`,
    whose 32 channels its GWCAPL at this depth could not use: the test
    gives it a DGCNNSeg that returns them all)."""
    from gfs3dseg_gws_tpu.models.dgcnnseg import DGCNNSeg as JaxSeg
    from gfs3dseg_gws_tpu.pipelines import basis as jax_basis
    from gfs3dseg_gws_tpu.utils.config import (DataConfig as JaxDataConfig,
                                               ModelConfig as JaxModelConfig)
    from gfs3dseg_gws_tpu_torch.cli import basis_cli
    from gfs3dseg_gws_tpu_torch.data import make_synthetic_blocks
    from gfs3dseg_gws_tpu_torch.pipelines.basis import basis_file_name
    from gfs3dseg_gws_tpu_torch.pipelines.pretrain import pretrain
    from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                     PretrainConfig)

    widths = dict(edgeconv_widths=FOUR, dgcnn_mlp_widths=(16, 16),
                  dgcnn_k=FOUR_K, pc_npts=BASIS_NPTS)
    train_dir, _ = make_synthetic_blocks(str(tmp_path / "data"),
                                         n_train_blocks=40, n_test_blocks=1,
                                         points_per_block=400, seed=12)
    log_dir = str(tmp_path / "log")
    pretrain(ModelConfig(**widths),
             DataConfig(data_path=train_dir, pc_npts=BASIS_NPTS),
             PretrainConfig(batch_size=4, n_iters=1, eval_interval=1,
                            log_dir=log_dir, device="cpu", seed=5),
             max_steps_per_epoch=3)
    save = str(tmp_path / "port")
    got = basis_cli.main([
        "--data_path", train_dir, "--pretrain_checkpoint_path", log_dir,
        "--num_cnt", str(BASIS_CNT), "--save_path", save, "--pc_npts",
        str(BASIS_NPTS), "--edgeconv_widths", "[[8],[8],[16],[32]]",
        "--dgcnn_mlp_widths", "[16,16]", "--dgcnn_k", str(FOUR_K),
        "--device", "cpu"])
    assert os.path.exists(os.path.join(save, basis_file_name(BASIS_CNT)))
    assert got.shape == (BASIS_CNT, FOUR_FEAT) and np.isfinite(got).all()

    class EveryBlock(JaxSeg):
        def __call__(self, pc, train=False, return_feat=False):
            logits = super().__call__(pc, train)
            if not return_feat:
                return logits
            return logits, jnp.concatenate(self.encoder(pc, train)[0], -1)

    monkeypatch.setattr(jax_basis, "DGCNNSeg", EveryBlock)
    ref = jax_basis.extract_basis(
        JaxModelConfig(use_pallas=False, **widths),
        JaxDataConfig(data_path=train_dir, pc_npts=BASIS_NPTS), BASIS_CNT,
        os.path.join(log_dir, "checkpoint.npz"), str(tmp_path / "jax"))
    assert ref.shape == got.shape
    assert _rel(got, ref) <= 1e-4, _rel(got, ref)
    assert np.linalg.matrix_rank(got) == np.linalg.matrix_rank(ref) > 0
