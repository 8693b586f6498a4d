"""PyTorch port, models: DGCNN, SelfAttention and the GWCAPL eval methods
against the JAX package (XLA path) at tiny widths, with the same weights
carried over by `state_dict_from_jax`; checkpoint loading."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gfs3dseg_gws_tpu.utils.checkpoint import (save_checkpoint,
                                               save_torch_gfs_checkpoint)
from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
from gfs3dseg_gws_tpu_torch.models.dgcnn import EdgeConvBlock
from gfs3dseg_gws_tpu_torch.utils.checkpoint import (_put_bn, _put_conv,
                                                     load_checkpoint,
                                                     load_torch_gfs_state_dict,
                                                     state_dict_from_jax)
from torch_port_util import TINY, jax_capl, one_thread, set_fp32, t, torch_capl

pytestmark = pytest.mark.usefixtures("one_thread")

NPTS, NUM_GW = 64, 10
FEAT_TOL = dict(rtol=1e-4, atol=1e-4)      # features
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)     # cosine x 10 logits

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "capl_eval_logits.npz")


@pytest.fixture(scope="module")
def pair():
    set_fp32()
    model, variables = jax_capl(num_gw=NUM_GW, npts=NPTS, seed=0)
    return model, variables, torch_capl(variables, num_gw=NUM_GW)


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(11)
    return dict(
        x=r.standard_normal((2, NPTS, 9)).astype(np.float32),
        gp=r.standard_normal((NUM_GW, 24)).astype(np.float32),
        y=r.integers(0, 13, (2, NPTS)),
        mask=(r.random((2, NPTS)) < 0.5).astype(np.float32),
        gened=r.standard_normal((3, 13, 16)).astype(np.float32),
        bc=(r.random((7, NUM_GW)) < 0.4).astype(np.float32),
        nc=(r.random((3, 6, NUM_GW)) < 0.4).astype(np.float32))


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol)


def test_dgcnn_matches_jax(pair, inputs):
    model, variables, tm = pair
    edges, out = model.apply(variables, jnp.asarray(inputs["x"]),
                             method=lambda m, x: m.encoder(x, False))
    with torch.no_grad():
        t_edges, t_out = tm.encoder(t(inputs["x"]))
    for a, b in zip(t_edges, edges):
        _close(a, b, FEAT_TOL)
    _close(t_out, out, FEAT_TOL)


def test_self_attention_matches_jax(pair, inputs):
    model, variables, tm = pair
    feat = np.random.default_rng(12).standard_normal((2, NPTS, 16)).astype(
        np.float32)
    ref = model.apply(variables, jnp.asarray(feat),
                      method=lambda m, f: m.att_learner(f, False))
    with torch.no_grad():
        got = tm.att_learner(t(feat))
    _close(got, ref, FEAT_TOL)


def test_edgeconv_block_of_three_widths_matches_jax():
    """Blocks that are not two layers deep take the plain composition."""
    from gfs3dseg_gws_tpu.models.dgcnn import EdgeConvBlock as JaxBlock
    from torch_port_util import randomize_bn

    x = np.random.default_rng(13).standard_normal((2, NPTS, 9)).astype(
        np.float32)
    blk = JaxBlock((8, 8, 8), k=5, use_pallas=False)
    variables = randomize_bn(blk.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                             seed=1)
    ref = blk.apply(variables, jnp.asarray(x), False)
    p = jax.device_get(variables["params"])
    s = jax.device_get(variables["batch_stats"])
    sd = {}
    _put_conv(sd, "layer.0", p["layer0_kernel"], conv2d=True)
    _put_bn(sd, "layer.1", p["layer0_bn"], s["layer0_bn"])
    for j in (1, 2):
        _put_conv(sd, f"layer.{3 * j}", p[f"layer{j}"]["conv"]["kernel"],
                  conv2d=True)
        _put_bn(sd, f"layer.{3 * j + 1}", p[f"layer{j}"]["bn"],
                s[f"layer{j}"]["bn"])
    tb = EdgeConvBlock(9, (8, 8, 8), k=5).eval()
    tb.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tb(t(x))
    _close(got, ref, FEAT_TOL)


def test_get_features_matches_jax(pair, inputs):
    model, variables, tm = pair
    ref = model.apply(variables, jnp.asarray(inputs["x"]),
                      jnp.asarray(inputs["gp"]), False,
                      method="get_features")
    with torch.no_grad():
        got = tm.get_features(t(inputs["x"]), t(inputs["gp"]))
    for a, b in zip(got, ref):
        _close(a, b, FEAT_TOL)


def test_get_fg_feat_matches_jax(pair, inputs):
    model, variables, tm = pair
    ref = model.apply(variables, jnp.asarray(inputs["x"]),
                      jnp.asarray(inputs["mask"]), jnp.asarray(inputs["gp"]),
                      method="get_fg_feat")
    with torch.no_grad():
        got = tm.get_fg_feat(t(inputs["x"]), t(inputs["mask"]),
                             t(inputs["gp"]))
    for a, b in zip(got, ref):
        _close(a, b, FEAT_TOL)


@pytest.mark.parametrize("valid", [None, 1])
def test_evaluate_matches_jax(pair, inputs, valid):
    model, variables, tm = pair
    args = [inputs[k] for k in ("x", "gp")] + [inputs["gened"][0],
                                               inputs["bc"], inputs["nc"][0],
                                               inputs["y"]]
    ref = model.apply(variables, *map(jnp.asarray, args), valid,
                      method="evaluate")
    with torch.no_grad():
        got = tm.evaluate(*map(t, args), valid)
    for a, b in zip(got, ref):
        _close(a, b, LOGIT_TOL)


@pytest.mark.parametrize("valid", [None, 1])
def test_evaluate_multi_matches_jax(pair, inputs, valid):
    model, variables, tm = pair
    args = [inputs[k] for k in ("x", "gp", "gened", "bc", "nc", "y")]
    ref = model.apply(variables, *map(jnp.asarray, args), valid,
                      method="evaluate_multi")
    with torch.no_grad():
        got = tm.evaluate_multi(*map(t, args), valid)
    assert got[0].shape == (3, 2, NPTS, 13)
    for a, b in zip(got, ref):
        _close(a, b, LOGIT_TOL)


def test_reproduces_golden_eval_logits():
    """The weights and inputs of tests/test_golden.py:17-35, carried into
    the port, give the committed JAX logits."""
    from gfs3dseg_gws_tpu.models.capl import GWCAPL as JaxGWCAPL

    set_fp32()
    model = JaxGWCAPL(classes=13, base_num=7, num_gw=10, main_dim=16,
                      edgeconv_widths=((8, 8), (8, 8), (8, 8)),
                      mlp_widths=(16, 16), base_widths=(8, 8), output_dim=8,
                      k=5, use_pallas=False)
    rng = jax.random.PRNGKey(0)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 64, 9))
    y = jax.random.randint(jax.random.PRNGKey(2), (2, 64), 0, 8)
    gp = jax.random.normal(jax.random.PRNGKey(3), (10, 24))
    variables = model.init({"params": rng, "dropout": rng, "fake": rng},
                           x, y, gp, train=True)
    gened = jax.random.normal(jax.random.PRNGKey(4), (13, 16))
    tm = torch_capl(variables, num_gw=10, eval_weight=1.0)
    with torch.no_grad():
        logits, _, _ = tm.evaluate(t(x), t(gp), t(gened), torch.ones(7, 10),
                                   torch.ones(6, 10))
    with np.load(GOLDEN_PATH) as z:
        golden = z["logits"]
    np.testing.assert_allclose(logits.numpy(), golden, rtol=5e-4, atol=5e-5)


def test_pth_from_jax_exporter_loads_strict(pair, tmp_path):
    _, variables, tm = pair
    path = str(tmp_path / "model.pth")
    save_torch_gfs_checkpoint(jax.device_get(variables["params"]),
                              jax.device_get(variables["batch_stats"]), path)
    fresh = GWCAPL(num_gw=NUM_GW, **TINY)
    fresh.load_state_dict(load_torch_gfs_state_dict(path), strict=True)
    for (k, a), b in zip(fresh.state_dict().items(),
                         tm.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_npz_from_jax_save_checkpoint_loads_through_converter(pair,
                                                              tmp_path):
    _, variables, tm = pair
    path = str(tmp_path / "train_epoch_0.npz")
    save_checkpoint(path, {"params": variables["params"],
                           "batch_stats": variables["batch_stats"],
                           "step": np.int32(3)}, {"epoch": 0})
    flat, meta = load_checkpoint(path)
    assert meta == {"epoch": 0}
    fresh = GWCAPL(num_gw=NUM_GW, **TINY)
    fresh.load_state_dict(state_dict_from_jax(flat), strict=True)
    for (k, a), b in zip(fresh.state_dict().items(),
                         tm.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
