"""PyTorch port, fourth slice, against the JAX package on the CPU: K6's and
K7's twins and the gather Function, K9's twin and the split EdgeConv, the
twins' independence from the kernels, a GFS train step and the eval
methods at widths whose third EdgeConv block is one layer deep, the
state-dict converters at the DGCNN semantic-segmentation widths, k-means,
the SVD reconstruction, and geometric-word extraction end to end
(`extract_basis`, `basis_cli`) from a checkpoint the port's pre-training
wrote.

Inputs are drawn with numpy; JAX models use use_pallas=False (the XLA
path). Tolerances are stated per test.
"""
import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gfs3dseg_gws_tpu.ops import edgeconv as jax_edgeconv
from gfs3dseg_gws_tpu.ops import fused_edgeconv as jax_fec
from gfs3dseg_gws_tpu.ops.knn import knn_indices as jax_knn_indices
from gfs3dseg_gws_tpu.ops.linalg import (
    svd_energy_reconstruct as jax_svd_energy_reconstruct)
from gfs3dseg_gws_tpu_torch.ops import kmeans as port_kmeans
from gfs3dseg_gws_tpu_torch.ops.edgeconv import (gather_neighbors,
                                                 gather_neighbors_plain,
                                                 scatter_bwd,
                                                 scatter_bwd_plain)
from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import (
    fused_edgeconv_infer_split, fused_edgeconv_plain, gather_conv,
    gather_conv_plain)
from gfs3dseg_gws_tpu_torch.ops.knn import knn_indices, knn_indices_plain
from gfs3dseg_gws_tpu_torch.ops.linalg import svd_energy_reconstruct
from torch_port_util import TINY, jax_capl, one_thread, set_fp32, t, torch_capl

pytestmark = pytest.mark.usefixtures("one_thread")

# the module: the package's __init__ re-exports a function of the same name
jax_kmeans = importlib.import_module("gfs3dseg_gws_tpu.ops.kmeans")

B, N, W, K = 2, 128, 8, 5
# the tiny widths with a third block one layer deep (DGCNN semseg's shape)
ONE_DEEP = ((8, 8), (8, 8), (8,))
SEMSEG = ((64, 64), (64, 64), (64,))


@pytest.fixture(autouse=True)
def _fp32():
    set_fp32()


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


# --------------------------------------------------------------------------- #
# (a) K6, K7 and K9: twins and wrappers on the CPU
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("c,k", [(9, 5), (64, 20), (3, 32)])
def test_knn_indices_twin_equals_jax(c, k):
    """K6's twin and the dispatcher on a CPU tensor: the JAX knn_indices
    (use_pallas=False) exactly, int32, without a launch."""
    x = np.random.default_rng(c + k).standard_normal((B, N, c)).astype(
        np.float32)
    ref = np.asarray(jax_knn_indices(jnp.asarray(x), k, use_pallas=False))
    before = knn_indices.launches
    for fn in (knn_indices_plain, knn_indices):
        got = fn(t(x), k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert knn_indices.launches == before


def _gather_inputs(seed, c=W, dtype=np.float32):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, N, c)).astype(dtype)
    idx = r.integers(0, N, (B, N, K)).astype(np.int32)
    idx[0, :4] = 7                                   # many edges, one row
    g = r.standard_normal((B, N, K, c)).astype(dtype)
    return x, idx, g


def test_gather_function_matches_jax_vjp():
    """The gather Function against the JAX gather_neighbors (its XLA
    segment-sum backward on the CPU): the forward exactly, the VJP within
    1e-6 of the largest entry; the plain twin under autograd likewise."""
    x, idx, g = _gather_inputs(0)
    ref, vjp = jax.vjp(lambda a: jax_edgeconv.gather_neighbors(
        a, jnp.asarray(idx)), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    before = scatter_bwd.launches
    for fn in (gather_neighbors, gather_neighbors_plain):
        xt = t(x).requires_grad_()
        out = fn(xt, t(idx))
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
        (dx,) = torch.autograd.grad(out, xt, t(g))
        assert _rel(dx.numpy(), ref_dx) <= 1e-6, fn.__name__
    assert scatter_bwd.launches == before
    np.testing.assert_array_equal(
        scatter_bwd(t(idx), t(g)).numpy(), scatter_bwd_plain(t(idx),
                                                             t(g)).numpy())


def test_gather_function_gradcheck():
    """torch.autograd.gradcheck of the Function in float64, int64 and
    int32 indices."""
    x, idx, _ = _gather_inputs(1, c=3, dtype=np.float64)
    x, idx = x[:, :12], idx[:, :12] % 12
    for ix in (t(idx), t(idx).long()):
        assert torch.autograd.gradcheck(
            lambda a, ix=ix: gather_neighbors(a, ix), (t(x).requires_grad_(),))


def _edgeconv_inputs(c, seed, w0=W, w1=W):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, N, c)).astype(np.float32),
            r.standard_normal((B, N, w0)).astype(np.float32),
            r.standard_normal((B, N, w0)).astype(np.float32),
            (r.standard_normal((w0, w1)) * 0.3).astype(np.float32),
            (r.standard_normal((w1,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("c,w1", [(9, 8), (8, 12)])
def test_gather_conv_and_split_match_xla(c, w1):
    """K9's twin on the JAX indices, and the split EdgeConv (K6's then K9's
    dispatch on CPU tensors), against the JAX _fused_edgeconv_xla within
    1e-5; the split equals fused_edgeconv_plain exactly."""
    args = _edgeconv_inputs(c, seed=c + w1, w1=w1)
    ref = np.asarray(jax_fec._fused_edgeconv_xla(*map(jnp.asarray, args),
                                                 k=K, neg_slope=0.2))
    idx = t(np.asarray(jax_knn_indices(jnp.asarray(args[0]), K,
                                       use_pallas=False)))
    before = gather_conv.launches
    got = gather_conv_plain(idx, *map(t, args[1:])).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gather_conv(idx, *map(t, args[1:])).numpy(),
                                  got)
    split = fused_edgeconv_infer_split(*map(t, args), K).numpy()
    np.testing.assert_allclose(split, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(split,
                                  fused_edgeconv_plain(*map(t, args),
                                                       K).numpy())
    assert gather_conv.launches == before


def test_twins_never_reach_the_kernels(monkeypatch):
    """With knn_indices and gather_neighbors (the K6 dispatcher and the K7
    Function) made to raise wherever the port imports them, every plain
    twin still runs: K1's, K3's, K4a's, K4b's, K9's and the unfused
    training composition."""
    from gfs3dseg_gws_tpu_torch.models import dgcnn
    from gfs3dseg_gws_tpu_torch.ops import edgeconv, fused_edgeconv, knn
    from gfs3dseg_gws_tpu_torch.ops import fused_edgeconv_train as fet

    def refuse(*_a, **_k):
        raise AssertionError("a twin reached a kernel dispatcher")

    for mod in (dgcnn, edgeconv, fused_edgeconv, knn, fet):
        for name in ("knn_indices", "gather_neighbors"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, refuse)
    r = np.random.default_rng(3)
    x, a, b, w2, bias2 = map(t, _edgeconv_inputs(9, seed=3))
    fused_edgeconv.fused_edgeconv_plain(x, a, b, w2, bias2, K)
    idx, cnt, scb = knn.knn_with_stats_plain(x, b, K)
    fused_edgeconv.gather_conv_plain(idx, a, b, w2, bias2)
    s1, t1 = torch.ones(W), torch.zeros(W)
    got = fet._gsf_plain(a, b, idx, s1, t1, w2, 0.2)
    p1 = torch.stack([s1, t1, torch.zeros(W), torch.ones(W), s1])
    pk = torch.stack([torch.ones(W), torch.zeros(W), torch.zeros(W),
                      torch.zeros(W), torch.ones(W)])
    fet._bwd_plain(a, b, idx, p1, w2, t(r.standard_normal((B, N, W)).astype(
        np.float32)), got[3], pk, 0.2)
    fet.fused_edgeconv_train_plain(a, b, s1, t1, w2, s1, t1, idx)
    fet.fused_edgeconv_train(a, b, s1, t1, w2, s1, t1, idx, cnt, scb)


# --------------------------------------------------------------------------- #
# (b) the model with a block one layer deep
# --------------------------------------------------------------------------- #

NB, NPTS, NUM_GW = 4, 64, 10


def test_gwcapl_train_pass_with_one_deep_block_matches_jax():
    """GWCAPL.forward in training at widths ((8,8),(8,8),(8,)) against JAX
    (attn_dropout 0, fake_row fixed): loss within 1e-5 relative, pred
    equal, every gradient within 1e-4 (test_torch_port_gfs_train's
    _check_grads), running statistics within 1e-5 (the one-deep block's
    bn1 takes its statistics over (B, N, K) through the gather Function)."""
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import state_dict_from_jax
    from test_torch_port_gfs_train import _check_grads, _train_batch

    model, variables = jax_capl(num_gw=NUM_GW, npts=NPTS, seed=14,
                                attn_dropout=0.0, edgeconv_widths=ONE_DEEP)
    port = torch_capl(variables, num_gw=NUM_GW, attn_dropout=0.0,
                      edgeconv_widths=ONE_DEEP)
    x, y, gp, fake = _train_batch(16)

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


def test_evaluate_multi_with_one_deep_block_matches_jax():
    """Eval-mode evaluate_multi at widths ((8,8),(8,8),(8,)) against JAX:
    logits, predictions and coding within 1e-3 (the cosine x 10 logits'
    tolerance of test_torch_port_models)."""
    model, variables = jax_capl(num_gw=NUM_GW, npts=NPTS, seed=15,
                                edgeconv_widths=ONE_DEEP)
    port = torch_capl(variables, num_gw=NUM_GW, edgeconv_widths=ONE_DEEP)
    r = np.random.default_rng(17)
    args = [r.standard_normal((2, NPTS, 9)).astype(np.float32),
            r.standard_normal((NUM_GW, 24)).astype(np.float32),
            r.standard_normal((3, 13, 16)).astype(np.float32),
            (r.random((7, NUM_GW)) < 0.4).astype(np.float32),
            (r.random((3, 6, NUM_GW)) < 0.4).astype(np.float32),
            r.integers(0, 13, (2, NPTS))]
    ref = model.apply(variables, *map(jnp.asarray, args), None,
                      method="evaluate_multi")
    with torch.no_grad():
        got = port.evaluate_multi(*map(t, args), None)
    assert got[0].shape == (3, 2, NPTS, 13)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3,
                                   atol=1e-3)


def test_converters_take_the_semseg_widths():
    """At the DGCNN semantic-segmentation widths ((64,64),(64,64),(64,)),
    MLP (512, 256): pretrain_state_dict_from_jax and state_dict_from_jax
    load into the port's DGCNNSeg and GWCAPL with strict=True, and the
    encoder layout has no layer 1 in block 3."""
    from gfs3dseg_gws_tpu.models.dgcnnseg import DGCNNSeg as JaxDGCNNSeg
    from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
        pretrain_state_dict_from_jax, state_dict_from_jax)

    rng = jax.random.PRNGKey(0)
    seg = JaxDGCNNSeg(num_classes=8, edgeconv_widths=SEMSEG, use_pallas=False)
    v = seg.init({"params": rng, "dropout": rng}, jnp.zeros((2, 32, 9)), True)
    port_seg = DGCNNSeg(8, edgeconv_widths=SEMSEG)
    sd = pretrain_state_dict_from_jax(jax.device_get(v["params"]),
                                      jax.device_get(v["batch_stats"]))
    port_seg.load_state_dict(sd, strict=True)
    assert "encoder.edge_convs.2.layer.3.weight" not in sd
    assert sd["encoder.edge_convs.2.layer.0.weight"].shape == (64, 128, 1, 1)

    _, variables = jax_capl(num_gw=150, npts=32, edgeconv_widths=SEMSEG,
                            mlp_widths=(512, 256), base_widths=(128, 64),
                            output_dim=64, main_dim=128, k=20)
    port = torch_capl(variables, num_gw=150, edgeconv_widths=SEMSEG,
                      mlp_widths=(512, 256), base_widths=(128, 64),
                      output_dim=64, main_dim=128, k=20)
    assert port.state_dict()["encoder.edge_convs.2.layer.1.weight"].shape == (
        64,)


# --------------------------------------------------------------------------- #
# (c) k-means and the SVD reconstruction
# --------------------------------------------------------------------------- #

def _clusters(seed, n=600, d=12, k=6, spread=0.05):
    r = np.random.default_rng(seed)
    centres = r.standard_normal((k, d)) * 3.0
    lab = r.integers(0, k, n)
    return (centres[lab] + spread * r.standard_normal((n, d))).astype(
        np.float32)


@pytest.mark.parametrize("subsample", [100_000, 200])
def test_kmeans_plus_plus_init_equals_jax(subsample):
    """Same seed, same centres, bit for bit (with and without the
    subsample)."""
    x = _clusters(0)
    ref = jax_kmeans.kmeans_plus_plus_init(np.random.default_rng(5), x, 9,
                                           subsample=subsample)
    got = port_kmeans.kmeans_plus_plus_init(np.random.default_rng(5), x, 9,
                                            subsample=subsample)
    np.testing.assert_array_equal(got, ref)


def test_lloyd_matches_jax():
    """Lloyd from the same centres on well-separated clusters (one centre
    far from every point, so its cluster stays empty and keeps its place):
    centres within 1e-5, labels equal; kmeans() end to end likewise."""
    x = _clusters(1)
    c0 = port_kmeans.kmeans_plus_plus_init(np.random.default_rng(2), x, 6)
    c0[5] = 100.0
    ref_c, ref_l = jax_kmeans._lloyd(jnp.asarray(x), jnp.asarray(c0), 20)
    got_c, got_l = port_kmeans.lloyd(t(x), t(c0), 20)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    assert (got_c[5] == 100.0).all()
    ref_c, ref_l = jax_kmeans.kmeans(x, 6, n_iters=30, seed=3)
    got_c, got_l = port_kmeans.kmeans(x, 6, n_iters=30, seed=3)
    np.testing.assert_allclose(got_c, ref_c, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_l, ref_l)
    assert got_l.dtype == np.int32


def test_cluster_means_and_svd_equal_jax():
    """cluster_means and svd_energy_reconstruct give the JAX package's
    arrays exactly; an empty cluster fails as in JAX."""
    x = _clusters(4)
    labels = np.random.default_rng(6).integers(0, 7, x.shape[0])
    ref = jax_kmeans.cluster_means(x, labels, 7)
    got = port_kmeans.cluster_means(x, labels, 7)
    np.testing.assert_array_equal(got, ref)
    for energy in (0.5, 0.95):
        np.testing.assert_array_equal(svd_energy_reconstruct(got, energy),
                                      jax_svd_energy_reconstruct(ref, energy))
    with pytest.raises(AssertionError, match="empty"):
        port_kmeans.cluster_means(x, labels, 8)


# --------------------------------------------------------------------------- #
# (d) extract_basis and basis_cli end to end
# --------------------------------------------------------------------------- #

BASIS_NPTS, BASIS_CNT = 96, 12
BASIS_WIDTHS = dict(edgeconv_widths=ONE_DEEP, dgcnn_mlp_widths=(16, 16),
                    dgcnn_k=TINY["k"], pc_npts=BASIS_NPTS)
BASIS_TOL = 1e-4         # max |port - JAX| / max |JAX|


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """Synthetic blocks and a checkpoint.tar written by the port's
    pretrain() at the one-deep widths (CPU, two short epochs)."""
    from gfs3dseg_gws_tpu_torch.data import make_synthetic_blocks
    from gfs3dseg_gws_tpu_torch.pipelines.pretrain import pretrain
    from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                     PretrainConfig)

    set_fp32()
    root = tmp_path_factory.mktemp("basis")
    train_dir, _ = make_synthetic_blocks(str(root / "data"),
                                         n_train_blocks=40, n_test_blocks=1,
                                         points_per_block=400, seed=8)
    log_dir = str(root / "log")
    pretrain(ModelConfig(**BASIS_WIDTHS),
             DataConfig(data_path=train_dir, pc_npts=BASIS_NPTS),
             PretrainConfig(batch_size=4, n_iters=1, eval_interval=1,
                            log_dir=log_dir, device="cpu", seed=4),
             max_steps_per_epoch=3)
    return root, train_dir, log_dir


def test_basis_cli_matches_jax_extract_basis(pretrained):
    """`basis_cli --device cpu` on the blocks and the port's checkpoint.tar
    (its log directory) writes the reference file name; its basis agrees
    with the JAX extract_basis (use_pallas=False) from the same pre-training
    run within BASIS_TOL of the largest entry, with the same rank; the JAX
    load_basis reads the port's pickle; the port's extract_basis from the
    checkpoint.npz gives the same basis."""
    from gfs3dseg_gws_tpu.pipelines.basis import extract_basis as jax_extract
    from gfs3dseg_gws_tpu.utils.checkpoint import load_basis as jax_load_basis
    from gfs3dseg_gws_tpu.utils.config import (DataConfig as JaxDataConfig,
                                               ModelConfig as JaxModelConfig)
    from gfs3dseg_gws_tpu_torch.cli import basis_cli
    from gfs3dseg_gws_tpu_torch.pipelines.basis import (basis_file_name,
                                                        extract_basis)
    from gfs3dseg_gws_tpu_torch.utils.config import DataConfig, ModelConfig

    root, train_dir, log_dir = pretrained
    save = str(root / "port")
    got = basis_cli.main([
        "--dataset", "s3dis", "--cvfold", "0", "--data_path", train_dir,
        "--pretrain_checkpoint_path", log_dir, "--num_cnt", str(BASIS_CNT),
        "--save_path", save, "--pc_npts", str(BASIS_NPTS),
        "--edgeconv_widths", "[[8,8],[8,8],[8]]",
        "--dgcnn_mlp_widths", "[16,16]", "--dgcnn_k", str(TINY["k"]),
        "--device", "cpu"])
    path = os.path.join(save, basis_file_name(BASIS_CNT))
    assert os.path.basename(path) == (
        f"GlobalKmeans_EdgeConv123_cnt={BASIS_CNT}_energy=095_"
        "SVDReconstruct.pkl")
    on_disk = jax_load_basis(path)
    np.testing.assert_array_equal(on_disk, got)
    assert got.shape == (BASIS_CNT, 24) and np.isfinite(got).all()

    # the JAX package reads the same weights from the checkpoint.npz beside
    # the tar: its torch-layout converter takes two-layer blocks only
    # (gfs3dseg_gws_tpu/utils/checkpoint.py::convert_torch_dgcnn_encoder)
    ref = jax_extract(JaxModelConfig(use_pallas=False, **BASIS_WIDTHS),
                      JaxDataConfig(data_path=train_dir, pc_npts=BASIS_NPTS),
                      BASIS_CNT, os.path.join(log_dir, "checkpoint.npz"),
                      str(root / "jax"))
    assert _rel(got, ref) <= BASIS_TOL, _rel(got, ref)
    assert np.linalg.matrix_rank(got) == np.linalg.matrix_rank(ref)

    npz = extract_basis(ModelConfig(**BASIS_WIDTHS),
                        DataConfig(data_path=train_dir, pc_npts=BASIS_NPTS),
                        BASIS_CNT, os.path.join(log_dir, "checkpoint.npz"),
                        str(root / "npz"), device="cpu")
    np.testing.assert_allclose(npz, got, rtol=0, atol=1e-6)


def test_basis_cli_refuses_cuda_without_a_gpu(monkeypatch, tmp_path):
    from gfs3dseg_gws_tpu_torch.cli import basis_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        basis_cli.main(["--data_path", "does_not_exist", "--save_path",
                        str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
