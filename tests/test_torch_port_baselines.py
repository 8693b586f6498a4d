"""PyTorch port, few-shot baselines slice (ProtoNet and what the baselines
share), against the JAX package on the CPU: the episode bank file for
file, the few-shot metric, ProtoNet's logits, loss, gradients and
BatchNorm statistics, the few-shot optimizer and the episodic checkpoint
reader. The pipelines end to end are in test_torch_port_baselines_e2e.py,
MPTI in test_torch_port_mpti.py; both take their helpers from here.

Inputs are drawn with numpy; JAX models use use_pallas=False (the XLA
path). Tolerances are max |got - ref| / max |ref| unless stated. The
tiny widths are those of tests/test_baselines.py.
"""
import functools
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gfs3dseg_gws_tpu_torch.data import make_synthetic_blocks
from gfs3dseg_gws_tpu_torch.models.protonet import ProtoNet
from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
    fewshot_state_dict_from_jax)
from torch_port_util import one_thread, randomize_bn, set_fp32, t

pytestmark = pytest.mark.usefixtures("one_thread")

NPTS = 96
NET = dict(edgeconv_widths=((8, 8),) * 3, mlp_widths=(16, 16),
           base_widths=(8, 8), output_dim=8, k=5)
CFG = dict(edgeconv_widths=NET["edgeconv_widths"],
           dgcnn_mlp_widths=NET["mlp_widths"], base_widths=NET["base_widths"],
           output_dim=8, dgcnn_k=5, pc_npts=NPTS)
TINY_ARGS = ["--pc_npts", str(NPTS), "--edgeconv_widths", "[[8,8],[8,8],[8,8]]",
             "--dgcnn_mlp_widths", "[16,16]", "--base_widths", "[8,8]",
             "--output_dim", "8", "--dgcnn_k", "5", "--device", "cpu"]


def _rel(got, ref, floor=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), floor)


def _blocks(root: str, seed: int = 2):
    """The synthetic S3DIS-layout blocks of tests/test_baselines.py."""
    return make_synthetic_blocks(root, n_train_blocks=40, n_test_blocks=16,
                                 points_per_block=1500, seed=seed)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return _blocks(str(tmp_path_factory.mktemp("fs")))


def _configs(data_dir, kind="jax", **fs):
    if kind == "jax":
        from gfs3dseg_gws_tpu.pipelines.baselines import FewShotConfig
        from gfs3dseg_gws_tpu.utils.config import DataConfig, ModelConfig
        model_cfg = ModelConfig(use_pallas=False, **CFG)
    else:
        from gfs3dseg_gws_tpu_torch.pipelines.baselines import FewShotConfig
        from gfs3dseg_gws_tpu_torch.utils.config import DataConfig, ModelConfig
        model_cfg = ModelConfig(**CFG)
        fs = {"device": "cpu", **fs}
    data_cfg = DataConfig(dataset="s3dis", cvfold=0, data_path=data_dir,
                          pc_npts=NPTS, k_shot=fs.get("k_shot", 1))
    return model_cfg, data_cfg, FewShotConfig(**fs)


def _episode(seed, n_way=2, k_shot=2, n_q=2, npts=NPTS):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n_way, k_shot, npts, 9)).astype(np.float32),
            r.integers(0, 2, (n_way, k_shot, npts)).astype(np.int32),
            r.standard_normal((n_q, npts, 9)).astype(np.float32),
            r.integers(0, n_way + 1, (n_q, npts)).astype(np.int32))


def jax_protonet(seed, dist, attention, n_way=2, k_shot=2):
    from gfs3dseg_gws_tpu.models.protonet import ProtoNet as JaxProtoNet

    model = JaxProtoNet(n_way=n_way, k_shot=k_shot, dist_method=dist,
                        use_attention=attention, use_pallas=False, **NET)
    rng = jax.random.PRNGKey(seed)
    variables = model.init({"params": rng, "dropout": rng},
                           *map(jnp.asarray, _episode(0, n_way, k_shot)))
    return model, randomize_bn(variables, seed + 100)


def port_load(model, variables):
    model.load_state_dict(fewshot_state_dict_from_jax(
        jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"])), strict=True)
    return model


def check_train_step(port, model, variables, episode, tol_grad, tol_stats):
    """One train-mode step of `port` against JAX value_and_grad with
    mutable batch statistics: loss within 1e-5, every gradient within
    `tol_grad` of the largest (a gradient below 1e-5 of the largest must
    be as small), the new running statistics within `tol_stats`.
    Returns the port's logits."""
    def loss_fn(params):
        (logits, loss), upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *map(jnp.asarray, episode), True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return loss, (logits, upd["batch_stats"])

    (ref_loss, (ref_logits, ref_stats)), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    port.train()
    logits, loss = port(*map(t, episode))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert _rel(logits.detach().numpy(), ref_logits) < 1e-4
    ref_sd = fewshot_state_dict_from_jax(jax.device_get(ref_grads),
                                         jax.device_get(ref_stats))
    grads = {n: p.grad for n, p in port.named_parameters()}
    top = max(ref_sd[n].abs().max().item() for n in grads)
    for name, g in grads.items():
        ref = ref_sd[name].numpy()
        if np.abs(ref).max() < 1e-5 * top:
            assert np.abs(g.numpy()).max() < 1e-5 * top, name
            continue
        assert _rel(g.numpy(), ref, 1e-3 * top) < tol_grad, name
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), ref_sd[name].numpy(),
                                       rtol=tol_stats, atol=tol_stats,
                                       err_msg=name)
    return logits


# --------------------------------------------------------------------------- #
# (a) the episode bank and the few-shot metric
# --------------------------------------------------------------------------- #

def test_episode_bank_equals_jax_file_for_file(tmp_path, monkeypatch):
    """From the same blocks and seed the port writes the JAX package's bank:
    the same directory, the same file names in the same order, every array
    equal in value and dtype; each package reads the other's bank, and the
    port's `.npz` bank (written where h5py is missing) holds the same
    arrays. `.h5` without h5py raises, naming it."""
    from gfs3dseg_gws_tpu_torch.data import episodes
    from gfs3dseg_gws_tpu.data.episodes import (
        EpisodeDataset as JaxEpisodes, StaticEpisodeBank as JaxBank)
    from gfs3dseg_gws_tpu_torch.data.episodes import (EpisodeDataset,
                                                      StaticEpisodeBank)

    dirs = {name: _blocks(str(tmp_path / name))[0]
            for name in ("jax", "port", "npz")}
    kw = dict(cvfold=0, num_episode_per_comb=1, n_way=2, k_shot=2,
              n_queries=1, num_point=NPTS, mode="test")
    ref = JaxBank(dirs["jax"], "s3dis", **kw)
    got = StaticEpisodeBank(dirs["port"], "s3dis", **kw)
    monkeypatch.setattr(episodes, "default_format", lambda: "npz")
    npz = StaticEpisodeBank(dirs["npz"], "s3dis", **kw)
    assert len(got) == len(ref) == len(npz) == 15
    assert (got.format, npz.format) == ("h5", "npz")
    assert os.path.relpath(got.bank_path, dirs["port"]) == \
        os.path.relpath(ref.bank_path, dirs["jax"])
    assert [os.path.basename(p) for p in got.file_names] == \
        [os.path.basename(p) for p in ref.file_names]
    assert [os.path.basename(p) for p in npz.file_names] == \
        [f"{i}.npz" for i in range(15)]
    for i in range(len(ref)):
        for a, b, c in zip(got[i], ref[i], npz[i]):
            assert a.dtype == b.dtype == c.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(c, b)
    # each reads the other's
    shutil.rmtree(dirs["npz"])
    shutil.copytree(dirs["jax"], dirs["npz"])
    reread = StaticEpisodeBank(dirs["npz"], "s3dis", **kw)
    assert reread.format == "h5"
    for i in (0, 14):
        for a, b in zip(reread[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    jax_reads = JaxBank(dirs["port"], "s3dis", **kw)
    for a, b in zip(jax_reads[3], got[3]):
        np.testing.assert_array_equal(a, b)
    # the on-the-fly episodes draw alike from the same generator state
    ds = EpisodeDataset(dirs["port"], "s3dis", n_way=2, k_shot=2,
                        num_point=NPTS)
    ref_ds = JaxEpisodes(dirs["jax"], "s3dis", n_way=2, k_shot=2,
                         num_point=NPTS)
    for a, b in zip(ds.__getitem__(3, rng=np.random.default_rng((321, 3))),
                    ref_ds.__getitem__(3, rng=np.random.default_rng((321,
                                                                     3)))):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        got[0]


def test_fewshot_metric_matches_jax():
    """intersection_and_union (with ignored points), fewshot_accumulate on
    an array and on a tensor, and fewshot_miou: equal to the JAX
    package's."""
    from gfs3dseg_gws_tpu.ops import metrics as jax_metrics
    from gfs3dseg_gws_tpu_torch.ops import metrics

    r = np.random.default_rng(3)
    pred = r.integers(0, 5, (3, 200))
    gt = r.integers(0, 5, (3, 200))
    gt[0, :17] = 255
    got = metrics.intersection_and_union(t(pred), t(gt), 5)
    ref = jax_metrics.intersection_and_union(jnp.asarray(pred),
                                             jnp.asarray(gt), 5)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    test_classes = [3, 5, 9, 11]
    cm_ref, cm_np = np.zeros((5, 5)), np.zeros((5, 5))
    cm_t = torch.zeros((5, 5), dtype=torch.float64)
    for label2class in ([9, 3], [11, 5], [3, 11]):
        cm_ep = r.integers(0, 50, (3, 3)).astype(np.float64)
        jax_metrics.fewshot_accumulate(cm_ref, cm_ep, label2class,
                                       test_classes)
        metrics.fewshot_accumulate(cm_np, cm_ep, label2class, test_classes)
        metrics.fewshot_accumulate(cm_t, t(cm_ep.astype(np.float32)),
                                   np.asarray(label2class, np.int32),
                                   test_classes)
    np.testing.assert_array_equal(cm_np, cm_ref)
    np.testing.assert_array_equal(cm_t.numpy(), cm_ref)
    miou, iou = metrics.fewshot_miou(cm_np)
    ref_miou, ref_iou = jax_metrics.fewshot_miou(cm_ref)
    assert miou == ref_miou
    np.testing.assert_array_equal(iou, ref_iou)


# --------------------------------------------------------------------------- #
# (b) ProtoNet
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("attention", [False, True], ids=["mapper", "att"])
@pytest.mark.parametrize("dist", ["cosine", "euclidean"])
def test_protonet_matches_jax(monkeypatch, dist, attention):
    """Eval mode: logits within 1e-4 and loss within 1e-5 relative of the
    JAX ProtoNet (random BatchNorm statistics, folded by K1's twin). One
    train step (support and query in two encoder calls each with its own
    batch statistics, the running statistics moved twice): see
    check_train_step, gradients within 1e-3, statistics within 1e-5. The
    attention's dropout is 0 on both sides (the JAX side's through a
    partial in its protonet module's namespace)."""
    from gfs3dseg_gws_tpu.models import attention as jax_attention
    from gfs3dseg_gws_tpu.models import protonet as jax_protonet_mod

    set_fp32()
    monkeypatch.setattr(jax_protonet_mod, "SelfAttention", functools.partial(
        jax_attention.SelfAttention, attn_dropout=0.0))
    model, variables = jax_protonet(1, dist, attention)
    port = port_load(ProtoNet(n_way=2, k_shot=2, dist_method=dist,
                              use_attention=attention, attn_dropout=0.0,
                              **NET), variables)
    episode = _episode(5)
    ref_logits, ref_loss = model.apply(variables,
                                       *map(jnp.asarray, episode), False)
    port.eval()
    with torch.no_grad():
        logits, loss = port(*map(t, episode))
    assert _rel(logits.numpy(), ref_logits) < 1e-4
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    check_train_step(port, model, variables, _episode(6), 1e-3, 1e-5)


def test_fewshot_optimizer_matches_optax_across_lr_drop():
    """Three Adam steps on the same gradients against the JAX package's
    optax.multi_transform (encoder at 1e-4, the rest at lr), StepLR on
    the iteration with step_size 2 so that both rates halve before the
    third step: every parameter within 1e-6."""
    import optax

    from gfs3dseg_gws_tpu.pipelines.baselines import (
        FewShotConfig as JaxFS, _make_optimizer)
    from gfs3dseg_gws_tpu_torch.parallel.optim import make_fewshot_optimizer

    _, variables = jax_protonet(2, "cosine", True)
    port = port_load(ProtoNet(n_way=2, k_shot=2, **NET), variables)
    lr = 0.01
    tx = _make_optimizer(JaxFS(lr=lr, step_size=2, gamma=0.5))
    params = variables["params"]
    state = tx.init(params)
    opt, sched = make_fewshot_optimizer(port, lr, 2, 0.5)
    assert [g["lr"] for g in opt.param_groups] == [1e-4, lr]
    stats = jax.device_get(variables["batch_stats"])
    r = np.random.default_rng(10)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(r.standard_normal(a.shape).astype(
                np.float32)), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        g_sd = fewshot_state_dict_from_jax(jax.device_get(grads), stats)
        for name, p in port.named_parameters():
            p.grad = g_sd[name].clone()
        opt.step()
        sched.step()
    ref = fewshot_state_dict_from_jax(jax.device_get(params), stats)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert sched.get_last_lr() == [1e-4 * 0.5, lr * 0.5]
