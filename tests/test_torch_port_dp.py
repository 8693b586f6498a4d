"""Data parallelism of the PyTorch port (parallel/mesh.py) on the CPU, held
to the JAX package on the global batch.

Ranks are gloo processes spawned by `parallel/dryrun.py::run_ranks`, which
meet through a file under a fresh directory (no TCP port, so that pytest
workers do not collide); their functions are in tests/torch_port_dp_ranks.py.
Tiny widths ((8, 8) x 3, k = 5, N = 64); inputs from numpy with a fixed
seed; weights cross with `state_dict_from_jax`. Tolerances:

* the GWCAPL train pass over 2 ranks (B = 8) and 3 (B = 6: rank 1 holds
  rows 2-3, so the fake half, rows 3-5, straddles it) against JAX
  `jax.grad` on the global batch with fake_row fixed: loss 1e-5 relative,
  summed gradients 1e-4 relative (`_check_grads`), BN running statistics
  1e-5, the fake prototypes 1e-5;
* one JAX mesh step (`make_gfs_train_step(model, make_mesh(2))`) against
  one port DP step: loss and BN statistics 1e-5;
* the DGCNNSeg pre-training step over 2 ranks against JAX at dropout 0:
  as the GWCAPL pass;
* DP against the port's single process with dropout and attention dropout
  on: masks bit for bit, loss 1e-5, gradients 1e-4 as against JAX (the
  ranks add their partial BatchNorm sums in another order than one
  process: gradients that come out of cancelling sums, as a BN scale's,
  then differ by up to ~2e-5 of their largest entry in fp32, with the
  masks equal and dropout off alike);
* `evaluate_gfs` over 2 ranks (13 test blocks, batch 4: a final batch of
  one real block, none of it on rank 1) against one process: per-seed
  mIoU 1e-6, the base coding equal; `train_gfs` over 2 ranks, 2 epochs of
  3 steps: loss history 1e-4, rank 1 writes no file, the JAX package
  restores rank 0's checkpoint; `pretrain` likewise (validation mIoU
  1e-6).
"""
import glob
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gfs3dseg_gws_tpu_torch.parallel.dryrun import run_ranks
from torch_port_util import TINY, one_thread, set_fp32, t, torch_capl

import torch_port_dp_ranks as ranks

pytestmark = pytest.mark.usefixtures("one_thread")

NPTS, NUM_GW, NCLS = 64, 10, 8
CAPL = dict(classes=13, base_num=7, num_gw=NUM_GW, eval_weight=1.2, **TINY)
SEG = dict(num_classes=NCLS, edgeconv_widths=TINY["edgeconv_widths"],
           mlp_widths=TINY["mlp_widths"], k=TINY["k"])
GRAD_TOL, LOSS_TOL, STAT_TOL = 1e-4, 1e-5, 1e-5


def _rel(got, ref, floor=1e-12):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), floor)


def _check_grads(grads, ref_sd, tol):
    """Every gradient within `tol` of the reference's (max |diff| over the
    larger of max |ref| and 1e-3 of the model's largest gradient); where
    the reference's is below 1e-5 of the largest (a conv bias before a
    train-mode BatchNorm: zero in exact arithmetic), both stay below it."""
    top = max(ref_sd[n].abs().max().item() for n in grads)
    for name, g in grads.items():
        ref = ref_sd[name].numpy()
        if np.abs(ref).max() < 1e-5 * top:
            assert np.abs(g.numpy()).max() < 1e-5 * top, name
            continue
        assert _rel(g.numpy(), ref, 1e-3 * top) < tol, name


def _check_stats(stats, ref_sd, tol):
    n = 0
    for name, buf in stats.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), ref_sd[name].numpy(),
                                       rtol=tol, atol=tol / 10, err_msg=name)
            n += 1
    assert n


def _capl_batch(b, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, NPTS, 9)).astype(np.float32)
    y = r.integers(0, 8, (b, NPTS)).astype(np.int64)
    y[0, :5] = 255                               # ignored by both losses
    gp = r.standard_normal((NUM_GW, 24)).astype(np.float32)
    fake = np.zeros(13, np.float32)
    fake[[1, 4, 6]] = 1.0
    return x, y, gp, fake


def _jax_capl():
    """The JAX GWCAPL at the tiny widths (XLA path, attention dropout 0),
    its variables with random BatchNorm, and the port's state dict of them
    (as torch_port_util.jax_capl / torch_capl, with the init jitted)."""
    from gfs3dseg_gws_tpu.models.capl import GWCAPL as JaxGWCAPL
    from torch_port_util import randomize_bn

    model = JaxGWCAPL(use_pallas=False, attn_dropout=0.0, **CAPL)
    rng = jax.random.PRNGKey(4)
    variables = jax.jit(lambda r: model.init(
        {"params": r, "dropout": r, "fake": r}, jnp.zeros((2, NPTS, 9)),
        jnp.zeros((2, NPTS), jnp.int32), jnp.zeros((NUM_GW, 24)),
        train=True))(rng)
    variables = randomize_bn(variables, 104)
    state = torch_capl(variables, num_gw=NUM_GW,
                       attn_dropout=0.0).state_dict()
    return model, variables, state


def _jax_capl_pass(model, variables, x, y, gp, fake):
    """JAX value_and_grad of the train pass on the global batch (jitted),
    and the fake prototypes its generate_fake_proto built."""
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import state_dict_from_jax

    args = tuple(map(jnp.asarray, (x, y, gp)))

    def loss_fn(params):
        (_, loss), upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *args, True, fake_row=jnp.asarray(fake),
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda _, name:
                name == "generate_fake_proto")
        return loss, upd

    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    stats = upd["batch_stats"]
    proto = upd["intermediates"]["generate_fake_proto"][0][0]
    return {"loss": float(loss), "proto": np.asarray(proto),
            "grads": state_dict_from_jax(jax.device_get(grads),
                                         jax.device_get(stats)),
            "stats": state_dict_from_jax(jax.device_get(variables["params"]),
                                         jax.device_get(stats))}


def _seg_setup():
    from gfs3dseg_gws_tpu.models.dgcnnseg import DGCNNSeg as JaxDGCNNSeg
    from gfs3dseg_gws_tpu.models.layers import cross_entropy as jax_ce
    from gfs3dseg_gws_tpu_torch.models.dgcnnseg import DGCNNSeg
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import (
        pretrain_state_dict_from_jax)
    from torch_port_util import randomize_bn

    model = JaxDGCNNSeg(num_classes=NCLS, use_pallas=False, dropout=0.0,
                        edgeconv_widths=SEG["edgeconv_widths"],
                        mlp_widths=SEG["mlp_widths"], k=SEG["k"])
    rng = jax.random.PRNGKey(3)
    variables = randomize_bn(jax.jit(lambda r: model.init(
        {"params": r, "dropout": r}, jnp.zeros((2, NPTS, 9)), True))(rng), 9)
    r = np.random.default_rng(11)
    x = r.standard_normal((4, NPTS, 9)).astype(np.float32)
    y = r.integers(0, NCLS, (4, NPTS)).astype(np.int64)

    def loss_fn(params):
        logits, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(y)), upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    port = DGCNNSeg(dropout=0.0, **SEG)
    state = pretrain_state_dict_from_jax(
        jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"]))
    port.load_state_dict(state, strict=True)
    ref = {"loss": float(loss),
           "grads": pretrain_state_dict_from_jax(jax.device_get(grads),
                                                 jax.device_get(stats)),
           "stats": pretrain_state_dict_from_jax(
               jax.device_get(variables["params"]), jax.device_get(stats))}
    return state, t(x), t(y), ref


def _jax_mesh_step(model, variables, x, y, gp):
    """One JAX mesh step over 2 devices; returns (loss, new batch_stats as
    a state dict, the fake_row its generator drew)."""
    from gfs3dseg_gws_tpu.parallel import (TrainState, make_gfs_optimizer,
                                           make_gfs_train_step, make_mesh,
                                           replicate, shard_batch)
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import state_dict_from_jax

    mesh = make_mesh(2)
    tx = make_gfs_optimizer(1e-3, steps_per_epoch=10)
    state = replicate(TrainState.create(variables["params"],
                                        variables["batch_stats"], tx), mesh)
    rng = jax.random.PRNGKey(7)
    step = make_gfs_train_step(model, mesh, donate=False)
    state, loss, _ = step(state, shard_batch(jnp.asarray(x), mesh),
                          shard_batch(jnp.asarray(y, jnp.int32), mesh),
                          replicate(jnp.asarray(gp), mesh), rng)
    # the step's draw (steps.py: split(fold_in(rng, step)); capl.py:
    # make_rng("fake"), then generate_fake_proto's noise-argsort)
    r_fake = jax.random.split(jax.random.fold_in(rng, 0))[1]
    key = model.apply(variables, rngs={"fake": r_fake},
                      method=lambda m: m.make_rng("fake"))
    counts = np.bincount(np.asarray(y[y.shape[0] // 2:]).ravel(),
                         minlength=14)
    present = counts[1:14] > 0
    noise = np.asarray(jax.random.uniform(key, (13,)))
    score = np.where(present, noise, -1.0)
    rank = np.argsort(np.argsort(-score, kind="stable"), kind="stable")
    fake = (present & (rank < present.sum() // 2)).astype(np.float32)
    stats = state_dict_from_jax(jax.device_get(variables["params"]),
                                jax.device_get(state.batch_stats))
    return float(loss), stats, fake


@pytest.fixture(scope="module")
def capl_setup():
    set_fp32()
    return _jax_capl()


@pytest.fixture(scope="module")
def two_ranks(capl_setup):
    """Every 2-rank case but the pipelines' in one spawn, with its
    references: JAX for the fake_row-pinned GWCAPL pass, the mesh step and
    the DGCNNSeg step; the port's single process for the dropout runs."""
    model, variables, state = capl_setup
    x, y, gp, fake = _capl_batch(8, 6)
    capl_ref = _jax_capl_pass(model, variables, x, y, gp, fake)
    step_loss, step_stats, step_fake = _jax_mesh_step(model, variables, x, y,
                                                      gp)
    seg_state, sx, sy, seg_ref = _seg_setup()
    drop = dict(CAPL, attn_dropout=0.1)
    seg_drop = dict(SEG, dropout=0.3)
    tasks = [
        ("capl_pass", (dict(CAPL, attn_dropout=0.0), state, t(x), t(y),
                       t(gp), t(fake))),
        ("capl_step", (dict(CAPL, attn_dropout=0.0), state, t(x), t(y),
                       t(gp), t(step_fake))),
        ("seg_pass", (dict(SEG, dropout=0.0), seg_state, sx, sy)),
        ("capl_pass", (drop, state, t(x), t(y), t(gp), None, 5)),
        ("seg_pass", (seg_drop, seg_state, sx, sy, 6)),
    ]
    got = run_ranks(ranks.run_all, 2, "cpu", args=(tasks,), threads=1)
    single = {"capl": ranks.capl_pass(None, *tasks[3][1]),
              "seg": ranks.seg_pass(None, *tasks[4][1])}
    return dict(capl=(got[0][0], capl_ref), step=(got, step_loss, step_stats),
                seg=(got[0][2], seg_ref),
                drop={"capl": ([g[3] for g in got], single["capl"]),
                      "seg": ([g[4] for g in got], single["seg"])})


@pytest.fixture(scope="module")
def three_ranks(capl_setup):
    """The GWCAPL pass over 3 ranks at B = 6: rank 1 holds rows 2-3 of the
    fake half 3-5."""
    model, variables, state = capl_setup
    x, y, gp, fake = _capl_batch(6, 12)
    ref = _jax_capl_pass(model, variables, x, y, gp, fake)
    got = run_ranks(ranks.run_all, 3, "cpu", threads=1, args=([
        ("capl_pass", (dict(CAPL, attn_dropout=0.0), state, t(x), t(y),
                       t(gp), t(fake)))],))
    return got[0][0], ref


@pytest.fixture(scope="module", params=[2, 3], ids=["R2_B8", "R3_B6"])
def capl_runs(request, two_ranks, three_ranks):
    return two_ranks["capl"] if request.param == 2 else three_ranks


# --------------------------------------------------------------------------- #
# (a) the GWCAPL train pass against JAX on the global batch
# --------------------------------------------------------------------------- #

def test_capl_pass_loss_matches_jax(capl_runs):
    got, ref = capl_runs
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_TOL)


def test_capl_pass_summed_gradients_match_jax(capl_runs):
    got, ref = capl_runs
    _check_grads(got["grads"], ref["grads"], GRAD_TOL)


def test_capl_pass_bn_running_stats_match_jax(capl_runs):
    got, ref = capl_runs
    _check_stats(got["stats"], ref["stats"], STAT_TOL)


def test_capl_pass_fake_prototypes_match_jax(capl_runs):
    """The prototypes the fake half builds, all-reduced over the ranks that
    hold it (at R = 3 rank 0 holds none of it, rank 1 one row of it)."""
    got, ref = capl_runs
    np.testing.assert_allclose(got["proto"].numpy(), ref["proto"],
                               rtol=STAT_TOL, atol=STAT_TOL)


# --------------------------------------------------------------------------- #
# (b) one JAX mesh step against one port DP step
# --------------------------------------------------------------------------- #

def test_mesh_step_loss_matches_jax_mesh_step(two_ranks):
    got, loss, _ = two_ranks["step"]
    for rank in got:                  # every rank reports the global loss
        np.testing.assert_allclose(rank[1]["loss"], loss, rtol=LOSS_TOL)


def test_mesh_step_bn_statistics_match_jax_mesh_step(two_ranks):
    got, _, stats = two_ranks["step"]
    for rank in got:
        _check_stats(rank[1]["state"], stats, STAT_TOL)


# --------------------------------------------------------------------------- #
# (c) the DGCNNSeg pre-training step against JAX
# --------------------------------------------------------------------------- #

def test_pretrain_step_loss_matches_jax(two_ranks):
    got, ref = two_ranks["seg"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_TOL)


def test_pretrain_step_summed_gradients_match_jax(two_ranks):
    got, ref = two_ranks["seg"]
    _check_grads(got["grads"], ref["grads"], GRAD_TOL)


def test_pretrain_step_bn_running_stats_match_jax(two_ranks):
    got, ref = two_ranks["seg"]
    _check_stats(got["stats"], ref["stats"], STAT_TOL)


# --------------------------------------------------------------------------- #
# (d) dropout on: the ranks draw the single process's masks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("model", ["capl", "seg"])
def test_dropout_masks_equal_the_single_process(two_ranks, model):
    """The attention's (K5's hash, batch_offset = rank * B/R) and the
    segmenter's masks of the ranks' rows, concatenated, are the single
    process's bit for bit."""
    got, single = two_ranks["drop"][model]
    assert single["masks"]
    for i, mask in enumerate(single["masks"]):
        assert mask.float().mean() < 1.0          # some are dropped
        assert torch.equal(torch.cat([g["masks"][i] for g in got]), mask)


@pytest.mark.parametrize("model", ["capl", "seg"])
def test_dropout_loss_and_gradients_equal_the_single_process(two_ranks,
                                                             model):
    got, single = two_ranks["drop"][model]
    for rank in got:
        np.testing.assert_allclose(rank["loss"], single["loss"],
                                   rtol=LOSS_TOL)
    if model == "capl":                # the fake rows the generator drew
        pred = torch.cat([g["pred"] for g in got])
        assert torch.equal(pred, single["pred"])
    _check_grads(got[0]["grads"], single["grads"], GRAD_TOL)


@pytest.mark.parametrize("offset", [0, 3, 5])
def test_dropout_keep_mask_offset_takes_rows_of_the_global_mask(offset):
    from gfs3dseg_gws_tpu_torch.ops.attention_train import dropout_keep_mask

    whole = dropout_keep_mask(1234, 8, 40, 0.3)
    part = dropout_keep_mask(torch.tensor([1234], dtype=torch.int32), 3, 40,
                             0.3, batch_offset=offset)
    assert torch.equal(part, whole[offset:offset + 3])
    if offset == 0:                    # today's mask, bit for bit
        assert torch.equal(part, dropout_keep_mask(1234, 3, 40, 0.3))


# --------------------------------------------------------------------------- #
# (f), (g) evaluate_gfs and train_gfs over 2 ranks
# --------------------------------------------------------------------------- #

GFS_NPTS = 96
WIDTHS = dict(edgeconv_widths=TINY["edgeconv_widths"],
              dgcnn_mlp_widths=TINY["mlp_widths"],
              base_widths=TINY["base_widths"], output_dim=TINY["output_dim"],
              main_dim=TINY["main_dim"], dgcnn_k=TINY["k"], pc_npts=GFS_NPTS)


@pytest.fixture(scope="module")
def gfs_data(tmp_path_factory):
    """Synthetic blocks (40 train: every base class in at least 10, so that
    pre-training holds some out for validation; 13 test), a basis and a
    GFS checkpoint of seeded random weights at the tiny widths."""
    from gfs3dseg_gws_tpu_torch.data import make_synthetic_blocks
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import save_gfs_npz

    root = str(tmp_path_factory.mktemp("gfs_dp"))
    train_dir, test_dir = make_synthetic_blocks(
        root, n_train_blocks=40, n_test_blocks=13, points_per_block=500,
        seed=41)
    basis = np.random.default_rng(42).standard_normal((NUM_GW, 24)).astype(
        np.float32)
    basis_path = os.path.join(root, "basis.pkl")
    with open(basis_path, "wb") as f:
        pickle.dump(basis, f)
    model = GWCAPL(num_gw=NUM_GW, eval_weight=1.2,
                   generator=torch.Generator().manual_seed(43), **TINY)
    ckpt = os.path.join(root, "gfs.npz")
    save_gfs_npz(model, ckpt)
    return dict(root=root, train_dir=train_dir, test_dir=test_dir,
                basis_path=basis_path, ckpt=ckpt)


def _cfgs(gfs_data, tag):
    from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                     PretrainConfig,
                                                     TrainConfig)

    data = DataConfig(dataset="s3dis", cvfold=0,
                      data_path=gfs_data["train_dir"],
                      testing_data_path=gfs_data["test_dir"],
                      pc_npts=GFS_NPTS, k_shot=2, pc_augm=True)
    common = dict(basis_path=gfs_data["basis_path"], batch_size=4,
                  device="cpu", seed=5)
    ev = TrainConfig(only_evaluate=True, eval_weight=1.2,
                     model_checkpoint_path=gfs_data["ckpt"],
                     save_path=os.path.join(gfs_data["root"], tag, "eval"),
                     **common)
    tr = TrainConfig(epochs=2, eval_interval=1, coding_interval=5,
                     save_path=os.path.join(gfs_data["root"], tag, "train"),
                     **common)
    pre = PretrainConfig(batch_size=4, n_iters=2, eval_interval=1,
                         device="cpu", seed=5,
                         log_dir=os.path.join(gfs_data["root"], tag, "pre"))
    return ModelConfig(**WIDTHS), data, ev, tr, pre


@pytest.fixture(scope="module")
def pipeline_runs(gfs_data):
    set_fp32()
    single = ranks.pipelines(None, *_cfgs(gfs_data, "single"), 3)
    dp = run_ranks(ranks.pipelines, 2, "cpu", threads=1,
                   args=_cfgs(gfs_data, "dp") + (3,))
    return single, dp


def test_evaluate_gfs_over_two_ranks_equals_one_process(pipeline_runs):
    single, dp = pipeline_runs
    assert single["eval"]["coding_sweep"] and dp[0]["eval"]["coding_sweep"]
    for rank in dp:
        np.testing.assert_array_equal(rank["eval"]["base_coding"],
                                      single["eval"]["base_coding"])
        np.testing.assert_allclose(rank["eval"]["per_seed"],
                                   single["eval"]["per_seed"], rtol=0,
                                   atol=1e-6)


def test_evaluate_gfs_over_two_ranks_logs_one_process_gp_accuracies(
        gfs_data, pipeline_runs):
    """The gp and gp-novel accuracies that rank 0 logs for each seed's
    sweep: per batch the ratios over all the ranks' points (numerators
    and counts all-reduced), as one process logs them, within 1e-4 (one
    unit of the logged fourth decimal)."""
    def logged(tag):
        text = open(os.path.join(gfs_data["root"], tag, "eval",
                                 "log_test.txt")).read()
        return np.array(re.findall(
            r"gp acc: ([0-9.]+), gp_novel_acc: ([0-9.]+)", text), float)

    ref, got = logged("single"), logged("dp")
    assert ref.shape == got.shape and ref.shape[0] >= 1
    assert ref[:, 1].max() > 0                  # the sweep has novel points
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_train_gfs_over_two_ranks_follows_one_process(pipeline_runs):
    single, dp = pipeline_runs
    ref = single["train"]["history"]
    assert [h["steps"] for h in ref] == [3, 3]
    for rank in dp:
        hist = rank["train"]["history"]
        assert [h["steps"] for h in hist] == [3, 3]
        np.testing.assert_allclose([h["loss"] for h in hist],
                                   [h["loss"] for h in ref], rtol=1e-4)
        assert rank["train"]["step"] == single["train"]["step"] == 6


def test_pretrain_over_two_ranks_follows_one_process(pipeline_runs):
    """pretrain() over 2 ranks, 2 epochs of 3 steps with dropout 0.3 (the
    masks drawn for the global batch) and validation after each: the loss
    history within 1e-4 and the validation mIoU within 1e-6 of one
    process."""
    single, dp = pipeline_runs
    ref = single["pretrain"]["history"]
    for rank in dp:
        hist = rank["pretrain"]["history"]
        assert [h["steps"] for h in hist] == [h["steps"] for h in ref] \
            == [3, 3]
        np.testing.assert_allclose([h["loss"] for h in hist],
                                   [h["loss"] for h in ref], rtol=1e-4)
        np.testing.assert_allclose([h["miou"] for h in hist],
                                   [h["miou"] for h in ref], rtol=0,
                                   atol=1e-6)


def test_only_rank_zero_writes(gfs_data, pipeline_runs):
    """Rank 1 opened no file for writing under any save_path; rank 0 wrote
    what one process writes."""
    _, dp = pipeline_runs
    assert dp[1]["writes"] == []
    for run in ("eval", "train", "pre"):
        files = {re.split("[_.]", os.path.basename(p))[0] for p in glob.glob(
            os.path.join(gfs_data["root"], "dp", run, "*"))}
        ref = {re.split("[_.]", os.path.basename(p))[0] for p in glob.glob(
            os.path.join(gfs_data["root"], "single", run, "*"))}
        assert files == ref and files


def test_jax_restores_the_data_parallel_checkpoint(gfs_data, pipeline_runs,
                                                   capl_setup):
    from gfs3dseg_gws_tpu.utils.checkpoint import (load_checkpoint,
                                                   restore_into)

    path = sorted(glob.glob(os.path.join(gfs_data["root"], "dp", "train",
                                         "train_*.npz")),
                  key=os.path.getmtime)[-1]
    _, variables, _ = capl_setup
    flat, meta = load_checkpoint(path)
    restored = restore_into(
        {"params": jax.device_get(variables["params"]),
         "batch_stats": jax.device_get(variables["batch_stats"])}, flat,
        strict=True)
    assert set(meta) == {"epoch", "max_iou"} and restored["params"]


# --------------------------------------------------------------------------- #
# dryrun_multichip and the chip check's replay of its steps
# --------------------------------------------------------------------------- #

def test_dryrun_multichip_steps_equal_their_one_process_replay():
    """dryrun_multichip over 2 ranks recording their K3 graphs and K4a
    slots (chip_smoke.py's `dp_rank`; attention dropout 0.1, fake classes
    drawn, 2 Adam steps) and chip_smoke.py's `replay_dp_step` of each step
    in one process: loss and running statistics within 1e-5, every
    gradient's cosine >= 0.99999 (chip_smoke.DP_COS) and its norm within
    chip_smoke.DP_NORM of the ranks', no graph row or K4a slot differs; 29
    all-reduces a step on every rank."""
    import chip_smoke as cs
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
    from gfs3dseg_gws_tpu_torch.parallel.dryrun import dryrun_multichip

    kw = dict(TINY, num_gw=12, attn_dropout=0.1)
    out = dryrun_multichip(2, "cpu", steps=2, batch=8, npts=NPTS,
                           seed=cs.SEED, threads=1, rank_fn=cs.dp_rank, **kw)
    assert [r["collectives"] for r in out["ranks"]] == [[29, 29]] * 2
    model = GWCAPL(**kw)
    for step in range(2):
        loss, grads, stats, rows, flips = cs.replay_dp_step(
            model, out, step, torch.device("cpu"))
        np.testing.assert_allclose(loss, out["loss"][step], rtol=LOSS_TOL)
        assert rows == [0, 0, 0] and flips == [0, 0, 0]
        after = out["states"][1] if step == 0 else out["final_state"]
        _check_stats({n: v.float() for n, v in stats.items()},
                     after, STAT_TOL)
        for name, g in grads.items():
            ref = out["grads"][step][name].double().flatten()
            if ref.norm() > 1e-6:
                assert (g @ ref / (g.norm() * ref.norm())).item() \
                    >= cs.DP_COS, name
                assert abs((g.norm() / ref.norm()).item() - 1.0) \
                    <= cs.DP_NORM, name


def test_dryrun_multichip_follows_the_one_process_trajectory():
    """dryrun_multichip over 2 ranks (`gfs_ranks`, 3 Adam steps, attention
    dropout 0.1) against chip_smoke.py's `one_process_steps` from the same
    start on the global batch: the losses within 1e-5 relative. This
    holds the gradient all-reduce and the Adam updates end to end. Adam's
    step is blind to a gradient's uniform scale, which the replay test's
    norm ratio holds. The states are not compared: a bias before a
    BatchNorm has a gradient of rounding noise (~1e-8), which Adam turns
    into a step of +-lr either way."""
    import chip_smoke as cs
    from gfs3dseg_gws_tpu_torch.parallel.dryrun import dryrun_multichip

    kw = dict(TINY, num_gw=12, attn_dropout=0.1)
    out = dryrun_multichip(2, "cpu", steps=3, batch=8, npts=NPTS,
                           seed=cs.SEED, threads=1, **kw)
    assert "graphs" not in out and len(out["ranks"]) == 2
    losses, _ = cs.one_process_steps(out, torch.device("cpu"), **kw)
    np.testing.assert_allclose(out["loss"], losses, rtol=LOSS_TOL)


# --------------------------------------------------------------------------- #
# (h)-(j) the CLI under torchrun, and what the mesh refuses
# --------------------------------------------------------------------------- #

def test_train_cli_under_torchrun_trains_data_parallel(gfs_data, tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2 --standalone -m
    ...train_cli --device cpu` trains one epoch on 2 gloo ranks; rank 0
    logs the epoch and the run leaves no rank's error."""
    save = str(tmp_path / "cli")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--standalone", "-m", "gfs3dseg_gws_tpu_torch.cli.train_cli",
         "--data_path", gfs_data["train_dir"],
         "--testing_data_path", gfs_data["test_dir"],
         "--basis_path", gfs_data["basis_path"], "--save_path", save,
         "--pc_npts", str(GFS_NPTS), "--k_shot", "2", "--batch_size", "4",
         "--epochs", "1", "--dgcnn_k", str(TINY["k"]),
         "--edgeconv_widths", "[[8,8],[8,8],[8,8]]",
         "--dgcnn_mlp_widths", "[16,16]", "--base_widths", "[8,8]",
         "--output_dim", "8", "--mesh", "data", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=240,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr[-3000:]
    log = open(os.path.join(save, "log_train.txt")).read()
    assert "Train result at epoch [0/1]" in log
    assert log.count("Train result") == 1          # one writer: rank 0


def test_mesh_dxp_over_ranks_that_do_not_divide_raises(monkeypatch):
    """`--mesh dxp --mesh_sp 2` under three ranks: the world does not
    divide by the points axis, which raises before any rendezvous (JAX
    make_mesh_dxp raises ValueError likewise)."""
    from gfs3dseg_gws_tpu_torch.cli.common import mesh_from_env

    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="not divisible by mesh_sp=2"):
        mesh_from_env("cpu", "dxp", 2)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device", ["cuda", "cuda:1"])
def test_make_mesh_refuses_nccl_with_two_ranks_on_one_card(monkeypatch,
                                                           device):
    """NCCL takes a card a rank: two local ranks on a host with one card
    raise before any process group is made."""
    from gfs3dseg_gws_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks"):
        pmesh.make_mesh(device=device, rank=1, world_size=2)
    assert not torch.distributed.is_initialized()
