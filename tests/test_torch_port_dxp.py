"""The `data x points` mesh of the PyTorch port (`--mesh dxp`,
parallel/mesh.py::make_mesh_dxp) on the CPU, held to the port's single
process and to the JAX package.

Ranks are gloo processes spawned by `parallel/dryrun.py::run_ranks` on a
1 x 2 mesh (2 ranks, both along points) and a 2 x 2 mesh (4 ranks: data
index r // 2, points index r % 2); their functions are in
tests/torch_port_dxp_ranks.py. Tiny widths ((8, 8) x 3, k = 5, N = 96, the
sizes of tests/test_pipelines_mesh.py); inputs from numpy with a fixed
seed; weights cross with `state_dict_from_jax`. Tolerances:

* K1, K6 and K2's twins with local queries (rows [q0, q0 + N/S) against
  all N keys) equal the rows of the call over every query bit for bit, at
  S = 2 and 4, on random points and on the copied-point block of
  tests/test_torch_port_knn_ties.py (exact ties across the cut); K6's rows
  equal JAX `_knn_xla`'s, K2's are within 1e-6 of `_attention_xla`'s and
  K1's within 1e-5 of `_fused_edgeconv_xla`'s (the tolerance of
  test_torch_port_knn_ties.py, whose sums run in another order);
* `all_gather_points` equals `torch.cat` of the group's slices exactly and
  is counted;
* `GWCAPL.evaluate_multi` over each mesh against JAX `evaluate_multi` (XLA
  path): logits within 1e-5;
* `coding_step` over the 2 x 2 mesh against one process: the class sums
  and counts and the number of blocks with background equal (one-hot
  counts, exact), the sum of the blocks' background means within 1e-6
  (fp32 terms added in another order), on a batch with a block whose
  background lies on one points rank only and a block with none;
* `evaluate_gfs` over each mesh against the port's one process: per seed
  and per class within rtol 1e-5, atol 1e-6 (JAX's own
  test_pipelines_mesh.py:190-194), the base coding equal; against JAX
  `evaluate_gfs(mesh=None)` within MIOU_TOL (tests/test_torch_port_eval.py);
  `train_gfs` under the dxp mesh trains on the data mesh of all the ranks,
  its losses within 1e-4 of one process (tests/test_torch_port_dp.py);
* `train_cli --only_evaluate --mesh dxp --mesh_sp 2` under
  `torch.distributed.run --nproc_per_node 4` logs the mesh and one
  process's mIoU;
* the refusals: a world size that does not divide by mesh_sp, and N that
  does not divide by it.
"""
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

from chip_smoke import copied_block
from gfs3dseg_gws_tpu.ops.attention_kernel import _attention_xla
from gfs3dseg_gws_tpu.ops.fused_edgeconv import _fused_edgeconv_xla
from gfs3dseg_gws_tpu.ops.knn import _knn_xla
from gfs3dseg_gws_tpu_torch.ops.attention_kernel import fused_attention
from gfs3dseg_gws_tpu_torch.ops.fused_edgeconv import fused_edgeconv_infer
from gfs3dseg_gws_tpu_torch.ops.knn import knn_indices
from gfs3dseg_gws_tpu_torch.parallel import mesh as pmesh
from gfs3dseg_gws_tpu_torch.parallel.dryrun import run_ranks
from torch_port_util import TINY, jax_capl, one_thread, set_fp32, torch_capl

import torch_port_dxp_ranks as ranks

pytestmark = pytest.mark.usefixtures("one_thread")

NPTS, NUM_GW, K_SHOT, K = 96, 10, 2, 5
MESHES = {"1x2": (2, 2), "2x2": (4, 2)}        # ranks, ranks along points
LOGIT_TOL = 1e-5
MIOU_RTOL, MIOU_ATOL = 1e-5, 1e-6
MIOU_TOL = 2e-3                                 # port vs JAX
LOSS_TOL = 1e-4
WIDTHS = dict(edgeconv_widths=TINY["edgeconv_widths"],
              dgcnn_mlp_widths=TINY["mlp_widths"],
              base_widths=TINY["base_widths"], output_dim=TINY["output_dim"],
              main_dim=TINY["main_dim"], dgcnn_k=TINY["k"], pc_npts=NPTS)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------- #
# (a) the local-query twins of K1, K6 and K2
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def blocks():
    r = np.random.default_rng(7)
    return {"random": r.standard_normal((2, NPTS, 9)).astype(np.float32),
            "copied": copied_block()}


def _tables(x, seed=8, w=16):
    r = np.random.default_rng(seed)
    b, n, _ = x.shape
    a, bt = (r.standard_normal((b, n, w)).astype(np.float32)
             for _ in range(2))
    w2 = (r.standard_normal((w, w)) * 0.3).astype(np.float32)
    bias2 = (r.standard_normal(w) * 0.1).astype(np.float32)
    return a, bt, w2, bias2


def _local_call(kernel, x, tables, q0, nq):
    """The kernel's twin on query rows [q0, q0 + nq) against all of x."""
    xt = _t(x)
    if kernel == "k6":
        return knn_indices(xt, K, q0, nq)
    if kernel == "k2":
        return fused_attention(xt[:, q0:q0 + nq].contiguous(), xt, xt * 0.5,
                               3.0)
    a, bt, w2, bias2 = (_t(t) for t in tables)
    return fused_edgeconv_infer(xt, a, bt[:, q0:q0 + nq].contiguous(), w2,
                                bias2, K, q_offset=q0)


def _full_call(kernel, x, tables):
    return _local_call(kernel, x, tables, 0, x.shape[1])


@pytest.mark.parametrize("block", ["random", "copied"])
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("kernel", ["k1", "k6", "k2"])
def test_local_queries_equal_rows_of_the_full_call(blocks, kernel, sp,
                                                   block):
    x = blocks[block]
    tables = _tables(x)
    full = _full_call(kernel, x, tables)
    n = x.shape[1] // sp
    parts = [_local_call(kernel, x, tables, p * n, n) for p in range(sp)]
    for p, part in enumerate(parts):
        assert part.shape == full[:, p * n:(p + 1) * n].shape
        assert torch.equal(part, full[:, p * n:(p + 1) * n]), (kernel, p)
    assert torch.equal(torch.cat(parts, 1), full)


@pytest.mark.parametrize("kernel", ["k1", "k6", "k2"])
def test_local_queries_match_the_jax_rows(blocks, kernel):
    """The copied-point block's last quarter of queries (S = 4) against
    the JAX XLA path's rows of the whole block."""
    x = blocks["copied"]
    tables = _tables(x)
    n = x.shape[1] // 4
    got = _local_call(kernel, x, tables, 3 * n, n).numpy()
    xj = jnp.asarray(x)
    if kernel == "k6":
        ref = np.asarray(_knn_xla(xj, K))[:, 3 * n:]
        np.testing.assert_array_equal(got, ref)
        return
    if kernel == "k2":
        ref = np.asarray(_attention_xla(xj, xj, xj * 0.5, 3.0))[:, 3 * n:]
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        return
    ref = np.asarray(_fused_edgeconv_xla(
        xj, *(jnp.asarray(t) for t in tables), K, 0.2))[:, 3 * n:]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_local_queries_outside_the_block_raise(blocks):
    x = _t(blocks["random"])
    with pytest.raises(ValueError, match="query rows"):
        knn_indices(x, K, NPTS - 8, 16)


# --------------------------------------------------------------------------- #
# (b) the ranks: collectives, the model pass, the coding step, the pipelines
# --------------------------------------------------------------------------- #

def _capl_inputs(seed=11, b=4):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, NPTS, 9)).astype(np.float32)
    y = r.integers(0, 13, (b, NPTS)).astype(np.int64)
    gp = r.standard_normal((NUM_GW, 24)).astype(np.float32)
    gened = r.standard_normal((3, 13, TINY["main_dim"])).astype(np.float32)
    base = (r.random((7, NUM_GW)) < 0.3).astype(np.float32)
    novel = (r.random((3, 6, NUM_GW)) < 0.3).astype(np.float32)
    return x, y, gp, gened, base, novel


def _coding_inputs(seed=12, b=4):
    """Labels in 0..7 with no background in block 1 and block 0's
    background on points 0-29 alone (points rank 0 of 2 holds 0-47)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, NPTS, 9)).astype(np.float32)
    y = r.integers(1, 8, (b, NPTS)).astype(np.int64)
    y[0, :30] = 0
    y[2:, ::3] = 0
    return x, y


@pytest.fixture(scope="module")
def gfs_data(tmp_path_factory):
    """Synthetic blocks (20 train, 13 test: a final sweep batch of one real
    block, none of it on data index 1), a basis and a reference-layout
    `.pth` of the JAX initialisers with random BatchNorm."""
    from gfs3dseg_gws_tpu.data import make_synthetic_blocks
    from gfs3dseg_gws_tpu.utils.checkpoint import save_torch_gfs_checkpoint

    set_fp32()
    root = str(tmp_path_factory.mktemp("gfs_dxp"))
    train_dir, test_dir = make_synthetic_blocks(
        root, n_train_blocks=20, n_test_blocks=13, points_per_block=600,
        seed=21)
    basis = np.random.default_rng(22).standard_normal((NUM_GW, 24)).astype(
        np.float32)
    basis_path = os.path.join(root, "basis.pkl")
    with open(basis_path, "wb") as f:
        pickle.dump(basis, f)
    model, variables = jax_capl(num_gw=NUM_GW, npts=NPTS, seed=3)
    pth = os.path.join(root, "ckpt", "model.pth")
    save_torch_gfs_checkpoint(jax.device_get(variables["params"]),
                              jax.device_get(variables["batch_stats"]), pth)
    state = torch_capl(variables, num_gw=NUM_GW).state_dict()
    return dict(root=root, train_dir=train_dir, test_dir=test_dir,
                basis_path=basis_path, pth=pth, jax_model=model,
                variables=variables, state=state)


def _cfgs(gfs_data, tag):
    from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                     TrainConfig)

    data = DataConfig(dataset="s3dis", cvfold=0,
                      data_path=gfs_data["train_dir"],
                      testing_data_path=gfs_data["test_dir"],
                      pc_npts=NPTS, k_shot=K_SHOT)
    ev = TrainConfig(only_evaluate=True, eval_weight=1.2, batch_size=4,
                     basis_path=gfs_data["basis_path"],
                     model_checkpoint_path=gfs_data["pth"], device="cpu",
                     save_path=os.path.join(gfs_data["root"], tag, "eval"))
    tr = TrainConfig(epochs=1, batch_size=4, coding_interval=5,
                     basis_path=gfs_data["basis_path"], device="cpu", seed=5,
                     save_path=os.path.join(gfs_data["root"], tag, "train"))
    return ModelConfig(**WIDTHS), data, ev, tr


def _kwargs():
    return dict(classes=13, base_num=7, num_gw=NUM_GW, eval_weight=1.2,
                **TINY)


@pytest.fixture(scope="module")
def mesh_runs(gfs_data):
    """Every rank case, one spawn of each mesh."""
    x, y, gp, gened, base, novel = (_t(a) for a in _capl_inputs())
    cx, cy = (_t(a) for a in _coding_inputs())
    runs = {}
    for name, (n_ranks, sp) in MESHES.items():
        tasks = [("gather", (3,)),
                 ("evaluate_multi", (_kwargs(), gfs_data["state"], x, gp,
                                     gened, base, novel, y, 3)),
                 ("coding", (_kwargs(), gfs_data["state"], cx, cy, gp, 7)),
                 ("pipelines", _cfgs(gfs_data, name) + (2,))]
        runs[name] = run_ranks(ranks.run_all, n_ranks, "cpu", threads=1,
                               sp=sp, args=(tasks,))
    return runs


@pytest.fixture(scope="module")
def single_runs(gfs_data):
    """One process of the port: the pipelines and the coding step."""
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
    from gfs3dseg_gws_tpu_torch.parallel.steps import coding_step

    set_fp32()
    model = GWCAPL(**_kwargs())
    model.load_state_dict(gfs_data["state"])
    cx, cy = (_t(a) for a in _coding_inputs())
    gp = _t(_capl_inputs()[2])
    sums = [s.double() for s in coding_step(model, cx, cy, gp, 7)]
    out = ranks.pipelines(None, *_cfgs(gfs_data, "single"), 2)
    return dict(out, coding=sums)


@pytest.fixture(scope="module")
def jax_eval(gfs_data):
    from gfs3dseg_gws_tpu.pipelines import gfs as jax_gfs
    from gfs3dseg_gws_tpu.utils.config import (DataConfig, ModelConfig,
                                               TrainConfig)

    set_fp32()
    cfgs = (ModelConfig(use_pallas=False, **WIDTHS),
            DataConfig(dataset="s3dis", cvfold=0,
                       data_path=gfs_data["train_dir"],
                       testing_data_path=gfs_data["test_dir"],
                       pc_npts=NPTS, k_shot=K_SHOT),
            TrainConfig(only_evaluate=True, eval_weight=1.2, batch_size=8,
                        basis_path=gfs_data["basis_path"],
                        model_checkpoint_path=gfs_data["pth"],
                        save_path=os.path.join(gfs_data["root"], "jax")))
    return jax_gfs.evaluate_gfs(*cfgs, mesh=None)


def _case(runs, index):
    return [rank[index] for rank in runs]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_all_gather_points_equals_cat_and_is_counted(mesh_runs, mesh):
    n_ranks, sp = MESHES[mesh]
    got = _case(mesh_runs[mesh], 0)
    for r, res in enumerate(got):
        group = got[r - r % sp:r - r % sp + sp]
        assert torch.equal(res["got"], torch.cat([g["mine"] for g in group],
                                                 1))
        assert torch.equal(res["got"], res["want"])
        assert res["calls"] == 1 and res["collectives"] == 1
        assert res["bytes"] == res["got"].numel() * 4
        assert res["summed"].tolist() == [sp * (sp + 1) / 2] * 2


@pytest.fixture(scope="module")
def jax_logits(gfs_data):
    x, y, gp, gened, base, novel = _capl_inputs()
    logits, _, _ = gfs_data["jax_model"].apply(
        gfs_data["variables"], jnp.asarray(x), jnp.asarray(gp),
        jnp.asarray(gened), jnp.asarray(base), jnp.asarray(novel),
        jnp.asarray(y), jnp.asarray(3), method="evaluate_multi")
    return np.asarray(logits)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_evaluate_multi_matches_jax(mesh_runs, jax_logits, mesh):
    n_ranks, sp = MESHES[mesh]
    parts = _case(mesh_runs[mesh], 1)              # (S, B/D, N/S, cls)
    rows = [torch.cat(parts[d * sp:(d + 1) * sp], 2)
            for d in range(n_ranks // sp)]
    got = torch.cat(rows, 1).numpy()
    assert got.shape == jax_logits.shape
    np.testing.assert_allclose(got, jax_logits, rtol=0, atol=LOGIT_TOL)


def test_coding_step_over_2x2_equals_one_process(mesh_runs, single_runs):
    """The class sums and counts (one-hot, exact), the number of blocks
    with background (exact) and the sum of their background means, whose
    fp32 terms the ranks add in another order (within 1e-6): block 0's
    background sits on points rank 0 alone, block 1 has none."""
    sums, counts, bg_means, bg_blocks = single_runs["coding"]
    assert bg_blocks.item() == 3.0
    for got in _case(mesh_runs["2x2"], 2):
        np.testing.assert_array_equal(got[0].numpy(), sums.numpy())
        np.testing.assert_array_equal(got[1].numpy(), counts.numpy())
        np.testing.assert_allclose(got[2].numpy(), bg_means.numpy(),
                                   rtol=1e-6, atol=0)
        assert got[3].item() == bg_blocks.item()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_evaluate_gfs_equals_one_process(mesh_runs, single_runs, mesh):
    one = single_runs["eval"]
    assert one["coding_sweep"]
    for rank in _case(mesh_runs[mesh], 3):
        ev = rank["eval"]
        assert ev["coding_sweep"]
        np.testing.assert_array_equal(ev["base_coding"], one["base_coding"])
        np.testing.assert_allclose(ev["per_seed"], one["per_seed"],
                                   rtol=MIOU_RTOL, atol=MIOU_ATOL)
        np.testing.assert_allclose(ev["per_class"], one["per_class"],
                                   rtol=MIOU_RTOL, atol=MIOU_ATOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_evaluate_gfs_matches_jax(mesh_runs, jax_eval, mesh):
    ev = _case(mesh_runs[mesh], 3)[0]["eval"]
    for key in ("mean_iou", "base_iou", "novel_iou", "hm_iou"):
        assert abs(ev[key] - jax_eval[key]) <= MIOU_TOL, key
    np.testing.assert_allclose(ev["per_class"], jax_eval["per_class"],
                               rtol=0, atol=MIOU_TOL)


def test_evaluate_gfs_logs_the_data_x_points_mesh(gfs_data, mesh_runs):
    log = open(os.path.join(gfs_data["root"], "2x2", "eval",
                            "log_test.txt")).read()
    assert "data x points mesh {'data': 2, 'points': 2}" in log


def test_train_gfs_under_dxp_runs_the_data_mesh(gfs_data, mesh_runs,
                                                single_runs):
    """JAX's train_gfs ignores the mesh shape: the 2 x 2 mesh trains on the
    data mesh of its 4 ranks (a row a rank), losses as one process's."""
    log = open(os.path.join(gfs_data["root"], "2x2", "train",
                            "log_train.txt")).read()
    assert "data mesh of 4 rank(s)" in log and "data x points" not in log
    want = [h["loss"] for h in single_runs["train"]["history"]]
    for rank in _case(mesh_runs["2x2"], 3):
        got = [h["loss"] for h in rank["train"]["history"]]
        np.testing.assert_allclose(got, want, rtol=LOSS_TOL)


def test_dryrun_multichip_runs_the_dxp_evaluation_step():
    """dryrun_multichip over 4 ranks adds JAX's step 2: an evaluation pass
    on a 2 x 2 data x points mesh from the starting state, predictions
    (B, N) equal to one process's argmax of the same pass."""
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
    from gfs3dseg_gws_tpu_torch.parallel.dryrun import dryrun_multichip

    kw = dict(num_gw=NUM_GW, attn_dropout=0.0, **TINY)
    out = dryrun_multichip(4, "cpu", steps=1, batch=4, npts=64, seed=0,
                           threads=1, **kw)
    assert out["dxp_pred"].shape == (4, 64)
    model = GWCAPL(**kw)
    model.load_state_dict(out["init"])
    r = np.random.default_rng(2)           # dxp_evaluate's draw, seed + 2
    gened = _t(r.standard_normal((13, TINY["main_dim"])).astype(np.float32))
    with torch.inference_mode():
        logits, _, _ = model.evaluate(out["inputs"][0], out["inputs"][2],
                                      gened, torch.ones(7, NUM_GW),
                                      torch.ones(6, NUM_GW))
    assert torch.equal(out["dxp_pred"], logits.argmax(-1))


# --------------------------------------------------------------------------- #
# (c) the CLI under torchrun, and what the mesh refuses
# --------------------------------------------------------------------------- #

def test_train_cli_only_evaluate_under_torchrun_dxp(gfs_data, tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 4 --standalone -m
    ...train_cli --only_evaluate --mesh dxp --mesh_sp 2 --device cpu`: rc 0,
    rank 0 logs the 2 x 2 mesh and one process's mIoU. The CLI has no
    --main_dim: the checkpoint is a port model at the default 128."""
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import evaluate_gfs
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import save_gfs_npz
    from gfs3dseg_gws_tpu_torch.utils.config import ModelConfig, replace

    ckpt = str(tmp_path / "gfs.npz")
    save_gfs_npz(GWCAPL(num_gw=NUM_GW, eval_weight=1.2,
                        generator=torch.Generator().manual_seed(43),
                        **{**TINY, "main_dim": 128}), ckpt)
    model_cfg, data_cfg, ev, _ = _cfgs(gfs_data, "cli_single")
    one = evaluate_gfs(replace(model_cfg, main_dim=128), data_cfg,
                       replace(ev, model_checkpoint_path=ckpt))
    save = str(tmp_path / "cli")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "4", "--standalone", "-m", "gfs3dseg_gws_tpu_torch.cli.train_cli",
         "--phase", "test", "--only_evaluate",
         "--data_path", gfs_data["train_dir"],
         "--testing_data_path", gfs_data["test_dir"],
         "--basis_path", gfs_data["basis_path"],
         "--model_checkpoint_path", ckpt, "--save_path", save,
         "--pc_npts", str(NPTS), "--k_shot", str(K_SHOT), "--batch_size",
         "4", "--eval_weight", "1.2", "--dgcnn_k", str(TINY["k"]),
         "--edgeconv_widths", "[[8,8],[8,8],[8,8]]",
         "--dgcnn_mlp_widths", "[16,16]", "--base_widths", "[8,8]",
         "--output_dim", "8", "--mesh", "dxp", "--mesh_sp", "2",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=240,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr[-3000:]
    log = open(os.path.join(save, "log_test.txt")).read()
    assert "data x points mesh {'data': 2, 'points': 2}" in log
    found = re.search(r"Final mIoU: ([0-9.e-]+)", log)
    assert found and log.count("Final mIoU") == 1      # rank 0 alone
    np.testing.assert_allclose(float(found[1]), one["mean_iou"],
                               rtol=MIOU_RTOL, atol=MIOU_ATOL)


def test_make_mesh_dxp_refuses_a_world_that_does_not_divide():
    with pytest.raises(ValueError, match="not divisible by mesh_sp=2"):
        pmesh.make_mesh_dxp(2, rank=0, world_size=3)
    assert not torch.distributed.is_initialized()


def test_shard_points_refuses_points_that_do_not_divide():
    mesh = pmesh.Mesh(None, 1, 4, torch.device("cpu"), "gloo", sp=4,
                      kind="dxp")
    assert mesh.data_index == 0 and mesh.points_index == 1
    x = torch.arange(2 * 12 * 3).reshape(2, 12, 3)
    assert torch.equal(pmesh.shard_points(x, mesh), x[:, 3:6])
    with pytest.raises(ValueError, match="do not divide over mesh_sp=4"):
        pmesh.shard_points(x[:, :10], mesh)


def test_use_mesh_refuses_the_points_axis():
    """Training takes the data mesh; a dxp mesh with sp = 1 is one."""
    from gfs3dseg_gws_tpu_torch.models.layers import use_mesh

    mesh = pmesh.Mesh(None, 0, 4, torch.device("cpu"), "gloo", sp=2,
                      kind="dxp")
    with pytest.raises(ValueError, match="evaluation only"):
        use_mesh(torch.nn.Linear(2, 2), mesh)
    data = mesh.data_mesh()
    assert (data.sp, data.data_size, str(data)[:9]) == (1, 4, "data mesh")
