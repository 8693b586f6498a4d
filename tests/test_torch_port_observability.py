"""The port's spans and counters (utils/observability.py): the plain and
profiled books, the spans in the port's own loops (the evaluation sweep,
the train step, the native pool), `train_cli --trace_dir`, and the
per-layer metric readers of source `program_span` that read them.

No JAX here: on the GPU host the file runs whole, and its `cuda` test
checks a `--trace_dir` trace's op spans around their kernels:

    python -m pytest -p no:cacheprovider --noconftest \
        tests/test_torch_port_observability.py
"""
import glob
import importlib.util
import json
import os
import pickle
import sys
import threading
import time

import numpy as np
import pytest
import torch

from gfs3dseg_gws_tpu_torch.utils import observability as obs
from gfs3dseg_gws_tpu_torch.utils.observability import (calls, count,
                                                         snapshot, span)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "portbench")
NPTS, NUM_GW, K_SHOT = 96, 10, 2
TINY = dict(edgeconv_widths=((8, 8), (8, 8), (8, 8)),
            dgcnn_mlp_widths=(16, 16), base_widths=(8, 8), output_dim=8,
            main_dim=16, dgcnn_k=5, pc_npts=NPTS)
TINY_ARGS = ["--pc_npts", str(NPTS), "--dgcnn_k", "5",
             "--edgeconv_widths", "[[8,8],[8,8],[8,8]]",
             "--dgcnn_mlp_widths", "[16,16]", "--base_widths", "[8,8]",
             "--output_dim", "8"]


@pytest.fixture(autouse=True)
def clean_books():
    """Each test starts from empty books, on one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.reset()
    yield
    obs.reset()
    torch.set_num_threads(threads)


def _spans(book="plain"):
    return snapshot()[book]["spans"]


def _trace_events(prof, path):
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)


# --------------------------------------------------------------------------- #
# the facility
# --------------------------------------------------------------------------- #

def test_spans_without_a_profiler_keep_the_plain_book(monkeypatch):
    """With no profiler running, nested spans add calls and nanoseconds
    under their paths to the plain book, and never open a record_function
    (made to raise here)."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    for _ in range(3):
        with span("outer"):
            with span("inner"):
                time.sleep(0.001)
    spans = _spans()
    assert set(spans) == {"outer", "outer/inner"}
    assert spans["outer"]["calls"] == spans["outer/inner"]["calls"] == 3
    assert spans["outer"]["ns"] >= spans["outer/inner"]["ns"] >= 3e6
    assert _spans("profiled") == {}


def test_spans_under_a_profiler_land_in_the_trace_on_its_clock(tmp_path):
    """Under torch.profiler nested spans go to the profiled book with their
    paths, and the exported trace holds them as gfs3d.* user annotations
    whose edges (ts x 1000 + baseTimeNanoseconds) lie within 1 ms of
    time.time_ns() read around them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        before = time.time_ns()
        with span("outer"):
            with span("inner"):
                torch.ones(64).sum()
        after = time.time_ns()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert _spans() == {}
    assert {p: e["calls"] for p, e in _spans("profiled").items()} == {
        "outer": 1, "outer/inner": 1}
    trace = _trace_events(prof, str(tmp_path / "t.json"))
    base = trace["baseTimeNanoseconds"]
    found = {e["name"]: e for e in trace["traceEvents"]
             if e.get("name", "").startswith(obs.PREFIX)}
    assert set(found) == {"gfs3d.outer", "gfs3d.inner"}
    for e in found.values():
        assert e["cat"] == "user_annotation"
        start = e["ts"] * 1000 + base
        end = start + e["dur"] * 1000
        assert before - 1e6 <= start <= end <= after + 1e6


def test_counters_take_the_current_path_and_book():
    from torch.profiler import ProfilerActivity, profile

    count("bytes", 3)
    with span("a"):
        count("bytes", 4)
        count("bytes", 5)
    with profile(activities=[ProfilerActivity.CPU]):
        with span("a"):
            count("bytes", 7)
    snap = snapshot()
    assert snap["plain"]["counters"] == {"bytes": 3, "a/bytes": 9}
    assert snap["profiled"]["counters"] == {"a/bytes": 7}
    assert calls("a", snap) == 2
    obs.reset()
    assert snapshot() == {b: {"spans": {}, "counters": {}}
                          for b in obs.BOOKS}


def test_add_calls_counts_at_full_paths_without_host_time():
    """add_calls (a replayed CUDA graph's launches) adds calls and no
    nanoseconds at the full paths it is given, whatever span is open, to
    the spans that ran and to paths no span opened yet."""
    with span("train_step"):
        with span("op.k3"):
            pass
    ns = _spans()["train_step/op.k3"]["ns"]
    with span("train_step"):
        obs.add_calls({"train_step/op.k3": 2, "op.k4b": 3})
    spans = _spans()
    assert spans["train_step/op.k3"] == {"calls": 3, "ns": ns}
    assert spans["op.k4b"] == {"calls": 3, "ns": 0}
    assert spans["train_step"]["calls"] == 2
    assert calls("op.k3") == 3 and calls("op.k4b") == 3


def test_threads_keep_their_own_stacks_and_lose_no_call():
    """More threads than cores, switching every few microseconds: each
    keeps its own stack (no span parents another thread's), and the merged
    books count every call."""
    n_threads, n_calls = 4 * (os.cpu_count() or 1), 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            with span(f"t{i % 3}"):
                for _ in range(n_calls):
                    with span("leaf"):
                        count("n")
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = snapshot()
    assert calls("leaf", snap) == n_threads * n_calls
    assert set(snap["plain"]["spans"]) == {
        f"t{j}" for j in range(3)} | {f"t{j}/leaf" for j in range(3)}
    assert sum(snap["plain"]["counters"].values()) == n_threads * n_calls


def test_an_exception_closes_the_span():
    with pytest.raises(ValueError):
        with span("outer"):
            with span("inner"):
                raise ValueError
    with span("after"):
        pass
    assert set(_spans()) == {"outer", "outer/inner", "after"}


# --------------------------------------------------------------------------- #
# the spans in the port's loops (CPU, tiny widths)
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def gfs_data(tmp_path_factory):
    """Synthetic S3DIS-layout blocks and a basis."""
    from gfs3dseg_gws_tpu_torch.data import make_synthetic_blocks

    root = str(tmp_path_factory.mktemp("obs"))
    train_dir, test_dir = make_synthetic_blocks(
        root, n_train_blocks=40, n_test_blocks=13, points_per_block=300,
        seed=41)
    basis = np.random.default_rng(42).standard_normal((NUM_GW, 24)).astype(
        np.float32)
    basis_path = os.path.join(root, "basis.pkl")
    with open(basis_path, "wb") as f:
        pickle.dump(basis, f)
    return dict(root=root, train_dir=train_dir, test_dir=test_dir,
                basis=basis, basis_path=basis_path)


def _setup(gfs_data):
    from gfs3dseg_gws_tpu_torch.pipelines import gfs
    from gfs3dseg_gws_tpu_torch.utils.config import (DataConfig, ModelConfig,
                                                     TrainConfig)

    data = DataConfig(dataset="s3dis", cvfold=0,
                      data_path=gfs_data["train_dir"],
                      testing_data_path=gfs_data["test_dir"], pc_npts=NPTS,
                      k_shot=K_SHOT, support_seeds=(10, 20))
    setup = gfs.build_setup(ModelConfig(**TINY), data,
                            TrainConfig(device="cpu"), gfs_data["basis"],
                            torch.device("cpu"))
    gfs.init_model(setup, 5)
    return gfs, setup


def test_validate_multi_spans_and_copied_bytes(gfs_data):
    """One sweep: `sweep` once; `sweep.load` a batch and once more for the
    end; `eval_step` and its `features`, `heads`, `counts` a batch;
    `sweep.tail` once; `h2d` for each of the three prototype and coding
    arrays and each batch's points and labels, whose bytes `h2d_bytes`
    counts."""
    gfs, setup = _setup(gfs_data)
    n_base = len(setup.train_class_names)
    base, _ = gfs.collect_base_codings(setup.model, setup.gp,
                                       setup.train_data_noaug, n_base, 0.9, 8)
    main_proto = setup.model.main_proto.detach().numpy()
    reg = [gfs.register_novel_protos(
        setup.model, setup.gp, supp, main_proto, n_base,
        setup.test_learning_order_idx, 0.9) for supp in setup.supp_datasets]
    geneds = np.stack([g for g, _ in reg])
    novel = np.stack([c for _, c in reg])
    batch = 4
    obs.reset()
    gfs.validate_multi(setup.model, setup.gp, setup.val_dataset, geneds, base,
                       novel, setup.all_learning_order,
                       setup.test_class_names, len(setup.all_class_names),
                       batch)
    n_batches = -(-len(setup.val_dataset) // batch)
    spans = {p: e["calls"] for p, e in _spans().items()}
    assert spans == {
        "sweep": 1, "sweep/sweep.load": n_batches + 1,
        "sweep/h2d": 3 + 2 * n_batches, "sweep/eval_step": n_batches,
        "sweep/eval_step/features": n_batches,
        "sweep/eval_step/heads": n_batches,
        "sweep/eval_step/counts": n_batches, "sweep/sweep.tail": 1}
    copied = sum(np.asarray(a).nbytes for a in (geneds, base, novel))
    for points, labels, _ in gfs.eval_batches(setup.val_dataset, batch):
        assert points.shape == (batch, NPTS, 9)
        copied += points.nbytes + np.asarray(labels).nbytes
    assert snapshot()["plain"]["counters"] == {"sweep/h2d_bytes": copied}


def test_gfs_train_step_spans():
    """One tiny train step: `train_step` holds `forward`, `backward` and
    `optimizer`, one call each, and outlasts them."""
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL
    from gfs3dseg_gws_tpu_torch.parallel.optim import make_gfs_optimizer
    from gfs3dseg_gws_tpu_torch.parallel.steps import gfs_train_step

    model = GWCAPL(classes=13, base_num=7, num_gw=NUM_GW, main_dim=16,
                   edgeconv_widths=TINY["edgeconv_widths"],
                   mlp_widths=TINY["dgcnn_mlp_widths"],
                   base_widths=TINY["base_widths"], output_dim=8, k=5)
    model.train_init(torch.Generator().manual_seed(0))
    opt, sched = make_gfs_optimizer(model, 0.01, 10, 50, 0.5)
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((4, 64, 9)).astype(np.float32))
    y = torch.from_numpy(r.integers(0, 8, (4, 64)))
    gp = torch.from_numpy(r.standard_normal((NUM_GW, 24)).astype(
        np.float32))
    gfs_train_step(model, opt, x, y, gp, torch.Generator().manual_seed(1),
                   sched)
    spans = _spans()
    assert {p: e["calls"] for p, e in spans.items()} == {
        "train_step": 1, "train_step/forward": 1, "train_step/backward": 1,
        "train_step/optimizer": 1}
    inner = sum(spans[f"train_step/{s}"]["ns"]
                for s in ("forward", "backward", "optimizer"))
    assert spans["train_step"]["ns"] > inner


def _tiny_gwcapl(**kw):
    from gfs3dseg_gws_tpu_torch.models.capl import GWCAPL

    return GWCAPL(classes=13, base_num=7, num_gw=NUM_GW, main_dim=16,
                  edgeconv_widths=TINY["edgeconv_widths"],
                  mlp_widths=TINY["dgcnn_mlp_widths"],
                  base_widths=TINY["base_widths"], output_dim=8, k=5, **kw)


def _eval_args(seed, b=4, n=64, seeds=2):
    """New tensors (x, gp, gened_protos, base_coding, novel_codings, y) of
    the tiny model's evaluate_multi, drawn from `seed`."""
    r = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32))

    def multihot(*shape):
        return torch.from_numpy((r.random(shape) < 0.3).astype(np.float32))

    return (randn(b, n, 9), randn(NUM_GW, 24), randn(seeds, 13, 16),
            multihot(7, NUM_GW), multihot(seeds, 6, NUM_GW),
            torch.from_numpy(r.integers(0, 13, (b, n))))


def test_evaluate_multi_on_cpu_tensors_captures_nothing():
    """Past the warm-up's count of calls, evaluate_multi on CPU tensors
    stays eager: no graph counter, the `features` and `heads` spans a
    call, and each result equal to the eager pass's."""
    from gfs3dseg_gws_tpu_torch.parallel.graph import WARM_CALLS

    model = _tiny_gwcapl(generator=torch.Generator().manual_seed(0))
    inputs = [_eval_args(i) for i in range(WARM_CALLS + 3)]
    with torch.inference_mode():
        with span("eval_step"):
            got = [model.evaluate_multi(*a, valid=3) for a in inputs]
        ref = [model._evaluate_multi(*a, 3) for a in inputs]
    assert not any("graph" in path
                   for book in snapshot().values()
                   for path in book["counters"])
    spans = {p: e["calls"] for p, e in _spans().items()}
    assert spans["eval_step/features"] == spans["eval_step/heads"] == \
        len(inputs)
    for g, r in zip(got, ref):
        assert all(torch.equal(a, b) for a, b in zip(g, r))


def _eval_key(model, args, valid):
    """parallel/graph.py's key of an evaluate_multi call on `args`."""
    from gfs3dseg_gws_tpu_torch.parallel.graph import _graph_key

    return _graph_key(model, args, None, (valid,))


@pytest.mark.parametrize("change", ["valid", "y_none", "shape", "dtype",
                                    "inference_mode"])
def test_eval_graph_key_tells_calls_apart(change):
    """evaluate_multi's graph key changes with `valid`, with whether y is
    None, with an input's shape or dtype and with inference mode."""
    model = _tiny_gwcapl()
    args = _eval_args(0)
    with torch.inference_mode():
        key = _eval_key(model, args, 4)
        if change == "valid":
            other = _eval_key(model, args, 3)
        elif change == "y_none":
            other = _eval_key(model, args[:5] + (None,), 4)
        elif change == "shape":
            other = _eval_key(model, _eval_args(0, b=2), 4)
        elif change == "dtype":
            other = _eval_key(model, (args[0].double(),) + args[1:], 4)
    if change == "inference_mode":
        other = _eval_key(model, args, 4)
    assert key != other


@pytest.mark.parametrize("change", ["generator", "gp_shape", "fake_row",
                                    "points_shape"])
def test_train_graph_key_tells_calls_apart(change):
    """gfs_train_step's graph key, on its inputs (the optimizer, points,
    labels, gp, fake_row) and generator, changes with the generator, with
    gp's shape, with whether fake_row is given and with the batch's
    shape."""
    from gfs3dseg_gws_tpu_torch.parallel.graph import _graph_key

    model = _tiny_gwcapl()
    opt = torch.optim.Adam(model.parameters())
    x, gp, _, _, _, y = _eval_args(0)
    gen = torch.Generator()
    key = _graph_key(model, (opt, x, y, gp, None), gen, ())
    if change == "generator":
        other = _graph_key(model, (opt, x, y, gp, None), torch.Generator(),
                           ())
    elif change == "gp_shape":
        other = _graph_key(model, (opt, x, y, gp[:-1], None), gen, ())
    elif change == "fake_row":
        other = _graph_key(model, (opt, x, y, gp, torch.ones(13)), gen, ())
    elif change == "points_shape":
        other = _graph_key(model, (opt, x[:2], y[:2], gp, None), gen, ())
    assert key != other


def test_eval_graph_key_holds_no_tensor_id():
    """New tensors of the same shapes and dtypes (a sweep's prototypes and
    codings, made anew each sweep) give the same key, and the key holds
    the id of no argument."""
    model = _tiny_gwcapl()
    args, fresh = _eval_args(0), _eval_args(1)
    key = _eval_key(model, args, 4)
    assert key == _eval_key(model, fresh, 4)
    ids = {id(t) for t in args + fresh}
    assert not ids & {part for part in key if isinstance(part, int)}


def test_native_pool_records_one_wait_a_batch(gfs_data):
    from gfs3dseg_gws_tpu_torch.data import native_loader

    if not native_loader.is_available():
        pytest.skip("the native loader library is not built")
    names = sorted(f[:-len(".npy")] for f in os.listdir(
        os.path.join(gfs_data["train_dir"], "data")))[:10]
    pool = native_loader.NativeBatchPool(gfs_data["train_dir"], names,
                                         [0, 1, 2], 64, 4)
    try:
        batches = list(pool)
    finally:
        pool.close()
    assert len(batches) == 3
    assert {p: e["calls"] for p, e in _spans().items()} == {"pool.get": 3}


def test_cpu_tensors_open_no_op_span():
    """A CPU tensor takes the plain twin: an op span counts the card's
    kernel launches only."""
    from gfs3dseg_gws_tpu_torch.ops.edgeconv import gather_neighbors
    from gfs3dseg_gws_tpu_torch.ops.knn import knn_indices

    x = torch.randn(2, 16, 3, requires_grad=True)
    gather_neighbors(x, knn_indices(x.detach(), 4)).sum().backward()
    assert _spans() == {}


def test_trace_dir_writes_a_trace_of_the_train_steps(gfs_data, tmp_path):
    """`train_cli --trace_dir`: the first epoch's steps LOSS_LAG on are
    profiled into one Chrome trace holding gfs3d.train_step and its
    children; the steps before them are in the plain book."""
    from gfs3dseg_gws_tpu_torch.cli import train_cli
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import LOSS_LAG

    trace_dir = str(tmp_path / "trace")
    res = train_cli.main(
        ["--dataset", "s3dis", "--cvfold", "0",
         "--data_path", gfs_data["train_dir"],
         "--testing_data_path", gfs_data["test_dir"],
         "--basis_path", gfs_data["basis_path"],
         "--save_path", str(tmp_path / "run"), "--k_shot", str(K_SHOT),
         "--batch_size", "2", "--epochs", "1", "--device", "cpu",
         "--trace_dir", trace_dir] + TINY_ARGS,
        eval_interval=5, max_steps_per_epoch=LOSS_LAG + 2)
    assert res["step"] == LOSS_LAG + 2
    files = glob.glob(os.path.join(trace_dir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("gfs3d.train_step") == 2
    assert {"gfs3d.forward", "gfs3d.backward",
            "gfs3d.optimizer"} <= set(names)
    snap = snapshot()
    assert snap["plain"]["spans"]["train_step"]["calls"] == LOSS_LAG
    assert snap["profiled"]["spans"]["train_step"]["calls"] == 2


# --------------------------------------------------------------------------- #
# the per-layer readers of source program_span
# --------------------------------------------------------------------------- #

def _reader(name, monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"),
        os.path.join(BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entry(calls, ms):
    return {"calls": calls, "ns": int(ms * 1e6)}


HAND_MADE = {
    "plain": {"spans": {
        "sweep": _entry(2, 200.0), "sweep/eval_step": _entry(32, 96.0),
        "sweep/h2d": _entry(70, 44.8), "sweep/sweep.tail": _entry(2, 30.0),
        "train_step": _entry(10, 250.0),
        "train_step/backward": _entry(10, 80.0),
        "train_step/optimizer": _entry(10, 20.0),
        "pool.get": _entry(12, 6.0), "train_step/forward": _entry(10, 1.0)},
        "counters": {"sweep/h2d_bytes": 32 * 2_000_000,
                     "sweep/eval_step/graph_replays": 30,
                     "train_step/graph_replays": 9}},
    "profiled": {"spans": {"sweep/eval_step": _entry(8, 1000.0),
                           "train_step": _entry(24, 5000.0)},
                 "counters": {"sweep/h2d_bytes": 1}}}


@pytest.mark.parametrize("name,value", [
    ("eval.dispatch_ms", 3.0), ("eval.h2d_ms", 1.4), ("eval.h2d_mb", 2.0),
    ("eval.tail_ms", 15.0), ("train.dispatch_ms", 25.0),
    ("train.backward_ms", 8.0), ("train.optimizer_ms", 2.0),
    ("train.pool_wait_ms", 0.5), ("eval.replay_share", 30 / 32),
    ("train.replay_share", 0.9)])
def test_program_span_readers(name, value, monkeypatch):
    """Each reader, fed a hand-made snapshot, gives its definition's value
    from the plain book alone; with no books (a program without
    `snapshot`) or no such span it gives None."""
    read = _reader(name, monkeypatch).read
    monkeypatch.setattr(obs, "snapshot", lambda: HAND_MADE)
    assert read(None) == pytest.approx(value)
    empty = {b: {"spans": {}, "counters": {}} for b in obs.BOOKS}
    monkeypatch.setattr(obs, "snapshot", lambda: empty)
    assert read(None) is None
    monkeypatch.delattr(obs, "snapshot")
    assert read(None) is None


def test_every_program_span_metric_has_a_reader():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        metrics = [m["name"] for m in json.load(f)["per_layer"]
                   if m["source"] == "program_span"]
    readers = {os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(BENCH, "metrics", "*.py"))}
    assert set(metrics) <= readers


# --------------------------------------------------------------------------- #
# on the card: a --trace_dir trace's op spans enclose their kernels
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
def test_trace_dir_op_spans_enclose_their_kernels_on_the_card(gfs_data,
                                                              tmp_path):
    """`train_cli --trace_dir` on the card at the semseg depths, training
    (K3, K4a/b and K5a/b; K6 and K7 in the one-layer block 3), then
    `--only_evaluate` of what it trained (K1, K2; K6): in both traces
    every op span encloses the launch of its own kernel, and K1-K7 all
    show."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    from gfs3dseg_gws_tpu_torch.cli import train_cli
    from gfs3dseg_gws_tpu_torch.pipelines.gfs import LOSS_LAG
    from gfs3dseg_gws_tpu_torch.utils.checkpoint import save_gfs_npz

    common = ["--dataset", "s3dis", "--cvfold", "0",
              "--data_path", gfs_data["train_dir"],
              "--testing_data_path", gfs_data["test_dir"],
              "--basis_path", gfs_data["basis_path"], "--k_shot",
              str(K_SHOT), "--batch_size", "2", "--epochs", "1",
              "--device", "cuda", "--pc_npts", str(NPTS), "--dgcnn_k", "5",
              "--dgcnn_mlp_widths", "[16,16]", "--base_widths", "[8,8]",
              "--output_dim", "8"]
    train_dir, eval_dir = str(tmp_path / "tt"), str(tmp_path / "te")
    common += ["--edgeconv_widths", "[[8,8],[8,8],[8]]"]
    res = train_cli.main(
        common + ["--save_path", str(tmp_path / "run"), "--trace_dir",
                  train_dir], eval_interval=5,
        max_steps_per_epoch=LOSS_LAG + 2)
    model_path = str(tmp_path / "model.npz")
    save_gfs_npz(res["model"], model_path)
    train_cli.main(common + ["--save_path", str(tmp_path / "eval"),
                             "--only_evaluate", "--model_checkpoint_path",
                             model_path, "--trace_dir", eval_dir])
    kernels = {"op.k1": "edge_mma", "op.k2": "attention_mma",
               "op.k3": "knn", "op.k4a": "gsf_kernel",
               "op.k4b": "bwd_kernel", "op.k5a": "attn_train_fwd",
               "op.k5b": "attn_train_bwd", "op.k6": "knn",
               "op.k7": "edgeconv_scatter"}
    seen = set()
    for d in (train_dir, eval_dir):
        (path,) = glob.glob(os.path.join(d, "*.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name", "").startswith("gfs3d.op.")]
        launch = {e["args"]["correlation"]: e for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        for s in spans:
            op = s["name"][len("gfs3d."):]
            if op not in kernels:
                continue
            inside = [k for k in events if k.get("cat") == "kernel"
                      and (k["args"].get("correlation") in launch)
                      and s["ts"] <= launch[k["args"]["correlation"]]["ts"]
                      <= s["ts"] + s["dur"]]
            assert any(kernels[op] in k["name"] for k in inside), (
                op, [k["name"] for k in inside])
            seen.add(op)
    assert seen == set(kernels)
