"""The trace reduction: device operations attributed by the CPU range of
their launch, busy time as a union, the per-layer readers, and the p95
taken over every sweep of a window."""
import os

import pytest

from tracer import HERE, Shape, Summary, load_module, load_spans, union_s

SPANS = load_spans()


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def launch(name, at, start, dur, corr):
    return [ev("cuda_runtime", "cudaLaunchKernel", at, 1, corr),
            ev("kernel", name, start, dur, corr, tid=7)]


def trace():
    """A stretch of 100 us: two train steps; K3 in one, a GEMM, a glue
    kernel, K4b in an autograd node on another thread, a copy; kernels
    overlapping on two streams."""
    evs = [ev("user_annotation", "portbench.stretch", 0, 100),
           ev("user_annotation", "portbench.train.step", 0, 50),
           ev("user_annotation", "portbench.train.step", 50, 50),
           ev("user_annotation", "portbench.k3", 2, 4),
           ev("cpu_op", "autograd::engine::evaluate_function: "
              "_FusedEdgeConvTrainBackward", 20, 10, tid=2)]
    evs += launch("knn_split_kernel<64>", 3, 10, 10, 1)          # k3
    evs += launch("sm90_xmma_gemm_f32f32", 8, 15, 10, 2)          # GEMM
    evs += launch("vectorized_elementwise_kernel", 12, 30, 5, 3)  # glue
    evs += [ev("cuda_runtime", "cudaLaunchKernel", 22, 1, 4),     # k4b
            ev("kernel", "bwd_kernel", 40, 20, 4, tid=7)]
    evs += [ev("cuda_runtime", "cudaMemcpyAsync", 55, 1, 5),
            ev("gpu_memcpy", "Memcpy HtoD", 70, 5, 5, tid=7)]
    return evs


def summary():
    s = Summary(trace(), SPANS, {})
    s.blocks = 32
    return s


def test_union_of_overlapping_intervals():
    assert union_s([(0, 10), (5, 15), (20, 30), (25, 26)]) == \
        pytest.approx(25e-6)
    assert union_s([]) == 0.0


def test_ops_belong_to_the_span_enclosing_their_launch():
    s = summary()
    assert s.window_s == pytest.approx(100e-6)
    names = {o["name"]: o["spans"] for o in s.ops}
    assert names["knn_split_kernel<64>"] == {"k3", "train.step"}
    assert names["bwd_kernel"] == {"k4b", "train.step"}
    assert names["sm90_xmma_gemm_f32f32"] == {"train.step"}
    assert names["Memcpy HtoD"] == {"train.step"}
    # K3 and the GEMM overlap on 15..20: busy is their union
    assert s.busy_s == pytest.approx((25 - 10 + 35 - 30 + 60 - 40 + 5) * 1e-6)
    assert s.device_s("k3") == pytest.approx(10e-6)
    assert s.launches() == 4
    # glue: neither an op span nor a GEMM (the copy counts)
    assert s.glue_s() == pytest.approx((5 + 5) * 1e-6)


def read(metric, s):
    return load_module(os.path.join(HERE, "metrics", f"{metric}.py"),
                       "m_" + metric.replace(".", "_")).read(s)


def test_readers():
    s = summary()
    assert read("train.idle", s) == pytest.approx(
        100 * (1 - 45e-6 / 100e-6))
    assert read("train.launches", s) == 2.0
    assert read("train.glue_ms", s) == pytest.approx(1e3 * 10e-6 / 2)
    assert read("train.step_ms", s) == pytest.approx(1e3 * 45e-6 / 2)
    assert read("train.loader_ms", s) is None        # no such span
    assert read("train.k3_roofline", s) is None      # no call recorded


def test_roofline_from_recorded_calls():
    s = summary()
    x, b = Shape.__new__(Shape), Shape.__new__(Shape)
    x.shape, b.shape = (2, 64, 9), (2, 64, 64)
    s.calls = {"k3": [((x, b, 20), {})]}
    peaks = load_module(os.path.join(HERE, "tracer.py"), "t").load_peaks()
    fmas, nbytes = load_module(os.path.join(HERE, "counts", "k3.py"),
                               "c3").count(batch=2, n=64, c=9, cb=64, k=20)
    bound = max(2 * fmas / peaks["tf32_flops_per_s"],
                nbytes / peaks["hbm_bytes_per_s"])
    assert read("train.k3_roofline", s) == pytest.approx(
        100 * bound / 10e-6)


def test_breakdown_names_the_idle_gaps():
    out = summary().breakdown()
    assert out["device_ops"][0] == ["bwd_kernel", pytest.approx(20e-6)]
    gaps = dict(out["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(55e-6)
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10


def test_p95_over_every_sweep():
    p95 = load_module(os.path.join(HERE, "drivers", "eval_sweep.py"),
                      "d_eval").p95
    values = list(range(1, 201))              # 200 sweeps
    assert p95(values) == 190                 # 10 sweeps lie beyond it
    assert p95(list(reversed(values))) == 190
    assert p95([5.0]) == 5.0
