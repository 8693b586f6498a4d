"""The traced run's instrumentation and its reduction to a summary.

`Tracer.install` wraps each entry that a file under spans/ names (a
module-global function, looked up by the program at call time) in a
`record_function("portbench.<span>")` and records the shapes of each
call; an autograd node named in spans/ is a span too (the profiler's
"autograd::engine::evaluate_function: <node>"). `Tracer.stretch` profiles
a block of the window with torch.profiler (CPU and CUDA) and reduces the
Chrome trace to a `Summary`.

A device operation (kernel, copy, fill) belongs to every span whose CPU
range encloses its launch, not to a kernel name: a redesigned kernel
with a new name still counts where its op entry is. Busy time is the
union of the device operations' intervals, so that overlapping streams
are counted once.
"""
from __future__ import annotations

import bisect
import contextlib
import glob
import importlib
import importlib.util
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PREFIX = "portbench."
AUTOGRAD_PREFIX = "autograd::engine::evaluate_function: "
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "copy",
               "gpu_memset": "fill"}
GEMM_WORDS = ("gemm", "gemv", "xmma", "cutlass", "kernel2")


class Shape:
    """What a call's tensor argument leaves behind: its shape."""

    def __init__(self, t: torch.Tensor):
        self.shape = tuple(t.shape)


def _proxy(v):
    return Shape(v) if isinstance(v, torch.Tensor) else v


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spans(root: str = HERE) -> List[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(root, "spans", "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


class Tracer:
    def __init__(self, workdir: str, root: str = HERE):
        self.workdir = workdir
        self.spans = load_spans(root)
        self.calls: Dict[str, list] = defaultdict(list)
        self.recording = False
        self._saved: List[Tuple[object, str, object]] = []

    def install(self) -> "Tracer":
        for spec in self.spans:
            if "module" not in spec:
                continue
            mod = importlib.import_module(spec["module"])
            fn = getattr(mod, spec["attr"])
            self._saved.append((mod, spec["attr"], fn))
            setattr(mod, spec["attr"], self._wrap(fn, spec["span"]))
        return self

    def uninstall(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def _wrap(self, fn, span: str):
        name = PREFIX + span

        def wrapped(*args, **kwargs):
            if self.recording:
                self.calls[span].append((tuple(_proxy(a) for a in args),
                                         {k: _proxy(v)
                                          for k, v in kwargs.items()}))
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    @staticmethod
    def span(name: str):
        """A span of the benchmark's own (loaders, steps)."""
        return torch.profiler.record_function(PREFIX + name)

    @contextlib.contextmanager
    def stretch(self, device: torch.device):
        """Profile the block; `summarize` reduces it afterwards."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.calls.clear()
        sync = (lambda: torch.cuda.synchronize(device)) \
            if device.type == "cuda" else (lambda: None)
        sync()
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(PREFIX + "stretch"):
                self.recording = True
                yield
                sync()
                self.recording = False
        self._prof = prof

    def summarize(self) -> "Summary":
        """The profiled stretch reduced to a `Summary` (its Chrome trace is
        written to the work directory, read and removed)."""
        path = os.path.join(self.workdir, "trace.json")
        self._prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        self._prof = None
        self.summary = Summary(events, self.spans, dict(self.calls))
        return self.summary


class Summary:
    """The traced stretch reduced: device operations with the spans that
    enclose their launches, span intervals, the recorded calls."""

    def __init__(self, events: List[dict], spans: List[dict],
                 calls: Dict[str, list]):
        self.calls = calls
        self.blocks = 0         # blocks through the stretch (set by the
                                # traffic driver)
        self.cfg: dict = {}
        self.op_spans = {s["span"] for s in spans if s.get("kind") == "op"}
        autograd = {AUTOGRAD_PREFIX + s["autograd"]: s["span"]
                    for s in spans if "autograd" in s}
        launches: Dict[int, float] = {}
        self.intervals: Dict[str, List[Tuple[float, float]]] = \
            defaultdict(list)
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat in DEVICE_CATS:
                device.append(e)
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = e["ts"]
            elif cat == "user_annotation" and name.startswith(PREFIX):
                self.intervals[name[len(PREFIX):]].append(
                    (e["ts"], e["ts"] + e["dur"]))
            elif cat == "cpu_op" and name in autograd:
                self.intervals[autograd[name]].append(
                    (e["ts"], e["ts"] + e["dur"]))
        for v in self.intervals.values():
            v.sort()
        lo, hi = self.intervals["stretch"][0]
        self.window_s = (hi - lo) * 1e-6
        self.ops = []
        for e in device:
            start, end = e["ts"], e["ts"] + e["dur"]
            if end < lo or start > hi:
                continue
            when = launches.get(e.get("args", {}).get("correlation"))
            owners = frozenset(s for s in self.intervals if s != "stretch"
                               and when is not None
                               and self._inside(s, when))
            self.ops.append({"name": name_of(e), "kind": DEVICE_CATS[e["cat"]],
                             "start": max(start, lo), "end": min(end, hi),
                             "spans": owners})
        self.busy_s = union_s([(o["start"], o["end"]) for o in self.ops])

    def _inside(self, span: str, t: float) -> bool:
        ivs = self.intervals[span]
        i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
        return i >= 0 and ivs[i][0] <= t <= ivs[i][1]

    # ---- what the metric readers ask
    def ops_in(self, span: str) -> List[dict]:
        return [o for o in self.ops if span in o["spans"]]

    def device_s(self, span: str) -> float:
        return sum(o["end"] - o["start"] for o in self.ops_in(span)) * 1e-6

    def busy_in_s(self, span: str) -> float:
        return union_s([(o["start"], o["end"]) for o in self.ops_in(span)])

    def count(self, span: str) -> int:
        return len(self.intervals.get(span, []))

    def host_ms(self, span: str) -> Optional[float]:
        ivs = self.intervals.get(span, [])
        if not ivs:
            return None
        return sum(b - a for a, b in ivs) / len(ivs) * 1e-3

    def launches(self) -> int:
        return sum(1 for o in self.ops if o["kind"] == "kernel")

    def glue_s(self) -> float:
        """Device seconds outside every op span and outside the GEMMs."""
        return sum(o["end"] - o["start"] for o in self.ops
                   if not (o["spans"] & self.op_spans)
                   and not is_gemm(o["name"])) * 1e-6

    def bound_s(self, op: str) -> Optional[float]:
        """The least time of every call of `op` traced, by counts/<op>.py:
        the larger of its products at the TF32 peak and its bytes at the
        memory's. None where no call was traced."""
        mod = load_module(os.path.join(HERE, "counts", f"{op}.py"),
                          f"counts_{op}")
        calls = self.calls.get(getattr(mod, "CALLS_OF", op), [])
        if not calls:
            return None
        peaks = load_peaks()
        total = 0.0
        for args, kwargs in calls:
            fmas, nbytes = mod.count(**mod.shapes(args, kwargs))
            total += max(2.0 * fmas / peaks["tf32_flops_per_s"],
                         nbytes / peaks["hbm_bytes_per_s"])
        return total

    def roofline(self, op: str) -> Optional[float]:
        """bound_s / the device seconds of the op's span, in %."""
        bound, spent = self.bound_s(op), self.device_s(op)
        if bound is None or spent <= 0.0:
            return None
        return 100.0 * bound / spent

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the innermost benchmark span open at their middle."""
        by_name: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            by_name[o["name"]] += (o["end"] - o["start"]) * 1e-6
        gaps: Dict[str, float] = defaultdict(float)
        merged = merge([(o["start"], o["end"]) for o in self.ops])
        lo, hi = self.intervals["stretch"][0]
        edges = [lo] + [t for iv in merged for t in iv] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[self._host_at((a + b) / 2)] += (b - a) * 1e-6
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in order(by_name)],
                "idle_gaps": [[n, s] for n, s in order(gaps)]}

    def _host_at(self, t: float) -> str:
        best, width = "host outside the benchmark's spans", float("inf")
        for span, ivs in self.intervals.items():
            if span == "stretch":
                continue
            i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= t <= ivs[i][1] and \
                    ivs[i][1] - ivs[i][0] < width:
                best, width = span, ivs[i][1] - ivs[i][0]
        return best


def name_of(e: dict) -> str:
    name = e.get("name", "")
    return name if len(name) <= 120 else name[:117] + "..."


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(w in low for w in GEMM_WORDS)


def merge(ivs: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_s(ivs: List[Tuple[float, float]]) -> float:
    """Seconds covered by intervals given in microseconds."""
    return sum(b - a for a, b in merge(ivs)) * 1e-6


def load_peaks(root: str = HERE) -> dict:
    with open(os.path.join(root, "peaks.json")) as f:
        return json.load(f)
