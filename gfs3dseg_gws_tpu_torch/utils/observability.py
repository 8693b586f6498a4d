"""Observability: spans and counters, device traces and a scalar metrics
sink (counterpart of the JAX package's utils/observability.py, whose
module imports jax).

Spans and counters. `with span("name"):` times a block of host work on
`time.perf_counter_ns` and adds one call and its nanoseconds to an
in-memory aggregate keyed by the span's path: its name under the spans
open around it on the same thread ("sweep/eval_step/features").
`count("name", n)` adds n to a counter under the current path. The
aggregate keeps two books: "plain", the calls made while no torch
profiler runs, and "profiled", those made while one does. While a
profiler runs, a span also opens `record_function("gfs3d.<name>")`, so
that it lands in the profiler's Chrome trace, on the profiler's clock,
around the kernels it launched; with none running it never does (a
`record_function` costs ~13 us with the profiler off, the gated check
well under one). `snapshot()` returns both books, `calls(name)` the calls
of a span name over every path, `reset()` clears them. Each thread keeps
its own stack and books, merged by `snapshot()`: a backward on autograd's
device thread opens its spans at the top of that thread's stack.

The spans of the port (see README, "Tracing"):

  sweep, sweep.load, h2d, eval_step, features, heads, counts, sweep.tail
                        pipelines/gfs.py::validate_multi, its loader, its
                        copies (counter h2d_bytes), parallel/steps.py::
                        gfs_eval_multi_step, models/capl.py::evaluate_multi
  train_step, forward, backward, optimizer
                        parallel/steps.py::gfs_train_step and _update;
                        counters train_step/graph_captures and
                        train_step/graph_replays: the calls that captured
                        the step as a CUDA graph, and those that replayed
                        it (a replay opens no forward, backward or
                        optimizer span; it adds its graph's launches to
                        the op spans' calls, `add_calls`)
  pretrain_step, forward, seg_head, backward, optimizer
                        parallel/steps.py::pretrain_step and _update,
                        models/dgcnnseg.py::seg_head (DGCNNSeg's head);
                        counters pretrain_step/graph_captures and
                        pretrain_step/graph_replays, as train_step's
  pool.get              data/native_loader.py: the wait on the C++ pool
  op.k1 ... op.k9, op.gather
                        ops/: the kernels' launch paths; a CPU tensor takes
                        the plain twin and opens none, so an op span's
                        calls are its kernel's launches

`trace()` records a `torch.profiler` trace (CPU ops and, where CUDA is
present, the CUDA kernels) as Chrome-trace JSON, which Perfetto and
TensorBoard open. Scalars land in an append-only `metrics.jsonl` under
the run's log directory, one JSON object per line: {"tag", "value",
"step", "time"}, mirrored to TensorBoard where `torch.utils.tensorboard`
imports.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "gfs3d."                 # the spans' names in a profiler trace
BOOKS = ("plain", "profiled")

_clock = time.perf_counter_ns


class _Books:
    """One thread's span stack and books. Only its own thread writes them;
    an entry is replaced whole (a tuple), so a reader on another thread
    sees the calls and nanoseconds of one update together."""

    def __init__(self):
        self.stack = []                           # open spans' paths
        self.spans = ({}, {})                     # plain, profiled
        self.counters = ({}, {})


_local = threading.local()
_threads = []                                     # every thread's _Books
_lock = threading.Lock()


def _books() -> _Books:
    try:
        return _local.books
    except AttributeError:
        return _new_books()


def _new_books() -> _Books:
    books = _local.books = _Books()
    with _lock:
        _threads.append(books)
    return books


class span:
    """`with span("name"):` adds the block's host nanoseconds and one call
    to the current book under the span's path; under a running profiler
    the block is also a `record_function("gfs3d.<name>")`. The book is
    chosen when the span opens."""

    __slots__ = ("name", "_state")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        try:                                # _books(), inlined
            books = _local.books
        except AttributeError:
            books = _new_books()
        stack = books.stack
        path = stack[-1] + "/" + self.name if stack else self.name
        stack.append(path)
        if _profiler._is_profiler_enabled:
            rf = _profiler.record_function(PREFIX + self.name)
            rf.__enter__()
        else:
            rf = None
        self._state = (books, path, rf, _clock())
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = _clock()
        books, path, rf, start = self._state
        books.stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        book = books.spans[rf is not None]
        calls, total = book.get(path, (0, 0))
        book[path] = (calls + 1, total + end - start)
        return False


def profiler_running() -> bool:
    """Whether a torch profiler records now (autograd's own flag, the one
    `span` reads)."""
    return bool(_profiler._is_profiler_enabled)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` under the current path, in the book of
    the moment (profiled while a profiler records)."""
    books = _books()
    stack = books.stack
    key = stack[-1] + "/" + name if stack else name
    book = books.counters[bool(_profiler._is_profiler_enabled)]
    book[key] = book.get(key, 0) + n


def add_calls(paths: Dict[str, int]) -> None:
    """Add calls, and no host time, to the spans at these full paths in the
    book of the moment: the launches of work that ran without opening its
    spans, as the kernels of a replayed CUDA graph."""
    book = _books().spans[bool(_profiler._is_profiler_enabled)]
    for path, n in paths.items():
        calls, total = book.get(path, (0, 0))
        book[path] = (calls + n, total)


def snapshot() -> Dict[str, dict]:
    """Both books, every thread's merged: {"plain" | "profiled": {"spans":
    {path: {"calls", "ns"}}, "counters": {path: n}}}."""
    with _lock:
        threads = list(_threads)
    out = {name: {"spans": {}, "counters": {}} for name in BOOKS}
    for books in threads:
        for i, name in enumerate(BOOKS):
            spans, counters = out[name]["spans"], out[name]["counters"]
            for path, (calls, ns) in list(books.spans[i].items()):
                entry = spans.setdefault(path, {"calls": 0, "ns": 0})
                entry["calls"] += calls
                entry["ns"] += ns
            for path, n in list(books.counters[i].items()):
                counters[path] = counters.get(path, 0) + n
    return out


def calls(name: str, snap: Optional[dict] = None) -> int:
    """Calls of the spans named `name` under any path, in both books (of
    `snap`, else of a fresh snapshot). `calls("op.k1")` is K1's launches."""
    snap = snapshot() if snap is None else snap
    tail = "/" + name
    return sum(entry["calls"] for book in snap.values()
               for path, entry in book["spans"].items()
               if path == name or path.endswith(tail))


def reset() -> None:
    """Clear every thread's books (call it with no span open elsewhere)."""
    with _lock:
        threads = list(_threads)
    for books in threads:
        for book in books.spans + books.counters:
            book.clear()


class MetricsWriter:
    """Append-only JSONL scalar sink + optional TensorBoard mirror."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:         # no tensorboard package
                pass
            else:
                self._tb = SummaryWriter(log_dir=log_dir)

    def scalar(self, tag: str, value: float, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step),
                                  "time": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Record a torch.profiler trace of a code block into `log_dir`.

    Usage: `with trace("/tmp/trace") as prof: run_steps()`. On exit the
    device is waited for, so that every kernel launched inside is in the
    trace, and the trace is written as
    `<log_dir>/<host>_<pid>.<time>.pt.trace.json` (Chrome-trace JSON:
    Perfetto, chrome://tracing, TensorBoard's profiler plugin); `prof` is
    the `torch.profiler.profile`. The port's spans show in it as
    `gfs3d.<name>` annotations. CUDA kernels are recorded where CUDA is
    available. No-op (yields None) when `log_dir` is falsy.
    """
    if not log_dir:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
