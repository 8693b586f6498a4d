"""Observability: scalar metrics sink, device traces and a step timer
(counterpart of the JAX package's utils/observability.py, whose module
imports jax).

Scalars land in an append-only `metrics.jsonl` under the run's log
directory, one JSON object per line: {"tag", "value", "step", "time"},
mirrored to TensorBoard where `torch.utils.tensorboard` imports. `trace()`
records a `torch.profiler` trace (CPU ops, and CUDA kernels where CUDA is
present) as Chrome-trace JSON, which Perfetto and TensorBoard open.
`StepTimer` times steps on the host clock after waiting for the device.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional, Union

import torch


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
    trace is written as `<log_dir>/<host>_<pid>.<time>.pt.trace.json`
    (Chrome-trace JSON: Perfetto, chrome://tracing, TensorBoard's profiler
    plugin); `prof` is the `torch.profiler.profile`. CUDA kernels are
    recorded where CUDA is available. No-op (yields None) when `log_dir`
    is falsy.
    """
    if not log_dir:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class StepTimer:
    """Wall-clock per-step timing with warmup exclusion: the first `warmup`
    steps are not counted and `mean` is over the rest.

    A CUDA step is asynchronous: a clock read without waiting measures the
    launches. On a CUDA `device` the timer therefore synchronizes it before
    reading the clock, on entering and on leaving a step; on the CPU it
    reads the clock alone.
    """

    def __init__(self, warmup: int = 2,
                 device: Union[str, torch.device] = "cuda"):
        self.warmup = warmup
        self.device = torch.device(device)
        self.count = 0
        self.total = 0.0
        self._t0 = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt

    @property
    def mean(self) -> float:
        steps = max(self.count - self.warmup, 1)
        return self.total / steps
