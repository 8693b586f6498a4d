"""Seconds of each phase of a run's set-up, on the host clock after the
device has finished the phase's work."""
from __future__ import annotations

import time

import torch


class Phases:
    """`clock(name)` records the seconds since the previous call (or since
    construction) under `name` in the given dict."""

    def __init__(self, into: dict):
        self.into = into
        self.last = time.perf_counter()

    def __call__(self, name: str) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.into[name] = now - self.last
        self.last = now
