"""Scalar metrics sink (counterpart of the JAX package's
utils/observability.py::MetricsWriter, whose module imports jax).

Scalars land in an append-only `metrics.jsonl` under the run's log
directory, one JSON object per line: {"tag", "value", "step", "time"}.
"""
from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    """Append-only JSONL scalar sink."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def scalar(self, tag: str, value: float, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step),
                                  "time": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
