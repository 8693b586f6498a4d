"""Text logging + meters (reference util/logger.py, util/util.py:17-42)."""
from __future__ import annotations

import os


class IOStream:
    """Append-mode text log mirrored to stdout (reference util/logger.py:7-31)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = open(path, "a")

    def cprint(self, text: str):
        print(text)
        self.f.write(text + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


def init_logger(log_dir: str, args=None, phase: str = "train") -> IOStream:
    os.makedirs(log_dir, exist_ok=True)
    logger = IOStream(os.path.join(log_dir, f"log_{phase}.txt"))
    if args is not None:
        d = vars(args) if not isinstance(args, dict) else args
        for k in sorted(d):
            logger.cprint(f"{k}: {d[k]}")
    return logger


class AverageMeter:
    """Running average (reference util/util.py:17-42)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
