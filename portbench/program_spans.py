"""The program's own spans and counters, as the per-layer metrics of
source `program_span` read them: the plain book of
`gfs3dseg_gws_tpu_torch.utils.observability.snapshot()`, the calls made
while no profiler ran. In a `--trace 1` run that is the set-up and the
untraced part of the window, so these metrics measure the loop that the
end-to-end metrics time, not the profiled stretch. A program without the
books (no `snapshot`) gives None, and so does a path it never opened.
"""
from __future__ import annotations

from typing import Optional


def plain() -> Optional[dict]:
    """The plain book {"spans": {path: {"calls", "ns"}}, "counters":
    {path: n}}, or None."""
    from gfs3dseg_gws_tpu_torch.utils import observability

    snapshot = getattr(observability, "snapshot", None)
    return None if snapshot is None else snapshot()["plain"]


def calls(book: dict, path: str) -> int:
    return book["spans"].get(path, {}).get("calls", 0)


def ms_per(path: str, per: Optional[str] = None) -> Optional[float]:
    """Host ms in the span `path` a call of the span `per` (default: a call
    of `path` itself)."""
    book = plain()
    if book is None or path not in book["spans"]:
        return None
    n = calls(book, per or path)
    return book["spans"][path]["ns"] * 1e-6 / n if n else None


def counter_per(path: str, per: str) -> Optional[float]:
    """The counter `path` a call of the span `per`."""
    book = plain()
    if book is None or path not in book["counters"]:
        return None
    n = calls(book, per)
    return book["counters"][path] / n if n else None
