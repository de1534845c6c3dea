"""Per-stage timing hooks (SURVEY §5: the reference has only an exit-time
getrusage summary; here stages are first-class metrics)."""

from __future__ import annotations

import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_ENABLED = False
_totals: dict = defaultdict(float)
_counts: dict = defaultdict(int)
_lock = threading.Lock()  # contig threads and the batcher's worker share the totals


def enable(flag: bool = True) -> None:
    global _ENABLED
    _ENABLED = flag


@contextmanager
def stage(name: str):
    if not _ENABLED:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        with _lock:
            _totals[name] += time.time() - t0
            _counts[name] += 1


def reset() -> None:
    _totals.clear()
    _counts.clear()


def snapshot() -> dict:
    """Stage name -> cumulative seconds since the last reset()."""
    return dict(_totals)


def report(out=sys.stderr) -> None:
    if not _totals:
        return
    print("[np2 timing]", file=out)
    for name in sorted(_totals, key=lambda k: -_totals[k]):
        print(f"  {name:<28} {_totals[name]:8.2f}s  x{_counts[name]}", file=out)



@contextmanager
def profiler_trace(log_dir: str):
    """torch.profiler trace of the block (CPU activity, and CUDA activity
    where a card is present), written on exit as a Chrome trace
    `np2_trace.<pid>.json` in log_dir (created if missing). A profiler
    that cannot start raises: the caller asked for a trace."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"np2_trace.{os.getpid()}.json"))
