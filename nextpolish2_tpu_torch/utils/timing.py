"""The port's one recorder of spans and counters (SURVEY §5: the reference
has only an exit-time getrusage summary; here stages are first-class
metrics).

Off by default. While off, stage(), span(), count() and carry() check one
flag and do nothing else. While on:
- stage(name) adds its seconds to _totals[name] (one running total per
  name, summed over threads) and records the span;
- span(name, contig=None) only records: `pass` (one orchestrator.polish
  call) and `contig` (one contig's polish, naming the contig);
- count(name, n) adds n to a counter.

A span's record is Span(name, thread, start, end, parent, contig): start
and end are time.time() seconds (end is None while it is open); parent is
the index in spans() of the innermost span open on the same thread when it
opened, or of the span that handed its work to this thread (carry); contig
is the contig's name, the same on every thread that works for it.

Under profiler_trace each span also opens torch.profiler.record_function,
so the exported Chrome trace shows the spans on the kernels' timeline.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import defaultdict
from typing import NamedTuple, Optional

_ENABLED = False
_PROFILE = False  # profiler_trace is open: spans also open record_function
_totals: dict = defaultdict(float)
_counts: dict = defaultdict(int)
_counters: dict = defaultdict(int)
_spans: list = []  # [name, thread, start, end, parent, contig] per span
_gen = 0  # bumped by reset(): parents recorded before it are gone
# contig threads, the batcher's and the segmented engine's workers share
# the totals, the spans and the counters
_lock = threading.Lock()
_tls = threading.local()  # per thread: frames (gen, span index, contig)
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    thread: int
    start: float
    end: Optional[float]
    parent: Optional[int]
    contig: Optional[str]


def enable(flag: bool = True) -> None:
    """Turn the recorder on or off. Turned on while off, it starts a fresh
    recording: spans, counters and _totals are cleared."""
    global _ENABLED
    if flag and not _ENABLED:
        reset()
    _ENABLED = flag


def enabled() -> bool:
    """Whether the recorder is on: callers guard work that only computes
    a counter's increment with it."""
    return _ENABLED


def reset() -> None:
    global _gen
    with _lock:
        _totals.clear()
        _counts.clear()
        _counters.clear()
        _spans.clear()
        _gen += 1


def _frames() -> list:
    frames = getattr(_tls, "frames", None)
    if frames is None:
        frames = _tls.frames = []
    return frames


@contextlib.contextmanager
def _recorded(name: str, contig: Optional[str], total: bool):
    frames = _frames()
    gen, parent, inherited = frames[-1] if frames else (None, None, None)
    if contig is None:
        contig = inherited
    t0 = time.time()
    rec = [name, threading.get_ident(), t0, None, None, contig]
    with _lock:
        if gen == _gen:
            rec[4] = parent
        idx = len(_spans)
        _spans.append(rec)
        frames.append((_gen, idx, contig))
    annotation = None
    if _PROFILE:
        import torch

        annotation = torch.profiler.record_function(name)
        annotation.__enter__()
    try:
        yield
    finally:
        if annotation is not None:
            annotation.__exit__(None, None, None)
        frames.pop()
        t1 = time.time()
        rec[3] = t1
        if total:
            with _lock:
                _totals[name] += t1 - t0
                _counts[name] += 1


def stage(name: str):
    """Context manager: one stage, added to _totals[name] and recorded."""
    if not _ENABLED:
        return _OFF
    return _recorded(name, None, True)


def span(name: str, contig: Optional[str] = None):
    """Context manager: one span that is recorded but not added to _totals.
    contig names the contig it and the spans under it work for."""
    if not _ENABLED:
        return _OFF
    return _recorded(name, contig, False)


def count(name: str, n: int = 1) -> None:
    if not _ENABLED:
        return
    with _lock:
        _counters[name] += n


def carry(fn, contig: Optional[str] = None):
    """fn, to be run on another thread: while it runs there, the spans it
    opens take the calling thread's innermost open span as their parent,
    and its contig (or `contig`, where given). fn itself while off."""
    if not _ENABLED:
        return fn
    frames = _frames()
    gen, parent, inherited = frames[-1] if frames else (_gen, None, None)
    frame = (gen, parent, inherited if contig is None else contig)

    def carried(*args, **kwargs):
        frames = _frames()
        frames.append(frame)
        try:
            return fn(*args, **kwargs)
        finally:
            frames.pop()

    return carried


def spans() -> list:
    """A copy of the recorded spans, in the order they opened."""
    with _lock:
        return [Span(*r) for r in _spans]


def counters() -> dict:
    with _lock:
        return dict(_counters)


def snapshot() -> dict:
    """Stage name -> cumulative seconds since the last reset()."""
    return dict(_totals)


def self_seconds(records) -> dict:
    """Span name -> seconds of its closed spans that none of their
    children covers (children on other threads included), summed."""
    children = defaultdict(list)
    for r in records:
        if r.parent is not None and r.end is not None:
            children[r.parent].append((r.start, r.end))
    out: dict = defaultdict(float)
    for i, r in enumerate(records):
        if r.end is None:
            continue
        covered, reach = 0.0, r.start
        for s, e in sorted(children.get(i, ())):
            s, e = max(s, reach), min(e, r.end)
            if e > s:
                covered += e - s
                reach = e
        out[r.name] += r.end - r.start - covered
    return dict(out)


def report(out=sys.stderr) -> None:
    """Each stage's total and self time (the total less what its child
    spans cover), those of the pass and contig spans, the counters, and
    each contig's wall."""
    records = spans()
    if not _totals and not records:
        return
    own = self_seconds(records)
    print("[np2 timing]", file=out)
    print(f"  {'stage':<28} {'total':>9} {'self':>9}", file=out)
    for name in sorted(_totals, key=lambda k: -_totals[k]):
        print(f"  {name:<28} {_totals[name]:8.2f}s {own.get(name, 0.0):8.2f}s"
              f"  x{_counts[name]}", file=out)
    walls: dict = defaultdict(float)
    calls: dict = defaultdict(int)
    per_contig: dict = defaultdict(float)
    for r in records:
        if r.name in ("pass", "contig") and r.end is not None:
            walls[r.name] += r.end - r.start
            calls[r.name] += 1
            if r.name == "contig":
                per_contig[r.contig] += r.end - r.start
    for name in ("pass", "contig"):
        if calls[name]:
            print(f"  {name:<28} {walls[name]:8.2f}s {own[name]:8.2f}s"
                  f"  x{calls[name]}", file=out)
    for name, n in sorted(counters().items()):
        print(f"[np2 timing] counter {name:<28} {n}", file=out)
    for name, wall in per_contig.items():
        print(f"[np2 timing] contig {name} {wall:.2f}s", file=out)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """torch.profiler trace of the block (CPU activity, and CUDA activity
    where a card is present), written on exit as a Chrome trace
    `np2_trace.<pid>.json` in log_dir (created if missing). The recorder
    is on inside the block (turned on here if it was off) and each span
    opens a record_function of its name. A profiler that cannot start
    raises: the caller asked for a trace."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    global _PROFILE
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was_on = _ENABLED
    with profile(activities=activities) as prof:
        enable(True)
        _PROFILE = True
        try:
            yield prof
        finally:
            _PROFILE = False
            if not was_on:
                enable(False)
    prof.export_chrome_trace(
        os.path.join(log_dir, f"np2_trace.{os.getpid()}.json"))
