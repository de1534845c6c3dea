"""The traced window: torch.profiler with CUDA activity only, bracketed by
two marker kernels whose device start times also tie the trace's clock to
the host's, and the reduction of its Chrome trace to device intervals.

What it gives: the device operations (kernels, copies, sets) inside the
window with their names and times; the busy time, which is the union of
their intervals; and the idle gaps between them, each named by the
program stage that overlapped it most on the host.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER_CYCLES = 1000  # torch.cuda._sleep: a kernel named spin_kernel


def _marker(torch) -> float:
    """Host time (time.time()) at which a marker kernel was launched on an
    idle device."""
    torch.cuda.synchronize()
    t = time.time()
    torch.cuda._sleep(MARKER_CYCLES)
    torch.cuda.synchronize()
    return t


class Window:
    """Profile the block between start() and stop()."""

    def __init__(self, path: str, device: str = "cuda"):
        self.path = path
        self.cuda = device == "cuda"
        self.prof = None
        self.host_start = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        # (device "cpu": the CPU tests' rehearsal, with no device to trace)
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()
        self.host_start = _marker(torch) if self.cuda else time.time()

    def stop(self) -> None:
        import torch

        if self.cuda:
            _marker(torch)
        self.prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None


def device_events(trace_path: str):
    """[(name, cat, start_us, end_us)] of the trace's device operations,
    sorted by start."""
    with open(trace_path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            ts = float(e["ts"])
            out.append((e.get("name", "?"), e["cat"], ts,
                        ts + float(e.get("dur", 0.0))))
    out.sort(key=lambda x: x[2])
    return out


def reduce_window(events, host_start: float):
    """The window between the two markers (the first and the last
    spin_kernel): its device operations, busy seconds, window seconds,
    and the offset (seconds) that maps trace time onto host time.time().
    Without markers the first and last operation bound the window and no
    offset is known."""
    marks = [e for e in events if "spin_kernel" in e[0]]
    if len(marks) >= 2:
        w0, w1 = marks[0][3], marks[-1][2]
        offset = host_start - marks[0][2] * 1e-6
        ops = [e for e in events if e[2] >= w0 and e[3] <= w1
               and "spin_kernel" not in e[0]]
    else:
        ops = list(events)
        w0 = ops[0][2] if ops else 0.0
        w1 = ops[-1][3] if ops else 0.0
        offset = None
    merged = []
    for _, _, s, e in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-6
    return {"ops": ops, "busy_s": busy, "window_s": (w1 - w0) * 1e-6,
            "merged": merged, "w0": w0, "w1": w1, "offset": offset}


def top_ops(ops, n: int = 10):
    """[[name, seconds]] of the device operations that took most time."""
    tot = collections.Counter()
    for name, _, s, e in ops:
        tot[name] += (e - s) * 1e-6
    return [[k, v] for k, v in tot.most_common(n)]


def idle_gaps(red, intervals, n: int = 10):
    """[[name, seconds]]: the window's idle time (between device
    operations) by the stage that overlapped each gap most on the host,
    summed by stage name, largest first. `intervals` are the recorder's
    (name, thread, start, end) on host time."""
    if red["offset"] is None:
        return []
    edges = [red["w0"]] + [x for m in red["merged"] for x in m] + [red["w1"]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    ivs = sorted(intervals, key=lambda x: x[2])
    starts = [x[2] for x in ivs]
    longest = max((x[3] - x[2] for x in ivs), default=0.0)
    tot = collections.Counter()
    for g0, g1 in gaps:
        h0 = g0 * 1e-6 + red["offset"]
        h1 = g1 * 1e-6 + red["offset"]
        best, best_ov, best_len = "host outside any stage", 0.0, 0.0
        lo = bisect.bisect_left(starts, h0 - longest)
        hi = bisect.bisect_right(starts, h1)
        for name, _, s, e in ivs[lo:hi]:
            ov = min(e, h1) - max(s, h0)
            if ov > best_ov or (ov == best_ov and ov > 0
                                and e - s < best_len):
                best, best_ov, best_len = name, ov, e - s
        tot[best] += (g1 - g0) * 1e-6
    return [[k, v] for k, v in tot.most_common(n)]
