"""CPU rehearsal of the three DP kernels: csrc/emu/warp_emu.cc compiles the
CUDA sources themselves with the host C++ compiler against a stand-in
cuda_runtime.h and runs them, through their C entry points, one warp at a
time with the 32 lanes in lockstep. It proves the kernels' logic where there
is no card (lane mapping, trip counts under full-mask shuffles, tile edges,
the 4-byte and 16-byte paths) and aborts when the lanes of a warp diverge at
a warp-wide intrinsic. Registers, the cp.async pipeline and every time are
for the card: chip_smoke.py and utils/kernel_probe.py.

    python3 -m nextpolish2_tpu_torch.utils.warp_emu [case ...]

builds the emulator (g++, a few seconds) and holds consensus_dp_v2,
consensus_dp_base and consensus_dp_dynk (exact and mangled n_slots) to their
plain twins on the named edge-case tables of dp_cases (default: all). Exit
code 1 on any difference. At some 5 microseconds a warp-wide intrinsic it is
for small tables only.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
KERNELS = ("v2", "base", "dynk")


def compiler():
    """The host C++ compiler, or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def build(out_dir: str) -> str:
    """Compile the emulator into `out_dir`; returns the binary's path. Raises
    with the compiler's output when the build fails."""
    exe = os.path.join(out_dir, "warp_emu")
    cmd = [compiler() or "g++", "-std=c++17", "-O1", "-DNP2T_EMULATE",
           "-I", os.path.join(_CSRC, "emu"), "-o", exe,
           os.path.join(_CSRC, "emu", "warp_emu.cc")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("warp_emu build failed:\n" + r.stdout + r.stderr)
    return exe


def run(exe: str, kernel: str, key, cnt, cov, lead, seed, span=None,
        n_slots=None):
    """One kernel ("v2", "base" or "dynk") on numpy tables through the
    emulator: -> (scores int32 [B, W, K], besti int8 [B, W, K]). Raises
    RuntimeError when the emulator aborts (diverged lanes, a write past the
    outputs)."""
    B, W, K = key.shape
    zeros_bw = np.zeros((B, W), np.int32)
    with tempfile.TemporaryDirectory() as d:
        for name, a, dtype in (
                ("key", key, np.int32), ("cnt", cnt, np.int32),
                ("cov", cov, np.int32),
                ("ns", zeros_bw if n_slots is None else n_slots, np.int32),
                ("lead", lead, np.int32),
                ("span", np.zeros(B, np.int32) if span is None else span,
                 np.int32),
                ("seed", seed, np.uint8)):
            np.ascontiguousarray(a, dtype).tofile(os.path.join(d, name))
        r = subprocess.run([exe, d, kernel, str(B), str(W), str(K)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"warp_emu {kernel} exited {r.returncode}: "
                               f"{r.stderr.strip()}")
        return (np.fromfile(os.path.join(d, "scores"),
                            np.int32).reshape(B, W, K),
                np.fromfile(os.path.join(d, "besti"),
                            np.int8).reshape(B, W, K))


def check_case(exe: str, case) -> None:
    """The three DP kernels in the emulator against their plain twins on one
    dp_cases table, every output bit; dynamic-K under the exact and under a
    mangled n_slots. Raises AssertionError on a difference."""
    import torch

    from ..ops import consensus_cuda as cc
    from . import dp_cases

    key, cnt, cov, lead, seed8, span, _lc = dp_cases.case_tensors(case)
    tables = (case.key, case.cnt, case.cov, case.lead, case.seed)
    runs = [("v2", run(exe, "v2", *tables, span=case.span),
             cc.consensus_dp_plain(key, cnt, cov, lead, seed8, span)),
            ("base", run(exe, "base", *tables),
             cc.consensus_dp_base_plain(key, cnt, cov, lead, seed8))]
    for what, ns in (("exact", dp_cases.exact_n_slots(case.key)),
                     ("mangled", dp_cases.mangled_n_slots(case))):
        runs.append((f"dynk ({what} n_slots)",
                     run(exe, "dynk", *tables, n_slots=ns),
                     cc.consensus_dp_dynk_plain(key, cnt, cov,
                                                torch.from_numpy(ns), lead,
                                                seed8)))
    for what, got, want in runs:
        for part, g, w in zip(("scores", "besti"), got, want):
            if not np.array_equal(g, w.numpy()):
                raise AssertionError(
                    f"{case.name}: emulated {what} {part} differ from the "
                    f"twin's at {np.argwhere(g != w.numpy())[:5].tolist()}")


def main(argv) -> int:
    from . import dp_cases

    if compiler() is None:
        print("warp_emu: no C++ compiler", file=sys.stderr)
        return 1
    bad = 0
    with tempfile.TemporaryDirectory() as d:
        exe = build(d)
        for name in argv or dp_cases.CASE_NAMES:
            try:
                check_case(exe, dp_cases.edge_case(name))
                print(f"{name}: equal")
            except (AssertionError, RuntimeError) as e:
                bad += 1
                print(f"FAILED {e}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
