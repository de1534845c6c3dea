"""CPU rehearsal of the three DP kernels and the k-mer kernels:
csrc/emu/warp_emu.cc compiles the CUDA sources themselves with the host C++
compiler against a stand-in cuda_runtime.h and runs them, through their C
entry points, one warp at a time with the 32 lanes in lockstep. It proves
the kernels' logic where there is no card (lane mapping, trip counts under
full-mask shuffles, tile and strip edges, the 4-byte and 16-byte paths, the
persistent grid's strides) and aborts when the lanes of a warp diverge at a
warp-wide intrinsic. Registers, the cp.async pipeline and every time are
for the card: chip_smoke.py and utils/kernel_probe.py.

    python3 -m nextpolish2_tpu_torch.utils.warp_emu [case ...]

builds the emulator (g++, a few seconds) and holds consensus_dp_v2,
consensus_dp_base and consensus_dp_dynk (exact and mangled n_slots) to their
plain twins on the named edge-case tables of dp_cases, and kmer_lookup,
kmer_lookup_sharded and kmer_min_scores to theirs on the k-mer cases of
KMER_CASES (default: all).
Exit code 1 on any difference. At some 5 microseconds a warp-wide intrinsic
it is for small tables only.
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
# the k-mer cases: a table at load 0.78 (chains of the longest length) with
# the lookup's queries, allele batches for the scorer on a k21 and a k31
# table, one unpadded, one past 2^19 bases, and the sharded lookup on the
# first case's keys split into 2 and into 4 shards (check_kmer_case)
KMER_CASES = ("lookup_long_chains", "score_k21", "score_k31",
              "score_k21_unpadded", "score_k21_long_runs", "lookup_sharded")
SHARD_COUNTS = (2, 4)   # the shard counts of the lookup_sharded case


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


def _run_kmer(exe: str, args, files: dict, sms: int) -> np.ndarray:
    with tempfile.TemporaryDirectory() as d:
        for name, a in files.items():
            np.ascontiguousarray(a).tofile(os.path.join(d, name))
        r = subprocess.run([exe, d, *map(str, args)], capture_output=True,
                           text=True,
                           env=dict(os.environ, NP2T_EMU_SMS=str(sms)))
        if r.returncode != 0:
            raise RuntimeError(f"warp_emu {args[0]} exited {r.returncode}: "
                               f"{r.stderr.strip()}")
        return np.fromfile(os.path.join(d, "out"), np.int32)


def run_lookup(exe: str, entries, q_hi, q_lo, q_slot, min_count: int,
               n_probes: int, sms: int = 1) -> np.ndarray:
    """kmer_lookup's kernel through the emulator on a card of `sms` SMs:
    entries int32 [S, 4], queries int32 [Q] x 3 -> int32 [Q]."""
    return _run_kmer(exe, ("lookup", min_count, n_probes),
                     {"entries": np.asarray(entries, np.int32),
                      "q_hi": np.asarray(q_hi, np.int32),
                      "q_lo": np.asarray(q_lo, np.int32),
                      "q_slot": np.asarray(q_slot, np.int32)}, sms)


def run_lookup_sharded(exe: str, entries, q_hi, q_lo, q_slot, q_shard,
                       shard: int, min_count: int, n_probes: int,
                       sms: int = 1) -> np.ndarray:
    """kmer_lookup_sharded's kernel through the emulator: one shard's
    entries int32 [S, 4], queries and their shards int32 [Q] x 4 ->
    int32 [Q]."""
    return _run_kmer(exe, ("lookup_sharded", min_count, n_probes, shard),
                     {"entries": np.asarray(entries, np.int32),
                      "q_hi": np.asarray(q_hi, np.int32),
                      "q_lo": np.asarray(q_lo, np.int32),
                      "q_slot": np.asarray(q_slot, np.int32),
                      "q_shard": np.asarray(q_shard, np.int32)}, sms)


def run_score(exe: str, entries, codes, starts, ksize: int, min_count: int,
              n_probes: int, sms: int = 1) -> np.ndarray:
    """kmer_min_scores's kernel through the emulator on a card of `sms`
    SMs: entries int32 [S, 4], codes uint8 [L], starts int32 [N] -> int32
    [N]."""
    return _run_kmer(exe, ("score", ksize, min_count, n_probes),
                     {"entries": np.asarray(entries, np.int32),
                      "codes": np.asarray(codes, np.uint8),
                      "starts": np.asarray(starts, np.int32)}, sms)


def _kmer_table(ref: bytes, ksize: int, rng):
    """A DeviceKmerTable of the canonical k-mers of `ref` (yak-hashed), with
    counts 1..20."""
    from ..io.yak import rolling_kmers, yak_hash64
    from ..ops.kmer_table import DeviceKmerTable
    from .seqcodes import seq_to_codes

    kmers, valid = rolling_kmers(seq_to_codes(ref), ksize)
    h = np.unique(yak_hash64(kmers[valid], (1 << (2 * ksize)) - 1))
    return DeviceKmerTable.build(h, rng.integers(1, 21, len(h)), ksize)


def score_alleles(ref: bytes, rng, n: int = 180):
    """Alleles that reach every branch of the scorer: empty ones, ones
    shorter than k, runs of N, an internal N, ones that cross a lane's run
    of 16 positions, a warp's strip of ops.kmer_score.STRIP or several, half
    cut from `ref` (present k-mers), half with a base changed (absent
    ones), and ones of Ns only that span strips. (Joined by score_inputs,
    every allele owns its separator's position too.)"""
    seqs = []
    for i in range(n):
        kind = i % 9
        m = [0, 12, 25, 60, 150, 700, 2600, 40, 90][kind]
        m = max(0, m + int(rng.integers(-4, 5))) if m else 0
        p = int(rng.integers(0, len(ref) - m))
        s = bytearray(ref[p : p + m])
        if i % 2 and m > 30:
            s[m // 3] = b"CGTA"[b"ACGT".index(s[m // 3])]
        if kind == 7:
            s[m // 2] = ord("N")
        if (kind == 3 and i % 4 == 1) or (kind in (5, 6) and i % 4 == 2):
            s[:] = b"N" * m  # no valid k-mer, within a run or across strips
        seqs.append(bytes(s))
    return seqs


def kmer_case_inputs(name: str):
    """(table, kernel inputs) of one KMER_CASES case, made from a seed."""
    import torch

    from ..ops import kmer_score as ks
    from ..ops import kmer_table as kt
    from ..ops.kmer_table import DeviceKmerTable
    from .seqcodes import seq_to_codes

    if name == "lookup_sharded":
        # the first case's keys and queries, the keys split into shards
        # (packed at the default load 0.5, the sharded build's); each warp
        # holds queries of every shard
        from ..parallel.sharded_kmer import ShardedKmerTable

        tab, q = kmer_case_inputs("lookup_long_chains")
        hashes, counts = _table_keys(tab)
        qh = _join64(q[0].numpy(), q[1].numpy())
        return [(ShardedKmerTable.build(hashes, counts, 21, n), qh)
                for n in SHARD_COUNTS], None
    rng = np.random.default_rng(KMER_CASES.index(name) + 300)
    if name == "lookup_long_chains":
        from ..io.yak import yak_hash64

        mask = (1 << 42) - 1
        hashes = np.unique(yak_hash64(
            rng.integers(0, mask, size=4000, dtype=np.uint64), mask))[:3200]
        tab = DeviceKmerTable.build(hashes, rng.integers(1, 200, len(hashes)),
                                    21, load_factor=1.0)
        absent = np.setdiff1d(rng.integers(0, mask, 3000, dtype=np.uint64),
                              hashes)
        high = rng.integers(0, 1 << 62, 400, dtype=np.uint64) \
            | np.uint64(1 << 63) | np.uint64(1 << 31)
        sentinel = np.array([0xFFFFFFFFFFFFFFFE], dtype=np.uint64)
        q = np.concatenate([hashes, absent, high, sentinel, hashes[:77]])
        rng.shuffle(q)
        return tab, tuple(torch.from_numpy(a)
                          for a in tab.query_host_arrays(q))
    ksize = 31 if name == "score_k31" else 21
    ref = bytes(rng.choice(list(b"ACGT"), size=30000).astype(np.uint8))
    tab = _kmer_table(ref, ksize, rng)
    # past 2^19 bases the kernel takes its longer runs
    seqs = score_alleles(ref, rng, 1300 if name.endswith("_long_runs")
                         else 180)
    if name.endswith("_unpadded"):
        # the joined stream as it is, of a length that is no multiple of
        # 16; alleles that own no position (repeated starts, at 0, on run
        # and strip edges), a 52-base allele across every strip edge that
        # starts in the strip's last run, 80 alleles of 3 bases in one strip
        # of the appended reference (more boundaries than a warp holds at
        # once, k-mers the table holds), and a few padding alleles at L
        codes = seq_to_codes(b"\xff".join(seqs)).astype(np.uint8)
        codes = np.concatenate([codes, seq_to_codes(ref[:1001])])
        lens = np.array([len(s) + 1 for s in seqs])
        strip = ks.STRIP
        edges = np.arange(strip, len(codes) - 40, strip)
        starts = np.sort(np.concatenate([
            [0, 0], np.cumsum(lens)[:-1],
            [48, 48, strip, 2 * strip, 2 * strip, 4 * strip + 32],
            edges - 12, edges + 40,
            np.arange(80) * 3 + edges[edges > len(codes) - 990][0] + 10,
            np.full(5, len(codes))])).astype(np.int32)
    else:
        codes, starts = ks.score_inputs(seqs)
    assert kt.MAX_PROBES >= tab.n_probes
    return tab, (torch.from_numpy(codes), torch.from_numpy(starts), ksize)


def check_kmer_case(exe: str, name: str, sms: int = 1) -> None:
    """One k-mer kernel in the emulator against its plain twin on one case
    of KMER_CASES, every output bit, at min_count 0 and 7 and under the
    table's probe bound and MAX_PROBES. Raises AssertionError on a
    difference."""
    import torch

    from ..ops import kmer_score as ks
    from ..ops import kmer_table as kt

    if name == "lookup_sharded":
        _check_sharded(exe, sms)
        return
    tab, inputs = kmer_case_inputs(name)
    planes = tuple(torch.from_numpy(np.ascontiguousarray(p))
                   for p in (tab.key_hi, tab.key_lo, tab.counts))
    for min_count in (0, 7):
        for n_probes in (tab.n_probes, kt.MAX_PROBES):
            if name.startswith("lookup"):
                got = run_lookup(exe, tab.entries,
                                 *(a.numpy() for a in inputs), min_count,
                                 n_probes, sms)
                want = kt.kmer_lookup_plain(*planes, *inputs, min_count,
                                            n_probes).numpy()
            else:
                codes, starts, ksize = inputs
                got = run_score(exe, tab.entries, codes.numpy(),
                                starts.numpy(), ksize, min_count, n_probes,
                                sms)
                want = ks.kmer_min_scores_plain(*planes, codes, starts, ksize,
                                                min_count, n_probes).numpy()
            if not np.array_equal(got, want):
                bad = np.nonzero(got != want)[0]
                raise AssertionError(
                    f"{name}: emulated kernel differs from the twin at "
                    f"min_count {min_count}, n_probes {n_probes}, "
                    f"{len(bad)} entries, first {bad[:5].tolist()}: "
                    f"{got[bad[:5]].tolist()} != {want[bad[:5]].tolist()}")


def _check_sharded(exe: str, sms: int) -> None:
    """kmer_lookup_sharded in the emulator against its twin on every shard
    of the lookup_sharded case, at 2 and 4 shards, min_count 0 and 7,
    under the table's probe bound and MAX_PROBES; and the shards' sum
    against the unsharded twin on the whole table."""
    import torch

    from ..ops import kmer_table as kt

    tables, _ = kmer_case_inputs("lookup_sharded")
    for tab, qh in tables:
        q = [torch.from_numpy(a) for a in tab.query_host_arrays(qh)]
        whole = kt.DeviceKmerTable.build(*_table_keys(tab), tab.ksize)
        wq = [torch.from_numpy(a) for a in whole.query_host_arrays(qh)]
        wplanes = [torch.from_numpy(np.ascontiguousarray(p))
                   for p in (whole.key_hi, whole.key_lo, whole.counts)]
        for min_count in (0, 7):
            for n_probes in (tab.n_probes, kt.MAX_PROBES):
                total = np.zeros(len(qh), np.int64)
                for s in range(tab.n_shards):
                    planes = [torch.from_numpy(np.ascontiguousarray(p[s]))
                              for p in (tab.key_hi, tab.key_lo, tab.counts)]
                    got = run_lookup_sharded(
                        exe, tab.entries[s], *(a.numpy() for a in q), s,
                        min_count, n_probes, sms)
                    want = kt.kmer_lookup_sharded_plain(
                        *planes, *q, s, min_count, n_probes).numpy()
                    if not np.array_equal(got, want):
                        bad = np.nonzero(got != want)[0]
                        raise AssertionError(
                            f"lookup_sharded: emulated shard {s} of "
                            f"{tab.n_shards} differs from the twin at "
                            f"min_count {min_count}, n_probes {n_probes}, "
                            f"{len(bad)} entries, first {bad[:5].tolist()}")
                    total += got
                want = kt.kmer_lookup_plain(*wplanes, *wq, min_count).numpy()
                if not np.array_equal(total, want):
                    raise AssertionError(
                        f"lookup_sharded: the sum over {tab.n_shards} shards "
                        f"differs from the unsharded lookup")


def _join64(hi, lo) -> np.ndarray:
    """int32 hi/lo planes -> the u64 hashes."""
    return ((hi.astype(np.int64).astype(np.uint64) << np.uint64(32))
            | (lo.astype(np.int64).astype(np.uint64)
               & np.uint64(0xFFFFFFFF)))


def _table_keys(tab):
    """(hashes, counts) of the keys a table's slot entries hold (one table
    or a stack of shards)."""
    e = tab.entries.reshape(-1, 4)
    live = ~((e[:, 0] == -1) & (e[:, 1] == -2))
    return _join64(e[live, 0], e[live, 1]), e[live, 2].astype(np.int64)


def main(argv) -> int:
    from . import dp_cases

    if compiler() is None:
        print("warp_emu: no C++ compiler", file=sys.stderr)
        return 1
    bad = 0
    with tempfile.TemporaryDirectory() as d:
        exe = build(d)
        for name in argv or dp_cases.CASE_NAMES + KMER_CASES:
            try:
                if name in KMER_CASES:
                    check_kmer_case(exe, name)
                else:
                    check_case(exe, dp_cases.edge_case(name))
                print(f"{name}: equal")
            except (AssertionError, RuntimeError) as e:
                bad += 1
                print(f"FAILED {e}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
