"""A short probe of the seven kernels for the first run on a card after a
change to any file under csrc/: seconds, where the whole smoke run takes
minutes.

    python3 -m nextpolish2_tpu_torch.utils.kernel_probe

It builds the kernels and prints what `ptxas -v` says of every source
(registers, stack, spills), holds the four chunk kernels to their twins on
every edge-case table of dp_cases (dynamic-K under an exact and a mangled
n_slots; every failing case is reported, not only the first), and times them
on synthetic chunks of the production shapes: a 4-window table from
dp_cases.make_case (sparse: about 1.3 live slots a column, as real chunks;
dense: 2 at K=8, 12 at K=48) repeated to B windows, with the first and last 4
windows compared with the twins. One JSON line per
shape (median of 20 launches, CUDA events). The three k-mer kernels are held
to their twins on the bundled k21 and k31 tables, packed on the card
(present, absent, below-min_count and high-bit queries; alleles with Ns,
empty ones, ones shorter than k, padding; the sharded lookup on each table
split into 2 shards, whose sum must also equal the unsharded lookup), and
timed at 2^20 queries and bases. Exit code 1 on any difference. The times are for comparing two builds
of a kernel with each other; the figures of record come from chip_smoke.py,
on real chunks.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

SHAPES = [(8, 512, 1280, 1027), (8, 128, 1280, 1027), (8, 128, 2560, 1421),
          (48, 128, 1280, 1027), (48, 128, 2560, 1421)]  # K, B, W, span
DENSITIES = {
    "sparse": lambda K: dict(reads=4, err=0.01, p_ins=0.01, p_late=0.05),
    "dense": lambda K: dict(reads=6 if K == 8 else 30,
                            err=0.05 if K == 8 else 0.3),
}


def _median_ms(fn, n: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def check_kmer_kernels(dev) -> int:
    """kmer_lookup and kmer_min_scores against their twins on the bundled
    tables; one JSON line per table. Returns the number of differences."""
    import os

    import numpy as np
    import torch

    from ..io.fastx import read_fastx
    from ..io.yak import load_yak
    from ..ops import kmer_score as ks
    from ..ops import kmer_table as kt
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded_kmer import ShardedKmerTable

    data = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "testdata")
    ref = next(iter(read_fastx(os.path.join(data, "slice.fa"))))[1]
    bad = 0
    for name in ("k21.yak", "k31.yak"):
        rng = np.random.default_rng(5)
        table = load_yak(os.path.join(data, name))
        table.device = dev
        tab, hi, lo, ct = table.device_table()
        h = table.full_hashes()
        n = 1 << 20
        q = np.concatenate([
            rng.choice(h, n // 2),
            rng.integers(0, 1 << (2 * table.ksize), n // 4, dtype=np.uint64),
            rng.integers(0, 1 << 62, n // 4, dtype=np.uint64)
            | np.uint64(1 << 63) | np.uint64(1 << 31)])
        qd = [torch.from_numpy(a).to(dev) for a in tab.query_host_arrays(q)]
        seqs, total = [], 0
        while total < n - 200:
            m = int(rng.integers(0, 200))
            at = int(rng.integers(0, len(ref) - m))
            a = bytearray(ref[at : at + m])
            if m > 40 and rng.random() < 0.1:
                a[m // 2] = ord("N")
            seqs.append(bytes(a))
            total += m + 1
        codes, starts = (torch.from_numpy(a).to(dev)
                         for a in ks.score_inputs(seqs))
        equal = True
        for min_count in (0, 5, 40):
            for n_probes in (tab.n_probes, kt.MAX_PROBES):
                got = kt.kmer_lookup(hi, lo, ct, *qd, min_count, n_probes)
                want = kt.kmer_lookup_plain(hi, lo, ct, *qd, min_count,
                                            n_probes)
                sg = ks.kmer_min_scores(hi, lo, ct, codes, starts,
                                        table.ksize, min_count, n_probes)
                sw = ks.kmer_min_scores_plain(hi, lo, ct, codes, starts,
                                              table.ksize, min_count,
                                              n_probes)
                torch.cuda.synchronize()
                equal &= torch.equal(got, want) and torch.equal(sg, sw)
        # the sharded lookup: every shard of 2 against its twin, and the
        # shards' sum against the unsharded lookup
        sharded = ShardedKmerTable.build(h, table.counts.astype(np.int64),
                                         table.ksize, 2)
        shi, slo, sct = sharded.put(make_mesh(1, 2, devices=[dev, dev]))
        sq = [torch.from_numpy(a).to(dev)
              for a in sharded.query_host_arrays(q)]
        for min_count in (0, 5):
            total = kt.kmer_lookup(hi, lo, ct, *qd, min_count, tab.n_probes)
            for s in range(2):
                got = kt.kmer_lookup_sharded(shi[s], slo[s], sct[s], *sq, s,
                                             min_count, sharded.n_probes)
                want = kt.kmer_lookup_sharded_plain(
                    shi[s], slo[s], sct[s], *sq, s, min_count,
                    sharded.n_probes)
                torch.cuda.synchronize()
                equal &= torch.equal(got, want)
                total = total - got
            equal &= not bool(total.any())
        bad += not equal
        print(json.dumps({
            "kmer_table": name, "keys": len(h), "slots": tab.size,
            "n_probes": tab.n_probes, "equal_to_twins": equal,
            "lookup_ms_at_2^20": _median_ms(lambda: kt.kmer_lookup(
                hi, lo, ct, *qd, 5, tab.n_probes)),
            "sharded_lookup_ms_at_2^20_shard_0_of_2": _median_ms(
                lambda: kt.kmer_lookup_sharded(shi[0], slo[0], sct[0], *sq, 0,
                                               5, sharded.n_probes)),
            "score_ms_at_2^20": _median_ms(lambda: ks.kmer_min_scores(
                hi, lo, ct, codes, starts, table.ksize, 5, tab.n_probes)),
            "device": torch.cuda.get_device_name(0)}), flush=True)
    return bad


def main() -> int:
    import torch

    from ..ops import consensus_cuda as cc
    from . import dp_cases

    if not torch.cuda.is_available():
        print("kernel_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    info = cc.build_kernels(force=True)
    for name in cc.SOURCES:
        for line in info[name]["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    bad = check_kmer_kernels(dev)
    for case in dp_cases.edge_cases():
        try:
            print(json.dumps(dp_cases.check_kernels(case, dev)))
        except AssertionError as e:
            bad += 1
            print(f"FAILED {e}")
    for K, B, W, span in SHAPES:
        for density, opts in DENSITIES.items():
            case = dp_cases.make_case(
                "probe", 7, K, 4, W, [span, span - 3, span - 40, span],
                **opts(K))
            small = dp_cases.case_tensors(case, dev)
            key, cnt, cov, lead, seed8, sp, last_col = (
                x.repeat(B // 4, *([1] * (x.dim() - 1))) for x in small)
            steps = W + 128
            sk, bk = cc.consensus_dp_v2(key, cnt, cov, lead, seed8, sp)
            ok = cc.backtrack_packed(key, cnt, cov, sk, bk, last_col, seed8,
                                     steps)
            ns = torch.from_numpy(dp_cases.exact_n_slots(case.key)).to(dev)
            n_slots = ns.repeat(B // 4, 1)
            sb, bb = cc.consensus_dp_base(key, cnt, cov, lead, seed8)
            sd, bd = cc.consensus_dp_dynk(key, cnt, cov, n_slots, lead, seed8)
            s4, b4 = cc.consensus_dp_plain(*small[:6])
            o4 = cc.backtrack_plain(*small[:3], s4, b4, small[6], small[4],
                                    steps)
            sb4, bb4 = cc.consensus_dp_base_plain(*small[:5])
            sd4, bd4 = cc.consensus_dp_dynk_plain(*small[:3], ns, *small[3:5])
            equal = all(torch.equal(got[sl], want) for got, want in
                        ((sk, s4), (bk, b4), (ok, o4), (sb, sb4), (bb, bb4),
                         (sd, sd4), (bd, bd4))
                        for sl in (slice(0, 4), slice(B - 4, B)))
            bad += not equal
            print(json.dumps({
                "K": K, "B": B, "W": W, "density": density,
                "live_slots_mean": float((key >= 0).sum(-1).float().mean()),
                "equal_to_twins": equal,
                "dp_ms": _median_ms(lambda: cc.consensus_dp_v2(
                    key, cnt, cov, lead, seed8, sp)),
                "backtrack_ms": _median_ms(lambda: cc.backtrack_packed(
                    key, cnt, cov, sk, bk, last_col, seed8, steps)),
                "base_ms": _median_ms(lambda: cc.consensus_dp_base(
                    key, cnt, cov, lead, seed8)),
                "dynk_ms": _median_ms(lambda: cc.consensus_dp_dynk(
                    key, cnt, cov, n_slots, lead, seed8)),
                "device": torch.cuda.get_device_name(0)}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
