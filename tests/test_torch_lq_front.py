"""The port's LQ front end against the JAX package's specs, on seeded random
inputs (both differential):

  - lq_from_qv_stream (array operations) against the JAX package's event
    loop: low-coverage resets inside a run, merged and back-to-back
    regions, insertion runs that repeat a position, events at indices 0, 1
    and n-1, L of 1, 2 and 5, an empty stream and one with no events;
  - the native extract_alleles (one walk over each read's tags) against the
    JAX _extract_alleles_py, region by region (order, k-mer, allele): a
    binding cap, dropped and empty reads, reads that end inside a region,
    gap tags, k of 21, 31, 32 and 33, and the segmented coord_offset with
    an order_map. The two counters agree with the port's own Python route.
"""

import copy

import numpy as np
import pytest

import nextpolish2_tpu.models.oracle_msa as jax_msa
from nextpolish2_tpu.io.yak import KmerTable as JaxKmerTable
from nextpolish2_tpu.models.oracle_align import AlignTags as JaxAlignTags
from nextpolish2_tpu.models.oracle_lq import (
    _extract_alleles_py as jax_extract_py)
from nextpolish2_tpu_torch.io import native
from nextpolish2_tpu_torch.io.yak import KmerTable
from nextpolish2_tpu_torch.models.oracle_align import AlignTags
from nextpolish2_tpu_torch.models.oracle_lq import (LqSeq,
                                                    _extract_alleles_py,
                                                    extract_alleles)
from nextpolish2_tpu_torch.models.oracle_msa import (LqRegion,
                                                     lq_from_qv_stream)
from nextpolish2_tpu_torch.utils import timing


@pytest.fixture(autouse=True)
def fresh_recorder():
    timing.enable(False)
    timing.reset()
    yield
    timing.enable(False)
    timing.reset()


class _CountingRegion(jax_msa.LqRegion):
    """The JAX loop's region, counting how often a start is written: once
    when a region is made, once more for every run merged into it."""

    start_writes = 0

    def __setattr__(self, name, value):
        if name == "start":
            type(self).start_writes += 1
        super().__setattr__(name, value)


def _stream(rng, n, *, p_low, p_cov, step_weights, base_same=0.3,
            edges=False):
    """One backtrack stream in descending genome order: positions that
    repeat inside insertion runs, bases that often repeat the previous one
    (so fewer close candidates), sparse low-qv and low-coverage events."""
    steps = rng.choice(len(step_weights), size=n,
                       p=np.asarray(step_weights) / sum(step_weights))
    pos = (10 * n - np.cumsum(steps)).astype(np.int64)
    base = rng.integers(0, 4, size=n).astype(np.uint8)
    same = rng.random(n) < base_same
    for i in np.nonzero(same)[0]:
        if i:
            base[i] = base[i - 1]
    qv = np.where(rng.random(n) < p_low, rng.integers(0, 95, size=n),
                  rng.integers(95, 101, size=n)).astype(np.uint8)
    lowcov = rng.random(n) < p_cov
    if edges and n:
        for i in (0, 1, n - 1):
            if i < n:
                qv[i] = rng.integers(0, 95)
    return pos, base, qv, lowcov


STREAM_CASES = {
    # name: (stream length range, keyword arguments of _stream)
    "lowcov_reset": ((40, 200), dict(p_low=0.12, p_cov=0.04,
                                     step_weights=[1, 6, 1])),
    "merged_back_to_back": ((40, 200), dict(p_low=0.25, p_cov=0.0,
                                            step_weights=[1, 8, 1])),
    "insertion_runs": ((40, 200), dict(p_low=0.1, p_cov=0.01,
                                       step_weights=[4, 4, 1])),
    "edge_events": ((3, 40), dict(p_low=0.08, p_cov=0.02,
                                  step_weights=[1, 6, 1], edges=True)),
}


def _regions(rs):
    return [(r.start, r.end, r.label, r.sudoseed, r.seqs) for r in rs]


@pytest.mark.parametrize("L", [1, 2, 5])
@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_lq_from_qv_stream_equals_event_loop(case, L, monkeypatch):
    """Region for region, start for start, the JAX event loop's output,
    and the same genome-order consensus; every case makes regions, and
    the merged case merges runs at L = 5."""
    (lo, hi), kw = STREAM_CASES[case]
    monkeypatch.setattr(jax_msa, "LqRegion", _CountingRegion)
    _CountingRegion.start_writes = 0
    rng = np.random.default_rng(1400 + 10 * L + sorted(STREAM_CASES)
                                .index(case))
    made = events = resets = 0
    for _ in range(60):
        n = int(rng.integers(lo, hi))
        pos, base, qv, lowcov = _stream(rng, n, **kw)
        want_cb, want = jax_msa.lq_from_qv_stream(pos, base, qv, lowcov, 95, L)
        timing.enable(True)
        cb, got = lq_from_qv_stream(pos, base, qv, lowcov, 95, L)
        timing.enable(False)
        assert _regions(got) == _regions(want)
        assert all(type(r) is LqRegion for r in got)
        np.testing.assert_array_equal(cb.pos, want_cb.pos)
        np.testing.assert_array_equal(cb.base, want_cb.base)
        ev = int(np.count_nonzero(lowcov | (qv < 95)))
        assert timing.counters().get("lq.events", 0) == ev
        assert timing.counters().get("lq.regions", 0) == len(got)
        made += len(want)
        events += ev
        # a low-coverage event right after a low-qv one: inside an open run
        resets += int(np.count_nonzero(lowcov[1:] & (qv[:-1] < 95)
                                       & ~lowcov[:-1]))
    assert made > 0 and events > made
    if case == "lowcov_reset":
        assert resets > 0
    if case == "merged_back_to_back" and L >= 3:
        # a run merges into the one before it only where its backscan
        # (from L before its first event) reaches that run's close, so
        # only where L >= 3
        assert _CountingRegion.start_writes > made


@pytest.mark.parametrize("n", [0, 1, 2, 50])
def test_lq_from_qv_stream_without_events(n):
    """An empty stream and streams with no event make no region; the
    consensus is the stream reversed."""
    pos = np.arange(n, dtype=np.int64)[::-1].copy()
    base = (np.arange(n) % 4).astype(np.uint8)
    qv = np.full(n, 100, np.uint8)
    lowcov = np.zeros(n, bool)
    timing.enable(True)
    cb, got = lq_from_qv_stream(pos, base, qv, lowcov, 95, 2)
    want_cb, want = jax_msa.lq_from_qv_stream(pos, base, qv, lowcov, 95, 2)
    assert got == [] and want == []
    assert timing.counters().get("lq.events", 0) == 0
    np.testing.assert_array_equal(cb.pos, want_cb.pos)
    np.testing.assert_array_equal(cb.base, want_cb.base)


def _reads(rng, n_pos, regions, n_reads):
    """Reads over a contig of n_pos positions, sorted by start with a few
    out of order: insertions repeat a tag position, gap tags (4) and N (5)
    among the bases, runs of gap tags (deletions) that push a k-mer past
    the decode limit, some reads dropped or empty, some ending inside a
    region."""
    out = []
    starts = np.sort(rng.integers(0, n_pos - 60, size=n_reads))
    if n_reads > 4:  # the sticky region cursor on non-monotone starts
        starts[2], starts[3] = starts[3], starts[2]
    for s in starts.tolist():
        if rng.random() < 0.2 and regions:
            r = regions[int(rng.integers(0, len(regions)))]
            e = max(s + 1, int(rng.integers(r.start, r.end + 1)))
        else:
            e = s + int(rng.integers(40, 400))
        e = min(n_pos - 1, e)
        reps = 1 + (rng.random(e - s + 1) < 0.12) \
            * rng.integers(1, 4, size=e - s + 1)
        t_pos = np.repeat(np.arange(s, e + 1, dtype=np.int32), reps)
        q = rng.choice(6, size=len(t_pos),
                       p=[0.22, 0.22, 0.22, 0.22, 0.1, 0.02]).astype(np.uint8)
        for _ in range(int(rng.integers(0, 4))):
            d = int(rng.integers(0, len(q)))
            q[d:d + int(rng.integers(5, 40))] = 4
        kind = rng.random()
        if kind < 0.06:
            t_pos, q = t_pos[:0], q[:0]  # an empty read
        out.append((s, e, t_pos, q, bool(0.06 <= kind < 0.14)))
    return out


def _dense_regions(rng, lo, hi):
    """Descending, non-overlapping regions every ~2-12 positions, some
    back to back, between lo and hi, with gaps of 30-80 positions here and
    there: a read's last region before one ends its decode early."""
    regs, p = [], lo + int(rng.integers(0, 5))
    while p < hi:
        e = min(hi, p + int(rng.integers(0, 6)))
        regs.append(LqRegion(start=p, end=e))
        p = e + 1 + int(rng.integers(30, 80) if rng.random() < 0.15
                        else rng.integers(0, 8))
    return regs[::-1]


def _seqs(regions):
    return [[(q.order, q.kmer, q.seq) for q in r.seqs] for r in regions]


@pytest.mark.parametrize("layout", ["genome", "segment", "swapped"])
@pytest.mark.parametrize("max_can", [60, 3])
@pytest.mark.parametrize("ksize", [21, 31, 32, 33])
def test_native_extract_alleles_equals_spec(ksize, max_can, layout):
    """Each region's alleles from the native walk, by order, k-mer and
    bytes, against the JAX _extract_alleles_py; regions that already hold
    alleles count against the cap. segment: regions in absolute
    coordinates with coord_offset, reads in the segment's frame, orders
    through order_map; swapped: two neighbouring regions out of order.
    The counters equal the port's Python route's."""
    if not native.available():
        pytest.skip("native library unavailable")
    segmented = layout == "segment"
    rng = np.random.default_rng(1401 + ksize * 4 + max_can
                                + ["genome", "segment", "swapped"]
                                .index(layout))
    n_pos, offset = 900, (123_456 if segmented else 0)
    regions = _dense_regions(rng, 8, n_pos - 8)
    if layout == "swapped":
        k = len(regions) // 2
        regions[k], regions[k + 1] = regions[k + 1], regions[k]
    raw = _reads(rng, n_pos, regions, 40)
    ref_codes = rng.integers(0, 4, size=n_pos).astype(np.uint8)
    full = np.arange(n_pos, dtype=np.int32)
    order_map = (np.concatenate([[0], rng.permutation(np.arange(1, 500))
                                 [:len(raw)]]).astype(np.int64)
                 if segmented else None)
    # a few regions already hold an allele: they reach the cap sooner
    for r in regions[::7]:
        r.seqs.append(LqSeq(order=0, kscore=0, kmer=0, seq=b"A"))
    ats = [AlignTags(0, n_pos - 1, full, q_base=ref_codes)] + [
        AlignTags(s, e, t, q_base=q, dropped=d) for s, e, t, q, d in raw]
    jats = [JaxAlignTags(0, n_pos - 1, full.astype(np.int64),
                         q_base=ref_codes.astype(np.int64))] + [
        JaxAlignTags(s, e, t.astype(np.int64), q_base=q.astype(np.int64),
                     dropped=d) for s, e, t, q, d in raw]
    empty = dict(ksize=ksize, pre=1, keys=np.zeros(0, np.uint64),
                 counts=np.zeros(0, np.uint16), bin_off=np.zeros(3, np.int64))
    want = copy.deepcopy(regions)
    jax_extract_py(jats, want, JaxKmerTable(**empty), max_can,
                   order_map=order_map)
    spec = copy.deepcopy(regions)
    timing.enable(True)
    _extract_alleles_py(ats, spec, KmerTable(**empty), max_can,
                        order_map=order_map)
    spec_counts = timing.counters()
    timing.enable(False)
    got = copy.deepcopy(regions)
    if segmented:  # the segment's reads and regions in absolute coordinates
        for r in got:
            r.start += offset
            r.end += offset
    timing.enable(True)
    extract_alleles(ats, got, KmerTable(**empty), max_can,
                    coord_offset=offset, order_map=order_map)
    counts = timing.counters()
    assert _seqs(got) == _seqs(want)
    assert _seqs(spec) == _seqs(want)
    if segmented:
        assert [(r.start - offset, r.end - offset) for r in got] == \
            [(r.start, r.end) for r in want]
    assert counts == spec_counts
    assert counts["lq.read_regions"] > len(regions)
    n_new = sum(len(r.seqs) for r in want) - sum(len(r.seqs) for r in regions)
    assert counts["lq.alleles"] == n_new > 0
    capped = sum(len(r.seqs) == max_can for r in want)
    assert (capped > 0) == (max_can == 3)
