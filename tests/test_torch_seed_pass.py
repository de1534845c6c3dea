"""The seed pass's native walk (io/_native/np2obj.c: seed_regions,
mark_hete, splice_labeled) against its Python twins in
models/oracle_lq.py and the JAX package's fill_seed_lqseqs,
mark_hete_lqseqs and update_consensus_with_lqseqs, on the CPU:

  - regions of the bundled slice's first 8 kb, through lq_from_qv_stream,
    extract_alleles and retrieve_kmer_count;
  - seeded fuzz regions: count ties, ties at order 0, zero kscores,
    duplicate non-ref alleles, 60 candidates, seeds on both sides of
    max_indel_len, regions with no alleles, and a splice whose start is
    absent from pos (the walk's break).

Region for region they must give the same seqs (order, and the same
objects in the same list), sudoseed, label and kscores, the same spliced
pos and base, and the same lq.het_regions, lq.regions_changed and
lq.seed_native (every region on the native walk, none on the twin).
"""

import numpy as np
import pytest
import torch

import nextpolish2_tpu.models.oracle_lq as jax_lq
import nextpolish2_tpu.models.oracle_msa as jax_msa
from nextpolish2_tpu_torch.io import native
from nextpolish2_tpu_torch.models import oracle_lq as lq
from nextpolish2_tpu_torch.models.oracle_msa import Consensus, LqRegion
from nextpolish2_tpu_torch.utils import timing

torch.set_num_threads(1)

BASE = "testdata"
MAX_CAN = 60
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def fresh_recorder():
    timing.enable(False)
    timing.reset()
    yield
    timing.enable(False)
    timing.reset()


@pytest.fixture(scope="module")
def obj():
    mod = native.load_obj()
    assert mod is not None, "np2obj did not build"
    return mod


@pytest.fixture(scope="module")
def slice_case(obj):
    """The slice's first 8 kb through the port's LQ front end: the regions
    (as plain tuples) and the consensus they splice into."""
    from nextpolish2_tpu_torch.config import PolishConfig
    from nextpolish2_tpu_torch.io.fastx import read_fastx
    from nextpolish2_tpu_torch.io.yak import load_yak
    from nextpolish2_tpu_torch.models.oracle import \
        build_alignseqs_native_flat
    from nextpolish2_tpu_torch.models.oracle_msa import lq_from_qv_stream
    from nextpolish2_tpu_torch.pipeline.engine import (
        ChunkRunner, device_consensus_stream, resolve_dp_variants)
    from nextpolish2_tpu_torch.utils.seqcodes import ASCII2CODE

    tseq = next(iter(read_fastx(f"{BASE}/slice.fa")))[1]
    cfg = PolishConfig(min_ctg_len=1000)
    alignseqs, _ = build_alignseqs_native_flat(f"{BASE}/slice.bam", 0, tseq,
                                               cfg)
    table = load_yak(f"{BASE}/k21.yak")
    pos, base, qv, low = device_consensus_stream(
        alignseqs, len(tseq), ASCII2CODE[np.frombuffer(tseq, np.uint8)], cfg,
        ChunkRunner(torch.device("cpu")), resolve_dp_variants(None),
        plan_end=8000)
    cb, regions = lq_from_qv_stream(pos, base, qv, low, cfg.hq_min_qv,
                                    cfg.lq_min_length)
    lq.extract_alleles(alignseqs, regions, table, MAX_CAN)
    lq.retrieve_kmer_count(regions, table, cfg.min_kmer_count)
    assert all(type(s) is obj.LqSeq for r in regions for s in r.seqs)
    return _spec(regions), cb, cfg.max_indel_len


def _spec(regions):
    return [(r.start, r.end, r.label, r.sudoseed,
             [(s.order, s.kscore, s.kmer, s.seq) for s in r.seqs])
            for r in regions]


def _build(spec, region_cls, seq_cls):
    return [region_cls(start=s, end=e, label=lab, sudoseed=sd,
                       seqs=[seq_cls(*a) for a in seqs])
            for s, e, lab, sd, seqs in spec]


def _fuzz_regions(rng, n, *, alleles=(1, 5), n_seqs=(1, 20), p_zero=0.2,
                  lens=(1, 6), p_ref_top=0.3, p_neg=0.0):
    """n regions, each led by the reference allele (order 0); its other
    alleles draw from a few distinct byte strings, so counts tie often;
    with p_ref_top the reference's bytes are the commonest; kscores are 0
    with p_zero, and of those -1 with p_neg."""
    spec, start = [], 10 * n + 100
    for _ in range(n):
        end = start + int(rng.integers(0, 4))
        seqs = []
        pool = [ACGT[rng.integers(0, 4, int(rng.integers(*lens)))]
                .tobytes() for _ in range(int(rng.integers(*alleles)))]
        S = int(rng.integers(n_seqs[0], n_seqs[1] + 1))
        orders = [0] + sorted(rng.choice(np.arange(1, 500), S - 1,
                                         replace=False).tolist())
        weights = np.ones(len(pool))
        if rng.random() < p_ref_top:
            weights[0] = 4.0
        pick = rng.choice(len(pool), S, p=weights / weights.sum())
        for o, k in zip(orders, pick.tolist()):
            ks = int(rng.integers(1, 40))
            if rng.random() < p_zero:
                ks = -1 if rng.random() < p_neg else 0
            seqs.append((o, ks, int(rng.integers(0, 1 << 63)), pool[k]))
        spec.append((start, end, 0, b"", seqs))
        start -= 10
    return spec


FUZZ = {
    # name: (seed, keyword arguments of _fuzz_regions)
    "count_ties": (1, dict(alleles=(2, 4), n_seqs=(4, 12), p_zero=0.0)),
    "ties_at_order_0": (2, dict(alleles=(3, 6), n_seqs=(3, 5), p_zero=0.0,
                                p_ref_top=0.0, lens=(2, 4))),
    "zero_kscores": (3, dict(alleles=(1, 4), n_seqs=(1, 15), p_zero=0.6,
                             p_neg=0.3)),
    "dup_non_ref": (4, dict(alleles=(2, 8), n_seqs=(2, 8), p_zero=0.5)),
    "max_can_60": (5, dict(alleles=(2, 12), n_seqs=(MAX_CAN, MAX_CAN))),
    "skip_long": (6, dict(alleles=(2, 5), n_seqs=(3, 12), lens=(1, 12))),
}


@pytest.fixture(params=["slice"] + sorted(FUZZ))
def case(request):
    """(name, regions spec, consensus or None, max_indel_len)"""
    if request.param == "slice":
        spec, cb, mil = request.getfixturevalue("slice_case")
        return "slice", spec, cb, mil
    seed, kw = FUZZ[request.param]
    spec = _fuzz_regions(np.random.default_rng(1700 + seed), 150, **kw)
    return request.param, spec, None, 4


def _index(lst, originals):
    """Each item's position in `originals`, by identity."""
    at = {id(o): k for k, o in enumerate(originals)}
    return [at[id(o)] for o in lst]


def _run(fn, spec, seq_cls, *args):
    """fn over fresh regions of seq_cls items; returns the regions, the
    item order each region's list (old and now) holds, and the counters."""
    regions = _build(spec, LqRegion, seq_cls)
    lists = [r.seqs for r in regions]
    items = [list(r.seqs) for r in regions]
    timing.reset()
    timing.enable(True)
    fn(regions, *args)
    timing.enable(False)
    order = [(_index(r.seqs, it), r.seqs is old, _index(old, it))
             for r, old, it in zip(regions, lists, items)]
    return regions, order, timing.counters()


def _jax(fn, spec, *args):
    regions = _build(spec, jax_msa.LqRegion, jax_lq.LqSeq)
    fn(regions, *args)
    return regions


def test_fill_seed_matches_twin_and_jax(case, obj):
    """fill_seed_lqseqs: the native walk, the dataclass twin and the JAX
    package give the same regions; the walk keeps each list and its
    objects, cut in the twin's order, and counts every region."""
    name, spec, _, mil = case
    got, got_order, got_c = _run(lq.fill_seed_lqseqs, spec, obj.LqSeq, mil,
                                 MAX_CAN)
    twin, twin_order, twin_c = _run(lq.fill_seed_lqseqs, spec, lq.LqSeq,
                                    mil, MAX_CAN)
    want = _jax(jax_lq.fill_seed_lqseqs, spec, mil, MAX_CAN)
    assert _spec(got) == _spec(twin) == _spec(want)
    assert got_order == twin_order
    assert got_c == {"lq.seed_native": len(spec)}
    assert twin_c.get("lq.seed_native", 0) == 0
    kept = [len(r.seqs) for r in got]
    assert any(k > 1 for k in kept)
    assert any(k == 0 for k in kept) == (name != "max_can_60")
    if name == "skip_long":
        # cleared though more than one allele was kept: the seed is more
        # than max_indel_len from the first allele (kept regions, above,
        # are within it)
        assert any(not r.label & lq.L_RECH and len(o[2]) > 1
                   for r, o in zip(got, got_order))


def test_mark_hete_matches_twin_and_jax(case, obj):
    """mark_hete_lqseqs: the same labels and zeroed kscores, and the same
    lq.het_regions, on the walk as on the twin and the JAX package; regions
    with no allele are taken and left as they are."""
    name, spec, _, _ = case
    if name != "slice":  # a tenth of the regions with no allele
        spec = [s if i % 10 else (s[0], s[1], s[2], s[3], [])
                for i, s in enumerate(spec)]
    if name == "ties_at_order_0":  # the reference last: its tie rule acts
        spec = [s[:4] + (s[4][1:] + s[4][:1],) for s in spec]
    got, got_order, got_c = _run(lq.mark_hete_lqseqs, spec, obj.LqSeq,
                                 MAX_CAN)
    twin, twin_order, twin_c = _run(lq.mark_hete_lqseqs, spec, lq.LqSeq,
                                    MAX_CAN)
    want = _jax(jax_lq.mark_hete_lqseqs, spec, MAX_CAN)
    assert _spec(got) == _spec(twin) == _spec(want)
    assert got_order == twin_order
    het = sum(1 for r in want if r.label & jax_lq.L_HETE)
    assert got_c == {"lq.het_regions": het, "lq.seed_native": len(spec)}
    assert twin_c.get("lq.het_regions", 0) == het
    assert twin_c.get("lq.seed_native", 0) == 0
    if name in ("slice", "count_ties", "max_can_60"):
        assert het > 0


def _fuzz_consensus(rng, spec, absent):
    """A consensus over the regions' span: every position once or, as an
    insertion, two or three times; with `absent`, one labelled region in
    the middle of the walk starts at a position the consensus lacks."""
    lo = min(s[0] for s in spec) - 5
    hi = max(s[1] for s in spec) + 5
    p = np.arange(lo, hi + 1, dtype=np.int64)
    pos = np.repeat(p, 1 + (rng.random(len(p)) < 0.1) * rng.integers(1, 3,
                                                                      len(p)))
    if absent:
        gone = spec[len(spec) // 2][0]
        pos = pos[pos != gone]
    base = ACGT[rng.integers(0, 4, len(pos))]
    return Consensus(pos=pos, base=base)


@pytest.mark.parametrize("label", [lq.L_SUCC, lq.L_RECH])
def test_splice_matches_twin_and_jax(case, obj, label):
    """update_consensus_with_lqseqs after the seed pass: the walk's pos and
    base equal the twin's and the JAX package's, and its
    lq.regions_changed the twin's."""
    name, spec, cb, mil = case
    regions = _build(spec, LqRegion, obj.LqSeq)
    lq.fill_seed_lqseqs(regions, mil, MAX_CAN)
    rng = np.random.default_rng(1790 + len(spec))
    if cb is None:
        for r in regions:  # seeds of 0-9 bases, some equal to the consensus
            r.label = int(rng.choice([0, lq.L_SUCC, lq.L_RECH,
                                      lq.L_SUCC | lq.L_RECH]))
            r.sudoseed = ACGT[rng.integers(0, 4, int(rng.integers(0, 10)))] \
                .tobytes()
        cb = _fuzz_consensus(rng, spec, absent=name == "dup_non_ref")
    seeded = _spec(regions)
    timing.enable(True)
    got = lq.update_consensus_with_lqseqs(regions, cb, label)
    got_c = timing.counters()
    timing.reset()
    timing.enable(True)
    twin = lq._update_consensus_with_lqseqs_py(regions, cb, label)
    twin_c = timing.counters()
    timing.enable(False)
    jregions = _build(seeded, jax_msa.LqRegion, jax_lq.LqSeq)
    want = jax_lq.update_consensus_with_lqseqs(
        jregions, jax_msa.Consensus(pos=cb.pos, base=cb.base), label)
    assert got.pos.dtype == np.int64 and got.base.dtype == np.uint8
    np.testing.assert_array_equal(got.pos, want.pos)
    np.testing.assert_array_equal(got.base, want.base)
    np.testing.assert_array_equal(twin.pos, want.pos)
    np.testing.assert_array_equal(twin.base, want.base)
    assert got_c.get("lq.regions_changed", 0) \
        == twin_c.get("lq.regions_changed", 0)
    # the walk itself, as the wrapper calls it
    raw_pos, raw_base, changed = obj.splice_labeled(regions, label, cb.pos,
                                                    cb.base, True)
    np.testing.assert_array_equal(np.frombuffer(raw_pos, np.int64), want.pos)
    np.testing.assert_array_equal(np.frombuffer(raw_base, np.uint8),
                                  want.base)
    assert changed == twin_c.get("lq.regions_changed", 0)
    assert _spec(regions) == seeded  # the splice changes no region
    if name != "slice":
        labelled = sum(1 for r in regions if r.label & label)
        assert labelled > 0 and got_c["lq.regions_changed"] > 0


def test_splice_break_at_an_absent_start(obj):
    """The walk stops at the first labelled region whose start is absent
    at or after its cursor: the regions below it in genome order are
    spliced, the rest of the consensus is kept as it was."""
    cb = Consensus(pos=np.array([0, 1, 2, 2, 4, 5, 6, 7], np.int64),
                   base=np.frombuffer(b"ACGTACGT", np.uint8).copy())
    regions = [LqRegion(6, 7, lq.L_SUCC, b"GG"),
               LqRegion(3, 3, lq.L_SUCC, b"TT"),  # 3 is absent: break
               LqRegion(1, 2, lq.L_SUCC, b"A")]
    timing.enable(True)
    out = lq.update_consensus_with_lqseqs(regions, cb, lq.L_SUCC)
    assert timing.counters() == {"lq.regions_changed": 1}
    assert out.pos.tolist() == [0, 1, 4, 5, 6, 7]
    assert out.base.tobytes() == b"AAACGT"
    twin = lq._update_consensus_with_lqseqs_py(regions, cb, lq.L_SUCC)
    np.testing.assert_array_equal(out.pos, twin.pos)
    np.testing.assert_array_equal(out.base, twin.base)


def test_native_walk_falls_back_before_any_change(obj):
    """A dataclass allele anywhere sends the whole call to the twin, and
    a region not led by the reference allele raises the twin's error
    after the regions before it were seeded, as the twin leaves them."""
    spec = _fuzz_regions(np.random.default_rng(1799), 6, n_seqs=(3, 8))
    mixed = _build(spec, LqRegion, obj.LqSeq)
    mixed[-1].seqs[0] = lq.LqSeq(*spec[-1][4][0])
    timing.enable(True)
    lq.fill_seed_lqseqs(mixed, 4, MAX_CAN)
    assert timing.counters().get("lq.seed_native", 0) == 0
    assert _spec(mixed) == _spec(_jax(jax_lq.fill_seed_lqseqs, spec, 4,
                                      MAX_CAN))
    bad = [s if i != 3 else (s[0], s[1], s[2], s[3], s[4][1:] + s[4][:1])
           for i, s in enumerate(spec)]
    got = _build(bad, LqRegion, obj.LqSeq)
    want = _build(bad, jax_msa.LqRegion, jax_lq.LqSeq)
    with pytest.raises(AssertionError):
        lq.fill_seed_lqseqs(got, 4, MAX_CAN)
    with pytest.raises(AssertionError):
        jax_lq.fill_seed_lqseqs(want, 4, MAX_CAN)
    assert _spec(got) == _spec(want)
