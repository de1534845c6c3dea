"""The port's segmented chromosome-scale engine on the CPU, on the bundled
fixtures with small segments (byte-exact: tolerance 0):

  - the port's RangeScanner against its whole-contig native ingest on the
    slice and on one m20 contig (one range equals the full ingest; ascending
    ranges cover it; a same-lo extension is a superset): the counterparts of
    the JAX package's scanner tests, which need a file absent here;
  - polish_contig_cuda_segmented on the slice (NP2_SEG_LEN=5000, k21+k31)
    and on one m20 contig (NP2_SEG_LEN=10000) against the port's
    whole-contig polish_contig_cuda, the JAX package's
    polish_contig_tpu_segmented on the same input, and the goldens;
  - routing: NP2_SEG_FORCE through polish_contig_cuda, through polish() at
    threads=4 (segments ride the cross-contig batcher) and at threads=1
    (the one-contig ingest lookahead declines such contigs, and each of them
    still reaches the segmented engine).
"""

import numpy as np
import pytest
import torch

from nextpolish2_tpu.config import PolishConfig as JaxPolishConfig
from nextpolish2_tpu.io.yak import load_yak as jax_load_yak
from nextpolish2_tpu.pipeline.segmented import polish_contig_tpu_segmented
from nextpolish2_tpu_torch.config import PolishConfig
from nextpolish2_tpu_torch.io.bam import BamReader
from nextpolish2_tpu_torch.io.fastx import read_fastx
from nextpolish2_tpu_torch.io.native import RangeScanner, available
from nextpolish2_tpu_torch.io.yak import load_yak
from nextpolish2_tpu_torch.models.oracle import (build_alignseqs_native_flat,
                                                 consensus_to_bytes)
from nextpolish2_tpu_torch.pipeline import engine
from nextpolish2_tpu_torch.pipeline.segmented import \
    polish_contig_cuda_segmented
from nextpolish2_tpu_torch.utils.seqcodes import ASCII2CODE

# one OpenMP thread per test worker: see test_torch_consensus.py
torch.set_num_threads(1)

BASE = "testdata"
# fixture -> (fasta, bam, yak tables, truth, NP2_SEG_LEN of the byte test)
FIXTURES = {
    "slice": ("slice.fa", "slice.bam", ("k21.yak", "k31.yak"),
              "slice.golden.fa", 5000),
    "m20": ("m20.fa", "m20.bam", ("m20.k21.yak",), "m20.truth.fa", 10000),
}


@pytest.fixture(autouse=True)
def _native():
    if not available():
        pytest.skip("native library unavailable (g++ build failed)")


def _contig(fixture: str, index: int = 0):
    """(name, tseq, bam path, tid, truth) of one contig of a fixture."""
    fa, bam, _, truth, _ = FIXTURES[fixture]
    name, tseq = list(read_fastx(f"{BASE}/{fa}"))[index]
    bam = f"{BASE}/{bam}"
    tid = [n for n, _ in BamReader(bam).references].index(name)
    want = dict(read_fastx(f"{BASE}/{truth}"))[name]
    return name, tseq, bam, tid, want


def _reads_and_codes(fixture):
    _, tseq, bam, tid, _ = _contig(fixture)
    cfg = PolishConfig(min_ctg_len=1000)
    aligns, _ = build_alignseqs_native_flat(bam, tid, tseq, cfg)
    codes = ASCII2CODE[np.frombuffer(tseq, dtype=np.uint8)]
    return tseq, bam, tid, cfg, codes, aligns[1:]


def _read_rows(r):
    ends = np.append(r["read_start"][1:], len(r["t"]))
    for i, o in enumerate(r["orders"]):
        yield i, int(o), int(r["read_start"][i]), int(ends[i])


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_scanner_one_range_equals_full_ingest(fixture):
    tseq, bam, tid, cfg, codes, reads = _reads_and_codes(fixture)
    with RangeScanner(bam, tid, codes, cfg) as sc:
        r = sc.next(0, len(tseq))
    assert len(reads) > 20
    assert list(r["orders"]) == list(range(1, len(reads) + 1))
    for i, o, s, e in _read_rows(r):
        a = reads[o - 1]
        assert np.array_equal(r["t"][s:e] + r["base"], a.t_pos)
        assert np.array_equal(r["k"][s:e], a.kkey)
        assert r["bounds"][i, 0] + r["base"] == a.aln_t_s
        assert r["bounds"][i, 1] + r["base"] == a.aln_t_e
        assert bool(r["clip_drop"][i]) == a.dropped


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_scanner_multi_range_covers_and_matches(fixture):
    tseq, bam, tid, cfg, codes, reads = _reads_and_codes(fixture)
    seen = set()
    lo = 0
    his = [int(len(tseq) * f) for f in (0.25, 0.45, 0.7)] + [len(tseq)]
    with RangeScanner(bam, tid, codes, cfg) as sc:
        for hi in his:
            r = sc.next(max(0, lo - 2), hi)
            assert len(r["orders"])
            for i, o, s, e in _read_rows(r):
                a = reads[o - 1]
                assert np.array_equal(r["t"][s:e] + r["base"], a.t_pos)
                assert np.array_equal(r["k"][s:e], a.kkey)
                assert r["bounds"][i, 0] + r["base"] == a.aln_t_s
                assert bool(r["clip_drop"][i]) == a.dropped
                # the range's read set: overlap by trimmed bounds
                assert a.aln_t_s < hi and a.aln_t_e >= max(0, lo - 2)
                seen.add(o)
            lo = hi
    assert len(seen) == len(reads)


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_scanner_same_lo_extension(fixture):
    """Re-calling next() with the same t_lo and a larger t_hi extends the
    set (the SegmentCutError retry path)."""
    tseq, bam, tid, cfg, codes, _ = _reads_and_codes(fixture)
    with RangeScanner(bam, tid, codes, cfg) as sc:
        r1 = sc.next(0, len(tseq) // 4)
        r2 = sc.next(0, len(tseq) // 2)
    assert len(r2["orders"]) > len(r1["orders"]) > 0
    assert set(r1["orders"].tolist()) <= set(r2["orders"].tolist())


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_segmented_byte_identical(fixture, monkeypatch):
    """Small segments (several per contig, 2 iterations, phasing and the
    multi-k recheck) give the whole-contig engine's bytes, the JAX
    package's segmented engine's bytes and the golden."""
    _, tseq, bam, tid, want = _contig(fixture)
    yaks, seg = FIXTURES[fixture][2], FIXTURES[fixture][4]
    monkeypatch.setenv("NP2_SEG_LEN", str(seg))
    before = engine.STATS["segments"]
    cb = polish_contig_cuda_segmented(
        tseq, [load_yak(f"{BASE}/{y}") for y in yaks],
        PolishConfig(min_ctg_len=1000), bam, tid, device="cpu")
    got = consensus_to_bytes(cb)
    assert engine.STATS["segments"] - before >= 2 * (len(tseq) // seg)
    assert got == want
    jcb = polish_contig_tpu_segmented(
        tseq, [jax_load_yak(f"{BASE}/{y}") for y in yaks],
        JaxPolishConfig(min_ctg_len=1000), bam, tid)
    assert jcb.to_bytes() == cb.to_bytes()
    assert np.array_equal(jcb.pos, cb.pos)
    monkeypatch.setenv("NP2_NO_SEG", "1")
    whole = engine.polish_contig_cuda(
        tseq, [], [load_yak(f"{BASE}/{y}") for y in yaks],
        PolishConfig(min_ctg_len=1000), device="cpu", native=(bam, tid),
        fallback=False)
    assert whole.to_bytes() == cb.to_bytes()
    assert np.array_equal(whole.pos, cb.pos)


def test_segmented_routing_in_polish_contig_cuda(monkeypatch):
    """polish_contig_cuda routes a native contig to the segmented engine
    under NP2_SEG_FORCE (and by length under a lowered NP2_SEG_MIN), and
    not when the caller hands its ingest (pre_ingest)."""
    _, tseq, bam, tid, want = _contig("m20", 1)
    tables = [load_yak(f"{BASE}/m20.k21.yak")]
    cfg = PolishConfig(min_ctg_len=1000)
    monkeypatch.setenv("NP2_SEG_LEN", "30000")
    for env, value in (("NP2_SEG_FORCE", "1"),
                       ("NP2_SEG_MIN", str(len(tseq)))):
        with monkeypatch.context() as m:
            m.setenv(env, value)
            before = engine.STATS["segmented_contigs"]
            cb = engine.polish_contig_cuda(tseq, [], tables, cfg,
                                           device="cpu", native=(bam, tid))
            assert engine.STATS["segmented_contigs"] == before + 1
            assert consensus_to_bytes(cb) == want
    monkeypatch.setenv("NP2_SEG_FORCE", "1")
    before = engine.STATS["segmented_contigs"]
    pre = build_alignseqs_native_flat(bam, tid, tseq, cfg)
    cb = engine.polish_contig_cuda(tseq, [], tables, cfg, device="cpu",
                                   native=(bam, tid), pre_ingest=pre)
    assert engine.STATS["segmented_contigs"] == before
    assert consensus_to_bytes(cb) == want


@pytest.mark.parametrize("threads", [4, 1])
def test_segmented_routing_in_polish(threads, tmp_path, monkeypatch):
    """polish() with NP2_SEG_FORCE over two m20 contigs: every contig goes
    through the segmented engine (at threads=4 its segments ride the
    batcher; at threads=1 the ingest lookahead declines each later contig
    and it is still segmented), output equal to m20.truth.fa."""
    from nextpolish2_tpu_torch.pipeline.orchestrator import (PolishStats,
                                                             polish)

    contigs = list(read_fastx(f"{BASE}/m20.fa"))[2:4]
    fa = tmp_path / "two.fa"
    fa.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s)
                            for n, s in contigs))
    truth = dict(read_fastx(f"{BASE}/m20.truth.fa"))
    monkeypatch.setenv("NP2_SEG_FORCE", "1")
    monkeypatch.setenv("NP2_SEG_LEN", "30000")
    stats = PolishStats()
    before = engine.STATS["segmented_contigs"]
    out = polish(str(fa), f"{BASE}/m20.bam", [f"{BASE}/m20.k21.yak"],
                 PolishConfig(min_ctg_len=1000, threads=threads),
                 engine="cuda", device="cpu", stats=stats, out=None)
    assert engine.STATS["segmented_contigs"] - before == 2
    assert [c.name for c in out] == [n for n, _ in contigs]
    for c in out:
        assert c.seq == truth[c.name]
    assert (stats.batches > 0) == (threads > 1)


def test_segmented_entry_raises_without_cuda(monkeypatch):
    """The segmented engine asks for the card by default, and raises where
    there is none, before it reads anything."""
    _, tseq, bam, tid, _ = _contig("m20")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        polish_contig_cuda_segmented(tseq, [load_yak(f"{BASE}/m20.k21.yak")],
                                     PolishConfig(min_ctg_len=1000), bam, tid)
    monkeypatch.setenv("NP2_SEG_FORCE", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.polish_contig_cuda(tseq, [], [], PolishConfig(min_ctg_len=1000),
                                  native=(bam, tid))
