"""The port's recorder (nextpolish2_tpu_torch/utils/timing.py) on the CPU:

  - off, it records nothing and leaves _totals and the counters alone;
  - enable(True) from off starts a fresh recording;
  - parents and contigs cross a thread hand-off (carry);
  - self time is a span's time less the union of its children's;
  - a dict subclass swapped into _totals, as the benchmark's probe swaps
    one in, gets the same totals, and the intervals it rebuilds match the
    recorder's spans;
  - lq.seed_native counts the regions np2obj's seed pass took: none
    where the alleles are the dataclass twin's;
  - on the bundled slice, lq.regions counts the regions the engine made,
    lq.seed_native every one of them,
    lq.events and lq.read_regions count the LQ front end's work, and the
    two k-mer route counters together count every k-mer queried,
    whichever route resolved it; off, a polish counts nothing;
  - profiler_trace writes a Chrome trace that names the pass and stages.
"""

import io
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from nextpolish2_tpu_torch.utils import timing
from nextpolish2_tpu_torch.utils.timing import Span

torch.set_num_threads(1)

BASE = "testdata"
YAKS = [f"{BASE}/k21.yak", f"{BASE}/k31.yak"]


@pytest.fixture(autouse=True)
def fresh_recorder():
    timing.enable(False)
    timing.reset()
    yield
    timing.enable(False)
    timing.reset()


def _by_name(name):
    return [s for s in timing.spans() if s.name == name]


def test_off_records_nothing_and_leaves_totals_alone():
    timing._totals["kept"] = 1.5
    fn = object()
    with timing.stage("a"), timing.span("pass"):
        timing.count("n", 3)
    assert timing.carry(fn) is fn
    assert timing.spans() == [] and timing.counters() == {}
    assert dict(timing._totals) == {"kept": 1.5}
    assert not timing.enabled()


def test_enable_starts_a_fresh_recording():
    timing.enable(True)
    with timing.stage("a"):
        timing.count("n")
    timing.enable(True)  # already on: keeps what it has
    assert [s.name for s in timing.spans()] == ["a"]
    timing.enable(False)
    assert timing.counters() == {"n": 1}  # off: still readable
    timing.enable(True)
    assert timing.spans() == [] and timing.counters() == {}
    assert timing.snapshot() == {}


def test_pass_and_contig_spans_stay_out_of_totals():
    timing.enable(True)
    with timing.span("pass"):
        with timing.span("contig", contig="c1"):
            with timing.stage("plan_windows"):
                pass
    assert set(timing.snapshot()) == {"plan_windows"}
    p, c, s = timing.spans()
    assert (p.parent, c.parent, s.parent) == (None, 0, 1)
    assert (p.contig, c.contig, s.contig) == (None, "c1", "c1")
    assert all(x.end >= x.start for x in (p, c, s))


@pytest.mark.parametrize("handoff", ["pool", "thread", "contig_override"])
def test_parent_and_contig_cross_a_thread_handoff(handoff):
    timing.enable(True)

    def work():
        with timing.stage("ingest_begin3"):
            pass

    with timing.span("pass"):
        with timing.span("contig", contig="c1"):
            if handoff == "pool":
                with ThreadPoolExecutor(1) as ex:
                    ex.submit(timing.carry(work)).result()
            elif handoff == "thread":
                t = threading.Thread(target=timing.carry(work))
                t.start()
                t.join()
            else:  # the lookahead: the next contig's ingest, under the pass
                with ThreadPoolExecutor(1) as ex:
                    ex.submit(timing.carry(work, contig="c2")).result()
    ing, = _by_name("ingest_begin3")
    assert ing.thread != threading.get_ident()
    assert ing.parent == 1 and ing.contig == ("c2" if handoff
                                              == "contig_override" else "c1")
    # the pool thread's frame is gone once the task returns
    with ThreadPoolExecutor(1) as ex:
        ex.submit(work).result()
    assert _by_name("ingest_begin3")[1].parent is None


def test_reset_drops_parents_recorded_before_it():
    timing.enable(True)
    with timing.span("pass"):
        timing.reset()
        with timing.stage("a"):
            pass
    a, = timing.spans()
    assert a.name == "a" and a.parent is None


def test_self_time_is_the_time_no_child_covers():
    recs = [Span("pass", 1, 0.0, 10.0, None, None),
            Span("a", 1, 1.0, 3.0, 0, None),
            Span("b", 2, 2.0, 5.0, 0, None),    # another thread, overlaps a
            Span("c", 2, 9.0, 12.0, 0, None),   # past the pass: clipped
            Span("d", 1, 1.5, 2.5, 1, None),    # a's child, not the pass's
            Span("e", 1, 4.0, None, 0, None)]   # open: covers nothing
    own = timing.self_seconds(recs)
    assert own == pytest.approx({"pass": 10.0 - 4.0 - 1.0, "a": 1.0,
                                 "b": 3.0, "c": 3.0, "d": 1.0})


def test_report_prints_self_time_counters_and_contig_wall():
    timing.enable(True)
    with timing.span("pass"):
        with timing.span("contig", contig="chr1"):
            with timing.stage("lq_detect"):
                with timing.stage("extract_alleles"):
                    time.sleep(0.02)
            timing.count("lq.regions", 7)
    out = io.StringIO()
    timing.report(out)
    text = out.getvalue()
    lq = next(line for line in text.splitlines() if "lq_detect" in line)
    total, own = (float(x.rstrip("s")) for x in lq.split()[1:3])
    assert total >= 0.02 and own < total
    assert "counter lq.regions" in text and text.count("\n") >= 6
    assert "contig chr1 " in text


def test_swapped_totals_get_todays_totals_and_intervals():
    """The benchmark's probe swaps _totals for a dict subclass that
    rebuilds each interval from the running total as it is written; it
    must see the totals it saw before the recorder, and its intervals must
    match the recorder's spans name for name."""
    from polishbench.probes import StageIntervals

    rec = StageIntervals()
    saved = timing._totals
    timing._totals = rec
    try:
        timing.enable(True)
        for name, dt in (("a", 0.01), ("b", 0.0), ("a", 0.005)):
            with timing.stage(name):
                time.sleep(dt)
        with timing.span("pass"):
            pass
        timing.enable(False)
    finally:
        timing._totals = saved
    spans = [s for s in timing.spans() if s.name != "pass"]
    for name in ("a", "b"):
        assert rec[name] == pytest.approx(
            sum(s.end - s.start for s in spans if s.name == name), abs=1e-9)
    assert set(rec) == {"a", "b"}  # pass is not a stage
    assert [iv[0] for iv in rec.intervals] == [s.name for s in spans]
    for (name, tid, s0, e0), s in zip(rec.intervals, spans):
        assert tid == s.thread
        assert abs(s0 - s.start) < 1e-3 and abs(e0 - s.end) < 1e-3


@pytest.mark.parametrize("seeds,changed", [
    ((b"CG", b"T"), 0),       # each seed equals the bytes it replaces
    ((b"CA", b"T"), 1),       # one base differs
    ((b"C", b"TT"), 2),       # a base deleted, one inserted
])
def test_splice_counts_the_regions_it_changed(seeds, changed):
    """update_consensus_with_lqseqs counts a splice in lq.regions_changed
    where its seed differs from the consensus bytes over the region."""
    from nextpolish2_tpu_torch.models.oracle_lq import (
        L_SUCC, update_consensus_with_lqseqs)
    from nextpolish2_tpu_torch.models.oracle_msa import Consensus, LqRegion

    cns = Consensus(pos=np.arange(8, dtype=np.int64),
                    base=np.frombuffer(b"AACGTTGA", np.uint8).copy())
    # descending genome order: 2-3 ("CG") and 5-5 ("T")
    regions = [LqRegion(5, 5, L_SUCC, seeds[1]),
               LqRegion(2, 3, L_SUCC, seeds[0])]
    update_consensus_with_lqseqs(regions, cns, L_SUCC)  # off: no counter
    assert timing.counters() == {}
    timing.enable(True)
    out = update_consensus_with_lqseqs(regions, cns, L_SUCC)
    assert timing.counters() == {"lq.regions_changed": changed}
    assert out.base.tobytes() == b"AA" + seeds[0] + b"T" + seeds[1] + b"GA"


@pytest.mark.parametrize("items", ["native", "dataclass"])
def test_seed_native_counts_the_regions_the_native_pass_took(items):
    """lq.seed_native counts the regions that mark_hete_lqseqs and
    fill_seed_lqseqs hand to np2obj's walk when it loads, and reads 0
    where the alleles are the dataclass twin's."""
    from nextpolish2_tpu_torch.io.native import load_obj
    from nextpolish2_tpu_torch.models.oracle_lq import (
        L_HETE, LqSeq, fill_seed_lqseqs, mark_hete_lqseqs)
    from nextpolish2_tpu_torch.models.oracle_msa import LqRegion

    obj = load_obj()
    assert obj is not None
    cls = obj.LqSeq if items == "native" else LqSeq

    def regions(n):  # descending genome order; a het site each
        return [LqRegion(10 * i, 10 * i + 1, seqs=[
            cls(0, 3, 0, b"AC"), cls(4, 2, 0, b"AG"), cls(9, 2, 0, b"AG")])
            for i in range(n, 0, -1)]

    het, seed = regions(5), regions(3)
    timing.enable(True)
    mark_hete_lqseqs(het, 60)
    fill_seed_lqseqs(seed, 4, 60)
    c = timing.counters()
    assert c.get("lq.seed_native", 0) == (8 if items == "native" else 0)
    assert c["lq.het_regions"] == 5
    assert all(r.label & L_HETE for r in het)
    assert [r.sudoseed for r in seed] == [b"AG"] * 3


def _k_mers(seqs, k):
    return sum(len(s) - k + 1 for s in seqs if len(s) >= k)


@pytest.mark.parametrize("route", ["host", "device", "mixed"])
def test_slice_counts_regions_and_every_kmer_once(route, monkeypatch):
    """The slice polished on the CPU, its tables on the host route, on the
    device routes (device="cpu", thresholds at 1), or scoring on the
    device and lookups on the host. The regions the engine made and the
    k-mers asked of the tables and of the scorer, counted by wrappers,
    equal the recorder's counters; the LQ front end's two work counters
    read above 0; and the output is the golden's. Off (host route), a
    polish leaves the recorder empty."""
    from nextpolish2_tpu_torch.config import PolishConfig
    from nextpolish2_tpu_torch.io import yak
    from nextpolish2_tpu_torch.io.fastx import read_fastx
    from nextpolish2_tpu_torch.ops import kmer_score
    from nextpolish2_tpu_torch.pipeline import engine, orchestrator

    if route != "host":
        orig_load = orchestrator.load_yak

        def load_on_device(path):
            t = orig_load(path)
            t.use_device, t.device = True, "cpu"
            return t

        monkeypatch.setattr(orchestrator, "load_yak", load_on_device)
        monkeypatch.setenv("NP2_KMER_SCORE_DEVICE_MIN", "1")
        monkeypatch.setenv("NP2_KMER_DEVICE_MIN",
                           "1" if route == "device" else str(1 << 40))
    asked = {"regions": 0, "kmers": 0}
    orig_lq, orig_get = engine.lq_from_qv_stream, yak.KmerTable.get
    orig_score = kmer_score.device_min_kscores

    def lq(*a, **kw):
        cb, regions = orig_lq(*a, **kw)
        asked["regions"] += len(regions)
        return cb, regions

    def get(self, hashes, min_count=0):
        asked["kmers"] += len(np.atleast_1d(hashes))
        return orig_get(self, hashes, min_count)

    def score(table, seqs, min_count):
        asked["kmers"] += _k_mers(seqs, table.ksize)
        return orig_score(table, seqs, min_count)

    monkeypatch.setattr(engine, "lq_from_qv_stream", lq)
    monkeypatch.setattr(yak.KmerTable, "get", get)
    monkeypatch.setattr(kmer_score, "device_min_kscores", score)
    if route == "host":  # off, a polish leaves the counters empty
        orchestrator.polish(f"{BASE}/slice.fa", f"{BASE}/slice.bam", YAKS,
                            PolishConfig(min_ctg_len=1000), device="cpu",
                            out=io.BytesIO())
        assert timing.counters() == {} and timing.spans() == []
        asked.update(regions=0, kmers=0)
    sink = io.BytesIO()
    timing.enable(True)
    orchestrator.polish(f"{BASE}/slice.fa", f"{BASE}/slice.bam", YAKS,
                        PolishConfig(min_ctg_len=1000), device="cpu",
                        out=sink)
    timing.enable(False)
    c = timing.counters()
    golden = next(iter(read_fastx(f"{BASE}/slice.golden.fa")))[1]
    assert sink.getvalue().split(b"\n")[1] == golden
    assert asked["regions"] > 0 and c["lq.regions"] == asked["regions"]
    # every region goes through the native seed pass, in mark_hete_lqseqs
    # (first iteration) or fill_seed_lqseqs (last)
    assert c["lq.seed_native"] == asked["regions"]
    dev, host = c.get("kmer.queries_device", 0), c.get("kmer.queries_host", 0)
    assert asked["kmers"] > 0 and dev + host == asked["kmers"]
    assert (dev > 0, host > 0) == {"host": (False, True),
                                   "device": (True, False),
                                   "mixed": (True, True)}[route]
    assert c["lq.alleles"] > c["lq.regions"]
    # the detector took more events than it made regions; extraction
    # visited every (read, region) pair it cut an allele for, and more
    assert c["lq.events"] > c["lq.regions"]
    assert c["lq.read_regions"] >= c["lq.alleles"]
    p, = _by_name("pass")
    contig, = _by_name("contig")
    assert contig.contig == "slice" and contig.parent == timing.spans() \
        .index(p)
    # every span but the pass, its table load and its heap release works
    # for the contig
    assert {s.contig for s in timing.spans()
            if s.name not in ("pass", "load_yak_tables", "release_heap")} \
        == {"slice"}


def test_profiler_trace_names_the_pass_and_a_stage(tmp_path):
    """profiler_trace turns the recorder on for its block and opens a
    record_function per span: the Chrome trace names them."""
    with timing.profiler_trace(str(tmp_path)):
        with timing.span("pass"):
            with timing.stage("plan_windows"):
                torch.ones(4).sum()
    assert not timing.enabled()
    path = tmp_path / f"np2_trace.{os.getpid()}.json"
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pass", "plan_windows"} <= names
    assert [s.name for s in timing.spans()] == ["pass", "plan_windows"]
