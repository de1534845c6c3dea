"""A diploid assembly at -t 3 through the port's normal path on the CPU:
the shape of the benchmark's hg002_diploid_t5.het cell at a tiny size.

polishbench/gen/fixture.py draws three polished contigs of 40-60 kb and
one passthrough contig, a het SNP every 1,331 bp, an assembly error every
20 kb, 30x reads of 8 kb with the measured HiFi errors, and k21 and k31
tables. orchestrator.polish(threads=3, engine="cuda", device="cpu")
polishes them through the cross-contig batcher, with the recorder on,
once for the three checks:

  - the FASTA is byte-identical to the plain reference's
    (polishbench/reference), passthrough contig included;
  - heterozygous regions are labelled, the read graph has edges, phasing
    drops reads, and the batcher dispatches lanes;
  - the batcher's batch_aggregate and batch_dispatch spans lie on a
    thread that no contig span lies on;
  - the pass ends by handing the C heap's free pages back to the OS
    (release_heap), which test_release_free_heap_returns_freed_pages
    checks on its own.
"""

import io
import json
import os
import sys

import pytest
import torch

from nextpolish2_tpu_torch.config import PolishConfig
from nextpolish2_tpu_torch.pipeline import orchestrator
from nextpolish2_tpu_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "polishbench", "gen"))
import fixture  # noqa: E402

from polishbench.compare import fasta_record  # noqa: E402
from polishbench.reference.worker import polish_contigs  # noqa: E402

torch.set_num_threads(1)

with open(os.path.join(ROOT, "polishbench", "traffic",
                       "hg002_diploid_t5.het.json")) as _f:
    CELL = json.load(_f)
TRAFFIC = {"contigs": [50000, 45000, 40000], "passthrough": [12000],
           "err_bp": 20000, "het_bp": CELL["het_bp"], "repeats": 1,
           "repeat_len": 3000, "repeat_copies": 2, "cov": CELL["cov"],
           "read_len": 8000, "read_errors": CELL["read_errors"],
           "kmer_cov": CELL["kmer_cov"]}
KS = [21, 31]
OVERRIDES = {"min_ctg_len": 20000}
SEED = 1331


@pytest.fixture(scope="module")
def polished(tmp_path_factory):
    """One polish of the seed's inputs with the recorder on (the K=48 DP
    twin on the CPU takes nearly all of its minute), and the reference's
    FASTA of the same inputs."""
    d = str(tmp_path_factory.mktemp("diploid_t5") / "in")
    meta = fixture.generate(TRAFFIC, KS, SEED, d)
    fa = os.path.join(d, "asm.fa")
    bam = os.path.join(d, "reads.bam")
    yaks = [os.path.join(d, f"k{k}.yak") for k in KS]
    assert meta["het_sites"] > 0

    sink = io.BytesIO()
    timing.enable(False)
    timing.reset()
    timing.enable(True)
    try:
        orchestrator.polish(fa, bam, yaks, PolishConfig(threads=3,
                                                        **OVERRIDES),
                            engine="cuda", device="cpu", out=sink)
    finally:
        timing.enable(False)
    counters = timing.counters()
    records = timing.spans()
    timing.reset()

    ref = polish_contigs(fa, bam, yaks, OVERRIDES, meta["contigs"])
    want = b"".join(fasta_record(n, *ref[n]) for n in meta["contigs"])
    return {"got": sink.getvalue(), "want": want, "counters": counters,
            "records": records}


def _reference(p):
    assert p["got"] == p["want"]


def _counters(p):
    counters = p["counters"]
    for name in ("lq.het_regions", "phasing.reads_dropped", "phasing.edges",
                 "batcher.lanes_real"):
        assert counters.get(name, 0) > 0, name
    assert counters["batcher.lanes_real"] \
        <= counters["batcher.lanes_dispatched"]
    assert counters["batcher.batches"] > 0


def _batch_spans(p):
    records = p["records"]
    contig_threads = {s.thread for s in records if s.name == "contig"}
    batch = [s for s in records
             if s.name in ("batch_aggregate", "batch_dispatch")]
    assert {s.name for s in batch} == {"batch_aggregate", "batch_dispatch"}
    assert all(s.end is not None for s in batch)
    assert not {s.thread for s in batch} & contig_threads
    assert len({s.contig for s in records if s.name == "contig"}) == 4


def _heap_release(p):
    records = p["records"]
    (pass_,) = [s for s in records if s.name == "pass"]
    released = [s for s in records if s.name == "release_heap"]
    assert len(released) == 1
    assert released[0].thread == pass_.thread
    assert pass_.start <= released[0].start <= released[0].end <= pass_.end


@pytest.mark.parametrize("check", [_reference, _counters, _batch_spans,
                                   _heap_release],
                         ids=["reference", "counters", "batch_spans",
                              "heap_release"])
def test_diploid_t3_equals_reference_and_phases(polished, check):
    check(polished)


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def test_release_free_heap_returns_freed_pages():
    """Chunks under glibc's mmap threshold, freed around a few still held,
    stay resident until release_free_heap hands their pages back."""
    held, freed = [], []
    for i in range(2048):  # 128 MiB in 64 KiB chunks, 1 in 64 held
        (held if i % 64 == 0 else freed).append(bytearray(64 << 10))
    del freed
    before = _rss()
    assert orchestrator.release_free_heap()
    assert before - _rss() > (64 << 20)
    assert len(held) == 32
