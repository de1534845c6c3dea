"""The readers of the program's own spans and counters (program.py and
the four metrics that use it) on a recorded sample, with nothing to read,
and on the program's recorder as a traced window leaves it."""

import pytest

from polishbench import spec
from polishbench.program import recording

BASES = 14_620_000

# (name, thread, start, end, parent, contig): a pass with stages on two
# threads, and one span still open
SPANS = [("pass", 1, 0.0, 10.0, None, None),
         ("contig", 1, 0.1, 9.9, 0, "c1"),
         ("ingest_begin3", 2, 0.5, 2.0, 0, "c2"),
         ("lq_detect", 1, 1.0, 3.0, 1, "c1"),
         ("extract_alleles", 1, 3.0, 4.0, 1, "c1"),
         ("phasing", 1, 4.0, 4.5, 1, "c1"),
         ("plan_windows", 1, 5.0, 6.0, 1, "c1"),
         ("lq_detect", 3, 9.5, None, None, None)]
COUNTERS = {"lq.regions": 1000, "lq.regions_changed": 10,
            "kmer.queries_device": 3000, "kmer.queries_host": 1000}

READS = {
    "lq.us_per_region": 1e6 * (2.0 + 1.0 + 0.5) / 1000,
    "lq.changed_share": 100.0 * 10 / 1000,
    "kmer.device_query_share": 100.0 * 3000 / 4000,
    # covered: 0.5-4.5 (three stages and another thread's), then 5-6
    "orchestrator.unstaged_s_per_Mbp": (10.0 - 4.0 - 1.0) / 14.62,
}


def _ctx(spans=SPANS, counters=COUNTERS):
    return {"bases": BASES, "program": {"spans": list(spans),
                                        "counters": dict(counters)}}


@pytest.mark.parametrize("name", sorted(READS))
def test_program_reader_on_recorded_sample(name):
    assert spec.load_metric_reader(name).read(_ctx()) \
        == pytest.approx(READS[name])


@pytest.mark.parametrize("name", sorted(READS))
def test_program_reader_with_nothing_to_read(name):
    """No pass, no region, no device query: nothing to read."""
    assert spec.load_metric_reader(name).read(_ctx([], {})) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_program_reader_on_a_program_without_recorder(name, monkeypatch):
    from nextpolish2_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "spans")
    assert spec.load_metric_reader(name).read({"bases": BASES}) is None


def test_no_changed_splice_reads_zero():
    c = dict(COUNTERS, **{"lq.regions_changed": 0})
    assert spec.load_metric_reader("lq.changed_share").read(
        _ctx(counters=c)) == 0.0


def test_recording_reads_the_recorder_as_the_window_left_it():
    from nextpolish2_tpu_torch.utils import timing

    timing.enable(True)
    try:
        with timing.span("pass"):
            with timing.stage("lq_detect"):
                timing.count("lq.regions", 4)
    finally:
        timing.enable(False)
    try:
        prog = recording({"bases": BASES})
        assert [s[0] for s in prog["spans"]] == ["pass", "lq_detect"]
        assert prog["counters"] == {"lq.regions": 4}
        assert spec.load_metric_reader("lq.us_per_region").read(
            {"bases": BASES}) > 0
    finally:
        timing.reset()
