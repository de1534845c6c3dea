"""The readers of the diploid cell's batcher and phasing counters
(batcher.lane_fill, phasing.us_per_het_region) on hand-made recordings:
their values, and nothing to read where a counter is 0 or missing or the
program has no recorder."""

import pytest

from polishbench import spec

BASES = 8_250_000

# (name, thread, start, end, parent, contig): two contigs phasing on their
# own threads, the batcher's worker, and one phasing span still open
SPANS = [("pass", 1, 0.0, 20.0, None, None),
         ("contig", 2, 0.1, 19.0, 0, "ctg000"),
         ("contig", 3, 0.1, 18.0, 0, "ctg001"),
         ("batch_aggregate", 4, 1.0, 1.5, 0, None),
         ("batch_dispatch", 4, 1.5, 1.6, 0, None),
         ("phasing", 2, 5.0, 5.75, 1, "ctg000"),
         ("phasing", 3, 6.0, 6.5, 2, "ctg001"),
         ("lq_detect", 2, 4.0, 5.0, 1, "ctg000"),
         ("phasing", 3, 17.0, None, 2, "ctg001")]
COUNTERS = {"batcher.batches": 12, "batcher.lanes_dispatched": 1536,
            "batcher.lanes_real": 1152, "lq.het_regions": 2500,
            "phasing.edges": 90000, "phasing.reads_dropped": 300}

READS = {
    "batcher.lane_fill": 100.0 * 1152 / 1536,
    "phasing.us_per_het_region": 1e6 * (0.75 + 0.5) / 2500,
}
# the counter a reader divides by
DIVISOR = {"batcher.lane_fill": "batcher.lanes_dispatched",
           "phasing.us_per_het_region": "lq.het_regions"}


def _ctx(spans=SPANS, counters=COUNTERS):
    return {"bases": BASES, "program": {"spans": list(spans),
                                        "counters": dict(counters)}}


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_on_recorded_sample(name):
    assert spec.load_metric_reader(name).read(_ctx()) \
        == pytest.approx(READS[name])


@pytest.mark.parametrize("name", sorted(READS))
@pytest.mark.parametrize("value", [0, None])
def test_reader_without_its_divisor(name, value):
    """The divisor counter at 0, or never counted (-t 1, a haploid
    assembly): nothing to read."""
    counters = dict(COUNTERS)
    if value is None:
        del counters[DIVISOR[name]]
    else:
        counters[DIVISOR[name]] = value
    assert spec.load_metric_reader(name).read(_ctx(counters=counters)) \
        is None


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_with_nothing_recorded(name):
    assert spec.load_metric_reader(name).read(_ctx([], {})) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_on_a_program_without_recorder(name, monkeypatch):
    from nextpolish2_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "spans")
    assert spec.load_metric_reader(name).read({"bases": BASES}) is None


def test_lane_fill_without_real_lanes_reads_zero():
    c = {k: v for k, v in COUNTERS.items() if k != "batcher.lanes_real"}
    assert spec.load_metric_reader("batcher.lane_fill").read(
        _ctx(counters=c)) == 0.0


def test_us_per_het_region_without_phasing_spans_reads_zero():
    spans = [s for s in SPANS if s[0] != "phasing"]
    assert spec.load_metric_reader("phasing.us_per_het_region").read(
        _ctx(spans=spans)) == 0.0


def test_readers_apply_to_the_diploid_cell_only():
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        if m["name"] in READS:
            assert m["workloads"] == ["hg002_diploid_t5.het"]
            assert spec.load_metric_reader(m["name"]).LAYER == m["layer"]
    names = [m.name for m in spec.resolve("hg002_diploid_t5.het").per_layer]
    assert set(READS) <= set(names)
    names = [m.name for m in
             spec.resolve("bacterial_haploid_t1.genome").per_layer]
    assert not set(READS) & set(names)
