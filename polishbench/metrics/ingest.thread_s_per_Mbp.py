"""Thread-seconds of BAM ingest per Mbp: the native fused decode, filter,
expand, trim and 3-mer streams of each polished contig (io/native.py,
io/_native/np2native.cc; io/bam.py without the native library).
`ingest_alignseqs` wraps the whole ingest of a contig; ingest_begin3,
ingest_prefault, ingest_fetch3 and ingest_refstream nest inside it and are
not counted again."""

from polishbench.readers import stage_seconds_per_mbp

LAYER = "BAM ingest"
UNIT = "s/Mbp"
MOVES = "polish_rate"
STAGES = ("ingest_alignseqs",)


def read(ctx):
    return stage_seconds_per_mbp(ctx, STAGES)
