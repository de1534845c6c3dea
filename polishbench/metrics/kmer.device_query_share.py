"""Share of the k-mers resolved on the card, in %: the program's
`kmer.queries_device` counter (KmerTable.get_device and get_sharded by
query, kmer_score.device_min_kscores by the k-mers of its alleles) over it
plus `kmer.queries_host` (the host search in KmerTable.get), each k-mer
counted once, at the leaf that resolved it (io/yak.py, ops/kmer_score.py).
Nothing to read where no query took a device route, as for
kernels.kmer_roofline."""

from polishbench.program import recording

LAYER = "k-mer scoring and splice"
UNIT = "%"
MOVES = "polish_rate"


def read(ctx):
    prog = recording(ctx)
    if not prog:
        return None
    dev = prog["counters"].get("kmer.queries_device", 0)
    if dev <= 0:
        return None
    return 100.0 * dev / (dev + prog["counters"].get("kmer.queries_host", 0))
