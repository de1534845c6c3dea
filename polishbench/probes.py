"""What a traced run records around the program, from the benchmark's own
files: the intervals of the program's stage spans, and the bytes of the problems
that the chunk program and the k-mer kernels solve (roofline.py turns
them into a least time).

The program's stage hook (utils/timing.stage) keeps only a total per
name; the recorder swaps its totals dict for one that also keeps each
interval (name, thread, start, end) as a stage closes. The byte counters
wrap the chunk program's upload and download (ChunkRunner.put and
ChunkRunner.finish) and the two device k-mer routes (KmerTable.get_device,
kmer_score.device_min_kscores). They are installed only in traced runs
and removed by uninstall().
"""

from __future__ import annotations

import collections
import threading
import time

from . import roofline


class StageIntervals(collections.defaultdict):
    """A stand-in for utils.timing._totals: the same running totals, and
    each closed stage as (name, thread id, start, end) on time.time()."""

    def __init__(self):
        super().__init__(float)
        self.intervals = []

    def __setitem__(self, name, total):
        if name in self:  # (a first read sets 0.0 through here: no stage)
            end = time.time()
            dt = total - self[name]
            self.intervals.append((name, threading.get_ident(), end - dt,
                                   end))
        super().__setitem__(name, total)

    def clear(self):
        super().clear()
        self.intervals = []


class Probes:
    """Installed on the program for a traced run."""

    def __init__(self):
        self.bytes = collections.Counter()
        self._lock = threading.Lock()
        self._undo = []
        self.stages = StageIntervals()

    def _add(self, key: str, n: int) -> None:
        with self._lock:
            self.bytes[key] += int(n)

    def _patch(self, owner, attr: str, wrapper) -> None:
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, orig))
        setattr(owner, attr, wrapper(orig))

    def install(self) -> None:
        from nextpolish2_tpu_torch.io.yak import KmerTable
        from nextpolish2_tpu_torch.ops import kmer_score
        from nextpolish2_tpu_torch.pipeline.engine import ChunkRunner
        from nextpolish2_tpu_torch.utils import timing

        self._undo.append((timing, "_totals", timing._totals))
        timing._totals = self.stages
        timing.enable(True)
        probes = self

        def put(orig):
            def wrapped(self, arrays):
                probes._add("chunk_in", roofline.chunk_bytes_in(arrays))
                return orig(self, arrays)
            return wrapped

        def finish(orig):
            def wrapped(self, out):
                probes._add("chunk_out", roofline.chunk_bytes_out(out))
                return orig(self, out)
            return wrapped

        def lookup(orig):
            def wrapped(self, hashes, min_count):
                probes._add("kmer", roofline.kmer_lookup_bytes(len(hashes)))
                return orig(self, hashes, min_count)
            return wrapped

        def score(orig):
            def wrapped(table, seqs, min_count):
                out = orig(table, seqs, min_count)
                if out is not None:
                    probes._add("kmer", roofline.kmer_score_bytes(seqs))
                return out
            return wrapped

        self._patch(ChunkRunner, "put", put)
        self._patch(ChunkRunner, "finish", finish)
        self._patch(KmerTable, "get_device", lookup)
        self._patch(kmer_score, "device_min_kscores", score)

    def uninstall(self) -> None:
        from nextpolish2_tpu_torch.utils import timing

        timing.enable(False)
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)
