"""Polish contigs with the plain reference, in worker processes.

Each worker reads the inputs from their files (assembly FASTA, BAM, yak
tables) with the reference's own readers and polishes whole contigs, so
nothing the program under test derived from the inputs reaches it.
"""

from __future__ import annotations

import gc
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

# control name -> what it breaks of the configuration's guarantees
CONTROLS = {
    # every k-mer reads as absent (yak counts stop at 1023): LQ alleles are
    # chosen without the short-read tables the configuration states
    "no_kmer_scoring": {"min_kmer_count": 1024},
}


def polish_contigs(fa: str, bam: str, yaks: Sequence[str], overrides: dict,
                   names: Sequence[str], control: Optional[str] = None
                   ) -> Dict[str, Tuple[bytes, int, int]]:
    """name -> (polished bases, first and last assembly position) for each
    contig in `names`, polished by the reference under `control` (None:
    as the configuration states)."""
    from .bamio import BamReader
    from .config import PolishConfig
    from .fastx import read_fastx
    from .polish import polish_contig
    from .yak import load_yak

    if control not in (None, *CONTROLS):
        raise ValueError(f"unknown control {control!r}")
    tables = sorted((load_yak(p) for p in yaks), key=lambda t: t.ksize)
    cfg = PolishConfig(**{**overrides, **CONTROLS.get(control, {})})
    want = set(names)
    seqs = {n: s for n, s in read_fastx(fa) if n in want}
    reader = BamReader(bam)
    tids = {i: n for i, (n, _) in enumerate(reader.references) if n in want}
    records = {n: [] for n in want}
    for tid, recs in reader.by_contig():
        if tid in tids:
            records[tids[tid]] = recs
    reader.close()
    out = {}
    # millions of allele objects and no cycles among them: the cyclic
    # collector's passes over them would only cost time
    was_on = gc.isenabled()
    gc.disable()
    try:
        for n in names:
            cb = polish_contig(seqs[n], records[n], tables, cfg)
            out[n] = (cb.to_bytes(), int(cb.pos[0]) if len(cb) else 0,
                      int(cb.pos[-1]) if len(cb) else 0)
    finally:
        if was_on:
            gc.enable()
    return out


def _one(args):
    return polish_contigs(*args)


def polish_parallel(fa: str, bam: str, yaks: Sequence[str], overrides: dict,
                    groups: List[List[str]], workers: int = 1
                    ) -> Dict[str, Tuple[bytes, int, int]]:
    """polish_contigs over groups of contigs, a group a task, in up to
    `workers` fresh processes (spawned: they hold no state of the caller).
    """
    out: Dict[str, Tuple[bytes, int, int]] = {}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=max(1, workers),
                             mp_context=ctx) as ex:
        for part in ex.map(_one, [(fa, bam, list(yaks), overrides, g)
                                  for g in groups]):
            out.update(part)
    return out
