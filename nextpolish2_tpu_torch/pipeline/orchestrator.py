"""Multi-contig streaming orchestrator + top-level polish() API.

Replaces the reference's thread pipeline (input thread / N workers / output
thread over bounded channels, main.rs:1689-1856). The sorted BAM is streamed
sequentially and grouped per contig, each contig runs through the CUDA engine
(windows are the intra-contig parallel unit: the device batch), and output is
written in INPUT ORDER. At -t 1 contigs run one after another with a
one-contig ingest lookahead; at -t N a pool of N contig threads shares one
cross-contig DeviceBatcher (pipeline/batcher.py), whose worker thread owns
the device. After a pass the C heap's free pages go back to the OS
(release_free_heap), so the next pass starts from the same resident size.
"""

from __future__ import annotations

import ctypes
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..config import PolishConfig
from ..io.bam import BamReader
from ..io.fastx import read_fastx, write_fasta_record, write_pos_records
from ..io.yak import load_yak
from ..models.oracle import consensus_to_bytes, passthrough_consensus, polish_contig
from ..models.oracle_msa import Consensus


@dataclass
class PolishedContig:
    name: str
    seq: bytes
    start: int
    end: int


@dataclass
class PolishStats:
    contigs: int = 0
    polished: int = 0
    passthrough: int = 0
    in_bases: int = 0
    out_bases: int = 0
    seconds: float = 0.0
    # cross-contig batcher (threads > 1): dispatched DP batches, their mean
    # lane fill, how many were aggregated CSR-direct, and reason -> count
    # for those that fell back to dense host tables
    batches: int = 0
    batch_fill: float = 0.0
    csr_batches: int = 0
    dense_reasons: dict = field(default_factory=dict)


def _pos_runs(out_path: str) -> List[tuple]:
    """(name, run_start_offset) per contiguous contig run of an --out_pos TSV
    file, WITHOUT reading it (one row per output base — a human assembly is
    ~3G rows; per-line Python scans are off the table). Each contig's rows
    are contiguous and appear once, so "name at offset == current name" is a
    monotone predicate within the tail: exponential + binary search finds
    each run's end in O(log filesize) seeks — O(n_contigs log n) total."""
    import os

    size = os.path.getsize(out_path)
    runs: List[tuple] = []
    with open(out_path, "rb") as f:

        def name_at(off: int):
            """(name, aligned_line_start) of the line containing offset."""
            if off >= size:
                return None, size
            back = max(0, off - 4096)
            f.seek(back)
            chunk = f.read(off - back)
            nl = chunk.rfind(b"\n")
            start = back + nl + 1 if nl >= 0 else (0 if back == 0 else None)
            if start is None:  # pathologically long line; walk from `back`
                f.seek(0)
                start = 0
                while True:
                    line = f.readline()
                    if not line or f.tell() > off:
                        break
                    start = f.tell()
            f.seek(start)
            line = f.readline()
            return line.split(b"\t", 1)[0], start

        pos = 0
        while pos < size:
            name, start = name_at(pos)
            if not name:
                break
            runs.append((name, start))
            # exponential probe for the run end, then binary search
            step = 1 << 16
            lo = start  # known inside the run
            while True:
                probe = lo + step
                if probe >= size:
                    hi = size
                    break
                n2, _ = name_at(probe)
                if n2 != name:
                    hi = probe
                    break
                lo = probe
                step *= 4
            # binary search last offset whose line-name == name in [lo, hi)
            while hi - lo > 4096:
                mid = (lo + hi) // 2
                n2, s2 = name_at(mid)
                if n2 == name:
                    lo = mid
                else:
                    hi = s2
            # walk the tail lines to the exact run end
            _, s2 = name_at(lo)
            f.seek(s2)
            pos = s2
            while pos < size:
                line = f.readline()
                if not line:
                    pos = size
                    break
                if line.split(b"\t", 1)[0] != name:
                    break
                pos = f.tell()
    return runs


def _pos_resume_state(out_path: str) -> tuple:
    """(completed names, trim offset) for an --out_pos TSV output.

    The last run is always suspect (a TSV run is not self-delimiting). If the
    file ends mid-line, the partial line may parse as a spurious new "run"
    (its name got cut), so the run BEFORE it is the incomplete one — drop
    that too."""
    import os

    runs = _pos_runs(out_path)
    if not runs:
        return set(), 0
    size = os.path.getsize(out_path)
    partial_tail = False
    with open(out_path, "rb") as f:
        if size:
            f.seek(size - 1)
            partial_tail = f.read(1) != b"\n"
    drop = 1
    if partial_tail and len(runs) >= 2:
        # is the last run exactly the partial trailing line?
        last_line_start = runs[-1][1]
        with open(out_path, "rb") as f:
            f.seek(last_line_start)
            rest = f.read()
        if b"\n" not in rest:
            drop = 2  # spurious run from the cut line + its true owner
    keep = runs[: len(runs) - drop]
    trim_at = runs[len(runs) - drop][1]
    return ({n.decode(errors="replace") for n, _ in keep}, trim_at)


def completed_contigs(out_path: str, out_pos: bool = False) -> set:
    """Names already present in a partial output file (crash-resume support;
    the reference has none — rerun from scratch, SURVEY §5).

    out_pos: the file holds `tid\\tbase\\tpos` TSV lines (write_pos_records)
    instead of FASTA; contig rows are contiguous, and the LAST contig is
    dropped as possibly truncated mid-write (a FASTA record is self-
    delimiting, a TSV run is not)."""
    import os

    done = set()
    if not os.path.exists(out_path):
        return done
    try:
        if out_pos:
            done, _ = _pos_resume_state(out_path)
        else:
            for name, _ in read_fastx(out_path):
                done.add(name)
    except Exception:
        pass
    return done


def trim_partial_output(out_path: str, out_pos: bool = False) -> None:
    """Truncate a crashed run's possibly-partial tail record so --resume can
    append cleanly (without this, the partial rows of the contig being
    re-polished would remain in the file ahead of its fresh copy)."""
    import os

    if not os.path.exists(out_path):
        return
    if out_pos:
        # keep only the provably-complete runs (see _pos_resume_state); the
        # rest is re-polished. Seek-based: no whole-file read (one TSV row
        # per output base).
        _, good = _pos_resume_state(out_path)
        if good < os.path.getsize(out_path):
            with open(out_path, "r+b") as f:
                f.truncate(good)
        return
    # FASTA: a complete record here = '>' header line + one seq line, both
    # newline-terminated (write_fasta_record format)
    with open(out_path, "rb") as f:
        data = f.read()
    n = len(data)
    good = off = 0
    while off < n and data.startswith(b">", off):
        nl = data.find(b"\n", off)
        if nl < 0:
            break
        sl = data.find(b"\n", nl + 1)
        if sl < 0:
            break
        good = off = sl + 1
    if good < n:
        with open(out_path, "r+b") as f:
            f.truncate(good)


def release_free_heap() -> bool:
    """Hand the pages of the C heap's free chunks back to the OS (glibc's
    malloc_trim(0)). A pass frees its arrays, but glibc keeps freed chunks
    resident in its arenas, one arena per thread that allocated; at -t N
    each pass left more resident than the one before. False where the C
    library has no malloc_trim."""
    try:
        trim = ctypes.CDLL(None).malloc_trim
    except (AttributeError, OSError):
        return False
    trim(0)
    return True


def polish(fa_path: str, bam_path: str, yak_paths: Sequence[str],
           cfg: Optional[PolishConfig] = None, engine: str = "cuda",
           out=None, stats: Optional[PolishStats] = None,
           skip_contigs: Optional[set] = None,
           verbose: bool = False, device=None,
           dp_variant: Optional[str] = None,
           host_shard=None) -> List[PolishedContig]:
    """Polish all contigs of `fa_path` using `bam_path` alignments and yak tables.

    engine: 'cuda' (device windowed engine) or 'oracle' (reference-faithful
    host). device: for engine 'cuda', "cuda" (default) or "cpu"; raises when
    CUDA is wanted and absent. dp_variant: the engine's DP formulation, "v2",
    "base" or "dynk" (None: the NP2_DP_DYNK / NP2_DP_BASE environment
    variables, else "v2"); the output is the same under each.
    cfg.threads > 1 polishes contigs concurrently through one cross-contig
    batcher; output order stays input order.
    If `out` is a binary file object, FASTA records are written as completed and
    sequences are not retained (returns empty list).
    skip_contigs: names to skip (resume support; see completed_contigs).
    host_shard: a parallel.distributed.HostShard; only the contigs it owns,
    by their index among all FASTA records, are polished here.
    """
    cfg = cfg or PolishConfig()
    if engine not in ("cuda", "oracle"):
        raise ValueError(f"unknown engine {engine!r} (expected 'cuda' or "
                         "'oracle')")
    dev = variants = None
    if engine == "cuda":
        from ..utils.torchcfg import resolve_device
        from .engine import resolve_dp_variants

        dev = resolve_device(device)
        variants = resolve_dp_variants(dp_variant)
    from ..utils.timing import carry, span, stage

    with span("pass"):
        t_start = time.time()
        with stage("load_yak_tables"):
            tables = [load_yak(p) for p in yak_paths]
        tables.sort(key=lambda t: t.ksize)  # option.rs:238
        if engine == "cuda" and dev.type == "cuda":
            # large lookup and scoring batches go to the device-resident table
            # (io/yak.py, models/oracle_lq.py routing thresholds)
            for t in tables:
                t.use_device = True
                t.device = dev

        from ..io.bam import fill_secondary_seq, retrieve_secondary_seqs
        from ..io.native import available as native_available

        # the native fast path handles -S itself: np2_extract_begin3 prefetches
        # primary SEQs once per BAM and substitutes them into secondary records
        # (np2native.cc prefetch_secondary; mirrors secondary.rs:82-148)
        use_native = native_available()
        reader = BamReader(bam_path)
        ref_names = [n for n, _ in reader.references]
        name_to_tid = {n: i for i, n in enumerate(ref_names)}
        contig_records: Dict[int, list] = {}
        # the oracle engine reads records, never the native ingest: it needs
        # them whether or not the native library loaded (the JAX package's
        # orchestrator loads them only without it, and its oracle engine then
        # sees no read and returns the assembly unchanged)
        if not use_native or engine != "cuda":
            sec_seqs = (retrieve_secondary_seqs(bam_path)
                        if cfg.use_secondary else {})
            for tid, recs in reader.by_contig():
                if cfg.use_secondary:
                    recs = [fill_secondary_seq(r, sec_seqs)
                            if r.is_secondary else r for r in recs]
                contig_records[tid] = recs

        results: List[PolishedContig] = []
        stats = stats if stats is not None else PolishStats()

        def run_one(name: str, seq: bytes, pre=None):
            with span("contig", contig=name):
                t_contig = time.time()
                if len(seq) >= (1 << 32):
                    # main.rs:1707-1711
                    raise ValueError(f"{name} is too long!")
                if len(seq) < cfg.min_ctg_len:
                    cb = passthrough_consensus(seq)
                    passthrough = True
                else:
                    tid = name_to_tid.get(name)
                    recs = (contig_records.get(tid, []) if tid is not None
                            else [])
                    native = ((bam_path, tid)
                              if (use_native and tid is not None) else None)
                    if engine == "cuda":
                        from .engine import polish_contig_cuda
                        cb = polish_contig_cuda(
                            seq, recs, tables, cfg, device=dev, native=native,
                            pre_ingest=pre, dp_variant=variants)
                    else:
                        cb = polish_contig(seq, recs, tables, cfg)
                    passthrough = False
                return cb, passthrough, time.time() - t_contig

        todo = []
        for contig_index, (name, seq) in enumerate(read_fastx(fa_path)):
            if host_shard is not None and not host_shard.owns(contig_index):
                continue  # another process polishes this contig
            if skip_contigs and name in skip_contigs:
                continue
            todo.append((name, seq))

        def finish(name, seq, cb, passthrough, dt):
            stats.contigs += 1
            stats.in_bases += len(seq)
            stats.passthrough += int(passthrough)
            stats.polished += int(not passthrough)
            out_seq = consensus_to_bytes(cb)
            stats.out_bases += len(out_seq)
            pc = PolishedContig(name=name, seq=out_seq,
                                start=int(cb.pos[0]) if len(cb) else 0,
                                end=int(cb.pos[-1]) if len(cb) else 0)
            if out is not None:
                _emit(out, pc, cb, cfg)
            else:
                results.append(pc)
            if verbose:
                print(f"[np2] {name}: {len(seq)} -> {len(out_seq)} bases in "
                      f"{dt:.1f}s", file=sys.stderr)

        batcher = None
        if engine == "cuda" and cfg.threads > 1 and len(todo) > 1:
            # cross-contig device batching: concurrent contig threads share
            # full device batches instead of each padding its own chunks
            from .batcher import DeviceBatcher, set_active_batcher

            batcher = DeviceBatcher(dev, variants)
            set_active_batcher(batcher)
        try:
            if cfg.threads > 1 and len(todo) > 1:
                # contig-level thread pool (the reference's worker parallelism;
                # windows within a contig are already device-parallel). Output
                # stays input-order.
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=cfg.threads) as ex:
                    futs = [(name, seq, ex.submit(carry(run_one), name, seq))
                            for name, seq in todo]
                    for name, seq, fut in futs:
                        cb, passthrough, dt = fut.result()
                        finish(name, seq, cb, passthrough, dt)
            elif engine == "cuda" and use_native and len(todo) > 1:
                # one-contig lookahead at -t 1 (reference input-thread
                # prefetch, main.rs:1703-1715): the NEXT contig's native BAM
                # ingest runs on a helper thread while the current contig
                # occupies the device. Bounded memory: at most ONE extra
                # contig's stream is resident.
                from concurrent.futures import ThreadPoolExecutor

                from ..models.oracle import build_alignseqs_native_flat

                def _pre_ingest(name: str, seq: bytes):
                    tid = name_to_tid.get(name)
                    if tid is None or len(seq) < cfg.min_ctg_len:
                        return None
                    from .segmented import use_segmented

                    if use_segmented(len(seq)):
                        return None  # segmented engine streams its own ingest
                    return build_alignseqs_native_flat(bam_path, tid, seq, cfg)

                with ThreadPoolExecutor(max_workers=1) as pre_pool:
                    pre_futs: Dict[int, object] = {}
                    for i, (name, seq) in enumerate(todo):
                        if i + 1 < len(todo):
                            pre_futs[i + 1] = pre_pool.submit(
                                carry(_pre_ingest, contig=todo[i + 1][0]),
                                *todo[i + 1])
                        cb, passthrough, dt = run_one(
                            name, seq, pre=pre_futs.pop(i, None))
                        finish(name, seq, cb, passthrough, dt)
            else:
                for name, seq in todo:
                    cb, passthrough, dt = run_one(name, seq)
                    finish(name, seq, cb, passthrough, dt)
        finally:
            if batcher is not None:
                set_active_batcher(None)
                batcher.shutdown()
                stats.batches = batcher.stats.batches
                stats.batch_fill = batcher.stats.fill
                stats.csr_batches = batcher.stats.csr_batches
                stats.dense_reasons = dict(batcher.stats.dense_reasons)
                # warn about any dense fallback EXCEPT pure no-CSR-closure
                # runs (a request without a CSR aggregation closure is
                # expected to go dense; a bail in other batches is not, and
                # must stay visible even when both kinds occur in one run)
                unexpected = set(stats.dense_reasons) - {"no_csr_closure"}
                if stats.csr_batches < stats.batches and unexpected:
                    print("[np2] warning: %d/%d device batches fell back to "
                          "dense host aggregation (%s)" % (
                              stats.batches - stats.csr_batches, stats.batches,
                              stats.dense_reasons), file=sys.stderr)
        with stage("release_heap"):
            release_free_heap()
        stats.seconds = time.time() - t_start
        return results


def _emit(out, pc: PolishedContig, cb: Consensus,
          cfg: PolishConfig) -> None:
    if cfg.out_pos:
        write_pos_records(out, pc.name, pc.seq, cb.pos,
                          uppercase=cfg.uppercase)
    else:
        write_fasta_record(out, pc.name, pc.seq, pc.start, pc.end,
                           uppercase=cfg.uppercase)
    out.flush()
