"""ctypes bindings for the native IO/extraction module (io/_native/np2native.cc).

Provides `extract_contig_native`, the fused BAM-decode + filter + CIGAR-expand +
trim + 3-mer-stream path — the reference's htslib C layer plus its per-read host
hot loops in one native pass. Falls back to the pure-Python path when the shared
library is absent (`build()` compiles it with g++ into `_build/` at first use).

Memory discipline (see np2native.cc header): extraction counts first and fills
exact-size caller buffers directly; `prefault()` pre-provisions heap pages so
the pipeline never faults fresh memory inside hot loops.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native")
# built at first use from the sources in _DIR; never committed (the libraries
# are compiled -march=native for the host that runs them)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_SO = os.path.join(BUILD_DIR, "libnp2native.so")
_OBJ_SO = os.path.join(BUILD_DIR, "np2obj.so")
_lib = None
_build_lock = threading.Lock()


def build() -> bool:
    import sys
    import sysconfig

    try:
        subprocess.run(["sh", os.path.join(_DIR, "build.sh"), BUILD_DIR,
                        sysconfig.get_paths()["include"]], check=True,
                       capture_output=True)
        return True
    except Exception as e:  # reported, then the caller takes the Python path
        err = getattr(e, "stderr", b"") or b""
        print(f"[np2] native build failed: {e} {err.decode()[-2000:]}",
              file=sys.stderr)
        return False


def _stale(so: str, src_name: str) -> bool:
    try:
        return (os.path.getmtime(os.path.join(_DIR, src_name))
                > os.path.getmtime(so))
    except OSError:
        return True


def _ensure_built(so: str, src_name: str) -> bool:
    with _build_lock:
        if not os.path.exists(so) or _stale(so, src_name):
            build()
        return os.path.exists(so) and not _stale(so, src_name)


def load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not _ensure_built(_SO, "np2native.cc"):
        return None
    lib = ctypes.CDLL(_SO)
    lib.np2_bam_refs.restype = ctypes.c_int
    lib.np2_open.restype = ctypes.c_void_p
    lib.np2_extract_begin3.restype = ctypes.c_int
    lib.np2_extract_fetch3.restype = ctypes.c_int
    lib.np2_sort_stream.restype = ctypes.c_int
    lib.np2_sort_stream_runs.restype = ctypes.c_int64
    lib.np2_aggregate3.restype = ctypes.c_int
    lib.np2_aggregate_csr.restype = ctypes.c_int
    lib.np2_col_slots.restype = ctypes.c_int
    lib.np2_host_window_dp.restype = ctypes.c_int
    lib.np2_prefault.restype = ctypes.c_int
    lib.np2_find_anchors.restype = ctypes.c_int
    lib.np2_filter_stream.restype = ctypes.c_int64
    lib.np2_extract_alleles.restype = ctypes.c_int
    lib.np2_plan_windows.restype = ctypes.c_int
    lib.np2_window_max.restype = ctypes.c_int
    lib.np2_range_open.restype = ctypes.c_void_p
    lib.np2_range_next.restype = ctypes.c_int
    lib.np2_range_fetch.restype = ctypes.c_int
    _lib = lib
    return lib


_obj_mod = None
_obj_failed = False


def load_obj():
    """Import the np2obj CPython extension (fast LqSeq type + bulk builder,
    np2obj.c), building it on demand; None when unavailable."""
    global _obj_mod, _obj_failed
    if _obj_mod is not None or _obj_failed:
        return _obj_mod
    if not _ensure_built(_OBJ_SO, "np2obj.c"):
        _obj_failed = True
        return None
    try:
        import importlib.machinery
        import importlib.util

        loader = importlib.machinery.ExtensionFileLoader("np2obj", _OBJ_SO)
        spec = importlib.util.spec_from_loader("np2obj", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _obj_mod = mod
    except Exception:
        _obj_failed = True
    return _obj_mod



# np2_extract_begin3 stashes per-call state (v3_recs/bounds/this contig's
# decompressed window) INSIDE the BamFile handle for np2_extract_fetch3 to
# consume, so a handle serves one begin+fetch pair at a time. Indexed opens
# are cheap (.bai/.np2idx: header parse + index load, no whole-file work), so
# concurrent contig threads draw from a small per-path handle POOL instead of
# serializing on one handle (round-3 bottleneck: 18-contig ingest was lock-
# bound). Pool growth is capped; the first open of an index-less BAM pays the
# one-time linear scan, later opens reuse the .np2idx it wrote.
_handles_lock = threading.Lock()  # eager: a lazily-built lock is itself racy
_pools: dict = {}  # path -> list of (handle, threading.Lock)
_grow_locks: dict = {}  # path -> Lock serializing pool growth (np2_open)
_POOL_MAX = 8


def _handle_for(bam_path: str):
    """Acquire (handle, lock) for one begin+fetch pair; the LOCK IS TAKEN.
    Callers must release it when the pair completes."""
    lib = load()
    with _handles_lock:
        pool = _pools.setdefault(bam_path, [])
        for h, lk in pool:
            if lk.acquire(blocking=False):
                return h, lk
        grow = len(pool) < _POOL_MAX
        glk = _grow_locks.setdefault(bam_path, threading.Lock())
    if grow:
        # ONE grower at a time per path: without this, N racing threads all
        # see len(pool) < cap and each np2_open — on an index-less BAM that
        # is N concurrent full-file linear index scans (the .np2idx cache is
        # only written when a scan completes), and the pool overshoots its
        # cap permanently
        with glk:
            with _handles_lock:
                pool = _pools[bam_path]
                for h, lk in pool:
                    if lk.acquire(blocking=False):
                        return h, lk   # another grower's handle freed up
                grow = len(pool) < _POOL_MAX
            if grow:
                h = lib.np2_open(bam_path.encode())
                if not h:
                    raise RuntimeError(f"np2_open failed for {bam_path}")
                lk = threading.Lock()
                lk.acquire()
                with _handles_lock:
                    _pools[bam_path].append((h, lk))
                return h, lk
    # pool at cap and all busy: wait on the least-recent lock
    with _handles_lock:
        h, lk = _pools[bam_path][0]
    lk.acquire()
    return h, lk


def close_handles() -> None:
    lib = load()
    with _handles_lock:
        for pool in _pools.values():
            for h, _ in pool:
                lib.np2_close(ctypes.c_void_p(h))
        _pools.clear()


def available() -> bool:
    return load() is not None


_pf_lock = threading.Lock()
_pf_provisioned = 0      # heap bytes this process has ever prefaulted
_pf_by_thread: dict = {}  # thread ident -> its current working-set request


def prefault(n_bytes: int, n_threads: int = 4) -> bool:
    """Ensure `n_bytes` of ALREADY-PROVISIONED heap for this thread's
    working set (kept mapped across frees by the package-level mallopt).

    The package's no-mmap/no-trim mallopt means pages provisioned once stay
    in the heap forever, so the steady state (every contig after the first,
    per thread) needs NO kernel work at all — yet the old unconditional
    np2_prefault re-touched 1 byte/4 KB of GBs per contig (~2-5 s each on
    this vCPU; it was the largest single-contig stage of the round-4
    E. coli profile). Now each thread registers its current request and the
    native fault only runs for the DELTA between the sum of live per-thread
    working sets and the historical provisioned high-water — zero in steady
    state, exact when concurrent contig threads (or the -t1 ingest
    lookahead) raise the true concurrent footprint. Conservative: thread
    exits leave their last request counted (over-provisioning only)."""
    lib = load()
    if lib is None or n_bytes <= 0:
        return False
    global _pf_provisioned
    with _pf_lock:
        _pf_by_thread[threading.get_ident()] = n_bytes
        need = sum(_pf_by_thread.values())
        if need <= _pf_provisioned:
            return True
        _pf_provisioned = need
    # fault the FULL current sum, not the delta: a delta-sized malloc would
    # typically be carved from already-resident freed heap and the mincore
    # pass would touch nothing — exactly when the working set grew past the
    # high-water. A need-sized malloc forces the allocator past the resident
    # free space; mincore keeps the cost proportional to the non-resident
    # tail (~the delta), so re-faulting the resident prefix stays a scan.
    return lib.np2_prefault(ctypes.c_int64(need),
                            ctypes.c_int64(n_threads)) == 0


def bam_refs_native(bam_path: str) -> List[Tuple[str, int]]:
    lib = load()
    assert lib is not None
    names = ctypes.create_string_buffer(1 << 20)
    lens = np.zeros(65536, dtype=np.int64)
    n = ctypes.c_int64(0)
    rc = lib.np2_bam_refs(
        bam_path.encode(), names, ctypes.c_int64(len(names)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(lens)), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"np2_bam_refs failed rc={rc}")
    out = []
    raw = names.raw
    pos = 0
    for i in range(n.value):
        end = raw.index(b"\x00", pos)
        out.append((raw[pos:end].decode(), int(lens[i])))
        pos = end + 1
    return out


def _p(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def extract_contig_native(bam_path: str, tid: int, tseq_codes: np.ndarray,
                          cfg, n_threads: int = 4,
                          lead_room: int = 0) -> Optional[tuple]:
    """Native per-contig extraction -> (t_pos i32, key i32, read_start i64,
    aln_bounds [nr,2] i64, clip_flags u8) flat arrays, or None if the library
    is unavailable.

    Count-then-fill protocol: np2_extract_begin3 runs the filter+trim analysis
    (multi-threaded) and reports exact sizes; np2_extract_fetch3 re-expands the
    kept records and emits tag streams directly into these buffers — no native
    staging copies (first-touch page faults are the scarce resource on the
    target VMs). Matches build_alignseqs + kmer_stream for the read alignments
    (the ref pseudo-alignment alignseqs[0] is added by the caller).

    lead_room > 0 over-allocates t_pos/key with that many leading entries and
    returns VIEWS offset past them (view.base is the full buffer): the caller
    writes the ref pseudo-alignment stream in front so the whole-contig
    stream needs no later concatenation copy."""
    lib = load()
    if lib is None:
        return None
    handle, hlock = _handle_for(bam_path)  # lock held for the begin+fetch pair
    stream_n = ctypes.c_int64(0)
    reads_n = ctypes.c_int64(0)
    try:
        return _extract_contig_locked(lib, handle, tid, tseq_codes, cfg,
                                      n_threads, stream_n, reads_n, lead_room)
    finally:
        hlock.release()


def _extract_contig_locked(lib, handle, tid, tseq_codes, cfg, n_threads,
                           stream_n, reads_n, lead_room=0):
    from ..utils.timing import stage

    with stage("ingest_begin3"):
        rc = lib.np2_extract_begin3(
            ctypes.c_void_p(handle), ctypes.c_int32(tid),
            _p(tseq_codes, ctypes.c_uint8), ctypes.c_int64(len(tseq_codes)),
            ctypes.c_int64(cfg.min_map_qual), ctypes.c_int64(cfg.min_read_len),
            ctypes.c_int64(cfg.min_map_len), ctypes.c_double(cfg.min_map_fra),
            ctypes.c_int64(cfg.max_clip_len),
            ctypes.c_int64(1 if cfg.use_secondary else 0),
            ctypes.c_int64(1 if cfg.use_supplementary else 0),
            ctypes.c_int64(cfg.trim_len), ctypes.c_int64(cfg.short_ref_len),
            ctypes.c_int64(n_threads), ctypes.byref(stream_n),
            ctypes.byref(reads_n),
        )
    if rc != 0:
        raise RuntimeError(f"np2_extract_begin3 failed rc={rc}")
    ns, nr = stream_n.value, reads_n.value
    # Pre-provision the whole per-contig working set (stream buffers, sorted
    # copies, numpy temporaries) in one threaded THP prefault: ~1-2 GB/s vs
    # ~4-40 MB/s for lazy 4K first-touch faults on these VMs. The ledger in
    # prefault() makes the steady-state call (warm heap) free.
    # 32 B/entry since the fused run-masked sort (np2_sort_stream_runs)
    # removed the rid planes + per-iteration filter copies (~16 B/entry) the
    # old 48 covered; under-provisioning pushes 4K faults into the dispatch
    # path (SCALE_r04 run4), over-provisioning pays the hypervisor for pages
    # never touched.
    per_entry = int(os.environ.get("NP2_PREFAULT_PER_ENTRY", "32"))
    # Small-working-set bypass (VERDICT r4): a tiny contig's stream (m20:
    # ~50 MB/contig) lazily faults in well under the cost of provisioning
    # the over-estimated envelope up front — the 23 s cumulative prefault on
    # a ~1 Mb assembly was pure waste, and the staggered stalls it induced
    # also broke cross-contig batch packing (fill 0.96 -> 0.67). The
    # threaded THP prefault only pays off when the per-contig working set
    # is large (SCALE_r04 run3: 3x worse without it at 4-8 Mb contigs).
    min_bytes = int(os.environ.get("NP2_PREFAULT_MIN_MB", "256")) << 20
    if ns and per_entry and ns * per_entry >= min_bytes:
        with stage("ingest_prefault"):
            prefault(ns * per_entry, 8)
    with stage("ingest_fetch3"):
        t_pos = np.empty(lead_room + ns, dtype=np.int32)[lead_room:]
        key = np.empty(lead_room + ns, dtype=np.int32)[lead_room:]
        read_start = np.empty(nr, dtype=np.int64)
        aln_bounds = np.empty(2 * nr, dtype=np.int64)
        clip_flags = np.empty(nr, dtype=np.uint8)
        rc = lib.np2_extract_fetch3(
            ctypes.c_void_p(handle),
            _p(t_pos, ctypes.c_int32), _p(key, ctypes.c_int32),
            _p(read_start, ctypes.c_int64), _p(aln_bounds, ctypes.c_int64),
            _p(clip_flags, ctypes.c_uint8), ctypes.c_int64(n_threads),
        )
    if rc != 0:
        raise RuntimeError(f"np2_extract_fetch3 failed rc={rc}")
    return t_pos, key, read_start, aln_bounds.reshape(nr, 2), clip_flags


def sort_stream_native(t_pos: np.ndarray, key: np.ndarray, rid: np.ndarray,
                       n_pos: int, n_threads: int = 4) -> Optional[tuple]:
    """Stable counting-sort of the global (t_pos, key, rid) stream by t_pos.
    Returns (t_sorted, k_sorted, rid_sorted, max_b1_delta) or None.

    Large streams take the two-level BUCKETED strategy (np2native
    sort_stream_bucketed: cache-resident bucket cursors, per-bucket
    counting sort through thread-local staging, sequential final writes —
    the one-level scatter was DRAM-latency-bound at ~600-700 MB/s;
    NP2_SORT_BUCKETED=0 reverts). n_threads parallelizes its second level
    by bucket range. The small/one-level path stays serial: its threaded
    scatter variant measured 15x SLOWER on this VM (round-2 note)."""
    lib = load()
    if lib is None:
        return None
    n = len(t_pos)
    t_pos = np.ascontiguousarray(t_pos, dtype=np.int32)
    key = np.ascontiguousarray(key, dtype=np.int32)
    rid = np.ascontiguousarray(rid, dtype=np.int32)
    t_out = np.empty(n, dtype=np.int32)
    k_out = np.empty(n, dtype=np.int32)
    rid_out = np.empty(n, dtype=np.int32)
    max_b1d = ctypes.c_int64(0)
    rc = lib.np2_sort_stream(
        _p(t_pos, ctypes.c_int32), _p(key, ctypes.c_int32),
        _p(rid, ctypes.c_int32), ctypes.c_int64(n), ctypes.c_int64(n_pos),
        _p(t_out, ctypes.c_int32), _p(k_out, ctypes.c_int32),
        _p(rid_out, ctypes.c_int32), ctypes.byref(max_b1d),
        ctypes.c_int64(n_threads))
    if rc != 0:
        raise RuntimeError(f"np2_sort_stream failed rc={rc}")
    return t_out, k_out, rid_out, max_b1d.value


def sort_stream_runs_native(t_pos: np.ndarray, key: np.ndarray,
                            aoff: np.ndarray, drop: np.ndarray,
                            n_pos: int,
                            t_out: Optional[np.ndarray] = None,
                            k_out: Optional[np.ndarray] = None,
                            n_threads: int = 4) -> Optional[tuple]:
    """Fused drop-filter + stable counting sort straight off the flat
    per-alignseq run stream (np2_sort_stream_runs): entries of run r live at
    [aoff[r], aoff[r+1]); drop[r] excludes the run. Sorting the kept
    subsequence stably is identical to filtering the stable sort of the full
    stream, so iteration 2+ of the phasing loop re-sorts from the PRISTINE
    resident flat stream with the cumulative drop mask — no rid plane, no
    filter copies (that was 16+ B/entry of sort-time working set).

    t_out/k_out: optional full-capacity (len >= n) reuse buffers persisted
    across phasing iterations; fresh exact-size buffers are allocated when
    absent. Returns (t_sorted, k_sorted, kept_max_b1d) prefix views, or None
    without the native lib."""
    lib = load()
    if lib is None:
        return None
    n = len(t_pos)
    nr = len(drop)
    t_pos = np.ascontiguousarray(t_pos, dtype=np.int32)
    key = np.ascontiguousarray(key, dtype=np.int32)
    aoff = np.ascontiguousarray(aoff, dtype=np.int64)
    drop = np.ascontiguousarray(drop, dtype=np.uint8)
    # run contract: aoff delimits nr runs over the n-entry stream; a caller
    # whose alignseqs list diverged from the flat stream's runs would
    # otherwise fault inside native code instead of raising here
    if len(aoff) != nr + 1 or int(aoff[-1]) > n:
        raise ValueError(
            f"run contract violated: len(aoff)={len(aoff)} nr={nr} "
            f"aoff[-1]={int(aoff[-1]) if len(aoff) else 'n/a'} n={n}")
    if t_out is None or k_out is None or len(t_out) < n or len(k_out) < n:
        t_out = np.empty(n, dtype=np.int32)
        k_out = np.empty(n, dtype=np.int32)
    max_b1d = ctypes.c_int64(0)
    kept = lib.np2_sort_stream_runs(
        _p(t_pos, ctypes.c_int32), _p(key, ctypes.c_int32),
        _p(aoff, ctypes.c_int64), _p(drop, ctypes.c_uint8),
        ctypes.c_int64(nr), ctypes.c_int64(n), ctypes.c_int64(n_pos),
        _p(t_out, ctypes.c_int32), _p(k_out, ctypes.c_int32),
        ctypes.byref(max_b1d), ctypes.c_int64(n_threads))
    if kept < 0:
        raise RuntimeError(f"np2_sort_stream_runs failed rc={kept}")
    return t_out[:kept], k_out[:kept], max_b1d.value


def find_anchors_native(t_sorted: np.ndarray, k_sorted: np.ndarray,
                        n_pos: int, ref_codes: np.ndarray,
                        startcnt: np.ndarray,
                        n_threads: int = 8) -> Optional[tuple]:
    """Single-pass anchor sweep over the sorted stream (np2_find_anchors);
    returns (anchors bool[n_pos], colcnt i64[n_pos]) or None."""
    lib = load()
    if lib is None:
        return None
    t_sorted = np.ascontiguousarray(t_sorted, dtype=np.int32)
    k_sorted = np.ascontiguousarray(k_sorted, dtype=np.int32)
    ref_codes = np.ascontiguousarray(ref_codes, dtype=np.uint8)
    startcnt = np.ascontiguousarray(startcnt, dtype=np.int64)
    anchors = np.empty(n_pos, dtype=np.uint8)
    colcnt = np.empty(n_pos, dtype=np.int64)
    rc = lib.np2_find_anchors(
        _p(t_sorted, ctypes.c_int32), _p(k_sorted, ctypes.c_int32),
        ctypes.c_int64(len(t_sorted)), ctypes.c_int64(n_pos),
        _p(ref_codes, ctypes.c_uint8), _p(startcnt, ctypes.c_int64),
        _p(anchors, ctypes.c_uint8), _p(colcnt, ctypes.c_int64),
        ctypes.c_int64(n_threads))
    if rc != 0:
        raise RuntimeError(f"np2_find_anchors failed rc={rc}")
    return anchors.view(bool), colcnt


def find_anchors_runs_native(t_flat: np.ndarray, k_flat: np.ndarray,
                             aoff: np.ndarray, drop: np.ndarray,
                             n_pos: int, ref_codes: np.ndarray,
                             startcnt: np.ndarray) -> Optional[tuple]:
    """Anchor sweep over the UNSORTED flat run stream (np2_find_anchors_runs):
    bit-identical to find_anchors_native on the drop-filtered sorted stream
    (anchors are order-independent per-column aggregates), but needs no
    sort — the segmented lookahead plans (and cuts) before the sort lands.
    Returns (anchors bool[n_pos], colcnt i64[n_pos]) or None."""
    lib = load()
    if lib is None:
        return None
    t_flat = np.ascontiguousarray(t_flat, dtype=np.int32)
    k_flat = np.ascontiguousarray(k_flat, dtype=np.int32)
    aoff = np.ascontiguousarray(aoff, dtype=np.int64)
    drop = np.ascontiguousarray(drop, dtype=np.uint8)
    ref_codes = np.ascontiguousarray(ref_codes, dtype=np.uint8)
    startcnt = np.ascontiguousarray(startcnt, dtype=np.int64)
    nr = len(aoff) - 1
    if len(drop) != nr or (nr and int(aoff[-1]) > len(t_flat)):
        raise ValueError(
            f"run contract violated: len(aoff)={len(aoff)} "
            f"len(drop)={len(drop)} aoff[-1]="
            f"{int(aoff[-1]) if len(aoff) else 'n/a'} n={len(t_flat)}")
    anchors = np.empty(n_pos, dtype=np.uint8)
    colcnt = np.empty(n_pos, dtype=np.int64)
    rc = lib.np2_find_anchors_runs(
        _p(t_flat, ctypes.c_int32), _p(k_flat, ctypes.c_int32),
        _p(aoff, ctypes.c_int64), _p(drop, ctypes.c_uint8),
        ctypes.c_int64(nr), ctypes.c_int64(len(t_flat)),
        ctypes.c_int64(n_pos), _p(ref_codes, ctypes.c_uint8),
        _p(startcnt, ctypes.c_int64),
        _p(anchors, ctypes.c_uint8), _p(colcnt, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"np2_find_anchors_runs failed rc={rc}")
    return anchors.view(bool), colcnt


def filter_stream_native(t_sorted: np.ndarray, k_sorted: np.ndarray,
                         rid_sorted: np.ndarray, drop: np.ndarray,
                         n_threads: int = 8,
                         in_place: bool = False) -> Optional[tuple]:
    """Filter the sorted stream by a per-read drop mask, preserving order
    (np2_filter_stream); returns (t_kept, k_kept) views or None.

    in_place: compact INTO t_sorted/k_sorted (forward compaction; the
    native fill runs sequentially to keep the write index behind the read
    index) and return prefix views of them — the FINAL phasing iteration's
    filter needs no second 8 B/entry copy of the stream, which lowers the
    per-contig working-set high-water the prefault must provision. The
    caller owns invalidating any cache that aliased these arrays.

    Returns (t_kept, k_kept, kept_max_b1d) — the max key delta over KEPT
    entries, for the delta-overflow guard on filtered streams."""
    lib = load()
    if lib is None:
        return None
    n = len(t_sorted)
    t_in, k_in = t_sorted, k_sorted
    t_sorted = np.ascontiguousarray(t_sorted, dtype=np.int32)
    k_sorted = np.ascontiguousarray(k_sorted, dtype=np.int32)
    rid_sorted = np.ascontiguousarray(rid_sorted, dtype=np.int32)
    drop = np.ascontiguousarray(drop, dtype=np.uint8)
    if in_place and (t_sorted is not t_in or k_sorted is not k_in):
        # the conversion copied (non-contiguous / wrong dtype input): an
        # "in-place" compaction of the hidden copy would silently RAISE peak
        # memory (original + copy) while the caller's buffer stays untouched
        in_place = False
    if in_place:
        t_out, k_out = t_sorted, k_sorted
    else:
        t_out = np.empty(n, dtype=np.int32)
        k_out = np.empty(n, dtype=np.int32)
    kept_maxd = ctypes.c_int64(0)
    kept = lib.np2_filter_stream(
        _p(t_sorted, ctypes.c_int32), _p(k_sorted, ctypes.c_int32),
        _p(rid_sorted, ctypes.c_int32), ctypes.c_int64(n),
        _p(drop, ctypes.c_uint8), ctypes.c_int64(len(drop)),
        _p(t_out, ctypes.c_int32), _p(k_out, ctypes.c_int32),
        ctypes.c_int64(n_threads), ctypes.byref(kept_maxd))
    if kept < 0:
        raise RuntimeError(f"np2_filter_stream failed rc={kept}")
    return t_out[:kept], k_out[:kept], kept_maxd.value


def aggregate3_native(t_sorted: np.ndarray, k_sorted: np.ndarray,
                      lo: np.ndarray, hi: np.ndarray, lead: np.ndarray,
                      B: int, W: int, K: int, n_threads: int = 4):
    """Native pileup aggregation for one device chunk, straight off the
    t-sorted stream (np2_aggregate3); None if the library is unavailable.
    lo/hi/lead are the chunk's own per-window arrays (len nw <= B)."""
    lib = load()
    if lib is None:
        return None
    t_sorted = np.ascontiguousarray(t_sorted, dtype=np.int32)
    k_sorted = np.ascontiguousarray(k_sorted, dtype=np.int32)
    lo = np.ascontiguousarray(lo, dtype=np.int64)
    hi = np.ascontiguousarray(hi, dtype=np.int64)
    lead = np.ascontiguousarray(lead, dtype=np.int64)
    nw = len(lo)
    key_tab = np.empty(B * W * K, dtype=np.int32)
    cnt_tab = np.empty(B * W * K, dtype=np.int32)
    coverage = np.empty(B * W, dtype=np.int32)
    n_slots = np.empty(B * W, dtype=np.int32)
    overflow = np.empty(B, dtype=np.uint8)
    rc = lib.np2_aggregate3(
        _p(t_sorted, ctypes.c_int32), _p(k_sorted, ctypes.c_int32),
        _p(lo, ctypes.c_int64), _p(hi, ctypes.c_int64),
        _p(lead, ctypes.c_int64), ctypes.c_int64(nw), ctypes.c_int64(B),
        ctypes.c_int64(W), ctypes.c_int64(K), ctypes.c_int64(n_threads),
        _p(key_tab, ctypes.c_int32), _p(cnt_tab, ctypes.c_int32),
        _p(coverage, ctypes.c_int32), _p(n_slots, ctypes.c_int32),
        _p(overflow, ctypes.c_uint8))
    if rc == -5:  # violated col>=0 precondition: fall back to the numpy path
        return None
    if rc != 0:
        raise RuntimeError(f"np2_aggregate3 failed rc={rc}")
    return (key_tab.reshape(B, W, K), cnt_tab.reshape(B, W, K),
            coverage.reshape(B, W), n_slots.reshape(B, W),
            overflow.astype(bool))


def aggregate_csr_native(t_sorted: np.ndarray, k_sorted: np.ndarray,
                         lo: np.ndarray, hi: np.ndarray, lead: np.ndarray,
                         B: int, W: int, K: int, n_threads: int = 4):
    """CSR-direct native pileup aggregation (np2_aggregate_csr): emits the
    flat entry stream the single-device dispatch uploads WITHOUT ever
    materializing the dense [B, W, K] host tables (tens of MB per chunk) or
    rescanning them in windows.split_csr. Returns (ns_u8 [B, W], keylo u16
    [E], dlo u8 [E], clo u8 [E], eidx i32 (flat UNPADDED exception indices),
    xkey, xcnt, overflow bool [B]) — the caller converts dlo to the sparse
    delta sidecar and bucket-pads (windows.aggregate_csr_host). None when
    the library is missing or the native pass bails (nw > B, K > 255,
    exception-list overflow)."""
    lib = load()
    if lib is None or K > 255:
        return None
    t_sorted = np.ascontiguousarray(t_sorted, dtype=np.int32)
    k_sorted = np.ascontiguousarray(k_sorted, dtype=np.int32)
    lo = np.ascontiguousarray(lo, dtype=np.int64)
    hi = np.ascontiguousarray(hi, dtype=np.int64)
    lead = np.ascontiguousarray(lead, dtype=np.int64)
    nw = len(lo)
    cap = int(np.minimum(hi - lo, W * K).sum())
    T_MAX = 16
    ns_u8 = np.empty(B * W, dtype=np.uint8)
    keylo = np.empty(max(cap, 1), dtype=np.uint16)
    dlo = np.empty(max(cap, 1), dtype=np.uint8)
    clo = np.empty(max(cap, 1), dtype=np.uint8)
    toffs = np.zeros(T_MAX, dtype=np.int64)
    tcounts = np.zeros(T_MAX, dtype=np.int64)
    xcap = 1 << 16
    xw = np.empty(xcap, dtype=np.int32)
    xcol = np.empty(xcap, dtype=np.int32)
    xslot = np.empty(xcap, dtype=np.int32)
    xkey = np.empty(xcap, dtype=np.int32)
    xcnt = np.empty(xcap, dtype=np.int32)
    xcount = ctypes.c_int64(0)
    overflow = np.empty(B, dtype=np.uint8)
    rc = lib.np2_aggregate_csr(
        _p(t_sorted, ctypes.c_int32), _p(k_sorted, ctypes.c_int32),
        _p(lo, ctypes.c_int64), _p(hi, ctypes.c_int64),
        _p(lead, ctypes.c_int64), ctypes.c_int64(nw), ctypes.c_int64(B),
        ctypes.c_int64(W), ctypes.c_int64(K), ctypes.c_int64(n_threads),
        _p(ns_u8, ctypes.c_uint8), _p(keylo, ctypes.c_uint16),
        _p(dlo, ctypes.c_uint8), _p(clo, ctypes.c_uint8),
        _p(toffs, ctypes.c_int64), _p(tcounts, ctypes.c_int64),
        _p(xw, ctypes.c_int32), _p(xcol, ctypes.c_int32),
        _p(xslot, ctypes.c_int32), _p(xkey, ctypes.c_int32),
        _p(xcnt, ctypes.c_int32), ctypes.c_int64(xcap),
        ctypes.byref(xcount), _p(overflow, ctypes.c_uint8))
    if rc < 0:
        return None
    T = rc
    # compact thread regions (<= 16 slice copies) into one globally
    # (window, column, slot)-ordered stream
    E = int(tcounts[:T].sum())
    pos = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(tcounts[:T], out=pos[1:])
    for t in range(T):
        s, n = int(toffs[t]), int(tcounts[t])
        if int(pos[t]) != s and n:
            keylo[pos[t]:pos[t + 1]] = keylo[s:s + n]
            dlo[pos[t]:pos[t + 1]] = dlo[s:s + n]
            clo[pos[t]:pos[t + 1]] = clo[s:s + n]
    # exception (window, col, slot) -> flat stream index via the ns cumsum
    nx = int(xcount.value)
    ns_i64 = ns_u8.astype(np.int64)
    start = np.cumsum(ns_i64) - ns_i64  # entry offset of each (win, col)
    eidx = (start[xw[:nx].astype(np.int64) * W + xcol[:nx]]
            + xslot[:nx]).astype(np.int32)
    return (ns_u8.reshape(B, W), keylo[:E], dlo[:E], clo[:E],
            eidx, xkey[:nx].copy(), xcnt[:nx].copy(),
            overflow.astype(bool))


def host_window_dp_native(cols: np.ndarray, keys: np.ndarray, width: int,
                          lead_abs: int, last_col: int, seed_anchor: bool):
    """Native host-fallback windowed DP (np2_host_window_dp); returns the
    reversed emission arrays (col, q3, count, coverage) + best score, or None
    if the library is unavailable / the window exceeds native bounds (the
    caller then runs the Python twin, pipeline/host_fallback.py)."""
    lib = load()
    if lib is None or width >= (1 << 20) or len(cols) == 0:
        return None
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    cap = len(cols) + 8
    out_col = np.empty(cap, dtype=np.int32)
    out_q3 = np.empty(cap, dtype=np.int32)
    out_cnt = np.empty(cap, dtype=np.int32)
    out_cov = np.empty(cap, dtype=np.int32)
    out_n = ctypes.c_int64(0)
    out_best = ctypes.c_int64(0)
    rc = lib.np2_host_window_dp(
        _p(cols, ctypes.c_int32), _p(keys, ctypes.c_int32),
        ctypes.c_int64(len(cols)), ctypes.c_int64(width),
        ctypes.c_int64(lead_abs), ctypes.c_int64(last_col),
        ctypes.c_int32(1 if seed_anchor else 0),
        _p(out_col, ctypes.c_int32), _p(out_q3, ctypes.c_int32),
        _p(out_cnt, ctypes.c_int32), _p(out_cov, ctypes.c_int32),
        ctypes.byref(out_n), ctypes.byref(out_best), ctypes.c_int64(cap))
    if rc != 0:
        return None
    m = out_n.value
    return (out_col[:m].astype(np.int64), out_q3[:m].astype(np.int64),
            out_cnt[:m].astype(np.int64), out_cov[:m].astype(np.int64),
            int(out_best.value))


def col_slots_native(t_sorted: np.ndarray, k_sorted: np.ndarray,
                     n_pos: int, n_threads: int = 4) -> Optional[np.ndarray]:
    """Per-absolute-column distinct-key counts over the whole t-sorted stream
    (np2_col_slots) — the per-window max-slot bound used for K tiering; None
    if the library is unavailable. Counts saturate at 0x7FFF."""
    lib = load()
    if lib is None:
        return None
    t_sorted = np.ascontiguousarray(t_sorted, dtype=np.int32)
    k_sorted = np.ascontiguousarray(k_sorted, dtype=np.int32)
    out = np.empty(n_pos, dtype=np.int32)
    rc = lib.np2_col_slots(
        _p(t_sorted, ctypes.c_int32), _p(k_sorted, ctypes.c_int32),
        ctypes.c_int64(len(t_sorted)), ctypes.c_int64(n_pos),
        ctypes.c_int64(n_threads), _p(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"np2_col_slots failed rc={rc}")
    return out


def extract_alleles_native(t_pos_all: np.ndarray, q_base_all: np.ndarray,
                           aoff: np.ndarray, aln_t_s: np.ndarray,
                           aln_t_e: np.ndarray, active: np.ndarray,
                           rstart: np.ndarray, rend: np.ndarray,
                           nseq0: np.ndarray, ksize: int, max_can: int):
    """Native per-read LQ allele extraction pass 1 (np2_extract_alleles;
    spec models/oracle_lq.py:_extract_alleles_py). Count-then-fill, each
    one walk over every active read's tags. Returns (region i32[M],
    order i32[M], soff i64[M+1], seq u8[S] ASCII, prehash u64[M], has u8[M],
    pairs), pairs the (read, region) pairs visited, or None when the
    library is unavailable."""
    lib = load()
    if lib is None:
        return None
    t_pos_all = np.ascontiguousarray(t_pos_all, dtype=np.int32)
    q_base_all = np.ascontiguousarray(q_base_all, dtype=np.uint8)
    aoff = np.ascontiguousarray(aoff, dtype=np.int64)
    aln_t_s = np.ascontiguousarray(aln_t_s, dtype=np.int64)
    aln_t_e = np.ascontiguousarray(aln_t_e, dtype=np.int64)
    active = np.ascontiguousarray(active, dtype=np.uint8)
    rstart = np.ascontiguousarray(rstart, dtype=np.int64)
    rend = np.ascontiguousarray(rend, dtype=np.int64)
    nseq0 = np.ascontiguousarray(nseq0, dtype=np.int32)
    A = len(aln_t_s)
    R = len(rstart)
    m = ctypes.c_int64(0)
    nbytes = ctypes.c_int64(0)
    pairs = ctypes.c_int64(0)
    null8 = None

    def _call(mode, region, order, soff, seq, prehash, has):
        return lib.np2_extract_alleles(
            _p(t_pos_all, ctypes.c_int32), _p(q_base_all, ctypes.c_uint8),
            _p(aoff, ctypes.c_int64), ctypes.c_int64(A),
            _p(aln_t_s, ctypes.c_int64), _p(aln_t_e, ctypes.c_int64),
            _p(active, ctypes.c_uint8),
            _p(rstart, ctypes.c_int64), _p(rend, ctypes.c_int64),
            _p(nseq0, ctypes.c_int32), ctypes.c_int64(R),
            ctypes.c_int64(ksize), ctypes.c_int64(max_can),
            ctypes.c_int(mode), ctypes.byref(m), ctypes.byref(nbytes),
            ctypes.byref(pairs), region, order, soff, seq, prehash, has)

    rc = _call(0, null8, null8, null8, null8, null8, null8)
    if rc != 0:
        raise RuntimeError(f"np2_extract_alleles count failed rc={rc}")
    M, S = int(m.value), int(nbytes.value)
    region = np.empty(max(M, 1), dtype=np.int32)
    order = np.empty(max(M, 1), dtype=np.int32)
    soff = np.empty(M + 1, dtype=np.int64)
    seq = np.empty(max(S, 1), dtype=np.uint8)
    prehash = np.empty(max(M, 1), dtype=np.uint64)
    has = np.empty(max(M, 1), dtype=np.uint8)
    rc = _call(1, _p(region, ctypes.c_int32), _p(order, ctypes.c_int32),
               _p(soff, ctypes.c_int64), _p(seq, ctypes.c_uint8),
               _p(prehash, ctypes.c_uint64), _p(has, ctypes.c_uint8))
    if rc != 0:
        raise RuntimeError(f"np2_extract_alleles fill failed rc={rc}")
    assert int(m.value) == M and int(soff[M]) == S
    return (region[:M], order[:M], soff, seq[:S], prehash[:M], has[:M],
            int(pairs.value))


def plan_windows_native(anchors: np.ndarray, n_pos: int, target: int):
    """Native greedy window planner (np2_plan_windows; spec
    pipeline/windows.plan_windows). Returns (starts i64, ends i64) or None."""
    lib = load()
    if lib is None:
        return None
    anchors = np.ascontiguousarray(anchors, dtype=np.uint8)
    n = ctypes.c_int64(0)
    rc = lib.np2_plan_windows(_p(anchors, ctypes.c_uint8),
                              ctypes.c_int64(n_pos), ctypes.c_int64(target),
                              ctypes.c_int(0), ctypes.byref(n), None, None)
    if rc != 0:
        raise RuntimeError(f"np2_plan_windows count failed rc={rc}")
    nw = int(n.value)
    starts = np.empty(max(nw, 1), dtype=np.int64)
    ends = np.empty(max(nw, 1), dtype=np.int64)
    rc = lib.np2_plan_windows(_p(anchors, ctypes.c_uint8),
                              ctypes.c_int64(n_pos), ctypes.c_int64(target),
                              ctypes.c_int(1), ctypes.byref(n),
                              _p(starts, ctypes.c_int64),
                              _p(ends, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"np2_plan_windows fill failed rc={rc}")
    return starts[:nw], ends[:nw]


def window_max_native(colslots: np.ndarray, lead: np.ndarray,
                      ends: np.ndarray, n_threads: int = 4):
    """Native per-window max column slot count (np2_window_max); None when
    the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    colslots = np.ascontiguousarray(colslots, dtype=np.int32)
    lead = np.ascontiguousarray(lead, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    out = np.empty(len(lead), dtype=np.int32)
    rc = lib.np2_window_max(_p(colslots, ctypes.c_int32),
                            ctypes.c_int64(len(colslots)),
                            _p(lead, ctypes.c_int64),
                            _p(ends, ctypes.c_int64),
                            ctypes.c_int64(len(lead)),
                            ctypes.c_int64(n_threads),
                            _p(out, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"np2_window_max failed rc={rc}")
    return out


class RangeScanner:
    """Sequential position-range ingest over one contig's BAM records
    (np2_range_open/next/fetch) — the bounded-memory primitive behind the
    segmented chromosome-scale engine (pipeline/segmented.py).

    One forward pass serves ascending [t_lo, t_hi) requests; each kept record
    is decoded/filtered/trimmed/expanded exactly once (identical semantics to
    extract_contig_native, incl. the incremental clip filter mirroring
    filter_alignseqs_by_clip, main.rs:531-574). `next()` returns a dict with
    the segment's read set or None when the native library is unavailable.
    """

    def __init__(self, bam_path: str, tid: int, tseq_codes: np.ndarray, cfg,
                 n_threads: int = 0):
        self._h = None
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        if n_threads <= 0:
            n_threads = int(os.environ.get(
                "NP2_SCAN_THREADS", str(min(8, os.cpu_count() or 4))))
        tseq_codes = np.ascontiguousarray(tseq_codes, dtype=np.uint8)
        h = lib.np2_range_open(
            bam_path.encode(), ctypes.c_int32(tid),
            _p(tseq_codes, ctypes.c_uint8), ctypes.c_int64(len(tseq_codes)),
            ctypes.c_int64(cfg.min_map_qual), ctypes.c_int64(cfg.min_read_len),
            ctypes.c_int64(cfg.min_map_len), ctypes.c_double(cfg.min_map_fra),
            ctypes.c_int64(cfg.max_clip_len),
            ctypes.c_int64(1 if cfg.use_secondary else 0),
            ctypes.c_int64(1 if cfg.use_supplementary else 0),
            ctypes.c_int64(cfg.trim_len), ctypes.c_int64(cfg.short_ref_len),
            ctypes.c_int64(cfg.clip_margin), ctypes.c_int64(n_threads))
        if not h:
            raise RuntimeError(f"np2_range_open failed for {bam_path}:{tid}")
        self._h = h

    def next(self, t_lo: int, t_hi: int, extract_mode: bool = False) -> dict:
        """Serve [t_lo, t_hi): t_lo must be nondecreasing across calls
        (re-calling with the same t_lo and a larger t_hi extends the
        segment). extract_mode additionally includes earlier-order records
        whose trimmed start landed past t_hi (allele-extraction cursor
        parity; see np2_range_next). Returns {"t","k" (i32, rebased to
        base), "read_start", "bounds" [nr,2] (rebased), "clip_drop",
        "clip_label" (u8), "orders" (i64 global kept-record ordinals,
        1-based), "base", "maxt" (absolute)}."""
        sn = ctypes.c_int64(0)
        rn = ctypes.c_int64(0)
        base = ctypes.c_int64(0)
        maxt = ctypes.c_int64(0)
        rc = self._lib.np2_range_next(
            ctypes.c_void_p(self._h), ctypes.c_int64(t_lo),
            ctypes.c_int64(t_hi), ctypes.c_int64(1 if extract_mode else 0),
            ctypes.byref(sn), ctypes.byref(rn),
            ctypes.byref(base), ctypes.byref(maxt))
        if rc != 0:
            raise RuntimeError(f"np2_range_next failed rc={rc}")
        ns, nr = sn.value, rn.value
        t = np.empty(ns, dtype=np.int32)
        k = np.empty(ns, dtype=np.int32)
        read_start = np.empty(nr, dtype=np.int64)
        bounds = np.empty(2 * nr, dtype=np.int64)
        clip_drop = np.empty(nr, dtype=np.uint8)
        clip_label = np.empty(nr, dtype=np.uint8)
        orders = np.empty(nr, dtype=np.int64)
        rc = self._lib.np2_range_fetch(
            ctypes.c_void_p(self._h),
            _p(t, ctypes.c_int32), _p(k, ctypes.c_int32),
            _p(read_start, ctypes.c_int64), _p(bounds, ctypes.c_int64),
            _p(clip_drop, ctypes.c_uint8), _p(clip_label, ctypes.c_uint8),
            _p(orders, ctypes.c_int64))
        if rc != 0:
            raise RuntimeError(f"np2_range_fetch failed rc={rc}")
        return {"t": t, "k": k, "read_start": read_start,
                "bounds": bounds.reshape(nr, 2), "clip_drop": clip_drop,
                "clip_label": clip_label, "orders": orders,
                "base": base.value, "maxt": maxt.value}

    def close(self) -> None:
        if self._h is not None:
            self._lib.np2_range_close(ctypes.c_void_p(self._h))
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
