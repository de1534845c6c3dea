"""Polishing engine on PyTorch: the device windowed consensus plus the shared
host LQ machinery.

Per contig: the host builds alignment tag streams and plans anchor-bounded
windows (pipeline/windows.py); each chunk of windows travels to the device as
ONE uint8 blob, where the chunk program (ops/consensus.py) assembles its slot
tables and runs the Viterbi DP and the backtrack as hand-written CUDA kernels
(ops/consensus_cuda.py); ONE packed u16 array comes back. The host stitches
window emissions into the exact global backtrack stream, runs the reference
LQ state machine over it, then allele extraction, phasing and recheck
(models/oracle_lq.py).

The DP formulation is chosen once per call (resolve_dp_variants: an explicit
dp_variant, else the NP2_DP_DYNK / NP2_DP_BASE environment variables) and
handed down. Under "dynk" the engine aggregates dense [B, W, K] tables on the
host and ships them whole (dispatch_chunk), since the dynamic-K kernel reads
the n_slots table; otherwise chunks ride the CSR blob. With an active
cross-contig batcher (pipeline/batcher.py, -t N) the windows go to it as
aggregation closures instead of being dispatched here.

Under an active mesh (parallel/mesh.py) whose 'win' axis divides the chunk
batch, chunks run sharded on a MeshRunner: each 'win' position assembles,
scores and walks its own rows on its device, from the same blob (or dense
tables split by rows under dynamic-K, or the sparse format when a batcher
has only dense tables: dispatch_chunk), and the rows are gathered in
position order.

Exactness: anchor-forced windowing makes the windowed DP equal to the
reference's whole-contig DP (pipeline/windows.py); windows that overflow the
device's static bounds (slots, path steps) re-run on the host, and a
degenerate contig falls back to the whole-contig oracle. A contig of
NP2_SEG_MIN bases or more, ingested natively, goes to the segmented engine
instead (pipeline/segmented.py): the same device engine over anchor-bounded
segments, with resident state bounded by the segment, byte-identical output,
and no oracle fallback.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import PolishConfig
from ..io.bam import BamRecord
from ..io.yak import KmerTable
from ..models.oracle import build_alignseqs, passthrough_consensus
from ..models.oracle_align import AlignTags
from ..models.oracle_lq import (
    L_SUCC,
    extract_alleles,
    fill_seed_lqseqs,
    mark_hete_lqseqs,
    phase_reads_by_lqseqs,
    retrieve_kmer_count,
    reupdate_consensus_with_lqseqs,
    update_consensus_with_lqseqs,
)
from ..models.oracle_msa import Consensus, lq_from_qv_stream
from ..ops.consensus import (DP_VARIANTS, SlotTables, decode_backtrack_words,
                             dp_backtrack_csr_blob,
                             dp_backtrack_csr_blob_sharded,
                             dp_backtrack_packed, dp_backtrack_packed_sharded,
                             dp_backtrack_sparse_packed, nibble_ns_for)
from ..parallel.mesh import axis_devices, axis_size, get_active_mesh
from ..utils.seqcodes import ASCII2CODE, CODE2ASCII
from ..utils.timing import stage
from ..utils.torchcfg import bucket, resolve_device
from .host_fallback import host_window_dp
from .windows import (WindowOverflow, aggregate_csr_host, aggregate_csr_parts,
                      aggregate_host, build_window_batch, pack_csr_blob,
                      split_csr, split_sparse)

K_SMALL = 8   # small DP-kernel slot tier
K_DENSE = 4   # dense width of the sparse upload; deeper slots are exceptions


def _chunk_b_k8() -> int:
    """Full-chunk batch of the K=8 tier, which most real windows take
    (NP2_CHUNK_B_K8, default 512)."""
    return int(os.environ.get("NP2_CHUNK_B_K8", "512"))


def _chunk_b_k48() -> int:
    """Full-chunk batch of the fat K tier (NP2_CHUNK_B_K48, default 128)."""
    return int(os.environ.get("NP2_CHUNK_B_K48", "128"))


def pipeline_depth() -> int:
    """Chunks a contig keeps in flight, so that the host aggregation of one
    overlaps the device work of the earlier ones (NP2_PIPELINE_DEPTH,
    default 3; read when a contig's chunk loop starts)."""
    return int(os.environ.get("NP2_PIPELINE_DEPTH", "3"))


# read at import, as in the JAX package; no value changes the output
CHUNK_B_TIERS = {K_SMALL: _chunk_b_k8(), 48: _chunk_b_k48()}

# process-wide engine counters (chip_smoke.py and tests read them); contig
# threads update them under _stats_lock
STATS: dict = collections.Counter()
_stats_lock = threading.Lock()


def _stat(name: str, n: int = 1) -> None:
    with _stats_lock:
        STATS[name] += n


class DpVariants(NamedTuple):
    """The DP formulation of each dispatch route."""
    blob: str    # "v2" | "base": chunks that ride the CSR blob
    dynk: bool   # dense-table chunks run the dynamic-K kernel, and the
    #              per-contig engine aggregates dense tables to feed it


def resolve_dp_variants(dp_variant=None) -> DpVariants:
    """An explicit dp_variant ("v2", "base" or "dynk"; an already resolved
    DpVariants passes through), else the environment: NP2_DP_DYNK selects
    the dynamic-K kernel on the dense route and NP2_DP_BASE the base
    formulation on the blob route."""
    if isinstance(dp_variant, DpVariants):
        return dp_variant
    if dp_variant is None:
        return DpVariants(
            blob="base" if os.environ.get("NP2_DP_BASE") else "v2",
            dynk=bool(os.environ.get("NP2_DP_DYNK")))
    if dp_variant not in DP_VARIANTS:
        raise ValueError(f"unknown dp_variant {dp_variant!r} "
                         f"(expected one of {DP_VARIANTS})")
    return DpVariants(blob="base" if dp_variant == "base" else "v2",
                      dynk=dp_variant == "dynk")


def chunk_b_tiers(fat_k: int) -> dict:
    """CHUNK_B_TIERS with the fat tier guaranteed at the actual
    cfg.max_kmers_per_col (window_ktiers returns {K_SMALL, K})."""
    t = dict(CHUNK_B_TIERS)
    t.setdefault(int(fat_k), _chunk_b_k48())
    return t


def plan_tiered_chunks(span_all: np.ndarray, ktier_all: np.ndarray,
                       tiers: List[int], chunk_b: int,
                       tier_b: Optional[dict] = None) -> List[tuple]:
    """Group windows by (width tier, K tier) into device chunks:
    (ids, width, K, pad_b) tuples, where pad_b is the chunk's batch shape.
    Regrouping is exact: DP/backtrack lanes are independent, and a window's
    slot tables are identical at any K >= its max column slot count.

    Only FULL chunks are emitted per tier (tier_b maps a K tier to its
    full-chunk batch); a K tier's leftovers first form full chunk_b chunks,
    then the final rests merge into combined tail chunks at their members'
    max (width, K)."""
    tier_b = tier_b or {}
    wtier_all = np.where(span_all <= tiers[0], tiers[0], tiers[1])
    chunks = []
    by_kt: dict = {}
    for wt in tiers:
        for kt in sorted(set(ktier_all.tolist())):
            ids_g = np.nonzero((wtier_all == wt) & (ktier_all == kt))[0]
            full_b = int(tier_b.get(int(kt), chunk_b))
            n_full = len(ids_g) // full_b * full_b
            for c0 in range(0, n_full, full_b):
                chunks.append((ids_g[c0 : c0 + full_b], int(wt), int(kt),
                               full_b))
            if len(ids_g) > n_full:
                by_kt.setdefault(int(kt), []).append(ids_g[n_full:])
    leftover: List[np.ndarray] = []
    for kt, parts in sorted(by_kt.items()):
        rest_k = np.sort(np.concatenate(parts))
        n_full = len(rest_k) // chunk_b * chunk_b
        for c0 in range(0, n_full, chunk_b):
            ids = rest_k[c0 : c0 + chunk_b]
            chunks.append((ids, int(wtier_all[ids].max()), kt, chunk_b))
        if len(rest_k) > n_full:
            leftover.append(rest_k[n_full:])
    if leftover:
        rest = np.concatenate(leftover)
        for c0 in range(0, len(rest), chunk_b):
            ids = np.sort(rest[c0 : c0 + chunk_b])
            chunks.append((ids, int(wtier_all[ids].max()),
                           int(ktier_all[ids].max()), chunk_b))
    return chunks


def window_ktiers(wb, n_pos: int, K: int, k_small: int = K_SMALL) -> np.ndarray:
    """Per-window K tier: k_small where no column exceeds k_small slots
    (one stream pass, window-independent), else the full K."""
    from .windows import col_slot_counts, window_max_slots

    if K <= k_small:
        return np.full(wb.n_windows, K, dtype=np.int64)
    lead_all = np.maximum(wb.window_start - 2, 0)
    ends_all = wb.window_start + wb.window_len - 1
    colslots = col_slot_counts(wb.t_sorted, wb.k_sorted, n_pos)
    wmax_slots = window_max_slots(colslots, lead_all, ends_all)
    return np.where(wmax_slots <= k_small, k_small, K)


def window_anchors(wb) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-window (lead, seed, last_col): the DP's first column, whether the
    window is anchored at relative column 2, and its last column relative
    to lead."""
    lead_all = np.maximum(wb.window_start - 2, 0)
    seed_all = wb.window_start > 0
    last_all = (wb.window_start + wb.window_len - 1 - lead_all).astype(np.int32)
    return lead_all, seed_all, last_all


def pad_anchors(anchors: Tuple[np.ndarray, np.ndarray, np.ndarray],
                ids: np.ndarray, pad_b: int):
    """The window_anchors rows of `ids`, padded to pad_b lanes:
    (lead int64, seed bool, last_col int32)."""
    n = len(ids)
    lead = np.zeros(pad_b, dtype=np.int64)
    seed = np.zeros(pad_b, dtype=bool)
    last_col = np.zeros(pad_b, dtype=np.int32)
    for dst, src in zip((lead, seed, last_col), anchors):
        dst[:n] = src[ids]
    return lead, seed, last_col


def csr_blob(csr: tuple, lead: np.ndarray, seed: np.ndarray,
             last_col: np.ndarray, ck: int):
    """Pack a CSR chunk (ns_u8, keylo, clo, dgap, dval, eidx, xkey, xcnt)
    and its per-window scalars into the upload blob. Returns (blob u8, P,
    Pd, Pe)."""
    ns_u8, keylo, clo, dgap, dval, eidx, xkey, xcnt = csr
    B, W = ns_u8.shape
    blob = pack_csr_blob(ns_u8, keylo, clo, dgap, dval, eidx, xkey, xcnt,
                         lead, seed, last_col,
                         nibble_ns=nibble_ns_for(B, W, ck))
    return blob, len(keylo), len(dgap), len(eidx)


def chunk_blob(wb, ids: np.ndarray, cwidth: int, ck: int, pad_b: int,
               anchors: Tuple[np.ndarray, np.ndarray, np.ndarray]):
    """Aggregate one chunk on the host and pack its upload blob; the
    window_anchors rows of `ids` are padded to pad_b lanes. Returns
    (blob u8, P, Pd, Pe, host overflow flags [pad_b], last_col [pad_b])."""
    lead, seed, last_col = pad_anchors(anchors, ids, pad_b)
    with stage("aggregate_pileup"):
        csr = aggregate_csr_host(wb, ck, width=cwidth, n_windows=pad_b,
                                 win_idx=ids)
        if csr is None:  # no native library: dense aggregation, then CSR
            key_tab, cnt_tab, _cov, n_slots, overflow = aggregate_host(
                wb, ck, width=cwidth, n_windows=pad_b, win_idx=ids)
            csr = split_csr(key_tab, cnt_tab, n_slots) + (overflow,)
    blob, P, Pd, Pe = csr_blob(csr[:-1], lead, seed, last_col, ck)
    return blob, P, Pd, Pe, csr[-1], last_col


class ChunkRunner:
    """Runs chunk programs on one device. On CUDA a chunk's host arrays are
    written into ONE pinned buffer, copied on a side stream, and the
    compute stream waits on that copy's event; the packed result comes back
    into pinned memory with a completion event, so the host keeps
    aggregating later chunks while the device works. Pinned buffers are
    allocated per chunk: PyTorch's pinned-memory allocator caches freed
    blocks and holds each back until the copy that used it is done. On the
    CPU the program runs inline. Streams are per thread: the thread that
    submits must also collect (result)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)

    def _upload(self, arrays: Sequence[np.ndarray]):
        """Host arrays (int32 first, then uint8) -> device tensors, through
        one pinned buffer and one H2D copy."""
        offs, total = [], 0
        for a in arrays:
            if a.dtype not in (np.int32, np.uint8) or total % a.itemsize:
                raise ValueError("upload takes int32 arrays, then uint8")
            offs.append(total)
            total += a.nbytes
        host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        hview = host.numpy()
        for a, o in zip(arrays, offs):
            hview[o : o + a.nbytes] = np.ascontiguousarray(a).reshape(-1) \
                .view(np.uint8)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.copy_stream):
            dev = host.to(self.device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(self.copy_stream)
        compute.wait_event(copied)
        dev.record_stream(compute)
        outs = []
        for a, o in zip(arrays, offs):
            t = dev[o : o + a.nbytes]
            if a.dtype == np.int32:
                t = t.view(torch.int32)
            outs.append(t.reshape(a.shape))
        return outs

    def put(self, arrays: Sequence[np.ndarray]) -> list:
        """Host arrays -> tensors on this runner's device (_upload's order
        and dtypes; on the CPU the arrays themselves)."""
        if self.cuda:
            return self._upload(arrays)
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]

    def finish(self, out: torch.Tensor):
        """The handle of a started program's packed output: on CUDA its
        download into pinned memory with a completion event."""
        return self._download(out) if self.cuda else out

    def _download(self, out: torch.Tensor):
        res = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        res.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return res, done

    def submit(self, blob: np.ndarray, *, B: int, W: int, K: int, P: int,
               Pd: int, Pe: int, max_steps: int, dp_variant: str = "v2"):
        """Start the CSR-blob chunk program; returns a handle for result."""
        (dev_blob,) = self.put([blob])
        return self.finish(dp_backtrack_csr_blob(
            dev_blob, B=B, W=W, K=K, P=P, Pd=Pd, Pe=Pe, max_steps=max_steps,
            dp_variant=dp_variant))

    def submit_dense(self, key_tab: np.ndarray, cnt_tab: np.ndarray,
                     coverage: np.ndarray, n_slots: np.ndarray,
                     lead: np.ndarray, seed: np.ndarray, last_col: np.ndarray,
                     *, max_steps: int, dp_variant: str):
        """Start the dense-table chunk program (int32 [B, W, K] tables
        shipped whole); returns a handle for result."""
        key, cnt, cov, ns, lead_t, last_t, seed_t = self.put(
            _dense_arrays(key_tab, cnt_tab, coverage, n_slots, lead, seed,
                          last_col))
        out = dp_backtrack_packed(SlotTables(key, cnt, cov, ns), lead_t,
                                  seed_t, last_t, max_steps, dp_variant)
        return self.finish(out)

    @staticmethod
    def result(handle) -> np.ndarray:
        """Wait for a submitted chunk; its packed output on the host."""
        if isinstance(handle, torch.Tensor):
            return handle.numpy()
        res, done = handle
        done.synchronize()
        return res.numpy()


def _dense_arrays(key_tab, cnt_tab, coverage, n_slots, lead, seed, last_col):
    """The dense-table upload: int32 tables and scalars, then seed as u8."""
    return [np.asarray(a, dtype=np.int32)
            for a in (key_tab, cnt_tab, coverage, n_slots, lead, last_col)] \
        + [np.asarray(seed, dtype=np.uint8)]


class MeshRunner:
    """Runs chunk programs sharded over a mesh's 'win' axis
    (parallel/mesh.py): one ChunkRunner a position, on that position's
    device. A chunk's upload is copied to every position (each parses it or
    slices its own rows there), every position starts its rows' program,
    and the positions' packed rows are gathered, in position order, on the
    first position's device, from where one download brings them back. A
    device may serve several positions; their work then runs in turn on it.
    Like a ChunkRunner, the thread that submits must also collect."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.runners = [ChunkRunner(d) for d in axis_devices(mesh, "win")]

    def _put(self, arrays: Sequence[np.ndarray]) -> list:
        """arrays on every position: per array, one tensor a position."""
        return [list(col) for col in zip(*(r.put(arrays)
                                           for r in self.runners))]

    def submit(self, blob: np.ndarray, *, B: int, W: int, K: int, P: int,
               Pd: int, Pe: int, max_steps: int, dp_variant: str = "v2"):
        """Start the CSR-blob chunk program sharded over 'win'
        (ops.consensus.dp_backtrack_csr_blob_sharded)."""
        (blobs,) = self._put([blob])
        return self.runners[0].finish(dp_backtrack_csr_blob_sharded(
            blobs, self.mesh, B=B, W=W, K=K, P=P, Pd=Pd, Pe=Pe,
            max_steps=max_steps, dp_variant=dp_variant))

    def submit_sparse(self, dense_key, dense_cnt, coverage, eb, ew, ek, ekey,
                      ecnt, lead, seed, last_col, *, K: int, max_steps: int,
                      dp_variant: str):
        """Start the sparse-upload program (pipeline.windows.split_sparse
        arrays), each position on its rows and their exceptions
        (ops.consensus.dp_backtrack_sparse_packed). Counts and coverage,
        u16 values, travel as int32, as the upload takes them."""
        arrays = [np.asarray(a, dtype=np.int32) for a in
                  (dense_key, dense_cnt, coverage, eb, ew, ek, ekey, ecnt,
                   lead, last_col)] + [np.asarray(seed, dtype=np.uint8)]
        (dk, dc, cov, eb_t, ew_t, ek_t, ekey_t, ecnt_t, lead_t, last_t,
         seed_t) = self._put(arrays)
        return self.runners[0].finish(dp_backtrack_sparse_packed(
            dk, dc, cov, eb_t, ew_t, ek_t, ekey_t, ecnt_t, lead_t, seed_t,
            last_t, K=K, max_steps=max_steps, dp_variant=dp_variant,
            mesh=self.mesh))

    def submit_dense(self, key_tab, cnt_tab, coverage, n_slots, lead, seed,
                     last_col, *, max_steps: int, dp_variant: str):
        """Start the dense-table program split by rows over 'win'
        (ops.consensus.dp_backtrack_packed_sharded)."""
        key, cnt, cov, ns, lead_t, last_t, seed_t = self._put(
            _dense_arrays(key_tab, cnt_tab, coverage, n_slots, lead, seed,
                          last_col))
        return self.runners[0].finish(dp_backtrack_packed_sharded(
            SlotTables(key, cnt, cov, ns), lead_t, seed_t, last_t, max_steps,
            dp_variant, self.mesh))

    result = staticmethod(ChunkRunner.result)


def _check_runner(runner, sharded: bool) -> None:
    if sharded != isinstance(runner, MeshRunner):
        raise ValueError("a sharded dispatch needs a MeshRunner, and only "
                         "a sharded one takes it")


def dispatch_chunk(runner, agg: tuple, lead: np.ndarray, seed: np.ndarray,
                   last_col: np.ndarray, cwidth: int, ck: int,
                   variants: DpVariants, sharded: bool = False):
    """One device dispatch for a chunk aggregated into dense tables, agg =
    (key_tab, cnt_tab, coverage, n_slots, overflow): the engine's dynamic-K
    route and the batcher's dense fallback go through here. Under dynamic-K
    the tables ship whole (the kernel reads n_slots), split by rows over the
    mesh when sharded; otherwise a sharded chunk (runner: a MeshRunner)
    takes the sparse format (dense K_DENSE tables plus exceptions,
    windows.split_sparse), and an unsharded one is split into the CSR
    stream on the host and rides the blob, as every other chunk does.
    Returns the runner's handle."""
    _check_runner(runner, sharded)
    key_tab, cnt_tab, coverage, n_slots, _overflow = agg
    max_steps = int(cwidth + 128)
    if variants.dynk:
        return runner.submit_dense(key_tab, cnt_tab, coverage, n_slots, lead,
                                   seed, last_col, max_steps=max_steps,
                                   dp_variant="dynk")
    if sharded:
        dense_key, dense_cnt, eb, ew, ek, ekey, ecnt = split_sparse(
            key_tab, cnt_tab, n_slots, K_DENSE)
        # counts and coverage as u16, as JAX ships them (a window whose
        # coverage exceeds it is flagged for the host fallback)
        return runner.submit_sparse(dense_key, dense_cnt.astype(np.uint16),
                                    coverage.astype(np.uint16), eb, ew, ek,
                                    ekey, ecnt, lead, seed, last_col,
                                    K=ck, max_steps=max_steps,
                                    dp_variant=variants.blob)
    return dispatch_chunk_csr(runner, split_csr(key_tab, cnt_tab, n_slots),
                              lead, seed, last_col, cwidth, ck, variants)


def dispatch_chunk_csr(runner, csr: tuple, lead: np.ndarray,
                       seed: np.ndarray, last_col: np.ndarray, cwidth: int,
                       ck: int, variants: DpVariants, mesh=None):
    """One device dispatch from an already-CSR chunk (ns_u8, keylo, clo,
    dgap, dval, eidx, xkey, xcnt). With `mesh` (runner: a MeshRunner over
    it) the same blob runs sharded over the mesh's 'win' axis. Returns the
    runner's handle."""
    _check_runner(runner, mesh is not None)
    blob, P, Pd, Pe = csr_blob(csr, lead, seed, last_col, ck)
    B, W = csr[0].shape
    return runner.submit(blob, B=B, W=W, K=ck, P=P, Pd=Pd, Pe=Pe,
                         max_steps=int(cwidth + 128), dp_variant=variants.blob)


def device_consensus_stream(alignseqs: List[AlignTags], n_pos: int,
                            ref_codes: np.ndarray, cfg: PolishConfig,
                            runner: Optional[ChunkRunner],
                            variants: DpVariants,
                            stream_cache: Optional[dict] = None,
                            final_iter: bool = False,
                            plan_start: int = 0,
                            plan_end: Optional[int] = None,
                            plan_end_nominal: Optional[int] = None,
                            plan_end_max: Optional[int] = None,
                            first_keep_ge: bool = True,
                            out_info: Optional[dict] = None,
                            on_plan=None,
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Run the device engine; return the global REVERSED backtrack stream as
    (pos, base_ascii, qv, lowcov) arrays: the exact stream the reference
    walk produces (genome-descending), with count/coverage reduced to the
    two facts the LQ state machine reads (qv = count*100 // coverage and
    coverage < 2; models.oracle_msa.lq_from_qv_stream). Chunks go through
    `runner`, or through the active cross-contig batcher when there is one
    (runner may then be None).

    Segmented use (pipeline/segmented.py): plan_start/plan_end[_nominal/_max]
    bound the window plan and on_plan fires the moment it is realized (see
    build_window_batch); first_keep_ge=False makes the FIRST window keep
    only pos > its start (a mid-contig segment whose opening anchor column
    belongs to the previous segment's last window); out_info (when given)
    receives {"cut", "best_sum"} and leaves the negative-global-best check
    to the caller (it is a whole-contig sum)."""
    with stage("plan_windows"):
        wb = build_window_batch(alignseqs, n_pos, ref_codes,
                                target=cfg.window_len,
                                stream_cache=stream_cache,
                                consume_cache=final_iter,
                                plan_start=plan_start, plan_end=plan_end,
                                plan_end_nominal=plan_end_nominal,
                                plan_end_max=plan_end_max, on_plan=on_plan)
    if wb.n_windows == 0:
        raise WindowOverflow("no windows")
    K = cfg.max_kmers_per_col
    nw = wb.n_windows
    _stat("windows", nw)

    # Two width tiers; the tier is chosen PER CHUNK from that chunk's widest
    # window. Windows wider than tier 2 are flagged by the aggregation and
    # take the host fallback.
    CHUNK_B = 16 if nw <= 16 else 128
    tiers = [bucket(cfg.window_len + 256, 128),
             bucket(2 * cfg.window_len + 512, 128)]

    def tier_for(span: int) -> int:
        return tiers[0] if span <= tiers[0] else tiers[1]

    # sharding: each chunk's rows split over the active mesh's 'win' axis
    # (the DP and the backtrack are per window, so positions exchange
    # nothing until the gather)
    mesh = get_active_mesh()
    n_win = axis_size(mesh, "win")
    sharded = mesh is not None and n_win > 1 and CHUNK_B % n_win == 0

    anchors = window_anchors(wb)
    lead_all, seed_all, last_all = anchors
    span_all = last_all + 1  # columns each window needs

    # K tier per window: the DP's slot loop costs O(K^2) per column and most
    # windows never exceed 8 slots in any column
    with stage("plan_ktiers"):
        ktier_all = window_ktiers(wb, n_pos, K)

    host_results = {}
    best_all = np.zeros(nw, dtype=np.int64)
    win_rows: List[Optional[tuple]] = [None] * nw

    def run_host_fallback(w: int) -> None:
        # windows exceeding device static bounds re-run on the host with
        # identical semantics and no caps (host_fallback.py)
        _stat("host_fallback_windows")
        with stage("host_fallback"):
            hcols, hkeys = wb.window_stream(w)
            hcol, hq3, hcnt, hcov, hbest = host_window_dp(
                hcols, hkeys, wb.width,
                int(lead_all[w]), int(last_all[w]), bool(seed_all[w]))
        host_results[w] = (hcol, hq3, hcnt, hcov)
        best_all[w] = hbest

    from .batcher import get_active_batcher

    batcher = get_active_batcher()
    if batcher is not None:
        # cross-contig batching: hand window subsets (aggregation deferred)
        # to the shared DeviceBatcher, which packs full batches across the
        # concurrently polished contigs per (width, K) tier
        SUB = 32
        futs = []
        for c0 in range(0, nw, SUB):
            c1 = min(c0 + SUB, nw)
            swidth = tier_for(int(span_all[c0:c1].max()))
            for kt in sorted(set(ktier_all[c0:c1].tolist())):
                ids = c0 + np.nonzero(ktier_all[c0:c1] == kt)[0]

                def agg(ids=ids, swidth=swidth, kt=kt):
                    with stage("aggregate_pileup"):
                        return aggregate_host(wb, kt, width=swidth,
                                              n_windows=len(ids),
                                              win_idx=ids)

                def agg_csr(lo, hi, ids=ids, swidth=swidth, kt=kt):
                    # CSR-direct range aggregation for the packed batch: no
                    # dense [B, W, K] host tables
                    with stage("aggregate_pileup"):
                        return aggregate_csr_parts(wb, kt, width=swidth,
                                                   n_windows=hi - lo,
                                                   win_idx=ids[lo:hi])

                futs.append((ids, batcher.submit(
                    (swidth, kt), len(ids), agg, lead_all[ids],
                    seed_all[ids], last_all[ids], aggregate_csr=agg_csr)))
        for ids, fut in futs:
            for i, (cols_r, packed_r, qv_r, best_sc, truncated,
                    lvl_over, overflow) in enumerate(fut.result()):
                w = int(ids[i])
                win_rows[w] = (cols_r, packed_r, qv_r)
                best_all[w] = best_sc
                if overflow or lvl_over or truncated:
                    run_host_fallback(w)
    else:
        def harvest(pend) -> None:
            ids, overflow, handle, last_col = pend
            n = len(ids)
            with stage("device_dp_backtrack"):
                cols_r, packed_r, qv_r, best_sc, truncated, lvl_over = \
                    decode_backtrack_words(runner.result(handle), last_col)
            best_all[ids] = best_sc[:n].astype(np.int64)
            needs_host = overflow[:n] | lvl_over[:n] | truncated[:n]
            for wl in range(n):
                w = int(ids[wl])
                win_rows[w] = (cols_r[wl], packed_r[wl], qv_r[wl])
                if needs_host[wl]:
                    run_host_fallback(w)

        chunks = plan_tiered_chunks(span_all, ktier_all, tiers, CHUNK_B,
                                    tier_b=chunk_b_tiers(K) if CHUNK_B >= 128
                                    else None)
        if sharded:
            runner = MeshRunner(mesh)
        # software pipeline: aggregate + submit chunks ahead BEFORE pulling,
        # so host pileup prep overlaps the device's DP of earlier chunks
        depth = pipeline_depth()
        pending = collections.deque()
        for ids, cwidth, ck, pad_b in chunks:
            if variants.dynk:
                # the dynamic-K kernel reads the n_slots table: aggregate
                # dense [B, W, K] tables and ship them whole
                lead, seed, last_col = pad_anchors(anchors, ids, pad_b)
                with stage("aggregate_pileup"):
                    agg = aggregate_host(wb, ck, width=cwidth,
                                         n_windows=pad_b, win_idx=ids)
                overflow = agg[4]
                with stage("device_submit"):
                    handle = dispatch_chunk(runner, agg, lead, seed, last_col,
                                            cwidth, ck, variants,
                                            sharded=sharded)
            else:
                blob, P, Pd, Pe, overflow, last_col = chunk_blob(
                    wb, ids, cwidth, ck, pad_b, anchors)
                with stage("device_submit"):
                    handle = runner.submit(blob, B=pad_b, W=cwidth, K=ck, P=P,
                                           Pd=Pd, Pe=Pe,
                                           max_steps=int(cwidth + 128),
                                           dp_variant=variants.blob)
            _stat("chunks")
            pending.append((ids, overflow, handle, last_col))
            if len(pending) >= depth:
                harvest(pending.popleft())
        while pending:
            harvest(pending.popleft())

    # whole-contig default-kmer check (main.rs:1651): window-local maxima are
    # partial sums from each anchor, so their sum is the true global best
    # (segmented callers sum it across segments instead: out_info)
    if out_info is not None:
        out_info["cut"] = int(wb.plan.ends[-1])
        out_info["best_sum"] = int(best_all.sum())
    elif int(best_all.sum()) < 0:
        raise WindowOverflow("global best score < 0 (degenerate default kmer)")

    # stitch in global reverse order: last window first; window w keeps
    # emissions with abs pos > window_start (w>0) / >= 0 (w==0)
    pos_parts, base_parts, qv_parts, low_parts = [], [], [], []
    for w in range(wb.n_windows - 1, -1, -1):
        if w in host_results:
            hcol, hq3, hcnt, hcov = host_results[w]
            abs_pos = hcol + lead_all[w]
            emit_base = CODE2ASCII[hq3 & 0x7]
            emit_qv = np.minimum(
                np.where(hcov > 0, hcnt.astype(np.int64) * 100
                         // np.maximum(hcov, 1), 0), 255).astype(np.uint8)
            emit_low = hcov < 2
            keep = np.ones(len(abs_pos), dtype=bool)
        else:
            cols_r, packed_r, qv_r = win_rows[w]
            keep = (packed_r & 0x10) != 0
            abs_pos = cols_r.astype(np.int64) + lead_all[w]
            emit_base = CODE2ASCII[packed_r & 0x7]
            emit_qv = qv_r
            emit_low = (packed_r & 0x20) != 0
        if w > 0 or not first_keep_ge:
            keep = keep & (abs_pos > wb.window_start[w])
        else:
            keep = keep & (abs_pos >= 0)
        pos_parts.append(abs_pos[keep])
        base_parts.append(emit_base[keep])
        qv_parts.append(emit_qv[keep])
        low_parts.append(emit_low[keep])
    return (np.concatenate(pos_parts), np.concatenate(base_parts),
            np.concatenate(qv_parts), np.concatenate(low_parts))


def polish_contig_cuda(tseq: bytes, records: Sequence[BamRecord],
                       tables: Sequence[KmerTable],
                       cfg: Optional[PolishConfig] = None, *,
                       device=None, native: Optional[tuple] = None,
                       fallback: bool = True,
                       pre_ingest=None, dp_variant=None) -> Consensus:
    """Per-contig polish on the device engine; output matches
    models.oracle.polish_contig.

    device: "cuda" (default) or "cpu"; raises when CUDA is wanted and
    absent. dp_variant: the DP formulation, "v2", "base" or "dynk" (None:
    resolve_dp_variants reads the environment once, here; a DpVariants is
    taken as resolved); the output is the same under each. With an active
    cross-contig batcher every chunk goes through it. native: optional
    (bam_path, tid) to ingest via the C++ fast path (io/_native) instead of
    the `records` list; with native, a contig for which
    segmented.use_segmented holds goes to the segmented engine unless
    pre_ingest carries its ingest. pre_ingest: optional Future (or plain
    tuple) carrying an already-run build_alignseqs_native_flat result for
    this contig, or None (the orchestrator's one-contig lookahead, which
    declines contigs that will be segmented)."""
    dev = resolve_device(device)
    variants = resolve_dp_variants(dp_variant)
    cfg = cfg or PolishConfig()
    if len(tseq) < cfg.min_ctg_len:
        return passthrough_consensus(tseq)
    pre = None
    if pre_ingest is not None:
        with stage("ingest_alignseqs"):
            pre = (pre_ingest.result() if hasattr(pre_ingest, "result")
                   else pre_ingest)
    if native is not None and pre is None:
        from ..io.native import available as native_available
        from .segmented import polish_contig_cuda_segmented, use_segmented

        # (a lookahead that declined a contig to be segmented hands None:
        # such a contig is routed here too)
        if use_segmented(len(tseq)) and native_available():
            # chromosome-scale: bounded-memory segmented engine (no oracle
            # fallback: a WindowOverflow there means degenerate input)
            return polish_contig_cuda_segmented(
                tseq, tables, cfg, native[0], native[1], device=dev,
                dp_variant=variants)
    from .batcher import get_active_batcher

    runner = None if get_active_batcher() is not None else ChunkRunner(dev)
    tables = sorted(tables, key=lambda t: t.ksize)
    ref_codes = ASCII2CODE[np.frombuffer(tseq, dtype=np.uint8)]
    alignseqs = None
    flat = None
    with stage("ingest_alignseqs"):
        if pre is not None:
            alignseqs, flat = pre
        if alignseqs is None and native is not None:
            from ..models.oracle import build_alignseqs_native_flat

            res = build_alignseqs_native_flat(native[0], native[1], tseq, cfg)
            if res is not None:
                alignseqs, flat = res
        if alignseqs is None:
            alignseqs = build_alignseqs(tseq, records, cfg)

    saved_drops = [a.dropped for a in alignseqs]
    try:
        stream_cache: dict = {}
        if flat is not None:
            # whole-contig flat stream (ref first): the window planner sorts
            # it directly and allele extraction reuses it as ea_concat
            stream_cache["flat_all"] = flat
            stream_cache["ea_concat"] = (flat["t"], flat["q"], flat["aoff"])
        for i in range(cfg.iter_count):
            out_cns = i + 1 == cfg.iter_count
            pos, base, qv, lowcov = device_consensus_stream(
                alignseqs, len(tseq), ref_codes, cfg, runner, variants,
                stream_cache, final_iter=out_cns)
            with stage("lq_detect"):
                cb, lqseqs = lq_from_qv_stream(pos, base, qv, lowcov,
                                               cfg.hq_min_qv,
                                               cfg.lq_min_length)
            if not lqseqs:
                if out_cns:
                    return cb
                continue
            with stage("extract_alleles"):
                extract_alleles(alignseqs, lqseqs, tables[0],
                                cfg.lqseq_max_can_count, cache=stream_cache)
            with stage("kmer_scoring"):
                retrieve_kmer_count(lqseqs, tables[0], cfg.min_kmer_count)
            if out_cns:
                with stage("splice_recheck"):
                    fill_seed_lqseqs(lqseqs, cfg.max_indel_len,
                                     cfg.lqseq_max_can_count)
                    consensus = update_consensus_with_lqseqs(lqseqs, cb, L_SUCC)
                    for p, table in enumerate(tables):
                        consensus = reupdate_consensus_with_lqseqs(
                            lqseqs, consensus, table, cfg.min_kmer_count, p + 1,
                            cfg.lqseq_max_can_count)
                return consensus
            with stage("phasing"):
                mark_hete_lqseqs(lqseqs, cfg.lqseq_max_can_count)
                invalid = phase_reads_by_lqseqs(lqseqs, cfg.model == "ref",
                                                cfg.use_all_reads)
            for order in invalid:
                alignseqs[order].dropped = True
        raise AssertionError("unreachable")
    except WindowOverflow:
        if not fallback:
            raise
        from ..models.oracle import polish_contig

        _stat("oracle_fallback_contigs")
        # restart from the pre-phasing state (native mode has no records
        # list, so the prebuilt alignseqs are handed to the oracle directly)
        for a, d in zip(alignseqs, saved_drops):
            a.dropped = d
        return polish_contig(tseq, records, tables, cfg, alignseqs=alignseqs)
