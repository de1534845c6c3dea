"""Cross-contig device batching: pack window chunks from many contigs into
full fixed-shape DP batches.

The reference balances small contigs with a contig-per-thread worker pool
(main.rs:1717-1843); here the device batch IS the parallel unit, so a
many-small-contig assembly (yeast/fly-scale) would underfill the fixed
chunk shapes if each contig dispatched its own chunks. Contig threads
`submit()` window ranges as *aggregation closures*; a single worker thread
packs pending lanes (per width tier) into full batches, runs the host pileup
aggregation for exactly the lanes it packs (small internal pool: the native
aggregator releases the GIL), and dispatches one DP+backtrack per batch.
Per-window results flow back through futures.

The worker thread owns the device: it creates the ChunkRunner, submits every
batch and waits on every completion event (CUDA's current stream is per
thread). Contig threads never touch the device. Under an active mesh
(parallel/mesh.py) a batch whose rows split evenly over the 'win' axis runs
sharded on a MeshRunner the worker makes; one that does not goes dense on
one device (reason shape_misalign).

Exactness is free: every DP/backtrack lane is independent of its batch mates
(ops/consensus.py), so packing order cannot change any window's output;
tests/test_torch_batcher.py byte-compares batched and unbatched polish. The
idle-flush grace makes batch COMPOSITION depend on timing, never the output.

A 2-stage software pipeline (aggregate batch i+1 while the device runs batch
i) also overlaps host prep with device time even for a single contig.

With the recorder on (utils/timing.py), the worker's packing and launch of
each batch are the stages batch_aggregate and batch_dispatch, and the
counters batcher.batches, batcher.lanes_dispatched and batcher.lanes_real
count what BatchStats counts.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..parallel.mesh import axis_size, get_active_mesh
from ..utils.timing import carry, count, stage

# one dispatched batch is LANE_B windows (the same chunk shapes as the
# per-contig path, engine.py); a tail flush of <= LANE_SMALL lanes reuses the
# small tier so the padding waste stays bounded. K tiers with a bigger
# full chunk (engine.CHUNK_B_TIERS, K=8 at 512 lanes) pack to that size.
LANE_B = 128
LANE_SMALL = 16


def _tier_lane_b(tier) -> int:
    from .engine import CHUNK_B_TIERS, K_SMALL, _chunk_b_k48

    if isinstance(tier, tuple) and tier[1] is not None:
        if tier[1] in CHUNK_B_TIERS:
            return max(LANE_B, int(CHUNK_B_TIERS[tier[1]]))
        if tier[1] > K_SMALL:  # fat tier of a K != 48 config
            return max(LANE_B, _chunk_b_k48())
    return LANE_B


@dataclass
class _Request:
    """One contig's window range: aggregation deferred until packing."""
    n: int
    aggregate: Callable[[], tuple]  # -> (key_tab, cnt_tab, coverage, n_slots,
    #                                    overflow) with leading dim == n
    lead: np.ndarray  # [n] int64
    seed: np.ndarray  # [n] bool
    last: np.ndarray  # [n] int32
    # optional CSR-direct range aggregation: (row_lo, row_hi) -> unpadded
    # windows.aggregate_csr_parts tuple for those rows (None -> dense only)
    aggregate_csr: Optional[Callable[[int, int], Optional[tuple]]] = None
    future: Future = field(default_factory=Future)
    # filled by the worker: per-lane outputs, assembled across batches
    _parts: List[Tuple[int, tuple]] = field(default_factory=list)
    _done_rows: int = 0


class BatchStats:
    def __init__(self) -> None:
        self.batches = 0
        self.lanes_dispatched = 0
        self.lanes_real = 0
        self.csr_batches = 0  # batches aggregated CSR-direct (no dense
        #                       host tables)
        # why a batch was aggregated into dense tables instead (a silent
        # change of format must stay visible):
        #   no_k            tier carries no K (dense-only tier)
        #   shape_misalign  padded B not divisible by the win-mesh axis
        #   no_csr_closure  a request was submitted without aggregate_csr
        #   csr_bailed      the native CSR pass refused (overflow/fallback)
        self.dense_reasons: Dict[str, int] = {}

    @property
    def fill(self) -> float:
        return self.lanes_real / max(1, self.lanes_dispatched)


class DeviceBatcher:
    """Packs window-range submissions into full fixed-shape device batches.

    One instance per polish() run on one device; `submit` is thread-safe.
    `variants` (engine.DpVariants) names the DP formulation of the CSR-blob
    batches and of the dense-table batches. Close with `shutdown()` (flushes
    nothing: callers must have resolved their futures).
    """

    def __init__(self, device, variants=None, agg_threads: int = 1,
                 idle_flush_s: float = 0.05):
        from ..utils.torchcfg import resolve_device
        from .engine import resolve_dp_variants

        self._device = resolve_device(device)  # raises when CUDA is absent
        self._variants = variants or resolve_dp_variants("v2")
        self._runner = None  # made by the worker thread, which owns it
        self._mesh_runner = None  # the worker's MeshRunner, for one mesh
        # agg_threads=1: the native aggregator is internally multithreaded
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # per (width, K) tier: list of (request, row_offset) cursors
        self._queues: Dict[tuple, List[Tuple[_Request, int]]] = {}
        self._stop = False
        self._idle_flush_s = idle_flush_s
        self.stats = BatchStats()
        self._agg_pool = ThreadPoolExecutor(max_workers=agg_threads,
                                            thread_name_prefix="np2agg")
        # the worker's spans take the span that made the batcher as parent
        self._worker = threading.Thread(target=carry(self._run),
                                        name="np2batcher", daemon=True)
        self._error: Optional[BaseException] = None
        self._worker.start()

    # ---- producer side -------------------------------------------------
    def submit(self, tier, n: int, aggregate: Callable[[], tuple],
               lead: np.ndarray, seed: np.ndarray, last: np.ndarray,
               aggregate_csr=None) -> Future:
        """Queue `n` windows for `tier` = (width, K) (a bare int width is
        accepted for K = the aggregation's own K). `aggregate()` must return
        unpadded [n, ...] slot tables with that K; `aggregate_csr(lo, hi)`,
        when given, returns the unpadded CSR parts for a row range (no dense
        [B, W, K] host tables anywhere). Returns a Future resolving to a list of n per-window
        tuples (cols_r, packed_r, qv_r, best_sc, truncated, lvl_over,
        overflow)."""
        if not isinstance(tier, tuple):
            tier = (int(tier), None)
        # the closures run on the aggregation pool under the caller's span
        req = _Request(n=n, aggregate=carry(aggregate), lead=np.asarray(lead),
                       seed=np.asarray(seed), last=np.asarray(last),
                       aggregate_csr=(None if aggregate_csr is None
                                      else carry(aggregate_csr)))
        with self._wake:
            if self._error is not None:
                raise RuntimeError("batcher worker died") from self._error
            self._queues.setdefault(tier, []).append((req, 0))
            self._wake.notify()
        return req.future

    def shutdown(self) -> None:
        with self._wake:
            self._stop = True
            self._wake.notify()
        self._worker.join(timeout=60)
        self._agg_pool.shutdown(wait=False)

    # ---- worker side ---------------------------------------------------
    def _take_batch(self, allow_partial: bool) -> Optional[tuple]:
        """Pop up to the tier's lane target from the fullest tier (by fill
        fraction of its own target; must hold lock)."""
        best_w, best_lanes, best_frac = None, 0, 0.0
        for w, q in self._queues.items():
            lanes = sum(r.n - off for r, off in q)
            frac = lanes / _tier_lane_b(w)
            if frac > best_frac:
                best_w, best_lanes, best_frac = w, lanes, frac
        if best_w is None or (best_lanes < _tier_lane_b(best_w)
                              and not allow_partial):
            return None
        take: List[Tuple[_Request, int, int]] = []  # (req, row_lo, row_hi)
        # partial flushes ship at the smallest compiled shape that fits
        # (LANE_SMALL / LANE_B) instead of padding the big tier batch —
        # a 160-lane flush on a 512-lane tier would otherwise be 31% fill
        room = _tier_lane_b(best_w)
        if best_lanes < room:
            room = LANE_SMALL if best_lanes <= LANE_SMALL else LANE_B
        q = self._queues[best_w]
        while q and room:
            req, off = q[0]
            m = min(req.n - off, room)
            take.append((req, off, off + m))
            room -= m
            if off + m == req.n:
                q.pop(0)
            else:
                q[0] = (req, off + m)
        if not q:
            del self._queues[best_w]
        return best_w, take

    def _batch_b(self, tier, lanes: int) -> int:
        return (LANE_SMALL if lanes <= LANE_SMALL
                else LANE_B if lanes <= LANE_B else _tier_lane_b(tier))

    def _aggregate(self, tier,
                   take: List[Tuple[_Request, int, int]]) -> tuple:
        """Build the batch for `take`: ("csr", parts, ...) via the CSR-direct
        native pass when every request supports it (no dense [B, W, K] host
        tables), else ("dense", tables, ...). Both carry (overflow, lead,
        seed, last, n_real) behind the payload."""
        width, K = tier[0], tier[1]
        lanes = sum(hi - lo for _, lo, hi in take)
        B = self._batch_b(tier, lanes)
        lead = np.zeros(B, dtype=np.int64)
        seed = np.zeros(B, dtype=bool)
        last = np.zeros(B, dtype=np.int32)
        overflow = np.zeros(B, dtype=bool)
        row = 0
        for req, lo, hi in take:
            m = hi - lo
            lead[row:row + m] = req.lead[lo:hi]
            seed[row:row + m] = req.seed[lo:hi]
            last[row:row + m] = req.last[lo:hi]
            row += m

        n_win = axis_size(self._active_mesh(), "win")
        dense_reason = None
        if K is None:
            dense_reason = "no_k"
        elif B % n_win != 0:
            dense_reason = "shape_misalign"
        elif any(req.aggregate_csr is None for req, _, _ in take):
            dense_reason = "no_csr_closure"
        if dense_reason is None:
            futs = [self._agg_pool.submit(req.aggregate_csr, lo, hi)
                    for req, lo, hi in take]
            parts = [f.result() for f in futs]
            if all(p is not None for p in parts):
                ns = np.zeros((B, width), dtype=np.uint8)
                keylo_p, clo_p, didx_p, dval_p = [], [], [], []
                eidx_p, xkey_p, xcnt_p = [], [], []
                row = eoff = 0
                for (req, lo, hi), part in zip(take, parts):
                    (pns, pkeylo, pclo, pdidx, pdval, peidx, pxkey, pxcnt,
                     pov) = part
                    m = hi - lo
                    ns[row:row + m] = pns
                    overflow[row:row + m] = pov
                    keylo_p.append(pkeylo)
                    clo_p.append(pclo)
                    didx_p.append(pdidx + np.int32(eoff))
                    dval_p.append(pdval)
                    eidx_p.append(peidx + np.int32(eoff))
                    xkey_p.append(pxkey)
                    xcnt_p.append(pxcnt)
                    eoff += len(pkeylo)
                    row += m

                def cat(ps, dt):
                    return (np.concatenate(ps) if ps
                            else np.zeros(0, dtype=dt))

                from .windows import _pad_csr

                csr = _pad_csr(cat(keylo_p, np.uint16), cat(clo_p, np.uint8),
                               cat(didx_p, np.int32), cat(dval_p, np.uint8),
                               cat(eidx_p, np.int32), cat(xkey_p, np.int32),
                               cat(xcnt_p, np.int32),
                               e_bucket=1024, p_bucket=32768, d_bucket=4096)
                return ("csr", (ns,) + csr, overflow, lead, seed, last, row)
            dense_reason = "csr_bailed"

        self.stats.dense_reasons[dense_reason] = (
            self.stats.dense_reasons.get(dense_reason, 0) + 1)
        # dense fallback: aggregate whole requests once; slice rows after
        uniq: Dict[int, Future] = {}
        for req, lo, hi in take:
            if id(req) not in uniq:
                uniq[id(req)] = self._agg_pool.submit(req.aggregate)
        aggs = {k: f.result() for k, f in uniq.items()}
        first = aggs[id(take[0][0])]
        Kd = first[0].shape[2]
        key_tab = np.full((B, width, Kd), -1, dtype=np.int32)
        cnt_tab = np.zeros((B, width, Kd), dtype=np.int32)
        coverage = np.zeros((B, width), dtype=np.int32)
        n_slots = np.zeros((B, width), dtype=np.int32)
        row = 0
        for req, lo, hi in take:
            kt, ct, cv, ns, ov = aggs[id(req)]
            m = hi - lo
            key_tab[row:row + m] = kt[lo:hi]
            cnt_tab[row:row + m] = ct[lo:hi]
            coverage[row:row + m] = cv[lo:hi]
            n_slots[row:row + m] = ns[lo:hi]
            overflow[row:row + m] = ov[lo:hi]
            row += m
        return ("dense", (key_tab, cnt_tab, coverage, n_slots),
                overflow, lead, seed, last, row)

    def _resolve(self, take, batch, dev) -> None:
        try:
            self._resolve_inner(take, batch,
                                self._device_get(dev, batch[5]))
        except BaseException as e:
            for req, _, _ in take:
                if not req.future.done():
                    req.future.set_exception(e)
            raise

    def _resolve_inner(self, take, batch, host_out) -> None:
        (cols_r, packed_r, qv_r, best_sc, truncated, lvl_over) = host_out
        overflow = batch[2]
        row = 0
        for req, lo, hi in take:
            m = hi - lo
            rows = []
            for i in range(m):
                r = row + i
                rows.append((lo + i, (cols_r[r], packed_r[r], qv_r[r],
                                      int(best_sc[r]),
                                      bool(truncated[r]), bool(lvl_over[r]),
                                      bool(overflow[r]))))
            row += m
            with self._lock:
                req._parts.extend(rows)
                req._done_rows += m
                done = req._done_rows == req.n
            if done:
                out = [None] * req.n
                for idx, tup in req._parts:
                    out[idx] = tup
                req.future.set_result(out)

    def _pending_lanes(self) -> int:
        return sum(r.n - off for q in self._queues.values() for r, off in q)

    def _run(self) -> None:
        from .engine import ChunkRunner

        inflight = None  # (take, batch, pending device out)
        try:
            self._runner = ChunkRunner(self._device)
            while True:
                with self._wake:
                    while True:
                        if self._stop and not self._queues and inflight is None:
                            return
                        got = self._take_batch(allow_partial=False)
                        if got is not None:
                            break
                        if self._queues and (inflight is None or self._stop):
                            # underfull tier and idle device: flush a partial
                            # batch only if nothing new arrives during a short
                            # grace (a wake re-evaluates for a full batch)
                            before = self._pending_lanes()
                            self._wake.wait(timeout=self._idle_flush_s)
                            if self._pending_lanes() == before:
                                got = self._take_batch(allow_partial=True)
                                if got is not None:
                                    break
                            continue
                        if inflight is not None:
                            break  # drain the device while producers think
                        self._wake.wait(timeout=0.5)
                if got is None:  # drain inflight, then loop back to waiting
                    take, batch, dev = inflight
                    inflight = None
                    self._resolve(take, batch, dev)
                    continue
                tier, take = got
                try:
                    with stage("batch_aggregate"):
                        batch = self._aggregate(tier, take)
                    with stage("batch_dispatch"):
                        dev = self._dispatch(tier, batch)
                except BaseException as e:
                    for req, _, _ in take:  # fail just this batch's owners
                        if not req.future.done():
                            req.future.set_exception(e)
                    raise
                self.stats.batches += 1
                self.stats.lanes_dispatched += len(batch[2])  # padded B
                self.stats.lanes_real += batch[6]
                count("batcher.batches")
                count("batcher.lanes_dispatched", len(batch[2]))
                count("batcher.lanes_real", batch[6])
                if batch[0] == "csr":
                    self.stats.csr_batches += 1
                if inflight is not None:
                    ptake, pbatch, pdev = inflight
                    inflight = None
                    self._resolve(ptake, pbatch, pdev)
                inflight = (take, batch, dev)
        except BaseException as e:  # propagate to all waiting producers
            with self._lock:
                self._error = e
                reqs = {id(r): r for q in self._queues.values()
                        for r, _ in q}
                self._queues.clear()
            if inflight is not None:
                for req, _, _ in inflight[0]:
                    reqs[id(req)] = req
            for r in reqs.values():
                if not r.future.done():
                    r.future.set_exception(e)

    # ---- device dispatch (the engine's dispatch functions) --------------
    @staticmethod
    def _active_mesh():
        """The active mesh (parallel.mesh.set_active_mesh), read at every
        batch as the engine reads it."""
        return get_active_mesh()

    def _mesh_sharded(self, n_lanes: Optional[int] = None):
        """The mesh to shard a batch of n_lanes rows over, under the
        engine's policy: the active mesh when its 'win' axis is wider than
        1 and divides the batch; else None (one device)."""
        mesh = self._active_mesh()
        n_win = axis_size(mesh, "win")
        if mesh is not None and n_win > 1 and (
                n_lanes is None or n_lanes % n_win == 0):
            return mesh
        return None

    def _runner_for(self, mesh):
        """The worker's runner: its ChunkRunner, or with `mesh` a
        MeshRunner over it (made once for that mesh)."""
        if mesh is None:
            return self._runner
        from .engine import MeshRunner

        if self._mesh_runner is None or self._mesh_runner.mesh is not mesh:
            self._mesh_runner = MeshRunner(mesh)
        return self._mesh_runner

    def _dispatch(self, tier, batch):
        """Pack, upload and start one batch on the worker's runner, sharded
        over the active mesh's 'win' axis where it has one; returns its
        handle at once (the device works while the worker aggregates the
        next batch). _device_get collects it."""
        from .engine import dispatch_chunk, dispatch_chunk_csr

        kind, payload, overflow, lead, seed, last, _row = batch
        width = tier[0]
        if kind == "csr":
            # a CSR batch is aligned to the mesh (else shape_misalign made
            # it dense)
            mesh = self._mesh_sharded()
            return dispatch_chunk_csr(self._runner_for(mesh), payload, lead,
                                      seed, last, width, tier[1],
                                      self._variants, mesh=mesh)
        key_tab, cnt_tab, coverage, n_slots = payload
        mesh = self._mesh_sharded(len(overflow))
        return dispatch_chunk(
            self._runner_for(mesh),
            (key_tab, cnt_tab, coverage, n_slots, overflow), lead, seed, last,
            width, key_tab.shape[2], self._variants,
            sharded=mesh is not None)

    def _device_get(self, dev, last_col) -> tuple:
        from ..ops.consensus import decode_backtrack_words
        from .engine import ChunkRunner

        with stage("device_dp_backtrack"):
            return decode_backtrack_words(ChunkRunner.result(dev), last_col)


# ---- active batcher: engine.device_consensus_stream routes through it -----

_active: Optional[DeviceBatcher] = None


def set_active_batcher(b: Optional[DeviceBatcher]) -> None:
    global _active
    _active = b


def get_active_batcher() -> Optional[DeviceBatcher]:
    return _active
