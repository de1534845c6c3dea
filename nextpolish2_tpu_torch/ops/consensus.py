"""The per-chunk device program in PyTorch: blob parse, CSR assembly, DP and
backtrack dispatch, output pack; and the device form of the pileup
aggregation (aggregate_windows).

Counterpart of nextpolish2_tpu/ops/consensus.py::dp_backtrack_csr_blob (one
uint8 blob in; layout: pipeline.windows.pack_csr_blob) and of its dense-table
dispatch dp_backtrack_packed (SlotTables in). Either way one u16
[B, max_steps + 8] array comes out (pack_backtrack_out), bit-identical to the
JAX program. The DP, in the formulation the caller names (DP_VARIANTS), and
the backtrack run as hand-written CUDA kernels on a CUDA device and as their
plain PyTorch twins on the CPU (ops/consensus_cuda.py); everything else here
is plain tensor code.

Integer discipline: PyTorch on the CPU has no shift, compare or add for
uint32 and widens cumsum to int64, so the fused1 u32 entry word and the
packed backtrack state word are built in int64. u16 outputs travel as int16
bit patterns (view them as uint16 on the host).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

NEG_INF = -(1 << 30)
HEAD_Q = 15
# DP formulations: "v2" the span-bounded running pick (the default), "base"
# the per-slot _pick reduction, "dynk" the same reduction with each column's
# slot loop bounded by n_slots (dense tables only)
DP_VARIANTS = ("v2", "base", "dynk")


class SlotTables(NamedTuple):
    key: torch.Tensor                # int32 [B, W, K] packed kmer key (-1 = empty)
    count: torch.Tensor              # int32 [B, W, K]
    coverage: torch.Tensor           # int32 [B, W]
    n_slots: Optional[torch.Tensor]  # int32 [B, W]; None where only "v2"/"base" run
    # bool [B]: a column of the window has more than K slots (aggregate_windows)
    overflow: Optional[torch.Tensor] = None


def _b3d_from_key(key: torch.Tensor) -> torch.Tensor:
    """b3-delta of packed keys: delta + 2 where flags hold 0b0101, 1 where
    only bit 0 is set, else 0."""
    flags = (key >> 12) & 0xF
    delta = (key >> 16) & 0xFFFF
    return torch.where((flags & 0b0101) == 0b0101, delta + 2,
                       torch.where((flags & 1) == 1, torch.ones_like(key),
                                   torch.zeros_like(key)))


def aggregate_windows(cols: torch.Tensor, keys: torch.Tensor, width: int,
                      K: int) -> SlotTables:
    """[B, T] (col, key) streams -> per-column slot tables, on the inputs'
    device: the JAX aggregate_windows, field for field. col == width marks
    padding. Each column's distinct keys become its slots in the reference's
    order (b3-delta, then first occurrence in the stream); a window with a
    column of more than K slots is flagged in `overflow` and keeps its first
    K. Plain tensor code: no production path runs it (the host aggregation
    of pipeline/windows.py serves them all); it is the device form of the
    same function.

    Every tensor is int32 but the packed sort keys, which are int64:
    torch.sort takes one key where the JAX program sorts on two and three."""
    i32, i64 = torch.int32, torch.int64
    cols = cols.to(i32)
    keys = keys.to(i32)
    B, T = cols.shape
    dev = cols.device
    if width.bit_length() + 17 + T.bit_length() > 63:
        raise ValueError(f"aggregate_windows: width {width} and stream "
                         f"length {T} overflow the packed sort key")
    # stable sort by (col, key) in signed int32 order: key + 2^31 maps the
    # signed keys onto [0, 2^32) in order, below the column's bits
    order = torch.sort((cols.to(i64) << 32) + (keys.to(i64) + (1 << 31)),
                       dim=1, stable=True).indices
    scol = cols.gather(1, order)
    skey = keys.gather(1, order)
    sidx = order.to(i32)

    neg = torch.full((B, 1), -1, dtype=i32, device=dev)
    prev_col = torch.cat([neg, scol[:, :-1]], 1)
    prev_key = torch.cat([neg, skey[:, :-1]], 1)
    head = ((scol != prev_col) | (skey != prev_key)) & (scol < width)
    seg_id = torch.cumsum(head.to(i32), 1, dtype=i32) - 1  # -1: pre-first pad
    ones = (scol < width).to(i32)
    seg_ok = seg_id >= 0
    seg_idx = torch.where(seg_ok, seg_id, T - 1).to(i64)
    zero = torch.zeros_like(scol)

    def seg_reduce(fill: int, vals: torch.Tensor, how: str) -> torch.Tensor:
        out = torch.full((B, T), fill, dtype=i32, device=dev)
        return out.scatter_reduce_(1, seg_idx, vals, reduce=how,
                                   include_self=True)

    first_row = seg_ok & head  # each segment's first row, in stream order
    seg_count = seg_reduce(0, torch.where(seg_ok, ones, zero), "sum")
    seg_col = seg_reduce(width, torch.where(first_row, scol, width), "amin")
    seg_key = seg_reduce(0, torch.where(first_row, skey, zero), "amax")
    seg_first = seg_reduce(T, torch.where(first_row, sidx, T), "amin")
    seg_b3d = _b3d_from_key(seg_key)

    # order the segments by (col, b3d, first occurrence), the three packed
    # in one int64 (col < 2^width_bits, b3d <= 0xFFFF + 2 < 2^17, first <=
    # T). `first` is unique among real segments; the padding segments tie
    # on every field (col width, b3d 0, first T, key 0, count 0), so their
    # order among themselves changes nothing
    fb = T.bit_length()
    okey64 = ((seg_col.to(i64) << (17 + fb)) | (seg_b3d.to(i64) << fb)
              | seg_first.to(i64))
    o = torch.sort(okey64, dim=1, stable=True).indices
    ocol = seg_col.gather(1, o)
    ob3d = seg_b3d.gather(1, o)
    okey = seg_key.gather(1, o)
    ocount = seg_count.gather(1, o)

    # rank within the column: distance from the column's first segment
    t_iota = torch.arange(T, dtype=i32, device=dev).expand(B, T)
    col_change = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                            ocol[:, 1:] != ocol[:, :-1]], 1)
    run_start = torch.cummax(torch.where(col_change, t_iota, -1), 1).values
    rank = t_iota - run_start
    valid = ocol < width
    overflow = (valid & (rank >= K)).any(1)

    # scatter into tables with one spare column (width) that takes every
    # dropped segment, cut off afterwards
    keep = valid & (rank < K)
    ccol = torch.where(keep, ocol, width).to(i64)
    crank = torch.where(keep, rank, K - 1).to(i64)
    real = ccol < width
    b = torch.arange(B, dtype=i64, device=dev)[:, None]
    flat_slot = ((b * (width + 1) + ccol) * K + crank).reshape(-1)
    flat_col = (b * (width + 1) + ccol).reshape(-1)

    def table(n: int, fill: int, idx, vals, how: str) -> torch.Tensor:
        out = torch.full((n,), fill, dtype=i32, device=dev)
        return out.scatter_reduce_(0, idx, vals.reshape(-1), reduce=how,
                                   include_self=True)

    key_tab = table(B * (width + 1) * K, -1, flat_slot,
                    torch.where(real, okey, -1), "amax")
    cnt_tab = table(B * (width + 1) * K, 0, flat_slot,
                    torch.where(real, ocount, zero), "amax")
    coverage = table(B * (width + 1), 0, flat_col,
                     torch.where(real & (ob3d == 0), ocount, zero), "sum")
    n_slots = table(B * (width + 1), 0, flat_col, real.to(i32), "sum")
    return SlotTables(
        key=key_tab.reshape(B, width + 1, K)[:, :width].contiguous(),
        count=cnt_tab.reshape(B, width + 1, K)[:, :width].contiguous(),
        coverage=coverage.reshape(B, width + 1)[:, :width].contiguous(),
        n_slots=n_slots.reshape(B, width + 1)[:, :width].contiguous(),
        overflow=overflow)


def decode_keys(key: torch.Tensor, col: torch.Tensor):
    """Packed 3-mer key + its column -> (b1key, b2key, b3key, q1, q2, q3,
    b3d), with bNkey = t<<18 | delta<<4 | q in int32 (the JAX package's
    _decode_tile packing)."""
    flags = (key >> 12) & 0xF
    delta = (key >> 16) & 0xFFFF
    q1 = (key >> 8) & 0xF
    q2 = (key >> 4) & 0xF
    q3 = key & 0xF
    both = (flags & 0b0101) == 0b0101
    f23 = (flags & 0b0001) != 0
    f12 = (flags & 0b0100) != 0
    col = col.to(key.dtype).expand_as(key)
    b1_t = torch.where(both, col, torch.where(f23 | f12, col - 1, col - 2))
    b2_t = torch.where(both | f23, col, col - 1)
    zero = torch.zeros_like(key)
    b2_d = torch.where(both, delta + 1,
                       torch.where(f23, zero, torch.where(f12, delta + 1, zero)))
    b3d = torch.where(both, delta + 2, torch.where(f23, zero + 1, zero))

    def pack(t, d, q):
        return (t << 18) | (d << 4) | q

    return (pack(b1_t, delta, q1), pack(b2_t, b2_d, q2), pack(col, b3d, q3),
            q1, q2, q3, b3d)


def nibble_ns_for(B: int, W: int, K: int) -> bool:
    """Single source of truth for the ns nibble-packing decision: the packer
    (pipeline.windows.pack_csr_blob callers) and the blob parser below MUST
    agree or every later blob field parses as garbage."""
    return K < 16 and (B * W) % 2 == 0


def _le16u(b: torch.Tensor) -> torch.Tensor:
    """u8[2n] little-endian pairs -> int32[n] holding the u16 values
    (arithmetic combine: no reinterpreting view at an unaligned offset)."""
    b = b.reshape(-1, 2).to(torch.int32)
    return b[:, 0] | (b[:, 1] << 8)


def _le32i(b: torch.Tensor) -> torch.Tensor:
    """u8[4n] little-endian quads -> int32[n] (two's complement)."""
    b = b.reshape(-1, 4).to(torch.int64)
    u = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def parse_csr_blob(blob: torch.Tensor, B: int, W: int, K: int, P: int,
                   Pd: int, Pe: int):
    """THE blob parser (layout: pipeline.windows.pack_csr_blob). Returns
    (ns [B, W] int32, keylo, clo, dgap, dval, eidx, xkey, xcnt, lead, seed
    bool, last_col), all on the blob's device."""
    o = 0

    def take(n: int) -> torch.Tensor:
        nonlocal o
        sl = blob[o : o + n]
        o += n
        return sl

    if nibble_ns_for(B, W, K):
        ns4 = take(B * W // 2).to(torch.int32)
        ns = torch.stack([ns4 & 0xF, ns4 >> 4], dim=-1).reshape(B, W)
    else:
        ns = take(B * W).to(torch.int32).reshape(B, W)
    keylo = _le16u(take(2 * P))
    clo = take(P).to(torch.int32)
    dgap = _le16u(take(2 * Pd))
    dval = take(Pd).to(torch.int32)
    eidx = _le32i(take(4 * Pe))
    xkey = _le32i(take(4 * Pe))
    xcnt = _le32i(take(4 * Pe))
    lead = _le32i(take(4 * B))
    seed = take(B) != 0
    last_col = _le32i(take(4 * B))
    if o != blob.shape[0]:
        raise ValueError(
            f"CSR blob layout mismatch: parsed {o} of {blob.shape[0]} bytes")
    return (ns, keylo, clo, dgap, dval, eidx, xkey, xcnt, lead, seed,
            last_col)


def assemble_csr(ns, keylo, clo, dgap, dval, eidx, xkey, xcnt,
                 B: int, W: int, K: int, win_lo: Optional[int] = None,
                 Bl: int = 0):
    """Dense key/count tables [B, W, K] int32 and per-column coverage [B, W]
    from the flat CSR stream (the JAX fused1 variant, bit for bit). Entries
    are (window, column, slot)-ordered; deltas ride a gap-encoded sidecar
    (didx = cumsum(dgap) - 1; dval == 0 marks padding); full exceptions
    overwrite last. The fused u32 word keylo | delta<<16 | cnt<<24 is held
    in int64.

    win_lo/Bl: assemble only the window rows [win_lo, win_lo + Bl) into
    [Bl, W, K] tables (one 'win' position's share of a chunk). Entries,
    deltas and exceptions of other rows fall outside [0, Bl*W*K) and are
    dropped, never wrapped."""
    dev = keylo.device
    P = keylo.shape[0]
    Pd = dgap.shape[0]
    Pe = eidx.shape[0]
    if win_lo is None:
        win_lo, Bl = 0, B
    npad = Bl * W * K
    e_idx = torch.arange(P, dtype=torch.int64, device=dev)
    packed_e = keylo.to(torch.int64) | (clo.to(torch.int64) << 24)
    didx = torch.cumsum(dgap.to(torch.int64), 0) - 1
    dmask = (dval > 0) & (didx >= 0) & (didx < P)
    packed_e[didx[dmask]] += dval[dmask].to(torch.int64) << 16

    nb = ns.reshape(-1).to(torch.int64)
    cum = torch.cumsum(nb, 0)
    start = cum - nb
    # flat[e] = colid*K + slot = e + (colid*K - start[colid]); the per-column
    # base is non-decreasing in the column, so a scatter-max at each
    # column's start plus a running max hands every entry its column's base
    base_c = torch.arange(B * W, dtype=torch.int64, device=dev) * K - start
    base = torch.full((P,), torch.iinfo(torch.int64).min, dtype=torch.int64,
                      device=dev)
    smask = start < P
    base.scatter_reduce_(0, start[smask], base_c[smask], reduce="amax",
                         include_self=True)
    base = torch.cummax(base, 0).values
    gflat = e_idx + base - win_lo * W * K
    total = cum[-1] if cum.numel() else torch.zeros((), dtype=torch.int64,
                                                     device=dev)
    in_rng = (e_idx < total) & (gflat >= 0) & (gflat < npad)
    flat = torch.where(in_rng, gflat, npad + e_idx)

    packed_d = torch.full((npad,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    packed_d[flat[in_rng]] = packed_e[in_rng]
    empty = packed_d == 0xFFFFFFFF
    key = torch.where(empty, -1, packed_d & 0xFFFFFF).to(torch.int32)
    cnt = torch.where(empty, 0, packed_d >> 24).to(torch.int32)
    if Pe:
        e64 = eidx.to(torch.int64)
        fe = torch.where(e64 < P, flat[torch.clamp(e64, 0, max(P - 1, 0))],
                         npad + torch.arange(Pe, dtype=torch.int64,
                                             device=dev))
        emask = (fe >= 0) & (fe < npad)
        key[fe[emask]] = xkey[emask]
        cnt[fe[emask]] = xcnt[emask]
    key = key.reshape(Bl, W, K)
    cnt = cnt.reshape(Bl, W, K)
    coverage = torch.where(((key >> 12) & 1) == 0, cnt,
                           torch.zeros_like(cnt)).sum(-1, dtype=torch.int32)
    return key, cnt, coverage


def backtrack_state_tables(key, cnt, cov, besti, seed) -> torch.Tensor:
    """Per-state (col*K + slot) successor and 15-bit emission word packed as
    succ<<15 | word in int64 [B, W*K] (the JAX u32 table). Terminal states
    self-loop; word = qv<<7 | dec<<6 | covlow<<5 | nongap<<4 | q3."""
    B, W, K = key.shape
    dev = key.device
    col = torch.arange(W, dtype=torch.int64, device=dev).view(1, W, 1)
    slot = torch.arange(K, dtype=torch.int64, device=dev).view(1, 1, K)
    flags = (key >> 12) & 0xF
    q2 = (key >> 4) & 0xF
    q3 = (key & 0xF).to(torch.int64)
    cv = cov.to(torch.int64)[:, :, None]
    qv = torch.where(cv > 0, cnt.to(torch.int64) * 100
                     // torch.clamp(cv, min=1), torch.zeros_like(cv))
    qv = torch.clamp(qv, max=255)
    both = (flags & 0b0101) == 0b0101
    f23 = (flags & 1) != 0
    b2_same = both | f23
    is_head = q2 == HEAD_Q
    at_anchor = seed.view(B, 1, 1) & (col == 2)
    nxt_c = torch.where(b2_same, col, col - 1)
    alive_nxt = ~is_head & ~at_anchor & (nxt_c >= 0)
    succ = torch.where(alive_nxt, nxt_c * K + besti.to(torch.int64),
                       col * K + slot)
    dec = alive_nxt & ~b2_same
    word = ((qv << 7) | q3 | ((q3 != 4).to(torch.int64) << 4)
            | ((cv < 2).to(torch.int64) << 5) | (dec.to(torch.int64) << 6))
    return ((succ << 15) | word).reshape(B, W * K)


def backtrack_start(scores: torch.Tensor, last_col: torch.Tensor, K: int):
    """Start state = the LAST max slot at last_col (reference >= scan,
    main.rs:1680); all-NEG_INF columns start at slot K-1. A last_col past
    the chunk (a window flagged for the host fallback) is clamped to the last
    column, as the JAX program's gather clamps it. Returns (state int64 [B],
    best int32 [B])."""
    B, W = scores.shape[:2]
    lc = last_col.to(torch.int64).clamp(0, W - 1)
    sc_last = scores[torch.arange(B, device=scores.device), lc]  # [B, K]
    maxv = sc_last.amax(1)
    ismax = (sc_last == maxv[:, None]).to(torch.uint8)
    start_slot = (K - 1) - ismax.flip(1).argmax(1)
    return lc * K + start_slot, maxv


def _to_u16_bits(v: torch.Tensor) -> torch.Tensor:
    """Values in [0, 65535] -> int16 tensor with those u16 bit patterns."""
    v = v.to(torch.int32)
    return torch.where(v >= 32768, v - 65536, v).to(torch.int16)


def pack_backtrack_out(words, best, n_steps, trunc, lvl_over) -> torch.Tensor:
    """[B, max_steps] 15-bit step words + per-window meta -> ONE u16 array
    [B, max_steps + 8] (as int16 bits): the words, then (best, n_steps,
    truncated, lvl_over) as lo/hi u16 pairs. Host decode:
    decode_backtrack_words."""
    meta = torch.stack([best.to(torch.int64), n_steps.to(torch.int64),
                        trunc.to(torch.int64), lvl_over.to(torch.int64)], 1)
    meta = meta & 0xFFFFFFFF
    mlohi = torch.stack([meta & 0xFFFF, meta >> 16], -1).reshape(-1, 8)
    return torch.cat([_to_u16_bits(words & 0x7FFF), _to_u16_bits(mlohi)], 1)


def unpack_backtrack_out(arr: torch.Tensor, last_col: torch.Tensor):
    """The packed output back into the JAX dp_backtrack's (out, lvl_over),
    on the output's device: out = (cols int16 [B, max_steps], packed uint8,
    qv uint8, best int32 [B], n_steps int32, truncated bool), lvl_over
    bool [B]. Columns are rebuilt from last_col as in
    decode_backtrack_words."""
    a = arr.to(torch.int32) & 0xFFFF
    words = a[:, :-8]
    m = a[:, -8:].to(torch.int64)
    meta = m[:, 0::2] | (m[:, 1::2] << 16)
    meta = torch.where(meta >= 1 << 31, meta - (1 << 32), meta).to(torch.int32)
    dec = (words >> 6) & 1
    cum = torch.cumsum(dec, 1, dtype=torch.int32)
    cols = (last_col.to(torch.int32)[:, None] - (cum - dec)).to(torch.int16)
    out = (cols, (words & 0x7F).to(torch.uint8),
           ((words >> 7) & 0xFF).to(torch.uint8), meta[:, 0], meta[:, 1],
           meta[:, 2] != 0)
    return out, meta[:, 3] != 0


def decode_backtrack_words(arr, last_col) -> tuple:
    """Host-side inverse of pack_backtrack_out (numpy): returns (cols u16,
    packed u8, qv u8, best i32, truncated bool, lvl_over bool). Columns are
    rebuilt from last_col minus the running count of dec bits:
    cols[i] = last_col - sum(dec[0:i])."""
    arr = np.asarray(arr)
    if arr.dtype == np.int16:
        arr = arr.view(np.uint16)
    words = arr[:, :-8]
    m = arr[:, -8:].astype(np.uint32)
    meta = np.ascontiguousarray(m[:, 0::2] | (m[:, 1::2] << 16)).view(np.int32)
    packed_r = (words & 0x7F).astype(np.uint8)
    qv_r = ((words >> 7) & 0xFF).astype(np.uint8)
    dec = ((words >> 6) & 1).astype(np.int32)
    cum = np.cumsum(dec, axis=1, dtype=np.int32)
    cols_r = (np.asarray(last_col, dtype=np.int32)[:, None]
              - (cum - dec)).astype(np.uint16)
    return (cols_r, packed_r, qv_r, meta[:, 0],
            meta[:, 2].astype(bool), meta[:, 3].astype(bool))


def blob_tables(blob, *, B: int, W: int, K: int, P: int, Pd: int, Pe: int,
                device=None) -> tuple:
    """The chunk program's front half: blob (uint8 tensor or numpy array)
    -> the DP and backtrack inputs (key, cnt, cov, lead, seed u8,
    last_col)."""
    if isinstance(blob, np.ndarray):
        blob = torch.from_numpy(blob)
    if device is not None:
        blob = blob.to(device)
    (ns, keylo, clo, dgap, dval, eidx, xkey, xcnt, lead, seed,
     last_col) = parse_csr_blob(blob, B, W, K, P, Pd, Pe)
    key, cnt, cov = assemble_csr(ns, keylo, clo, dgap, dval, eidx, xkey,
                                 xcnt, B, W, K)
    return key, cnt, cov, lead, seed.to(torch.uint8), last_col


def dp_backtrack(tables: SlotTables, lead, seed_u8, last_col, max_steps: int,
                 dp_variant: str) -> torch.Tensor:
    """DP in the named formulation + backtrack + output pack on slot tables:
    lead/last_col int32 [B], seed_u8 uint8 [B] -> int16 [B, max_steps + 8].
    "v2" is bounded by each window's span (last_col + 1); "base" and "dynk"
    scan all W columns; "dynk" reads tables.n_slots."""
    from .consensus_cuda import (backtrack_packed, consensus_dp_base,
                                 consensus_dp_dynk, consensus_dp_v2)

    key, cnt, cov = tables.key, tables.count, tables.coverage
    if dp_variant == "v2":
        scores, besti = consensus_dp_v2(key, cnt, cov, lead, seed_u8,
                                        last_col + 1)
    elif dp_variant == "base":
        scores, besti = consensus_dp_base(key, cnt, cov, lead, seed_u8)
    elif dp_variant == "dynk":
        if tables.n_slots is None:
            raise ValueError("dp_variant 'dynk' needs the n_slots table")
        scores, besti = consensus_dp_dynk(key, cnt, cov, tables.n_slots,
                                          lead, seed_u8)
    else:
        raise ValueError(f"unknown dp_variant {dp_variant!r} "
                         f"(expected one of {DP_VARIANTS})")
    return backtrack_packed(key, cnt, cov, scores, besti, last_col, seed_u8,
                            max_steps)


def dp_backtrack_packed(tables: SlotTables, lead, seed, last_col,
                        max_steps: int, dp_variant: str) -> torch.Tensor:
    """The dense-table dispatch: slot tables and per-window scalars in any
    integer/bool dtype, all on one device -> int16 [B, max_steps + 8] (u16
    bits of the JAX dp_backtrack_packed output)."""
    i32 = torch.int32
    tables = SlotTables(
        key=tables.key.to(i32).contiguous(),
        count=tables.count.to(i32).contiguous(),
        coverage=tables.coverage.to(i32).contiguous(),
        n_slots=(None if tables.n_slots is None
                 else tables.n_slots.to(i32).contiguous()))
    return dp_backtrack(tables, lead.to(i32), seed.to(torch.uint8),
                        last_col.to(i32), max_steps, dp_variant)


def dp_backtrack_csr_blob(blob, *, B: int, W: int, K: int, P: int, Pd: int,
                          Pe: int, max_steps: int, device=None,
                          dp_variant: str = "v2") -> torch.Tensor:
    """The chunk program: blob (uint8 tensor or numpy array) -> int16
    [B, max_steps + 8] (u16 bits of the JAX output). dp_variant is "v2" or
    "base"; the blob carries no n_slots table, so "dynk" is an error. On a
    CUDA device the DP and the backtrack are the hand-written kernels; on
    the CPU their plain twins."""
    if dp_variant not in ("v2", "base"):
        raise ValueError(f"dp_variant {dp_variant!r} cannot run on the CSR "
                         "blob (expected 'v2' or 'base')")
    key, cnt, cov, lead, seed_u8, last_col = blob_tables(
        blob, B=B, W=W, K=K, P=P, Pd=Pd, Pe=Pe, device=device)
    return dp_backtrack(SlotTables(key, cnt, cov, None), lead, seed_u8,
                        last_col, max_steps, dp_variant)


def dp_backtrack_csr(ns_u8, keylo, clo, dgap, dval, eidx, xkey, xcnt,
                     overflow, lead_abs, seed_anchor, last_col, B: int,
                     W: int, K: int, max_steps: int,
                     dp_variant: str = "v2"):
    """DP + backtrack from the flat CSR upload (pipeline.windows.split_csr,
    the dgap stream raw as encode_dgap gives it), on the inputs' device: the
    JAX dp_backtrack_csr, with dp_variant ("v2" or "base") in place of
    use_pallas. assemble_csr, then the DP and backtrack kernels on a CUDA
    device (their plain twins on the CPU). Returns (out, lvl_over) as the
    JAX program does (unpack_backtrack_out); lvl_over is all False, as on
    the JAX Pallas route, since the DP has no level cap. `overflow` rides
    along unread, as in the JAX program."""
    if dp_variant not in ("v2", "base"):
        raise ValueError(f"dp_variant {dp_variant!r} cannot run on the CSR "
                         "upload (expected 'v2' or 'base')")
    i32 = torch.int32
    parts = [t.to(i32) for t in (ns_u8, keylo, clo, dgap, dval, eidx, xkey,
                                 xcnt)]
    key, cnt, cov = assemble_csr(*parts, B, W, K)
    last_col = last_col.to(i32).contiguous()
    packed = dp_backtrack(
        SlotTables(key, cnt, cov, None, overflow),
        lead_abs.to(i32).contiguous(),
        seed_anchor.to(torch.uint8).contiguous(), last_col, max_steps,
        dp_variant)
    return unpack_backtrack_out(packed, last_col)


# --------------------------------------------------------------------------
# the mesh's dispatch formats: each 'win' position runs its own rows of the
# chunk on its device (parallel/mesh.py); the positions' packed rows,
# concatenated in position order, are the one-device program's output, since
# every row's words and meta are its own


def _gather_rows(parts: list) -> torch.Tensor:
    """The positions' packed rows, in position order, on the first
    position's device (the gather waits on every position)."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts])


def dp_backtrack_csr_blob_sharded(blob, mesh, *, B: int, W: int, K: int,
                                  P: int, Pd: int, Pe: int, max_steps: int,
                                  dp_variant: str = "v2") -> torch.Tensor:
    """The chunk program sharded over the mesh's 'win' axis (the JAX
    dp_backtrack_csr_blob_sharded): every position parses the whole blob
    (one tensor a position, on its device, or one tensor or array to copy to
    each), assembles only its rows [i*Bl, (i+1)*Bl) into [Bl, W, K] tables
    (assemble_csr win_lo/Bl) and runs the DP and backtrack kernels on its Bl
    lanes. -> int16 [B, max_steps + 8] on the first position's device, equal
    to dp_backtrack_csr_blob's output."""
    from ..parallel.mesh import count_position, per_position, win_rows

    if dp_variant not in ("v2", "base"):
        raise ValueError(f"dp_variant {dp_variant!r} cannot run on the CSR "
                         "blob (expected 'v2' or 'base')")
    parts = []
    for i, ((lo, hi), b) in enumerate(zip(win_rows(mesh, B),
                                          per_position(mesh, blob))):
        (ns, keylo, clo, dgap, dval, eidx, xkey, xcnt, lead, seed,
         last_col) = parse_csr_blob(b, B, W, K, P, Pd, Pe)
        key, cnt, cov = assemble_csr(ns, keylo, clo, dgap, dval, eidx, xkey,
                                     xcnt, B, W, K, win_lo=lo, Bl=hi - lo)
        parts.append(dp_backtrack(SlotTables(key, cnt, cov, None),
                                  lead[lo:hi], seed[lo:hi].to(torch.uint8),
                                  last_col[lo:hi], max_steps, dp_variant))
        count_position("win", i)
    return _gather_rows(parts)


def _widen16(t: torch.Tensor) -> torch.Tensor:
    """u16 values (uint16, int16 bit patterns or any wider integer type) ->
    int32."""
    if t.dtype == torch.int16:
        return t.to(torch.int32) & 0xFFFF
    return t.to(torch.int32)


def sparse_tables(dense_key, dense_cnt, coverage, eb, ew, ek, ekey, ecnt,
                  K: int, lo: int = 0, Bl: Optional[int] = None
                  ) -> SlotTables:
    """Slot tables [Bl, W, K] of rows [lo, lo + Bl) from the sparse upload
    (pipeline.windows.split_sparse): the dense [B, W, KD] tables (counts and
    coverage as u16) widened to K slots, and the deeper slots scattered in
    from the exception arrays. Exceptions of other rows, and the padding
    rows eb == B, are dropped."""
    B, W, KD = dense_key.shape
    if Bl is None:
        Bl = B
    dev = dense_key.device
    # one spare row takes every dropped exception, then goes
    key = torch.full((Bl + 1, W, K), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((Bl + 1, W, K), dtype=torch.int32, device=dev)
    key[:Bl, :, :KD] = dense_key[lo : lo + Bl].to(torch.int32)
    cnt[:Bl, :, :KD] = _widen16(dense_cnt[lo : lo + Bl])
    b = eb.to(torch.int64) - lo
    b = torch.where((b >= 0) & (b < Bl), b, Bl)
    idx = (b, ew.to(torch.int64), ek.to(torch.int64))
    key.index_put_(idx, ekey.to(torch.int32))
    cnt.index_put_(idx, ecnt.to(torch.int32))
    return SlotTables(key[:Bl], cnt[:Bl],
                      _widen16(coverage[lo : lo + Bl]).contiguous(), None)


def dp_backtrack_sparse(dense_key, dense_cnt, coverage, eb, ew, ek, ekey,
                        ecnt, lead, seed, last_col, *, K: int,
                        max_steps: int, dp_variant: str = "v2",
                        lo: int = 0, Bl: Optional[int] = None
                        ) -> torch.Tensor:
    """DP + backtrack + pack from the sparse upload (sparse_tables), on rows
    [lo, lo + Bl) (default: all), on the inputs' device -> int16
    [Bl, max_steps + 8]. dp_variant "v2" or "base": the upload carries no
    n_slots table."""
    if dp_variant not in ("v2", "base"):
        raise ValueError(f"dp_variant {dp_variant!r} cannot run on the "
                         "sparse upload (expected 'v2' or 'base')")
    tables = sparse_tables(dense_key, dense_cnt, coverage, eb, ew, ek, ekey,
                           ecnt, K, lo, Bl)
    hi = lo + tables.key.shape[0]
    i32 = torch.int32
    return dp_backtrack(tables, lead[lo:hi].to(i32).contiguous(),
                        seed[lo:hi].to(torch.uint8).contiguous(),
                        last_col[lo:hi].to(i32).contiguous(), max_steps,
                        dp_variant)


def dp_backtrack_sparse_packed(dense_key, dense_cnt, coverage, eb, ew, ek,
                               ekey, ecnt, lead, seed, last_col, *, K: int,
                               max_steps: int, dp_variant: str = "v2",
                               mesh=None) -> torch.Tensor:
    """The mesh's fallback upload (the JAX dp_backtrack_sparse_packed): with
    `mesh`, each 'win' position runs dp_backtrack_sparse on its own rows and
    exceptions, on its device (each argument one tensor a position, or one
    tensor or array to copy to each); without, one device runs them all.
    -> int16 [B, max_steps + 8] on the first position's device."""
    args = (dense_key, dense_cnt, coverage, eb, ew, ek, ekey, ecnt, lead,
            seed, last_col)
    kw = dict(K=K, max_steps=max_steps, dp_variant=dp_variant)
    if mesh is None:
        return dp_backtrack_sparse(*args, **kw)
    from ..parallel.mesh import count_position, per_position, win_rows

    placed = list(zip(*(per_position(mesh, a) for a in args)))
    B = placed[0][0].shape[0]
    parts = []
    for i, (lo, hi) in enumerate(win_rows(mesh, B)):
        parts.append(dp_backtrack_sparse(*placed[i], lo=lo, Bl=hi - lo, **kw))
        count_position("win", i)
    return _gather_rows(parts)


def dp_backtrack_packed_sharded(tables: SlotTables, lead, seed, last_col,
                                max_steps: int, dp_variant: str,
                                mesh) -> torch.Tensor:
    """The dense-table dispatch split by rows over the mesh's 'win' axis:
    each position runs dp_backtrack_packed on its rows, on its device (each
    table and scalar one tensor a position, or one tensor or array to copy
    to each). -> int16 [B, max_steps + 8] on the first position's device."""
    from ..parallel.mesh import count_position, per_position, win_rows

    n_slots = tables.n_slots
    fields = [per_position(mesh, x) for x in
              (tables.key, tables.count, tables.coverage, lead, seed,
               last_col)]
    fields.append(per_position(mesh, n_slots) if n_slots is not None
                  else [None] * len(fields[0]))
    B = fields[0][0].shape[0]
    parts = []
    for i, (lo, hi) in enumerate(win_rows(mesh, B)):
        key, cnt, cov, ld, sd, lc, ns = (None if f[i] is None else f[i][lo:hi]
                                         for f in fields)
        parts.append(dp_backtrack_packed(SlotTables(key, cnt, cov, ns), ld,
                                         sd, lc, max_steps, dp_variant))
        count_position("win", i)
    return _gather_rows(parts)
