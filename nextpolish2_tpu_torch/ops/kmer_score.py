"""Device k-mer scoring from raw allele bytes (k < 32).

The host path (models.oracle_lq.batch_min_kscores) rolls canonical k-mers,
yak-hashes them and searches the host table per batch. This module runs the
whole chain on the card instead: upload the joined allele codes (1 byte a
base) and the allele start offsets, then rolling k-mer, canonical
min(forward, reverse complement), the yak hash (io.yak.yak_hash64), the
open-addressing probe (ops/kmer_table.py layout) and the per-allele minimum
in ONE kernel launch; only an [n_seqs] count vector comes back.

kmer_min_scores replaces the jitted XLA function
nextpolish2_tpu/ops/kmer_score.py::device_min_kscores_jit (:90-176). For
CUDA tensors it launches the hand-written kernel csrc/kmer_score.cu (a warp
a strip of 512 end positions, 1024 from 2^19 bases, each lane rolling its
k-mers over 16 or 32 of them, native 64-bit hash, one search of `starts` a
strip, one 16-byte load a probe, minima kept per allele in registers; one
memset and one kernel a call); for CPU tensors it runs the plain twin
kmer_min_scores_plain. It never falls back, and every launch adds one to
consensus_cuda.LAUNCHES["kmer_min_scores"].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import timing
from ..utils.torchcfg import bucket_pow2
from .consensus_cuda import _check, _count, _fn
from .kmer_table import (MAX_PROBES, MAX_SLOTS, _low32, entries_ptr,
                         launch_on, probe_plain)

SEP_CODE = 5  # joined-stream separator; any code >= 4 is an invalid base
# end positions a warp of the kernel below 2^19 bases (32 * kShortRun,
# kmer_score.cu; twice that from there on): it sizes the kernel's scratch
STRIP = 512
_BIG = np.iinfo(np.int32).max


def yak_hash64_plain(key: torch.Tensor, mask: int) -> torch.Tensor:
    """io.yak.yak_hash64 on int64 tensors holding values below 2^62 (k <
    32): every right shift acts on a masked, non-negative value, so torch's
    arithmetic shift is the logical one, and the masks drop what the left
    shifts and sums carry past bit 61."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    return (key + (key << 31)) & mask


def end_position_hashes(codes: torch.Tensor, ksize: int):
    """(valid bool [L], hash int64 [L]): for each end position j, whether
    codes[j-k+1 .. j] are all valid bases, and the yak hash of that window's
    canonical k-mer (garbage where not valid)."""
    L = codes.shape[0]
    c = codes.long()
    pos = torch.arange(L, dtype=torch.int64, device=codes.device)
    # trailing valid-run length: an invalid base (>= 4) resets it
    last_bad = torch.cummax(torch.where(c >= 4, pos, -1), 0).values
    valid = (pos - last_bad) >= ksize
    fwd = torch.zeros(L, dtype=torch.int64, device=codes.device)
    rev = torch.zeros(L, dtype=torch.int64, device=codes.device)
    for t in range(ksize):
        # window offset t (0 = leftmost) of end position j is c[j-k+1+t];
        # wrapped positions only feed j < k-1, which `valid` masks off
        ct = torch.roll(c, ksize - 1 - t) & 3
        fwd |= ct << (2 * (ksize - 1 - t))
        rev |= (ct ^ 3) << (2 * t)
    # both below 2^62, so the signed minimum is the unsigned one
    return valid, yak_hash64_plain(torch.minimum(fwd, rev),
                                   (1 << (2 * ksize)) - 1)


def kmer_min_scores_plain(key_hi, key_lo, counts, codes, starts, ksize: int,
                          min_count: int, n_probes: int = MAX_PROBES):
    """Plain twin of the kmer_min_scores kernel."""
    _count("kmer_min_scores_plain")
    mask = key_hi.shape[0] - 1
    valid, h = end_position_hashes(codes, ksize)
    s10 = h >> 10
    slot = (s10 ^ (h << 7)) & mask
    out, _ = probe_plain(key_hi, key_lo, counts, (h >> 32).to(torch.int32),
                         _low32(h), slot, n_probes)
    out = torch.where(out >= min_count, out, 0)
    S = starts.shape[0]
    L = codes.shape[0]
    # allele of each end position: #{i >= 1 : starts[i] <= j}
    sid = torch.searchsorted(starts[1:].contiguous(),
                             torch.arange(L, dtype=starts.dtype,
                                          device=codes.device), right=True)
    mins = torch.full((S,), _BIG, dtype=torch.int32, device=codes.device)
    mins.scatter_reduce_(0, sid[valid], out[valid], reduce="amin")
    return torch.where(mins == _BIG, 0, mins)


def kmer_min_scores_call(key_hi, key_lo, counts, codes, starts, ksize: int,
                         min_count: int, n_probes: int = MAX_PROBES):
    """The checked C call of kmer_min_scores on CUDA tensors, not made: (C
    function, its arguments, output tensor [S]). The call writes the
    output's buffer, which holds the kernel's scratch behind the S minima."""
    dev = key_hi.device
    if dev.type != "cuda":
        raise ValueError(f"kmer_min_scores: unsupported device {dev}")
    if not 1 <= ksize < 32:
        raise ValueError(f"kmer_min_scores: k={ksize} outside 1..31")
    size = key_hi.shape[0]
    if size < 1 or size & (size - 1) or size > MAX_SLOTS:
        raise ValueError(f"kmer_min_scores: table size {size} is not a "
                         "power of two")
    entries = entries_ptr("kmer_min_scores", key_hi, key_lo, counts)
    L, S = codes.shape[0], starts.shape[0]
    _check(codes, "codes", torch.uint8, (L,), dev)
    _check(starts, "starts", torch.int32, (S,), dev)
    if codes.data_ptr() % 16:
        raise ValueError("kmer_min_scores: codes are not 16-byte aligned")
    n = S + 1 + (L + STRIP - 1) // STRIP
    buf = torch.empty(n, dtype=torch.int32, device=dev)
    return (_fn("kmer_score"),
            (entries, codes.data_ptr(), starts.data_ptr(), buf.data_ptr(), L,
             S, int(ksize), size - 1, int(min_count), int(n_probes), n,
             torch.cuda.current_stream(dev).cuda_stream), buf[:S])


def kmer_min_scores(key_hi, key_lo, counts, codes, starts, ksize: int,
                    min_count: int, n_probes: int = MAX_PROBES):
    """codes uint8 [L] (joined alleles, SEP_CODE separators, pad >= 4),
    starts int32 [S] (allele start offsets, ascending; padding repeats L)
    -> int32 [S] min k-mer count per allele (0 if a k-mer is absent or
    below min_count, or the allele has no valid k-mer). key_hi/key_lo/
    counts: the table planes (on the card the columns of a
    DeviceKmerTable's entries). CPU tensors: the plain twin; CUDA tensors:
    the kernel."""
    if key_hi.device.type == "cpu":
        return kmer_min_scores_plain(key_hi, key_lo, counts, codes, starts,
                                     ksize, min_count, n_probes)
    fn, args, out = kmer_min_scores_call(key_hi, key_lo, counts, codes,
                                         starts, ksize, min_count, n_probes)
    launch_on(key_hi.device, "kmer_min_scores",
              (bucket_pow2(codes.shape[0], 1 << 12),), fn, *args)
    return out


def score_inputs(seqs):
    """Joined codes and padded starts of an allele batch, bucketed as the
    JAX package buckets them: codes uint8 [L] (alleles joined by SEP_CODE,
    padded with it to a power of two >= 2^16), starts int32 [S] (padded to
    a power of two >= 1024 with L)."""
    from ..utils.seqcodes import seq_to_codes

    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=n)
    codes = seq_to_codes(b"\xff".join(seqs)).astype(np.uint8)
    # separators are invalid bases like an internal N; allele ids come from
    # the start offsets, not the separators
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1] + 1, out=starts[1:])
    codes[starts[1:] - 1] = SEP_CODE
    L = bucket_pow2(max(len(codes), 1), 1 << 16)
    if L > len(codes):
        codes = np.concatenate(
            [codes, np.full(L - len(codes), SEP_CODE, np.uint8)])
    starts_p = np.full(bucket_pow2(n, 1024), L, dtype=np.int32)
    starts_p[:n] = starts
    return codes, starts_p


def device_min_kscores(table, seqs, min_count: int) -> Optional[np.ndarray]:
    """Score alleles on the table's device from raw bytes. Returns i32
    [len(seqs)], or None when the path does not apply (k >= 32, empty
    batch). `table` is an io.yak.KmerTable with use_device set."""
    if not seqs or table.ksize >= 32:
        return None
    if timing.enabled():
        lens = np.fromiter(map(len, seqs), np.int64, len(seqs))
        timing.count("kmer.queries_device",
                     int(np.maximum(lens - table.ksize + 1, 0).sum()))
    tab, hi, lo, ct = table.device_table()
    codes, starts = score_inputs(seqs)
    dev = hi.device
    out = kmer_min_scores(hi, lo, ct, torch.from_numpy(codes).to(dev),
                          torch.from_numpy(starts).to(dev), table.ksize,
                          int(min_count), tab.n_probes)
    return out.cpu().numpy()[: len(seqs)]
