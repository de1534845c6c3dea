"""The port's aggregate_windows and dp_backtrack_csr vs the JAX package, on
the CPU. Tolerance: exact, every field of every output.

  - aggregate_windows on the stream of test_aggregate.py's host-vs-device
    test (and against the host aggregation there), on seeded random streams
    with padding (col == width) anywhere in them, on keys with bit 31 set
    (negative in int32), and on columns with more than K distinct keys
    (overflow), at K 8 and 48;
  - dp_backtrack_csr on the split_csr upload of a slice chunk against the
    JAX dp_backtrack_csr with use_pallas=False (on every window its DP did
    not flag for its level cap), against the JAX Pallas route (the v2
    kernel in interpret mode, as test_pallas_dp.py runs it, then the JAX
    backtrack), and against the port's own dp_backtrack_csr_blob.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextpolish2_tpu.config import PolishConfig
from nextpolish2_tpu.io.bam import BamRecord
from nextpolish2_tpu.models.oracle import build_alignseqs
from nextpolish2_tpu.ops import consensus as jc
from nextpolish2_tpu.ops.consensus_pallas import consensus_dp_pallas
from nextpolish2_tpu.pipeline.windows import aggregate_host, build_window_batch
from nextpolish2_tpu.utils.seqcodes import ASCII2CODE
from nextpolish2_tpu_torch.ops import consensus as tc

from test_torch_consensus import slice_chunk

torch.set_num_threads(1)

FIELDS = ("key", "count", "coverage", "n_slots", "overflow")


def _host_test_stream():
    """The (cols, keys) stream, width and K of
    test_aggregate.py::test_host_vs_device_aggregation, and its host
    aggregation."""
    rng = np.random.default_rng(50)
    t = bytes(rng.choice(list(b"ACGT"), size=2000).astype(np.uint8))
    reads = []
    for s in range(0, 1500, 150):
        seq = bytearray(t[s : s + 600])
        for _ in range(3):
            i = int(rng.integers(len(seq)))
            seq[i] = int(rng.choice(list(b"ACGT")))
        reads.append(BamRecord(qname=f"r{s}".encode(), flag=0, tid=0, pos=s,
                               mapq=60, cigar=[(0, 600)], seq=bytes(seq)))
    cfg = PolishConfig(min_ctg_len=0, min_read_len=100, min_map_len=50)
    aligns = build_alignseqs(t, reads, cfg)
    ref_codes = ASCII2CODE[np.frombuffer(t, dtype=np.uint8)]
    wb = build_window_batch(aligns, len(t), ref_codes, target=512)
    K = 32
    cols, keys = wb.padded()
    return cols, keys, wb.width, K, aggregate_host(wb, K)


def _random_keys(rng, shape, bit31: bool):
    """Packed 3-mer keys: q nibbles, the flag patterns the decoder reads
    (none, bit 0, bits 0 and 2) and small deltas; with bit31, a share of
    the deltas reach 0x8000 and more (key < 0 in int32)."""
    q = rng.integers(0, 16, size=(3,) + shape)
    flags = rng.choice([0b0000, 0b0001, 0b0101, 0b0100], size=shape)
    delta = rng.integers(0, 4, size=shape)
    if bit31:
        hi = rng.random(shape) < 0.3
        delta = np.where(hi, rng.integers(0x8000, 0x10000, size=shape), delta)
    key = (delta << 16) | (flags << 12) | (q[0] << 8) | (q[1] << 4) | q[2]
    return key.astype(np.int64).astype(np.uint32).view(np.int32)


def _random_stream(seed: int, B: int, T: int, width: int, n_keys: int,
                   bit31: bool = False, pad_share: float = 0.15):
    """[B, T] streams: columns in [0, width) with padding (col == width)
    scattered through each row and a padded tail; keys drawn from a pool of
    n_keys per row, so that columns repeat keys (segments longer than 1)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, width, size=(B, T)).astype(np.int32)
    cols[rng.random((B, T)) < pad_share] = width
    cols[:, T - T // 8 :] = width
    pool = _random_keys(rng, (B, n_keys), bit31)
    keys = np.take_along_axis(pool, rng.integers(0, n_keys, size=(B, T)), 1)
    return cols, keys.astype(np.int32)


def _overflow_stream(K: int, width: int = 24):
    """Two windows: window 0 has columns with K-1, K, K+1 and 2K+3 distinct
    keys (each key seen 1-3 times), window 1 stays below K everywhere."""
    rng = np.random.default_rng(80 + K)
    rows = []
    for w, counts in enumerate(((K - 1, K, K + 1, 2 * K + 3), (K - 1, 2, 1))):
        c, k = [], []
        for col, n in enumerate(counts):
            keys = _random_keys(rng, (n,), bit31=False)
            keys = (keys & ~0xFF) | np.arange(n)  # n distinct keys
            for key in keys:
                for _ in range(int(rng.integers(1, 4))):
                    c.append(3 * col + 1)
                    k.append(key)
        perm = rng.permutation(len(c))
        rows.append((np.array(c)[perm], np.array(k)[perm]))
    T = max(len(c) for c, _ in rows) + 5
    cols = np.full((2, T), width, np.int32)
    keys = np.zeros((2, T), np.int32)
    for w, (c, k) in enumerate(rows):
        cols[w, : len(c)] = c
        keys[w, : len(k)] = k
    return cols, keys, width


def _case(name: str, K: int):
    if name == "host_stream":
        cols, keys, width, K, _ = _host_test_stream()
        return cols, keys, width, K
    if name == "random":
        return (*_random_stream(90 + K, 3, 600, 40, 12), 40, K)
    if name == "bit31":
        return (*_random_stream(91, 3, 500, 32, 10, bit31=True), 32, K)
    if name == "overflow":
        return (*_overflow_stream(K), K)
    raise ValueError(name)


def _assert_tables_equal(tt, jt):
    for f in FIELDS:
        got = getattr(tt, f)
        want = np.asarray(getattr(jt, f))
        assert got.dtype == (torch.bool if f == "overflow" else torch.int32), f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


@pytest.mark.parametrize("name,K", [("host_stream", 32), ("random", 8),
                                    ("random", 48), ("bit31", 8),
                                    ("overflow", 8), ("overflow", 48)])
def test_aggregate_windows_matches_jax(name, K):
    cols, keys, width, K = _case(name, K)
    jt = jc.aggregate_windows(jnp.asarray(cols), jnp.asarray(keys), width, K)
    tt = tc.aggregate_windows(torch.from_numpy(cols), torch.from_numpy(keys),
                              width, K)
    _assert_tables_equal(tt, jt)
    if name == "overflow":
        assert tt.overflow.tolist() == [True, False]
    if name == "bit31":
        assert (keys < 0).any()
    if name == "random":
        assert (tt.n_slots.numpy() > 1).any() and (cols == width).any()


def test_aggregate_windows_matches_host_aggregation():
    cols, keys, width, K, host = _host_test_stream()
    tt = tc.aggregate_windows(torch.from_numpy(cols), torch.from_numpy(keys),
                              width, K)
    for f, want in zip(FIELDS, host):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), want,
                                      err_msg=f)


@functools.lru_cache(maxsize=None)
def _csr_inputs(K: int, B: int, W: int):
    """The split_csr upload of a slice chunk (parsed back out of its blob:
    dgap raw, as encode_dgap gives it) and the chunk's numbers."""
    blob, P, Pd, Pe, last_col = slice_chunk(K, B, W)
    parts = [np.asarray(a) for a in
             jc._parse_csr_blob(jnp.asarray(blob), B, W, K, P, Pd, Pe)]
    return blob, (P, Pd, Pe), parts


def _port_csr(parts, B, W, K, max_steps):
    t = [torch.from_numpy(np.array(a)) for a in parts]
    ns, keylo, clo, dgap, dval, eidx, xkey, xcnt, lead, seed, last_col = t
    return tc.dp_backtrack_csr(ns, keylo, clo, dgap, dval, eidx, xkey, xcnt,
                               torch.zeros(B, dtype=torch.bool), lead, seed,
                               last_col, B, W, K, max_steps)


def _assert_out_equal(out_t, lvl_t, out_j, lvl_j, rows):
    names = ("cols", "packed", "qv", "best", "n_steps", "truncated")
    for name, a, b in zip(names, out_t, out_j):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy()[rows], b[rows], err_msg=name)
    np.testing.assert_array_equal(lvl_t.numpy()[rows],
                                  np.asarray(lvl_j)[rows])


@pytest.mark.parametrize("K,W", [(8, 1280), (48, 2560)])
def test_dp_backtrack_csr_matches_jax(K, W):
    B = 16
    max_steps = W + 128
    _blob, _sizes, parts = _csr_inputs(K, B, W)
    ns, keylo, clo, dgap, dval, eidx, xkey, xcnt, lead, seed, last_col = parts
    out_j, lvl_j = jc.dp_backtrack_csr(
        *(jnp.asarray(a) for a in parts[:8]), jnp.zeros(B, bool),
        jnp.asarray(lead), jnp.asarray(seed), jnp.asarray(last_col),
        B=B, W=W, K=K, max_steps=max_steps, use_pallas=False)
    out_t, lvl_t = _port_csr(parts, B, W, K, max_steps)
    assert not lvl_t.any()
    ok = ~np.asarray(lvl_j)
    assert ok.sum() >= B // 2
    _assert_out_equal(out_t, lvl_t, out_j, lvl_j, ok)


def test_dp_backtrack_csr_matches_jax_pallas_route():
    """The JAX program's use_pallas branch with the v2 kernel in interpret
    mode: every window, the level flag included (all False there too)."""
    K, B, W = 8, 16, 1280
    max_steps = W + 128
    _blob, _sizes, parts = _csr_inputs(K, B, W)
    lead, seed, last_col = (jnp.asarray(a) for a in parts[8:])
    key, cnt, cov = jc.assemble_csr(*(jnp.asarray(a) for a in parts[:8]),
                                    B, W, K)
    sc, bi, lvl_j = consensus_dp_pallas(key, cnt, cov, lead, seed,
                                        interpret=True, variant="v2",
                                        span=last_col + 1)
    tables = jc.SlotTables(key=key, count=cnt, coverage=cov, n_slots=None,
                           overflow=jnp.zeros(B, bool))
    out_j = jc.backtrack(tables, sc, bi.astype(jnp.int8), last_col, seed,
                         max_steps)
    out_t, lvl_t = _port_csr(parts, B, W, K, max_steps)
    _assert_out_equal(out_t, lvl_t, out_j, lvl_j, np.ones(B, bool))


@pytest.mark.parametrize("dp_variant", ["v2", "base"])
def test_dp_backtrack_csr_matches_port_blob(dp_variant):
    K, B, W = 8, 16, 1280
    max_steps = W + 128
    blob, (P, Pd, Pe), parts = _csr_inputs(K, B, W)
    t = [torch.from_numpy(np.array(a)) for a in parts]
    out_t, lvl_t = tc.dp_backtrack_csr(
        *t[:8], torch.zeros(B, dtype=torch.bool), *t[8:], B=B, W=W, K=K,
        max_steps=max_steps, dp_variant=dp_variant)
    packed = tc.dp_backtrack_csr_blob(blob, B=B, W=W, K=K, P=P, Pd=Pd, Pe=Pe,
                                      max_steps=max_steps, device="cpu",
                                      dp_variant=dp_variant)
    out_b, lvl_b = tc.unpack_backtrack_out(packed, t[10])
    for a, b in zip(out_t + (lvl_t,), out_b + (lvl_b,)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    # and the host decode of the same words
    host = tc.decode_backtrack_words(packed.numpy(), parts[10])
    np.testing.assert_array_equal(out_t[0].numpy().astype(np.uint16), host[0])
    np.testing.assert_array_equal(out_t[3].numpy(), host[3])
    with pytest.raises(ValueError, match="dynk"):
        tc.dp_backtrack_csr(*t[:8], torch.zeros(B, dtype=torch.bool),
                            *t[8:], B=B, W=W, K=K, max_steps=max_steps,
                            dp_variant="dynk")
