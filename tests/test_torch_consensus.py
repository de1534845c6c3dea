"""The port's chunk program vs the JAX package, bit for bit, on the CPU.

Same inputs (numpy, from a seed or from testdata/slice.*) go through the JAX
function and its PyTorch counterpart:
  - the DP's plain twin vs the Pallas kernel _dp_kernel_v2 in interpret mode
    with span bounding (scores everywhere, besti where key >= 0);
  - CSR assembly vs the JAX fused1 assemble_csr;
  - the whole blob program vs JAX dp_backtrack_csr_blob(use_pallas=False),
    on every window the JAX DP did not flag for its level cap.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextpolish2_tpu.config import PolishConfig
from nextpolish2_tpu.io.fastx import read_fastx
from nextpolish2_tpu.models.oracle import build_alignseqs_native_flat
from nextpolish2_tpu.ops import consensus as jc
from nextpolish2_tpu.ops.consensus_pallas import consensus_dp_pallas
from nextpolish2_tpu.pipeline.windows import (aggregate_csr_host,
                                              build_window_batch,
                                              pack_csr_blob, split_csr)
from nextpolish2_tpu.utils.seqcodes import ASCII2CODE
from nextpolish2_tpu_torch.ops import consensus as tc
from nextpolish2_tpu_torch.ops import consensus_cuda as tk
from nextpolish2_tpu_torch.utils import dp_cases

from test_pallas_dp import build_tables

# The plain twins run thousands of tiny ops; with every test worker holding
# a full OpenMP pool, the pools spin against each other and a run slows by
# an order of magnitude.
torch.set_num_threads(1)

BASE = "testdata"


@functools.lru_cache(maxsize=None)
def _slice_windows():
    tseq = next(iter(read_fastx(f"{BASE}/slice.fa")))[1]
    cfg = PolishConfig(min_ctg_len=1000)
    res = build_alignseqs_native_flat(f"{BASE}/slice.bam", 0, tseq, cfg)
    if res is None:
        pytest.skip("native library unavailable")
    al, flat = res
    ref = ASCII2CODE[np.frombuffer(tseq, dtype=np.uint8)]
    return build_window_batch(al, len(tseq), ref, target=cfg.window_len,
                              stream_cache={"flat_all": flat})


@functools.lru_cache(maxsize=None)
def slice_chunk(K: int, B: int, W: int):
    """(blob, P, Pd, Pe, last_col) of a real slice chunk built by the JAX
    package's host pipeline."""
    wb = _slice_windows()
    lead_all = np.maximum(wb.window_start - 2, 0)
    last_all = (wb.window_start + wb.window_len - 1 - lead_all).astype(np.int32)
    ids = np.nonzero(last_all < W)[0][:B]
    n = len(ids)
    lead = np.zeros(B, np.int64)
    lead[:n] = lead_all[ids]
    seed = np.zeros(B, bool)
    seed[:n] = wb.window_start[ids] > 0
    last_col = np.zeros(B, np.int32)
    last_col[:n] = last_all[ids]
    csr = aggregate_csr_host(wb, K, width=W, n_windows=B, win_idx=ids)
    ns_u8, keylo, clo, dgap, dval, eidx, xkey, xcnt, _over = csr
    blob = pack_csr_blob(ns_u8, keylo, clo, dgap, dval, eidx, xkey, xcnt,
                         lead, seed, last_col,
                         nibble_ns=jc.nibble_ns_for(B, W, K))
    return blob, len(keylo), len(dgap), len(eidx), last_col


def _tables_from_blob(blob, B, W, K, P, Pd, Pe):
    parts = tc.parse_csr_blob(torch.from_numpy(blob), B, W, K, P, Pd, Pe)
    key, cnt, cov = tc.assemble_csr(*parts[:8], B, W, K)
    return key, cnt, cov, parts[8], parts[9], parts[10]


def _pallas_dp(key, cnt, cov, lead, seed, span):
    sc, bi, _ = consensus_dp_pallas(
        jnp.asarray(key), jnp.asarray(cnt), jnp.asarray(cov),
        jnp.asarray(lead), jnp.asarray(seed), interpret=True, variant="v2",
        span=jnp.asarray(span.astype(np.int32)))
    return np.asarray(sc), np.asarray(bi)


def _assert_dp_equal(key, cnt, cov, lead, seed, span):
    sc_j, bi_j = _pallas_dp(key, cnt, cov, lead, seed, span)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    sc_t, bi_t = tk.consensus_dp_v2(
        t(key.astype(np.int32)), t(cnt.astype(np.int32)),
        t(cov.astype(np.int32)), t(lead.astype(np.int32)),
        t(seed.astype(np.uint8)), t(span.astype(np.int32)))
    np.testing.assert_array_equal(sc_t.numpy(), sc_j)
    valid = key >= 0
    np.testing.assert_array_equal(np.where(valid, bi_t.numpy(), 0),
                                  np.where(valid, bi_j.astype(np.int8), 0))


@pytest.mark.parametrize("seed", [70, 71, 72])
def test_dp_plain_matches_pallas_v2(seed):
    key, cnt, cov, lead, seed_anchor = build_tables(seed=seed)
    W = key.shape[1]
    span = W - np.argmax((key >= 0).any(2)[:, ::-1], axis=1)
    before = tk.LAUNCHES["consensus_dp_plain"]
    _assert_dp_equal(key, cnt, cov, lead, seed_anchor, span)
    assert tk.LAUNCHES["consensus_dp_plain"] == before + 1


@pytest.mark.parametrize("K,W,crop", [(8, 1280, 1280), (48, 2560, 128)])
def test_dp_plain_matches_pallas_v2_slice_chunk(K, W, crop):
    """Real slice chunks at the K=8 and K=48 tiers. The K=48 chunk keeps
    its first `crop` columns (a DP prefix is a DP of its own): the Pallas
    interpreter compiles the K=48 kernel body in tens of seconds and runs
    ~0.1 s per column."""
    B = 16
    blob, P, Pd, Pe, last_col = slice_chunk(K, B, W)
    key, cnt, cov, lead, seed, _lc = _tables_from_blob(blob, B, W, K, P, Pd,
                                                       Pe)
    key, cnt, cov = (key.numpy()[:, :crop], cnt.numpy()[:, :crop],
                     cov.numpy()[:, :crop])
    span = np.minimum(last_col + 1, crop)
    assert (key >= 0).any()
    _assert_dp_equal(key, cnt, cov, lead.numpy(), seed.numpy(), span)


def _synthetic_csr_chunk(seed=5, B=4, W=96, K=12):
    """Dense slot tables with deep slots, deltas (some > 0xFF) and counts up
    to 600, split into the CSR upload by the JAX package's split_csr."""
    rng = np.random.default_rng(seed)
    n_slots = rng.integers(0, K + 1, size=(B, W)).astype(np.int32)
    slot = np.arange(K)[None, None, :]
    live = slot < n_slots[:, :, None]
    keylo = rng.integers(0, 0x8000, size=(B, W, K))
    delta = np.where(rng.random((B, W, K)) < 0.3,
                     rng.integers(1, 0x3FF, size=(B, W, K)), 0)
    key = np.where(live, keylo | (delta << 16), -1).astype(np.int32)
    cnt = np.where(live, rng.integers(1, 600, size=(B, W, K)), 0).astype(np.int32)
    return key, cnt, n_slots


def test_assemble_csr_matches_jax_synthetic():
    key, cnt, n_slots = _synthetic_csr_chunk()
    B, W, K = key.shape
    ns_u8, keylo, clo, dgap, dval, eidx, xkey, xcnt = split_csr(key, cnt,
                                                                n_slots)
    assert (eidx < len(keylo)).any(), "needs a nonzero exception list"
    assert (dval > 0).any(), "needs a nonzero delta sidecar"
    assert (cnt >= 128).any() and (cnt > 0xFF).any()
    args = (ns_u8, keylo, clo, dgap, dval, eidx, xkey, xcnt)
    kj, cj, vj = jc.assemble_csr(*(jnp.asarray(a) for a in args), B, W, K)
    targs = [torch.from_numpy(np.ascontiguousarray(a)).to(torch.int32)
             for a in args]
    kt, ct, vt = tc.assemble_csr(*targs, B, W, K)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(kt.numpy(), key)
    np.testing.assert_array_equal(ct.numpy(), cnt)


@pytest.mark.parametrize("K,W", [(8, 1280), (48, 2560)])
def test_assemble_csr_matches_jax_slice(K, W):
    B = 16
    blob, P, Pd, Pe, _ = slice_chunk(K, B, W)
    assert Pd > 0 and Pe > 0
    key, cnt, cov, *_ = _tables_from_blob(blob, B, W, K, P, Pd, Pe)
    parts = jc._parse_csr_blob(jnp.asarray(blob), B, W, K, P, Pd, Pe)
    kj, cj, vj = jc.assemble_csr(*parts[:8], B, W, K)
    np.testing.assert_array_equal(key.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(cov.numpy(), np.asarray(vj))


@pytest.mark.parametrize("K,W", [(8, 1280), (48, 2560)])
def test_whole_blob_matches_jax(K, W):
    B = 16
    blob, P, Pd, Pe, last_col = slice_chunk(K, B, W)
    max_steps = W + 128
    out_j = np.asarray(jc.dp_backtrack_csr_blob(
        jnp.asarray(blob), B=B, W=W, K=K, P=P, Pd=Pd, Pe=Pe,
        max_steps=max_steps, use_pallas=False))
    out_t = tc.dp_backtrack_csr_blob(blob, B=B, W=W, K=K, P=P, Pd=Pd, Pe=Pe,
                                     max_steps=max_steps, device="cpu")
    assert out_t.dtype == torch.int16 and out_t.shape == (B, max_steps + 8)
    out_t = out_t.numpy().view(np.uint16)
    lvl_j = jc.decode_backtrack_words(out_j, last_col)[5]
    lvl_t = tc.decode_backtrack_words(out_t, last_col)[5]
    assert not lvl_t.any()
    ok = ~lvl_j
    assert ok.sum() >= B // 2
    np.testing.assert_array_equal(out_t[ok], out_j[ok])
    for a, b in zip(tc.decode_backtrack_words(out_t, last_col),
                    jc.decode_backtrack_words(out_j, last_col)):
        np.testing.assert_array_equal(a[ok], b[ok])


def test_whole_blob_window_wider_than_chunk():
    """A window whose last column lies past the chunk (the host aggregation
    flags it for the host fallback) must not break the chunk: the other
    windows still match JAX."""
    K, B, W = 8, 16, 1280
    blob, P, Pd, Pe, last_col = slice_chunk(K, B, W)
    last_col = last_col.copy()
    last_col[0] = W + 50
    blob = blob.copy()
    blob[-4 * B:] = last_col.astype("<i4").view(np.uint8)  # the last field
    max_steps = W + 128
    out_j = np.asarray(jc.dp_backtrack_csr_blob(
        jnp.asarray(blob), B=B, W=W, K=K, P=P, Pd=Pd, Pe=Pe,
        max_steps=max_steps, use_pallas=False))
    out_t = tc.dp_backtrack_csr_blob(blob, B=B, W=W, K=K, P=P, Pd=Pd, Pe=Pe,
                                     max_steps=max_steps, device="cpu")
    out_t = out_t.numpy().view(np.uint16)
    ok = ~jc.decode_backtrack_words(out_j, last_col)[5]
    ok[0] = False
    assert ok.sum() >= B // 2
    np.testing.assert_array_equal(out_t[ok], out_j[ok])


@pytest.mark.cuda
def test_kernels_match_plain_twins_on_card():
    """On a CUDA card: each kernel against its plain twin on a real chunk
    and on every edge-case table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    for case in dp_cases.edge_cases():
        assert dp_cases.check_kernels(case, dev)["K"] == case.key.shape[2]
    for K, W in [(8, 1280), (48, 2560)]:
        B = 16
        blob, P, Pd, Pe, _ = slice_chunk(K, B, W)
        key, cnt, cov, lead, seed, lc = (
            x.to(dev) for x in _tables_from_blob(blob, B, W, K, P, Pd, Pe))
        seed8, span = seed.to(torch.uint8), lc + 1
        sk, bk = tk.consensus_dp_v2(key, cnt, cov, lead, seed8, span)
        sp, bp = tk.consensus_dp_plain(key, cnt, cov, lead, seed8, span)
        assert torch.equal(sk, sp) and torch.equal(bk, bp)
        ok = tk.backtrack_packed(key, cnt, cov, sk, bk, lc, seed8, W + 128)
        op = tk.backtrack_plain(key, cnt, cov, sk, bk, lc, seed8, W + 128)
        torch.cuda.synchronize()
        assert torch.equal(ok, op)
        wide = lc.clone()
        wide[0] = W + 50
        assert torch.equal(
            tk.backtrack_packed(key, cnt, cov, sk, bk, wide, seed8, W + 128),
            tk.backtrack_plain(key, cnt, cov, sk, bk, wide, seed8, W + 128))
