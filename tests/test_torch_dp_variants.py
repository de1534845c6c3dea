"""The port's base and dynamic-K DP formulations and its dense-table dispatch
vs the JAX package, bit for bit, on the CPU (tolerance 0 throughout: integer
programs).

  - each plain twin against ITS Pallas kernel in interpret mode (_dp_kernel,
    _dp_kernel_dynk): scores everywhere, besti where key >= 0, on seeded
    tables, a real slice chunk, and a synthetic table whose chain falls below
    NEG_INF - 1, where the reductions of base/dynk and the running pick of v2
    give different scores;
  - dp_backtrack_packed under each variant against the JAX composition
    consensus_dp_pallas(interpret) -> backtrack -> pack_backtrack_out, the
    whole array (an empty window included), and against the JAX
    dp_backtrack_packed(use_pallas=False) on windows it did not flag lvl_over;
  - variant selection: explicit, from the environment, and its errors.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextpolish2_tpu.ops import consensus as jc
from nextpolish2_tpu.ops.consensus_pallas import consensus_dp_pallas
from nextpolish2_tpu_torch.ops import consensus as tc
from nextpolish2_tpu_torch.ops import consensus_cuda as tk
from nextpolish2_tpu_torch.pipeline import engine as te
from nextpolish2_tpu_torch.utils import dp_cases

from test_pallas_dp import build_tables
from test_torch_consensus import _tables_from_blob, slice_chunk

# one OpenMP thread per test worker: see test_torch_consensus.py
torch.set_num_threads(1)

NEG_INF = -(1 << 30)
VARIANTS = ("v2", "base", "dynk")


def _t(a, dtype=None):
    a = np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype))
    return torch.from_numpy(a)


def _last_col(key):
    """Last column holding a valid key (0 for an empty window)."""
    W = key.shape[1]
    any_c = (key >= 0).any(2)
    return np.where(any_c.any(1), W - 1 - np.argmax(any_c[:, ::-1], axis=1),
                    0).astype(np.int32)


@functools.lru_cache(maxsize=None)
def seeded_tables(seed: int):
    """build_tables(seed) plus one empty window (a pad lane): key, cnt, cov,
    n_slots, lead, seed_anchor, last_col."""
    key, cnt, cov, lead, sa = build_tables(seed=seed)
    B, W, K = key.shape
    key = np.concatenate([key, np.full((1, W, K), -1, key.dtype)])
    cnt = np.concatenate([cnt, np.zeros((1, W, K), cnt.dtype)])
    cov = np.concatenate([cov, np.zeros((1, W), cov.dtype)])
    lead = np.concatenate([lead, [0]]).astype(np.int32)
    sa = np.concatenate([sa, [False]])
    ns = (key >= 0).sum(2).astype(np.int32)
    return key, cnt, cov, ns, lead, sa, _last_col(key)


def below_neg1_tables():
    """A chain that hangs off an unreachable slot with negative gain. Plain
    3-mers (flags 0) in columns 5..10 of window 0, each overlapping the one
    before: slot A at column 5 has no predecessor and is no head, so it
    scores NEG_INF; B scores NEG_INF + gain < NEG_INF - 1; from C on the
    running pick (v2) and the _pick reduction (base, dynk) part. Window 1 is
    an ordinary head-started chain; window 2 is empty."""
    B, W, K = 3, 16, 4
    key = np.full((B, W, K), -1, np.int32)
    cnt = np.zeros((B, W, K), np.int32)
    cov = np.zeros((B, W), np.int32)

    def kmer(q1, q2, q3):
        return (q1 << 8) | (q2 << 4) | q3

    bases = [0, 1, 2, 3, 0, 1, 2, 3, 0]
    for n, c in enumerate(range(5, 11)):
        key[0, c, 0] = kmer(bases[n], bases[n + 1], bases[n + 2])
        cnt[0, c, 0] = 1
        cov[0, c] = 10  # gain = 10 * 1 - 4 * 10 = -30
    # a second, never-matching slot beside the chain: the reduction's
    # NEG_INF - 1 floor needs a non-matching row in the pool
    key[0, 5:11, 1] = kmer(2, 1, 0)
    cnt[0, 5:11, 1] = 1
    key[1, 0, 0] = kmer(15, 15, 0)
    key[1, 1, 0] = kmer(15, 0, 1)
    for n, c in enumerate(range(2, 9)):
        key[1, c, 0] = kmer(bases[n], bases[n + 1], bases[n + 2])
    cnt[1, :9, 0] = 5
    cov[1, :9] = 5
    ns = (key >= 0).sum(2).astype(np.int32)
    lead = np.zeros(B, np.int32)
    sa = np.zeros(B, bool)
    return key, cnt, cov, ns, lead, sa, _last_col(key)


@functools.lru_cache(maxsize=None)
def slice_tables(crop: int = 256):
    """The first `crop` columns of a real K=8 slice chunk (a DP prefix is a
    DP of its own), n_slots from the keys."""
    K, B, W = 8, 16, 1280
    blob, P, Pd, Pe, last_col = slice_chunk(K, B, W)
    key, cnt, cov, lead, seed, _lc = _tables_from_blob(blob, B, W, K, P, Pd,
                                                       Pe)
    key, cnt, cov = (key.numpy()[:, :crop], cnt.numpy()[:, :crop],
                     cov.numpy()[:, :crop])
    ns = (key >= 0).sum(2).astype(np.int32)
    return (key, cnt, cov, ns, lead.numpy(), seed.numpy(),
            np.minimum(last_col, crop - 1).astype(np.int32))


CASES = {"seed70": lambda: seeded_tables(70),
         "seed71": lambda: seeded_tables(71),
         "seed72": lambda: seeded_tables(72),
         "below_neg1": below_neg1_tables,
         "slice": slice_tables}
_pallas_cache: dict = {}


def pallas_dp(case: str, variant: str):
    """(scores, besti) of the JAX package's own kernel for `variant` in
    interpret mode."""
    if (case, variant) not in _pallas_cache:
        key, cnt, cov, ns, lead, sa, last_col = CASES[case]()
        args = (jnp.asarray(key), jnp.asarray(cnt), jnp.asarray(cov),
                jnp.asarray(lead), jnp.asarray(sa))
        if variant == "dynk":
            sc, bi, _ = consensus_dp_pallas(*args, interpret=True,
                                            n_slots_bw=jnp.asarray(ns),
                                            dynamic_k=True)
        elif variant == "base":
            sc, bi, _ = consensus_dp_pallas(*args, interpret=True,
                                            variant="base")
        else:
            sc, bi, _ = consensus_dp_pallas(
                *args, interpret=True, variant="v2",
                span=jnp.asarray(last_col.astype(np.int32) + 1))
        _pallas_cache[(case, variant)] = (np.asarray(sc), np.asarray(bi))
    return _pallas_cache[(case, variant)]


def torch_dp(case: str, variant: str):
    key, cnt, cov, ns, lead, sa, last_col = CASES[case]()
    tables = tc.SlotTables(_t(key), _t(cnt), _t(cov), _t(ns))
    args = (tables.key, tables.count, tables.coverage)
    lead_t, seed_t = _t(lead, np.int32), _t(sa, np.uint8)
    if variant == "dynk":
        return tk.consensus_dp_dynk(*args, tables.n_slots, lead_t, seed_t)
    if variant == "base":
        return tk.consensus_dp_base(*args, lead_t, seed_t)
    return tk.consensus_dp_v2(*args, lead_t, seed_t, _t(last_col + 1))


@pytest.mark.parametrize("variant", ["base", "dynk"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_its_pallas_kernel(case, variant):
    key = CASES[case]()[0]
    name = f"consensus_dp_{variant}_plain"
    before = tk.LAUNCHES[name]
    sc_t, bi_t = torch_dp(case, variant)
    assert tk.LAUNCHES[name] == before + 1
    sc_j, bi_j = pallas_dp(case, variant)
    assert sc_t.dtype == torch.int32 and bi_t.dtype == torch.int8
    np.testing.assert_array_equal(sc_t.numpy(), sc_j)
    valid = key >= 0
    assert valid.any()
    np.testing.assert_array_equal(np.where(valid, bi_t.numpy(), 0),
                                  np.where(valid, bi_j.astype(np.int8), 0))


def test_base_twin_besti_matches_pallas_on_every_slot():
    """The base formulation is copied slot for slot: besti agrees with the
    Pallas kernel on invalid slots too."""
    for case in ("seed70", "below_neg1"):
        np.testing.assert_array_equal(torch_dp(case, "base")[1].numpy(),
                                      pallas_dp(case, "base")[1])


def test_below_neg1_table_separates_the_formulations():
    """Past the slot that scores NEG_INF + gain, v2's running pick reports a
    match (score NEG_INF - 1 + gain) where the reduction reports none
    (NEG_INF): in Pallas and, formulation for formulation, in the port."""
    sc = {v: pallas_dp("below_neg1", v)[0] for v in VARIANTS}
    gain = -30
    assert sc["v2"][0, 6, 0] == sc["base"][0, 6, 0] == NEG_INF + gain
    assert sc["v2"][0, 7, 0] == NEG_INF - 1 + gain
    assert sc["base"][0, 7, 0] == sc["dynk"][0, 7, 0] == NEG_INF
    assert not np.array_equal(sc["v2"], sc["base"])
    np.testing.assert_array_equal(sc["base"], sc["dynk"])
    for v in VARIANTS:
        np.testing.assert_array_equal(torch_dp("below_neg1", v)[0].numpy(),
                                      sc[v])


@pytest.mark.parametrize("case", ["seed70", "seed71", "seed72", "slice"])
def test_formulations_agree_on_real_shaped_tables(case):
    key = CASES[case]()[0]
    valid = key >= 0
    sc_v, bi_v = torch_dp(case, "v2")
    for variant in ("base", "dynk"):
        sc, bi = torch_dp(case, variant)
        np.testing.assert_array_equal(sc.numpy(), sc_v.numpy())
        np.testing.assert_array_equal(np.where(valid, bi.numpy(), 0),
                                      np.where(valid, bi_v.numpy(), 0))


def test_real_overflow_window_parts_only_on_unreachable_scores():
    """The slice's one K=48-tier window loses slots to the K cap (the host
    aggregation flags it overflow and the host fallback re-runs it), which
    leaves a slot without predecessor and a chain below NEG_INF - 1 behind
    it: there the reduction (base, dynk) and the running pick (v2) part on
    real data, on unreachable scores only, and the packed output is one."""
    K, B, W = 48, 16, 2560
    blob, P, Pd, Pe, last_col = slice_chunk(K, B, W)
    key, cnt, cov, lead, seed, _lc = _tables_from_blob(blob, B, W, K, P, Pd,
                                                       Pe)
    deep = int((key >= 0).sum(2).amax(1).argmax())
    crop = 1024
    assert int(last_col[deep]) < crop
    sl = slice(deep, deep + 1)
    key, cnt, cov = (key[sl, :crop].contiguous(), cnt[sl, :crop].contiguous(),
                     cov[sl, :crop].contiguous())
    lead, seed8 = lead[sl].contiguous(), seed[sl].to(torch.uint8)
    lc = _t(last_col[sl])
    ns = (key >= 0).sum(2).to(torch.int32)
    assert int(ns.max()) == K
    sv, bv = tk.consensus_dp_v2(key, cnt, cov, lead, seed8, lc + 1)
    sb, bb = tk.consensus_dp_base(key, cnt, cov, lead, seed8)
    sd, bd = tk.consensus_dp_dynk(key, cnt, cov, ns, lead, seed8)
    assert torch.equal(sb, sd) and torch.equal(bb, bd)
    parted = (sv != sb) | ((bv != bb) & (key >= 0))
    assert 0 < int(parted.sum()) < 10
    assert int(sv[parted].max()) <= NEG_INF and int(sb[parted].max()) <= NEG_INF
    packed = [tk.backtrack_packed(key, cnt, cov, s_, b_, lc, seed8, crop + 128)
              for s_, b_ in ((sv, bv), (sb, bb))]
    assert torch.equal(*packed)


def _jax_tables(key, cnt, cov, ns):
    return jc.SlotTables(jnp.asarray(key), jnp.asarray(cnt), jnp.asarray(cov),
                         jnp.asarray(ns), jnp.zeros(key.shape[0], bool))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_dispatch_matches_jax_composition(case, variant):
    """Whole packed array, pad lanes and the empty window included."""
    key, cnt, cov, ns, lead, sa, last_col = CASES[case]()
    B, W, K = key.shape
    max_steps = W + 128
    sc_j, bi_j = pallas_dp(case, variant)
    out = jc.backtrack(_jax_tables(key, cnt, cov, ns), jnp.asarray(sc_j),
                       jnp.asarray(bi_j.astype(np.int8)),
                       jnp.asarray(last_col), jnp.asarray(sa), max_steps)
    want = np.asarray(jc.pack_backtrack_out(out, jnp.zeros(B, bool)))
    got = tc.dp_backtrack_packed(
        tc.SlotTables(_t(key), _t(cnt), _t(cov), _t(ns)),
        _t(lead.astype(np.int64)), _t(sa), _t(last_col), max_steps, variant)
    assert got.dtype == torch.int16 and got.shape == (B, max_steps + 8)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_dense_dispatch_matches_jax_xla_dispatch(variant):
    """Against the JAX dense dispatch on its XLA DP, wherever that DP did
    not flag its level cap."""
    key, cnt, cov, ns, lead, sa, last_col = seeded_tables(70)
    B, W, K = key.shape
    max_steps = W + 128
    want = np.asarray(jc.dp_backtrack_packed(
        _jax_tables(key, cnt, cov, ns), jnp.asarray(lead), jnp.asarray(sa),
        jnp.asarray(last_col), max_steps, use_pallas=False))
    ok = ~jc.decode_backtrack_words(want, last_col)[5]
    assert ok.sum() >= B // 2
    got = tc.dp_backtrack_packed(
        tc.SlotTables(_t(key), _t(cnt), _t(cov), _t(ns)), _t(lead), _t(sa),
        _t(last_col), max_steps, variant).numpy().view(np.uint16)
    np.testing.assert_array_equal(got[ok], want[ok])


def test_real_chunks_carry_exact_n_slots():
    """The dynamic-K kernel trusts n_slots: the host aggregation's table
    must equal the count of valid keys on real chunks."""
    from nextpolish2_tpu_torch.config import PolishConfig
    from nextpolish2_tpu_torch.io.fastx import read_fastx
    from nextpolish2_tpu_torch.models.oracle import build_alignseqs_native_flat
    from nextpolish2_tpu_torch.pipeline.windows import (aggregate_host,
                                                        build_window_batch)
    from nextpolish2_tpu_torch.utils.seqcodes import ASCII2CODE

    tseq = next(iter(read_fastx("testdata/slice.fa")))[1]
    cfg = PolishConfig(min_ctg_len=1000)
    res = build_alignseqs_native_flat("testdata/slice.bam", 0, tseq, cfg)
    if res is None:
        pytest.skip("native library unavailable")
    wb = build_window_batch(res[0], len(tseq),
                            ASCII2CODE[np.frombuffer(tseq, dtype=np.uint8)],
                            target=cfg.window_len,
                            stream_cache={"flat_all": res[1]})
    for K, W in [(8, 1280), (48, 2560)]:
        ids = np.arange(min(wb.n_windows, 16))
        key, _cnt, _cov, n_slots, _over = aggregate_host(
            wb, K, width=W, n_windows=16, win_idx=ids)
        assert (key >= 0).any()
        np.testing.assert_array_equal(n_slots, (key >= 0).sum(-1))


def test_dynk_with_short_n_slots_drops_slots_and_is_not_repaired():
    key, cnt, cov, ns, lead, sa, _lc = seeded_tables(70)
    short = np.minimum(ns, 1).astype(np.int32)
    sc, bi = tk.consensus_dp_dynk(_t(key), _t(cnt), _t(cov), _t(short),
                                  _t(lead), _t(sa, np.uint8))
    seeded_col2 = np.zeros(key.shape, bool)
    seeded_col2[:, 2] = sa[:, None]
    past = (np.arange(key.shape[2]) >= 1) & ~seeded_col2
    assert (key[past] >= 0).any()
    assert (sc.numpy()[past] == NEG_INF).all() and (bi.numpy()[past] == 0).all()


def test_dp_variant_selection(monkeypatch):
    monkeypatch.delenv("NP2_DP_DYNK", raising=False)
    monkeypatch.delenv("NP2_DP_BASE", raising=False)
    assert te.resolve_dp_variants(None) == te.DpVariants("v2", False)
    assert te.resolve_dp_variants("base") == te.DpVariants("base", False)
    assert te.resolve_dp_variants("dynk") == te.DpVariants("v2", True)
    both = te.DpVariants("base", True)
    assert te.resolve_dp_variants(both) is both
    monkeypatch.setenv("NP2_DP_BASE", "1")
    assert te.resolve_dp_variants(None) == te.DpVariants("base", False)
    monkeypatch.setenv("NP2_DP_DYNK", "1")
    assert te.resolve_dp_variants(None) == te.DpVariants("base", True)
    assert te.resolve_dp_variants("v2") == te.DpVariants("v2", False)
    with pytest.raises(ValueError, match="dp_variant"):
        te.resolve_dp_variants("fast")


def test_dp_variant_errors():
    key, cnt, cov, ns, lead, sa, last_col = below_neg1_tables()
    tables = tc.SlotTables(_t(key), _t(cnt), _t(cov), None)
    with pytest.raises(ValueError, match="n_slots"):
        tc.dp_backtrack_packed(tables, _t(lead), _t(sa), _t(last_col), 32,
                               "dynk")
    with pytest.raises(ValueError, match="dp_variant"):
        tc.dp_backtrack_packed(tables, _t(lead), _t(sa), _t(last_col), 32,
                               "v3")
    blob, P, Pd, Pe, _ = slice_chunk(8, 16, 1280)
    with pytest.raises(ValueError, match="dynk"):
        tc.dp_backtrack_csr_blob(blob, B=16, W=1280, K=8, P=P, Pd=Pd, Pe=Pe,
                                 max_steps=1408, dp_variant="dynk")


def test_blob_program_under_base_gives_the_v2_bytes():
    """The CSR-blob chunk program with dp_variant="base" on a real chunk:
    the base twin runs, and the packed output is the default's."""
    K, B, W = 8, 16, 1280
    blob, P, Pd, Pe, _ = slice_chunk(K, B, W)
    kw = dict(B=B, W=W, K=K, P=P, Pd=Pd, Pe=Pe, max_steps=W + 128,
              device="cpu")
    before = tk.LAUNCHES["consensus_dp_base_plain"]
    got = tc.dp_backtrack_csr_blob(blob, dp_variant="base", **kw)
    assert tk.LAUNCHES["consensus_dp_base_plain"] == before + 1
    np.testing.assert_array_equal(got.numpy(),
                                  tc.dp_backtrack_csr_blob(blob, **kw).numpy())


@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_runs_the_named_formulation(tmp_path, variant):
    """polish_contig_cuda under each variant: the JAX oracle's consensus,
    through that variant's twin and no other; dynk takes the dense route
    (no CSR blob is parsed)."""
    from nextpolish2_tpu.models.oracle import polish_contig
    from test_torch_engine import _carry, _port_records, _scenario_errors
    from test_tpu_engine import cfg_small

    t, recs, tables = _scenario_errors(np.random.default_rng(31), tmp_path)
    cfg = cfg_small()
    want = polish_contig(t, recs, tables, cfg)
    tcfg, ttables = _carry(cfg, tables)
    before = dict(tk.LAUNCHES)
    got = te.polish_contig_cuda(t, _port_records(recs), ttables, tcfg,
                                device="cpu", fallback=False,
                                dp_variant=variant)
    assert np.array_equal(want.pos, got.pos)
    assert np.array_equal(want.base, got.base)
    ran = {k for k in tk.LAUNCHES if tk.LAUNCHES[k] > before.get(k, 0)}
    twin = {"v2": "consensus_dp_plain", "base": "consensus_dp_base_plain",
            "dynk": "consensus_dp_dynk_plain"}[variant]
    assert ran == {twin, "backtrack_plain"}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["base", "dynk"])
def test_kernel_matches_plain_twin_on_card(variant):
    """On a CUDA card: the kernel against its plain twin, every output bit,
    on a real K=8 chunk, a K=48 chunk, the below-NEG_INF-1 table and every
    edge-case table (dynamic-K: under the exact n_slots and under a mangled
    one, which the kernel takes as given)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    chunks = [below_neg1_tables()[:6]]
    for c in dp_cases.edge_cases():
        chunks.append((c.key, c.cnt, c.cov, dp_cases.exact_n_slots(c.key),
                       c.lead, c.seed))
        if variant == "dynk":
            chunks.append((c.key, c.cnt, c.cov, dp_cases.mangled_n_slots(c),
                           c.lead, c.seed))
    for K, W in [(8, 1280), (48, 2560)]:
        blob, P, Pd, Pe, _ = slice_chunk(K, 16, W)
        key, cnt, cov, lead, seed, _lc = _tables_from_blob(blob, 16, W, K, P,
                                                           Pd, Pe)
        chunks.append((key.numpy(), cnt.numpy(), cov.numpy(),
                       (key.numpy() >= 0).sum(2).astype(np.int32),
                       lead.numpy(), seed.numpy()))
    for key, cnt, cov, ns, lead, sa in chunks:
        a = [_t(key).to(dev), _t(cnt).to(dev), _t(cov).to(dev)]
        tail = [_t(lead, np.int32).to(dev), _t(sa, np.uint8).to(dev)]
        if variant == "dynk":
            a.append(_t(ns).to(dev))
            kern, twin = tk.consensus_dp_dynk, tk.consensus_dp_dynk_plain
        else:
            kern, twin = tk.consensus_dp_base, tk.consensus_dp_base_plain
        before = tk.LAUNCHES[f"consensus_dp_{variant}"]
        sk, bk = kern(*a, *tail)
        sp, bp = twin(*a, *tail)
        torch.cuda.synchronize()
        assert tk.LAUNCHES[f"consensus_dp_{variant}"] == before + 1
        assert torch.equal(sk, sp) and torch.equal(bk, bp)
