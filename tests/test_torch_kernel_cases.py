"""The port's DP and backtrack twins vs the JAX package on the edge-case
tables of nextpolish2_tpu_torch/utils/dp_cases.py, bit for bit (tolerance 0:
integer programs), on the CPU.

The same tables go through the smoke run on the card, kernel against twin
(chip_smoke.py), and through the cuda-marked tests of test_torch_consensus.py
and test_torch_dp_variants.py; here they go through
  - the Pallas kernel _dp_kernel_v2 in interpret mode with span bounding vs
    consensus_dp_v2 (the plain twin on CPU tensors): scores everywhere, besti
    where key >= 0;
  - the JAX walk (_backtrack_scan_packed through backtrack, packed by
    pack_backtrack_out) on the Pallas outputs vs backtrack_packed on the
    twin's, the whole array, at every step limit of BACKTRACK_MAX_STEPS.
So the twins can be trusted on the inputs the kernels' lane mapping finds
hard: odd K, B and W, spans of 0 and W, full columns, deep insertion chains,
invalid slots that match, chains below NEG_INF - 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextpolish2_tpu.ops import consensus as jc
from nextpolish2_tpu.ops.consensus_pallas import consensus_dp_pallas
from nextpolish2_tpu_torch.ops import consensus_cuda as tk
from nextpolish2_tpu_torch.utils import dp_cases

# one OpenMP thread per test worker: see test_torch_consensus.py
torch.set_num_threads(1)

NEG_INF = -(1 << 30)


def _t(a, dtype=None):
    a = np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype))
    return torch.from_numpy(a)


case_tensors = dp_cases.case_tensors
step_limits = dp_cases.step_limits


def test_cases_reach_what_they_claim():
    """The generator's tables do hold the hard inputs (else the comparisons
    below prove less than they say)."""
    cases = {c.name: c for c in dp_cases.edge_cases()}
    assert {c.key.shape[2] for c in cases.values()} >= {1, 5, 8, 16, 33, 48, 64}
    assert {c.key.shape[0] for c in cases.values()} >= {1, 3, 5, 130}
    for c in cases.values():
        B, W, K = c.key.shape
        assert W <= 256
        past = np.arange(W)[None, :] >= c.span[:, None]
        assert (c.key[past] == -1).all()
    spans = np.concatenate([c.span for c in cases.values()])
    assert (spans == 0).any() and (spans % 32 != 0).any()
    for name in ("k8_full_columns", "k48_full_columns", "k64_full_columns",
                 "k33_two_slots_a_lane"):
        c = cases[name]
        assert ((c.key >= 0).sum(-1) == c.key.shape[2]).any(), name
    level = np.vectorize(dp_cases.key_level)
    sc, bi = (x.numpy() for x in tk.consensus_dp_v2(
        *case_tensors(cases["k8_deep_insertions"])[:6]))
    deep = cases["k8_deep_insertions"].key
    assert (level(deep)[(sc > NEG_INF) & (deep >= 0)] >= 4).any()
    c = cases["k8_invalid_slots"]
    sc, bi = (x.numpy() for x in tk.consensus_dp_v2(*case_tensors(c)[:6]))
    assert ((bi != 0) & (c.key < 0)).any()
    c = cases["k8_below_neg_inf"]
    sc, bi = (x.numpy() for x in tk.consensus_dp_v2(*case_tensors(c)[:6]))
    assert (sc < NEG_INF - 1).any()
    assert (cases["k8_130_windows"].last_col >= 40).any()
    # an invalid same-column slot whose target sits behind it: the base
    # formulation's pool holds the target (at NEG_INF) and reports its slot
    c = cases["k8_later_targets"]
    sc, bi = (x.numpy() for x in tk.consensus_dp_base(*case_tensors(c)[:5]))
    slot = np.arange(c.key.shape[2])[None, None, :]
    assert ((bi >= slot) & (bi > 0) & (c.key < 0)).any()
    valid = c.key >= 0
    assert (dp_cases.exact_n_slots(c.key) > valid.sum(-1)).any()


@pytest.mark.parametrize("name", dp_cases.CASE_NAMES)
def test_twins_match_jax_on_edge_case(name):
    case = dp_cases.edge_case(name)
    B, W, K = case.key.shape
    key, cnt, cov, lead, seed8, span, _lc = case_tensors(case)

    sc_j, bi_j, _ = consensus_dp_pallas(
        jnp.asarray(case.key), jnp.asarray(case.cnt), jnp.asarray(case.cov),
        jnp.asarray(case.lead), jnp.asarray(case.seed), interpret=True,
        variant="v2", span=jnp.asarray(case.span))
    sc_j, bi_j = np.asarray(sc_j), np.asarray(bi_j).astype(np.int8)
    before = tk.LAUNCHES["consensus_dp_plain"]
    sc_t, bi_t = tk.consensus_dp_v2(key, cnt, cov, lead, seed8, span)
    assert tk.LAUNCHES["consensus_dp_plain"] == before + 1
    np.testing.assert_array_equal(sc_t.numpy(), sc_j)
    valid = case.key >= 0
    np.testing.assert_array_equal(np.where(valid, bi_t.numpy(), 0),
                                  np.where(valid, bi_j, 0))

    # the walk: JAX on the Pallas outputs, the port on its own. A last_col
    # past the chunk is clamped by both, but JAX derives its start state
    # from the unclamped value: such a window is compared in the port only
    # (kernel against twin, on the card)
    inside = case.last_col < W
    lc = np.clip(case.last_col, 0, W - 1).astype(np.int32)
    tables = jc.SlotTables(jnp.asarray(case.key), jnp.asarray(case.cnt),
                           jnp.asarray(case.cov),
                           jnp.asarray((case.key >= 0).sum(-1).astype(np.int32)),
                           jnp.zeros(B, bool))
    for max_steps in step_limits(W):
        out = jc.backtrack(tables, jnp.asarray(sc_j), jnp.asarray(bi_j),
                           jnp.asarray(lc), jnp.asarray(case.seed), max_steps)
        want = np.asarray(jc.pack_backtrack_out(out, jnp.zeros(B, bool)))
        got = tk.backtrack_packed(key, cnt, cov, sc_t, bi_t, _t(lc), seed8,
                                  max_steps)
        assert got.dtype == torch.int16 and got.shape == (B, max_steps + 8)
        np.testing.assert_array_equal(got.numpy().view(np.uint16)[inside],
                                      want[inside])
