"""The port's base and dynamic-K DP twins vs the JAX package's own kernels on
the edge-case tables of nextpolish2_tpu_torch/utils/dp_cases.py, bit for bit
(tolerance 0: integer programs), on the CPU.

For every table, consensus_dp_base / consensus_dp_dynk (the plain twins on
CPU tensors) against the Pallas kernels _dp_kernel / _dp_kernel_dynk in
interpret mode: scores everywhere, besti where key >= 0, and for the base
formulation besti on every slot, since it is copied slot for slot. Dynamic-K
runs under dp_cases.exact_n_slots, the bound with which the port's per-window
slot loop and Pallas's per-tile one compute the same slots. The same tables go
through the kernels against these twins on the card (chip_smoke.py), so the
twins can be trusted where the kernels' lane mapping is held to them: the
NEG_INF - 1 floor, same-column targets behind their query, odd K, B and W,
full columns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextpolish2_tpu.ops.consensus_pallas import consensus_dp_pallas
from nextpolish2_tpu_torch.ops import consensus_cuda as tk
from nextpolish2_tpu_torch.utils import dp_cases

# one OpenMP thread per test worker: see test_torch_consensus.py
torch.set_num_threads(1)


@pytest.mark.parametrize("variant", ["base", "dynk"])
@pytest.mark.parametrize("name", dp_cases.CASE_NAMES)
def test_reduce_twin_matches_its_pallas_kernel_on_edge_case(name, variant):
    case = dp_cases.edge_case(name)
    key, cnt, cov, lead, seed8, _span, _lc = dp_cases.case_tensors(case)
    args = (jnp.asarray(case.key), jnp.asarray(case.cnt),
            jnp.asarray(case.cov), jnp.asarray(case.lead),
            jnp.asarray(case.seed))
    twin = f"consensus_dp_{variant}_plain"
    before = tk.LAUNCHES[twin]
    if variant == "dynk":
        ns = dp_cases.exact_n_slots(case.key)
        sc_j, bi_j, _ = consensus_dp_pallas(*args, interpret=True,
                                            n_slots_bw=jnp.asarray(ns),
                                            dynamic_k=True)
        sc_t, bi_t = tk.consensus_dp_dynk(key, cnt, cov, torch.from_numpy(ns),
                                          lead, seed8)
    else:
        sc_j, bi_j, _ = consensus_dp_pallas(*args, interpret=True,
                                            variant="base")
        sc_t, bi_t = tk.consensus_dp_base(key, cnt, cov, lead, seed8)
    assert tk.LAUNCHES[twin] == before + 1
    sc_j, bi_j = np.asarray(sc_j), np.asarray(bi_j).astype(np.int8)
    assert sc_t.dtype == torch.int32 and bi_t.dtype == torch.int8
    np.testing.assert_array_equal(sc_t.numpy(), sc_j)
    compared = case.key >= 0 if variant == "dynk" else np.ones_like(case.key,
                                                                    bool)
    np.testing.assert_array_equal(np.where(compared, bi_t.numpy(), 0),
                                  np.where(compared, bi_j, 0))
