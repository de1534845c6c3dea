"""The CUDA sources of the three DP kernels, run on the CPU: compiled by the
host C++ compiler against the stand-in runtime of
nextpolish2_tpu_torch/csrc/emu/ and executed one warp at a time with the 32
lanes in lockstep (nextpolish2_tpu_torch/utils/warp_emu.py), against their
plain twins on every edge-case table of dp_cases, every output bit
(tolerance 0: integer programs).

The twins are held to the JAX package in test_torch_kernel_cases.py and
test_torch_reduce_cases.py, and the kernels to the twins on the card by
chip_smoke.py; this file holds the kernels' own logic (lane mapping, trip
counts under warp-wide exchanges, tile edges, unaligned rows) to the twins
where there is no card, and fails when the lanes of a warp diverge at a
warp-wide intrinsic. What only the card shows (registers, cp.async, times)
is not its business.
"""

import pytest
import torch

from nextpolish2_tpu_torch.utils import dp_cases, warp_emu

# one OpenMP thread per test worker: see test_torch_consensus.py
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if warp_emu.compiler() is None:
        pytest.skip("no host C++ compiler")
    return warp_emu.build(str(tmp_path_factory.mktemp("warp_emu")))


@pytest.mark.parametrize("name", dp_cases.CASE_NAMES)
def test_emulated_kernels_match_twins_on_edge_case(emulator, name):
    warp_emu.check_case(emulator, dp_cases.edge_case(name))


def test_emulator_rejects_bad_calls(emulator):
    """A kernel name the emulator does not know is an error, and so is an
    input that does not fit its shape: neither leaves outputs to compare."""
    case = dp_cases.edge_case("k1_odd_width")
    with pytest.raises(RuntimeError, match="exited"):
        warp_emu.run(emulator, "v3", case.key, case.cnt, case.cov, case.lead,
                     case.seed)
    with pytest.raises(RuntimeError, match="do not fit"):
        warp_emu.run(emulator, "base", case.key, case.cnt, case.cov[:, :-1],
                     case.lead, case.seed)
