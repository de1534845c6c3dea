"""The CUDA sources of the two k-mer kernels (csrc/kmer_lookup.cu,
csrc/kmer_score.cu), run on the CPU: compiled by the host C++ compiler
against the stand-in runtime of nextpolish2_tpu_torch/csrc/emu/ and executed
one warp at a time with the 32 lanes in lockstep
(nextpolish2_tpu_torch/utils/warp_emu.py), against their plain twins, every
output bit (tolerance 0: integer programs), on the seeded cases of
warp_emu.KMER_CASES:

  - kmer_lookup on a table at load 0.78 (chains of the longest length the
    build used), with present and absent keys, hashes with bits 31 and 63
    set and the empty sentinel itself;
  - kmer_min_scores with k = 21 and 31 on allele batches with alleles that
    cross a lane's run, a warp's strip and several strips, alleles with no
    valid k-mer (shorter than k, Ns only, across strips too) or with an
    internal N, alleles that own no position, and starts padded with L;
    once as score_inputs pads the batch, once unpadded, of a length that is
    no multiple of 16, and once past 2^19 bases, where the kernel takes its
    longer runs;
  - kmer_lookup_sharded on the first case's keys split into 2 and into 4
    shards: every shard's launch against its twin (queries of every shard
    in each warp, those of other shards unprobed), and the shards' sum
    against the unsharded lookup.

Each runs on an emulated card of 3 SMs and, but for the longest, of 1 SM,
so the persistent grid strides over its work. The twins are held to the JAX package in
test_torch_kmer.py, and the kernels to the twins on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from nextpolish2_tpu_torch.ops import kmer_score as ks
from nextpolish2_tpu_torch.ops import kmer_table as kt
from nextpolish2_tpu_torch.utils import warp_emu

# one OpenMP thread per test worker: see test_torch_consensus.py
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if warp_emu.compiler() is None:
        pytest.skip("no host C++ compiler")
    return warp_emu.build(str(tmp_path_factory.mktemp("warp_emu")))


# every case on 1 SM and on 3; the batch past 2^19 bases (a few seconds a
# run) on 3 only
RUNS = [(name, sms) for name in warp_emu.KMER_CASES for sms in (1, 3)
        if not (name.endswith("_long_runs") and sms == 1)]


@pytest.mark.parametrize("name,sms", RUNS)
def test_emulated_kmer_kernels_match_twins(emulator, name, sms):
    warp_emu.check_kmer_case(emulator, name, sms)


def test_kmer_cases_reach_their_edges():
    """The cases hold what the module docstring claims of them."""
    tab, q = warp_emu.kmer_case_inputs("lookup_long_chains")
    planes = (torch.from_numpy(tab.key_hi.copy()),
              torch.from_numpy(tab.key_lo.copy()),
              torch.from_numpy(tab.counts.copy()))
    _, probes = kt.probe_plain(*planes, *q, tab.n_probes)
    assert tab.n_probes >= 16 and int(probes.max()) == tab.n_probes
    assert ((q[0] == -1) & (q[1] == -2)).sum() == 1      # the sentinel
    assert ((q[0] < 0) & (q[1] < 0) & (q[0] != -1)).sum() > 100
    tables, _ = warp_emu.kmer_case_inputs("lookup_sharded")
    assert [t.n_shards for t, _ in tables] == list(warp_emu.SHARD_COUNTS)
    for t, qh in tables:
        shard = t.query_host_arrays(qh)[3]
        # every warp of 32 queries holds queries of more than one shard
        assert all(len(set(shard[i:i + 32])) > 1
                   for i in range(0, len(shard) - 31, 32))
        assert (t.n_probes >= 5 and
                len(warp_emu._table_keys(t)[0]) == len(tab.counts.nonzero()[0]))
    for name in [n for n in warp_emu.KMER_CASES if n.startswith("score")]:
        tab, (codes, starts, k) = warp_emu.kmer_case_inputs(name)
        L, st = len(codes), starts.numpy().astype(np.int64)
        ends = np.append(st[1:], L)
        real = st < L
        valid, _ = ks.end_position_hashes(codes, k)
        sid = np.searchsorted(st[1:], np.arange(L), side="right")
        n_valid = np.bincount(sid[valid.numpy()], minlength=len(st))
        strips = ks.STRIP
        crosses = real & (ends > st) & (st // strips != (ends - 1) // strips)
        assert crosses.sum() > 20
        assert (crosses & (n_valid == 0)).sum() >= 3
        assert (real & (ends > st) & (n_valid == 0)).sum() > 20
        assert (~real).sum() >= 5 and (st[~real] == L).all()
        scores = ks.kmer_min_scores_plain(*(torch.from_numpy(p.copy()) for p
                                            in (tab.key_hi, tab.key_lo,
                                                tab.counts)),
                                          codes, starts, k, 0, tab.n_probes)
        assert (scores[torch.from_numpy(real)] > 0).sum() > 20
        if name.endswith("_unpadded"):
            assert L % 16 and (real & (ends == st)).sum() >= 3
        else:   # alleles across several strips
            assert (ends - st).max() > 2 * strips
        assert (L >= 1 << 19) == name.endswith("_long_runs")


def test_emulator_rejects_bad_kmer_calls(emulator):
    """Entries that are no [2^n, 4] table and queries of unequal lengths
    are errors that leave no output to compare."""
    tab, q = warp_emu.kmer_case_inputs("lookup_long_chains")
    qh, ql, qs = (a.numpy() for a in q)
    with pytest.raises(RuntimeError, match="exited 4"):
        warp_emu.run_lookup(emulator, tab.entries[:-1], qh, ql, qs, 0, 8)
    with pytest.raises(RuntimeError, match="exited 4"):
        warp_emu.run_lookup(emulator, tab.entries, qh, ql[:-1], qs, 0, 8)
