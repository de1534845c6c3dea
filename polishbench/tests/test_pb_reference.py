"""The reference's whole-contig consensus DP, computed by chains, against
the entry-by-entry form of the upstream loop it stands for."""

import os
import sys

import pytest

from polishbench.spec import BENCH_DIR

sys.path.insert(0, os.path.join(BENCH_DIR, "gen"))
import fixture  # noqa: E402
from conftest import READ_ERRORS  # noqa: E402


@pytest.mark.parametrize("seed,scale", [(2**31 + 1, 1.0), (17, 3.0),
                                        (2**32 + 5, 6.0)])
def test_consensus_dp_equals_the_scalar_loop(tmp_path, seed, scale):
    from polishbench.reference import msa
    from polishbench.reference.bamio import BamReader
    from polishbench.reference.config import PolishConfig
    from polishbench.reference.fastx import read_fastx
    from polishbench.reference.polish import build_alignseqs

    errors = dict(READ_ERRORS, sub=READ_ERRORS["sub"] * scale,
                  ins=READ_ERRORS["ins"] * scale,
                  **{"del": READ_ERRORS["del"] * scale})
    traffic = {"contigs": [12000], "passthrough": [], "err_bp": 800,
               "het_bp": 700, "repeats": 1, "repeat_len": 1500, "cov": 20,
               "read_len": 3000, "read_errors": errors, "kmer_cov": 30}
    d = str(tmp_path / "in")
    fixture.generate(traffic, [21], seed, d)
    (name, tseq), = read_fastx(os.path.join(d, "asm.fa"))
    reader = BamReader(os.path.join(d, "reads.bam"))
    (_, records), = reader.by_contig()
    reader.close()
    aligns = build_alignseqs(tseq, records, PolishConfig(min_ctg_len=1000))
    msas = msa.build_msas(aligns, len(tseq))
    got = msa.consensus_dp(msas)
    want = msa.consensus_dp_scalar(msas)
    assert got[2] == want[2]
    assert got[1] == want[1]
    assert got[0] == want[0]
    # the inputs reach the chains' rare cases: unreachable entries
    assert min(want[0]) == msa.NEG_INF
