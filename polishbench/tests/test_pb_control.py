"""The control: the plain reference with the k-mer tables giving no
support (a guarantee of both configurations: LQ alleles are chosen with
the short-read tables) comes out not correct, here at a size a test run
holds; on the chip it runs at each cell's own size (control.py)."""

from polishbench import control


def test_control_is_not_correct(tiny_cell):
    seeds = [2**31 + 31, 5]
    res = control.control_checks(tiny_cell, seeds, "no_kmer_scoring",
                                 workers=2)
    for s in seeds:
        correct, checks, ref_truth = res[s]
        assert correct is False
        assert dict((k, v) for k, v, _ in checks)["bases_differing"] > 0
        assert ref_truth == 0
