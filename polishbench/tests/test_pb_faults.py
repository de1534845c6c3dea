"""A run with its timed path broken underneath comes out not correct:
once for each fault a cell can have. The look for a card is skipped: the
run goes on the CPU with the kernels' plain twins, at a tiny size.

Faults: a pass that returns its state unchanged (the assembly, not
polished); half the batch left out (every other contig missing); an
answer altered where it is produced (one polished base changed). One card
a cell, so no exchange between cards can be left out."""

import io

import pytest

from nextpolish2_tpu_torch.pipeline import orchestrator


def _unchanged(real):
    def polish(fa, bam, yaks, cfg, out=None, stats=None, **kw):
        cfg.min_ctg_len = 1 << 40  # every contig passes through
        return real(fa, bam, yaks, cfg, out=out, stats=stats, **kw)
    return polish


def _half_left_out(real):
    def polish(fa, bam, yaks, cfg, out=None, stats=None, **kw):
        buf = io.BytesIO()
        real(fa, bam, yaks, cfg, out=buf, stats=stats, **kw)
        lines = buf.getvalue().split(b"\n")
        recs = [lines[i:i + 2] for i in range(0, len(lines) - 1, 2)]
        for head, seq in recs[::2]:
            out.write(head + b"\n" + seq + b"\n")
    return polish


def _altered(real):
    def polish(fa, bam, yaks, cfg, out=None, stats=None, **kw):
        buf = io.BytesIO()
        real(fa, bam, yaks, cfg, out=buf, stats=stats, **kw)
        data = bytearray(buf.getvalue())
        i = data.index(b"\n") + 100  # a base of the first contig
        data[i] = ord("A") if data[i] != ord("A") else ord("C")
        out.write(bytes(data))
    return polish


@pytest.mark.parametrize("fault,check", [
    (None, None),
    (_unchanged, "bases_differing"),
    (_half_left_out, "contigs_missing"),
    (_altered, "bases_differing"),
])
def test_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, fault,
                                          check):
    from polishbench import run

    if fault is not None:
        monkeypatch.setattr(orchestrator, "polish", fault(orchestrator.polish))
    res = run.run_cell(tiny_cell, 2**31 + 21, 0.2, False, device="cpu")
    if fault is None:
        assert res["correct"] is True
        assert all(c["value"] == 0 for c in res["checks"].values())
        return
    assert res["correct"] is False
    assert res["failed"] == res["attempted"] >= 1
    assert res["checks"][check]["value"] > res["checks"][check]["limit"]
