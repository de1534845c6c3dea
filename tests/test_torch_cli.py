"""The port's CLI on the slice writes the same file as the JAX package's
oracle engine."""

import os
import subprocess
import sys

from nextpolish2_tpu.config import PolishConfig
from nextpolish2_tpu.pipeline.orchestrator import polish

BASE = os.path.abspath("testdata")
REPO = os.path.dirname(BASE)


def test_cli_matches_jax_oracle(tmp_path):
    yaks = [f"{BASE}/k21.yak", f"{BASE}/k31.yak"]
    ref = tmp_path / "oracle.fa"
    with open(ref, "wb") as f:
        polish(f"{BASE}/slice.fa", f"{BASE}/slice.bam", yaks,
               PolishConfig(min_ctg_len=1000), engine="oracle", out=f)
    out = tmp_path / "port.fa"
    # one OpenMP thread, as in the other port tests: parallel test workers'
    # thread pools otherwise spin against each other
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "nextpolish2_tpu_torch.cli",
         f"{BASE}/slice.bam", f"{BASE}/slice.fa", *yaks, "--device", "cpu",
         "-L", "1000", "-o", str(out), "--timing"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr
    assert "consensus_dp_plain" in res.stderr
    assert out.read_bytes() == ref.read_bytes()


def _batch_line(cli_main, orchestrator, monkeypatch, capsys, tmp_path, tag,
                extra=()):
    """The 'Device batches' line that cli_main prints to stderr after a
    polish() that reports a dense fallback (polish stubbed: it only fills
    the batcher's stats)."""

    def fake_polish(*args, stats, **kwargs):
        stats.batches, stats.batch_fill, stats.csr_batches = 7, 0.96274, 5
        stats.dense_reasons = {"no_csr_closure": 2}

    monkeypatch.setattr(orchestrator, "polish", fake_polish)
    argv = [f"{BASE}/slice.bam", f"{BASE}/slice.fa", f"{BASE}/k21.yak",
            "-o", str(tmp_path / f"{tag}.fa"), *extra]
    assert cli_main(argv) == 0
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("Device batches:")]
    assert len(lines) == 1
    return lines[0]


def test_cli_batch_line_matches_jax(monkeypatch, capsys, tmp_path):
    """The port's stderr line on the cross-contig batcher is the JAX CLI's,
    character for character: lane fill to one decimal and the dense
    fallbacks' reasons."""
    from nextpolish2_tpu import cli as jax_cli
    from nextpolish2_tpu.pipeline import orchestrator as jax_orch
    from nextpolish2_tpu_torch import cli as port_cli
    from nextpolish2_tpu_torch.pipeline import orchestrator as port_orch

    got = _batch_line(port_cli.main, port_orch, monkeypatch, capsys,
                      tmp_path, "port", ("--device", "cpu"))
    want = _batch_line(jax_cli.main, jax_orch, monkeypatch, capsys, tmp_path,
                       "jax")
    assert got == want
    assert got == ("Device batches: 7 (cross-contig lane fill 96.3%, 5 "
                   "CSR-direct, dense fallbacks: {'no_csr_closure': 2})")


def test_cli_oracle_engine_polishes_from_the_bam(tmp_path):
    """--engine oracle reads the BAM's records even where the native library
    loaded (the JAX orchestrator hands its oracle engine no read then, and
    the assembly comes back unchanged): on a fixture whose assembly carries
    errors, the output is the JAX oracle's polish_contig of the same
    records, equals the cuda engine's (on the CPU) and differs from the
    assembly."""
    from nextpolish2_tpu.io.bam import BamReader
    from nextpolish2_tpu.io.fastx import read_fastx
    from nextpolish2_tpu.io.yak import load_yak
    from nextpolish2_tpu.models.oracle import consensus_to_bytes, polish_contig
    from nextpolish2_tpu_torch import cli
    from nextpolish2_tpu_torch.tools import make_fixture

    prefix = str(tmp_path / "fx")
    assert make_fixture.main([prefix, "--contigs", "1", "--size", "20000",
                              "--cov", "8", "--seed", "3"]) == 0
    files = [prefix + ".bam", prefix + ".fa", prefix + ".k21.yak"]
    outs = {}
    for engine in ("oracle", "cuda"):
        outs[engine] = tmp_path / f"{engine}.fa"
        assert cli.main([*files, "-L", "1000", "--device", "cpu",
                         "--engine", engine, "-o", str(outs[engine])]) == 0
    name, asm = next(iter(read_fastx(prefix + ".fa")))
    recs = next(BamReader(prefix + ".bam").by_contig())[1]
    spec = consensus_to_bytes(polish_contig(
        asm, recs, [load_yak(files[2])], PolishConfig(min_ctg_len=1000)))
    got = list(read_fastx(str(outs["oracle"])))
    assert [n.split()[0] for n, _ in got] == [name]
    assert got[0][1] == spec != asm
    assert outs["oracle"].read_bytes() == outs["cuda"].read_bytes()
