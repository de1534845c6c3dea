"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "nextpolish2_tpu_torch")


def _port_files():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_jax_package():
    files = list(_port_files())
    assert len(files) > 20
    bad = [(os.path.relpath(p, REPO), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "nextpolish2_tpu")]
    assert not bad, bad


def test_small_cpu_dp_loads_no_jax():
    code = """
import sys
import torch
from nextpolish2_tpu_torch.ops.consensus_cuda import consensus_dp_v2
key = torch.full((2, 8, 4), -1, dtype=torch.int32)
key[:, :, 0] = 0
z = torch.zeros(2, dtype=torch.int32)
sc, bi = consensus_dp_v2(key, torch.ones_like(key), torch.ones((2, 8), dtype=torch.int32),
                         z, torch.zeros(2, dtype=torch.uint8), z + 8)
assert sc.shape == (2, 8, 4) and bi.dtype == torch.int8
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "nextpolish2_tpu")], sorted(sys.modules)
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path, capsys):
    from nextpolish2_tpu_torch import cli
    from nextpolish2_tpu_torch.config import PolishConfig
    from nextpolish2_tpu_torch.pipeline.engine import polish_contig_cuda
    from nextpolish2_tpu_torch.pipeline.orchestrator import polish

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PolishConfig(min_ctg_len=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        polish_contig_cuda(b"ACGT" * 10, [], [], cfg)
    base = os.path.join(REPO, "testdata")
    with pytest.raises(RuntimeError, match="CUDA"):
        polish(f"{base}/slice.fa", f"{base}/slice.bam", [f"{base}/k21.yak"],
               cfg)
    out = tmp_path / "o.fa"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([f"{base}/slice.bam", f"{base}/slice.fa", f"{base}/k21.yak",
                  "-o", str(out)])
    assert not out.exists()
    # threads > 1: for want of CUDA, not for want of a batcher
    with pytest.raises(RuntimeError, match="CUDA"):
        polish(f"{base}/m20.fa", f"{base}/m20.bam", [f"{base}/m20.k21.yak"],
               PolishConfig(min_ctg_len=0, threads=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([f"{base}/m20.bam", f"{base}/m20.fa", f"{base}/m20.k21.yak",
                  "-t", "8", "-o", str(out)])
    assert not out.exists()
    from nextpolish2_tpu_torch.pipeline.batcher import (DeviceBatcher,
                                                        get_active_batcher)

    assert get_active_batcher() is None
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBatcher("cuda")
    # the QV tool: on the card by default, never on the host unasked
    from nextpolish2_tpu_torch.tools import qv

    capsys.readouterr()
    with pytest.raises(RuntimeError, match="CUDA"):
        qv.main([f"{base}/slice.fa", f"{base}/k21.yak"])
    assert capsys.readouterr().out == ""


def test_mesh_modules_load_no_jax_and_raise_without_cuda(monkeypatch,
                                                          tmp_path):
    """The mesh path's modules import no JAX; its entry points go to the
    card unless given CPU devices, and raise where there is none."""
    mods = ("parallel.mesh", "parallel.sharded_kmer", "parallel.distributed",
            "bridge", "utils.timing", "cli")
    for m in mods:
        assert os.path.exists(os.path.join(PORT, *m.split(".")) + ".py")
    code = ("import sys\n"
            + "".join(f"import nextpolish2_tpu_torch.{m}\n" for m in mods)
            + "assert not [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'nextpolish2_tpu')]\nprint('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"

    import numpy as np

    from nextpolish2_tpu_torch import cli
    from nextpolish2_tpu_torch.io.yak import load_yak
    from nextpolish2_tpu_torch.parallel import mesh as tm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.make_mesh(1, 1)
    assert tm.auto_mesh(yak_bytes=1 << 40) is None
    base = os.path.join(REPO, "testdata")
    out = tmp_path / "o.fa"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([f"{base}/slice.bam", f"{base}/slice.fa",
                  f"{base}/k21.yak", "--mesh", "1x2", "-o", str(out)])
    assert tm.get_active_mesh() is None and not out.exists()
    # a mesh of CUDA devices raises at its first placement
    table = load_yak(f"{base}/k21.yak")
    tm.set_active_mesh(tm.make_mesh(1, 2, devices=["cuda:0", "cuda:0"]))
    try:
        with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            table.get(table.full_hashes()[:300])
    finally:
        tm.set_active_mesh(None)
    assert np.array_equal(table.get(table.full_hashes()[:300]),
                          table.counts[:300])
