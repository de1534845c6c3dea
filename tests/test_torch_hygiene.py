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


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
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
