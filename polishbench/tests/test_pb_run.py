"""run.py without a card, in a bare checkout, and its look for modules
that a run may not load."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from polishbench import spec

CMD = ["--workload", "bacterial_haploid_t1.genome", "--seed", str(2**31 + 3),
       "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "polishbench/run.py", *CMD],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_exits_nonzero_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    p = _run(spec.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in p.stderr


def test_bare_checkout_exits_nonzero_with_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and polishbench/: the
    polisher is absent, so no run and no result."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "polishbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "polishbench/run.py", *CMD],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_forbidden_modules_compares_top_level_names(monkeypatch):
    from polishbench import run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nextpolish2_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nextpolish2_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax", "nextpolish2_tpu"]


def test_result_line_shape(tiny_cell):
    """A run on the CPU (the tests' rehearsal) gives every key of the
    result line, the checks last."""
    from polishbench import run

    res = run.run_cell(tiny_cell, 2**31 + 7, 0.5, False, device="cpu")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"polish_rate", "peak_rss", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    json.dumps(res)


def test_traced_result_line(tiny_cell):
    """--trace 1 on the CPU: the per-layer metrics that read the program's
    stages and counters, the trace's keys (no device operations here),
    and the probes removed afterwards."""
    from nextpolish2_tpu_torch.pipeline.engine import ChunkRunner
    from nextpolish2_tpu_torch.utils import timing

    from polishbench import run

    put = ChunkRunner.put
    res = run.run_cell(tiny_cell, 2**31 + 9, 0.5, True, device="cpu")
    assert res["correct"] is True
    names = set(res["metrics"])
    assert {"ingest.thread_s_per_Mbp", "windows.thread_s_per_Mbp",
            "engine.device_wait_s_per_Mbp", "lq.thread_s_per_Mbp",
            "kmer.thread_s_per_Mbp"} <= names
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert ChunkRunner.put is put and not timing._ENABLED
