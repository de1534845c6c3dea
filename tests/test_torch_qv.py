"""The port's QV (eval/qv.py, tools/qv.py) vs the JAX package, on the CPU.
Tolerance: exact, all four QvResult fields and the tools' stdout.

The port's table takes each contig's batch on the host route (the default)
and on the device route with device="cpu" (NP2_KMER_DEVICE_MIN=1, so every
batch goes to the device table and the kmer_lookup kernel's plain twin).
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from nextpolish2_tpu.eval.qv import estimate_qv as jax_estimate_qv
from nextpolish2_tpu.io.fastx import read_fastx
from nextpolish2_tpu.io.yak import load_yak as jax_load_yak
from nextpolish2_tpu_torch.eval.qv import estimate_qv
from nextpolish2_tpu_torch.io.yak import load_yak
from nextpolish2_tpu_torch.ops import consensus_cuda as cc
from nextpolish2_tpu_torch.tools import qv as qv_tool

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "testdata")
FILES = [("slice.fa", "k21.yak"), ("slice.fa", "k31.yak"),
         ("slice.golden.fa", "k21.yak"), ("slice.golden.fa", "k31.yak"),
         ("m20.fa", "m20.k21.yak")]


def _jax_qv(fa, yak, min_count=5):
    seqs = [s for _, s in read_fastx(os.path.join(DATA, fa))]
    return jax_estimate_qv(seqs, jax_load_yak(os.path.join(DATA, yak)),
                           min_count)


@pytest.mark.parametrize("route", ["host", "device_cpu"])
@pytest.mark.parametrize("fa,yak", FILES)
def test_estimate_qv_matches_jax(fa, yak, route, monkeypatch):
    seqs = [s for _, s in read_fastx(os.path.join(DATA, fa))]
    table = load_yak(os.path.join(DATA, yak))
    before = cc.LAUNCHES["kmer_lookup_plain"]
    if route == "device_cpu":
        monkeypatch.setenv("NP2_KMER_DEVICE_MIN", "1")
        table.use_device = True
        table.device = "cpu"
    got = estimate_qv(seqs, table)
    want = _jax_qv(fa, yak)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert str(got) == str(want)
    assert got.total_kmers > 0
    launched = cc.LAUNCHES["kmer_lookup_plain"] - before
    assert launched == (len(seqs) if route == "device_cpu" else 0)


def test_qv_of_marks_the_table_for_its_device(monkeypatch):
    """tools.qv on device="cpu" routes a batch at or above
    NP2_KMER_DEVICE_MIN through the device table (one launch a contig) and
    a smaller one to the host search: the same result either way."""
    fa, yak = (os.path.join(DATA, f) for f in ("m20.fa", "m20.k21.yak"))
    want = _jax_qv("m20.fa", "m20.k21.yak", 3)
    n_contigs = sum(1 for _ in read_fastx(fa))
    for dev_min, launches in (("1", n_contigs), (str(1 << 30), 0)):
        monkeypatch.setenv("NP2_KMER_DEVICE_MIN", dev_min)
        before = cc.LAUNCHES["kmer_lookup_plain"]
        got = qv_tool.qv_of(fa, yak, 3, device="cpu")
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert cc.LAUNCHES["kmer_lookup_plain"] - before == launches


@pytest.mark.parametrize("fa,yak,args", [
    ("slice.fa", "k21.yak", []),
    ("slice.golden.fa", "k31.yak", ["-k", "3"]),
])
def test_qv_tool_stdout_matches_jax_tool(fa, yak, args):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    paths = [os.path.join(DATA, fa), os.path.join(DATA, yak)]
    port = subprocess.run(
        [sys.executable, "-m", "nextpolish2_tpu_torch.tools.qv", *paths,
         *args, "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    ref = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "qv.py"), *paths, *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    assert port.stdout == ref.stdout
    assert port.stdout.startswith("kmers=")
