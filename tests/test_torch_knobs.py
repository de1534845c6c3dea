"""The engine's chunk knobs in the port, against the JAX package: the tier
batches NP2_CHUNK_B_K8 and NP2_CHUNK_B_K48 (read at import) and the
pipeline depth NP2_PIPELINE_DEPTH (read when a contig's chunk loop starts).
Tolerance: exact. No value changes the output."""

import json
import os
import subprocess
import sys

import pytest
import torch

from nextpolish2_tpu_torch.config import PolishConfig
from nextpolish2_tpu_torch.io.bam import BamReader
from nextpolish2_tpu_torch.io.fastx import read_fastx
from nextpolish2_tpu_torch.io.yak import load_yak
from nextpolish2_tpu_torch.models.oracle import consensus_to_bytes
from nextpolish2_tpu_torch.pipeline import engine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(REPO, "testdata")

# both engines imported under the environment given, their tiers and chunk
# plans printed: seeded spans and K tiers, planned at the fat K of 48 and 33
# (the tier CHUNK_B_TIERS lacks, filled in by chunk_b_tiers)
_PLAN = """
import json
import numpy as np
from nextpolish2_tpu.pipeline import engine as je
from nextpolish2_tpu_torch.pipeline import engine as te

rng = np.random.default_rng(40)
span = rng.integers(200, 2600, size=3000).astype(np.int64)
ktier = np.where(rng.random(3000) < 0.1, 48, 8).astype(np.int64)
out = {}
for name, e in (("jax", je), ("port", te)):
    plans = []
    for fat_k in (48, 33):
        kt = np.where(ktier == 48, fat_k, ktier)
        chunks = e.plan_tiered_chunks(span, kt, [1280, 2560], 128,
                                      tier_b=e.chunk_b_tiers(fat_k))
        plans.append([[np.asarray(ids).tolist(), int(w), int(k), int(b)]
                      for ids, w, k, b in chunks])
    out[name] = {"tiers": {str(k): v for k, v in e.CHUNK_B_TIERS.items()},
                 "fat33": e.chunk_b_tiers(33), "plans": plans}
print(json.dumps(out))
"""


@pytest.mark.parametrize("env", [{}, {"NP2_CHUNK_B_K8": "256",
                                      "NP2_CHUNK_B_K48": "64"}])
def test_chunk_tiers_and_plans_match_jax(env):
    full = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO, **env)
    for k in ("NP2_CHUNK_B_K8", "NP2_CHUNK_B_K48"):
        if k not in env:
            full.pop(k, None)
    res = subprocess.run([sys.executable, "-c", _PLAN], cwd=REPO, env=full,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["port"] == out["jax"]
    want = {"8": int(env.get("NP2_CHUNK_B_K8", 512)),
            "48": int(env.get("NP2_CHUNK_B_K48", 128))}
    assert out["port"]["tiers"] == want
    assert out["port"]["fat33"]["33"] == want["48"]
    assert len(out["port"]["plans"][0]) > 4


def test_slice_golden_at_pipeline_depth_1(monkeypatch):
    monkeypatch.setenv("NP2_PIPELINE_DEPTH", "1")
    assert engine.pipeline_depth() == 1
    tseq = next(iter(read_fastx(f"{BASE}/slice.fa")))[1]
    golden = next(iter(read_fastx(f"{BASE}/slice.golden.fa")))[1]
    tables = [load_yak(f"{BASE}/k21.yak"), load_yak(f"{BASE}/k31.yak")]
    recs = next(BamReader(f"{BASE}/slice.bam").by_contig())[1]
    engine.STATS.clear()
    cb = engine.polish_contig_cuda(tseq, recs, tables,
                                   PolishConfig(min_ctg_len=1000),
                                   device="cpu", fallback=False)
    assert consensus_to_bytes(cb).upper() == golden.upper()
    assert engine.STATS["chunks"] >= 2  # depth 1 harvests between them
