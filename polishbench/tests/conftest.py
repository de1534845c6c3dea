"""Shared pieces of the benchmark's CPU tests: a tiny cell (two polished
contigs of 30-40 kb and one passthrough contig, diploid, reads with the
measured HiFi errors, two k-mer tables) whose inputs are made under the
test's own temporary directory."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the read errors of the bacterial cell's traffic (measured HiFi profile)
with open(os.path.join(ROOT, "polishbench", "traffic",
                       "bacterial_haploid_t1.genome.json")) as _f:
    READ_ERRORS = json.load(_f)["read_errors"]
TINY_TRAFFIC = {"contigs": [30000, 40000], "passthrough": [5000],
                "err_bp": 2000, "het_bp": 1000, "repeats": 1,
                "repeat_len": 3000, "cov": 20, "read_len": 5000,
                "read_errors": READ_ERRORS, "kmer_cov": 30}
TINY_CONFIG = {"threads": 2, "polish": {"min_ctg_len": 10000},
               "ks": [21, 31]}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def tiny_cell(tmp_path, monkeypatch):
    """A Cell of the bacterial configuration's metrics with the tiny
    (diploid) traffic at two threads, its inputs cached under tmp_path."""
    import torch

    from polishbench import inputs, spec

    torch.set_num_threads(1)
    monkeypatch.setattr(inputs, "CACHE", str(tmp_path / "cache"))
    tfile = tmp_path / "tiny.test.json"
    tfile.write_text(json.dumps(TINY_TRAFFIC))
    cell = spec.resolve("bacterial_haploid_t1.genome")
    cell.name = "tiny.test"
    cell.traffic = dict(TINY_TRAFFIC)
    cell.traffic_file = str(tfile)
    cell.config = json.loads(json.dumps(TINY_CONFIG))
    return cell
