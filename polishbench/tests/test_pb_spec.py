"""BENCHMARK.json against the files it names, and the data-driven layout:
every configuration, traffic mix and per-layer metric resolves by name,
and a new cell takes only new files and entries."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from polishbench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = spec.resolve(cell)
    assert os.path.isfile(c.traffic_file)
    assert c.config["ks"] and int(c.config["threads"]) >= 1
    assert {m.name for m in c.end_to_end} >= {"setup_s", "polish_rate"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        for attr in ("LAYER", "UNIT", "MOVES"):
            assert hasattr(m.reader, attr), (m.name, attr)
        assert m.reader.UNIT == m.unit and m.reader.LAYER == m.layer
        assert m.reader.MOVES == m.moves
        assert callable(m.reader.read)


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["polishbench"]
    assert BENCH["command"][1].startswith("polishbench/")
    names = [c["name"] for c in BENCH["configs"]] + CELLS \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("polishbench/")
        cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert all(k in cfg for k in c["reduced"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert os.path.isfile(os.path.join(spec.BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_cell_takes_only_new_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix and a
    cell as new files and entries; the copy's harness resolves it."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "polishbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "bacterial_haploid_t1_copy",
                             "source": "test", "reduced": [], "why": "test",
                             "file": "polishbench/configs/"
                                     "bacterial_haploid_t1_copy.json"})
    bench["workloads"].append({"name": "bacterial_haploid_t1_copy.draft",
                               "config": "bacterial_haploid_t1_copy",
                               "traffic": "draft", "chips": 1, "why": "t"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = spec.load_json(spec.config_path("bacterial_haploid_t1"))
    (root / "polishbench/configs/bacterial_haploid_t1_copy.json") \
        .write_text(json.dumps(cfg))
    traffic = spec.load_json(spec.traffic_path("bacterial_haploid_t1",
                                               "genome"))
    traffic["err_bp"] = 1000
    (root / "polishbench/traffic/bacterial_haploid_t1_copy.draft.json") \
        .write_text(json.dumps(traffic))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from polishbench.spec import resolve; "
            "c = resolve('bacterial_haploid_t1_copy.draft'); "
            "print(c.traffic['err_bp'], len(c.per_layer))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True).stdout.split()
    assert out[0] == "1000" and int(out[1]) > 0
