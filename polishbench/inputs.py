"""A run's inputs: made from the seed by gen/fixture.py in a child process
(so the generator's memory never counts in the run's peak RSS), and kept
under .cache/<cell>/<seed>/, at most two seeds a cell."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from .spec import BENCH_DIR, Cell

CACHE = os.path.join(BENCH_DIR, ".cache")
KEEP_SEEDS = 2


def cell_dir(cell_name: str) -> str:
    return os.path.join(CACHE, cell_name)


def ensure_inputs(cell: Cell, seed: int, keep: int = KEEP_SEEDS) -> str:
    """The directory of `cell`'s inputs for `seed`, generated if absent;
    the cell's other seeds but the `keep` - 1 newest are removed."""
    base = cell_dir(cell.name)
    d = os.path.join(base, str(seed))
    if not os.path.exists(os.path.join(d, "meta.json")):
        os.makedirs(base, exist_ok=True)
        ks = ",".join(str(k) for k in cell.config["ks"])
        subprocess.run([sys.executable,
                        os.path.join(BENCH_DIR, "gen", "fixture.py"),
                        "--traffic", cell.traffic_file, "--ks", ks,
                        "--seed", str(seed), "--out", d],
                       check=True, stdout=subprocess.DEVNULL)
    os.utime(d)
    entries = [os.path.join(base, s) for s in os.listdir(base)]
    for part in (p for p in entries if p.endswith(".part")):
        shutil.rmtree(part, ignore_errors=True)  # a cut generation's rest
    seeds = sorted((p for p in entries
                    if os.path.isdir(p) and not p.endswith(".part")),
                   key=os.path.getmtime)
    for old in seeds[:-keep]:
        if old != d:
            shutil.rmtree(old, ignore_errors=True)
    return d


def input_files(d: str, ks) -> dict:
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return {"fa": os.path.join(d, "asm.fa"),
            "bam": os.path.join(d, "reads.bam"),
            "yaks": [os.path.join(d, f"k{k}.yak") for k in ks],
            "meta": meta}
