"""The import check: nothing the benchmark loads has jax, jaxlib, flax or
nextpolish2_tpu as its top-level name, and the plain reference loads
nothing of the polisher either."""

import ast
import os
import subprocess
import sys

from polishbench import spec

BANNED = {"jax", "jaxlib", "flax", "nextpolish2_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(spec.BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for p in _sources():
        for name in _imports(p):
            assert name.split(".")[0] not in BANNED, (p, name)


def test_reference_imports_nothing_of_the_polisher():
    for p in _sources("reference"):
        for name in _imports(p):
            assert not name.startswith("nextpolish2_tpu"), (p, name)


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=spec.ROOT)).stdout.split()
    return set(out)


def test_loaded_modules_after_a_run_and_the_reference():
    loaded = _loaded_after(
        "import polishbench.run, polishbench.trace, polishbench.probes, "
        "polishbench.control\n"
        "from polishbench.spec import resolve\n"
        "resolve('bacterial_haploid_t1.genome')\n"
        "from nextpolish2_tpu_torch.pipeline import orchestrator, batcher\n"
        "from nextpolish2_tpu_torch.ops import consensus_cuda, kmer_score")
    assert not loaded & BANNED
    assert "nextpolish2_tpu_torch" in loaded
    ref = _loaded_after("import polishbench.reference.worker\n"
                        "from polishbench.reference import polish, lq, yak")
    assert not ref & (BANNED | {"nextpolish2_tpu_torch", "torch"})
