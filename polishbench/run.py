"""One run of one cell of the polisher's benchmark.

    python3 polishbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Set-up: the cell's inputs are made from the seed in a child process (or
found in .cache/), the polisher (nextpolish2_tpu_torch) is imported, its
kernels are built or loaded, and one whole pass polishes the assembly as a
warm-up. The window: passes run back to back, each one call of
`orchestrator.polish` over the whole assembly at the configuration's
threads, until S seconds have passed; the pass under way then runs to its
end and counts. After the window the polished FASTA of every pass is held
byte for byte to the plain reference (polishbench/reference), run in
worker processes, and the last pass's polished contigs to the truth the
generator drew (truth.py).

--trace 0 prints the end-to-end metrics with the program's stage timing
off; --trace 1 turns it on, profiles the window (CUDA activity only) and
prints the per-layer metrics. The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines
on standard error and the last key of that object. Exits non-zero, with no
result, where no card (or fewer than the cell asks for) is present, or
where jax, jaxlib, flax or nextpolish2_tpu was loaded.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "nextpolish2_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold,
    compared whole (nextpolish2_tpu_torch is not nextpolish2_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def missing_cards(chips: int):
    """Why the run cannot go on, or None where the cards are there."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return (f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {chips}")
    return None


def _log(*a):
    print("[polishbench]", *a, file=sys.stderr, flush=True)


def per_layer(cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        v = m.reader.read(ctx)
        if v is not None:
            out[m.name] = {"value": v, "unit": m.unit}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """Set-up, window and check of one run; returns the result object.
    main() always runs it on the card; device="cpu" is only for the CPU
    tests, which rehearse a whole run (and its faults) without one."""
    from polishbench import compare, inputs
    from polishbench.reference.worker import polish_parallel
    from polishbench.truth import read_truth

    d = inputs.ensure_inputs(cell, seed)
    files = inputs.input_files(d, cell.config["ks"])
    t_inputs = time.time()

    import torch

    from nextpolish2_tpu_torch.config import PolishConfig
    from nextpolish2_tpu_torch.pipeline import orchestrator

    overrides = dict(cell.config.get("polish", {}))
    threads = int(cell.config["threads"])
    if device == "cuda":
        from nextpolish2_tpu_torch.ops import consensus_cuda

        consensus_cuda.build_kernels()
        torch.cuda.init()
    t_imports = time.time()

    def one_pass():
        sink = io.BytesIO()
        st = orchestrator.PolishStats()
        orchestrator.polish(files["fa"], files["bam"], files["yaks"],
                            PolishConfig(threads=threads, **overrides),
                            engine="cuda", device=device, out=sink, stats=st)
        return sink.getvalue(), st

    one_pass()  # warm-up: native library, kernels, first launches
    t_warm = time.time()
    _log(f"setup: inputs {t_inputs - T0:.3f} s, imports and kernels "
         f"{t_imports - t_inputs:.3f} s, warm-up pass {t_warm - t_imports:.3f}"
         " s")

    probes = window = None
    if trace:
        from polishbench import probes as probes_mod
        from polishbench import trace as trace_mod

        probes = probes_mod.Probes()
        probes.install()
        window = trace_mod.Window(os.path.join(inputs.cell_dir(cell.name),
                                               "trace.json"), device)
        window.start()
    t_start = time.time()
    digests, stats, ends, last = [], [], [], b""
    while True:
        last, st = one_pass()
        digests.append(compare.digest(last))
        stats.append(st)
        t_end = time.time()
        ends.append(t_end - t_start)
        if t_end - t_start >= seconds:
            break
    bases = sum(s.in_bases for s in stats)
    span = t_end - t_start
    if window is not None:
        window.stop()
        probes.uninstall()
    peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    dev_info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    if device == "cuda":
        torch.cuda.synchronize()
        dev_info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": int(cell.chips),
                    "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    _log(f"window: {len(stats)} passes, {bases} bases in {span:.3f} s; "
         f"passes end at {', '.join(f'{t:.3f}' for t in ends)} s")

    metrics, breakdown = {}, None
    if trace:
        from polishbench import roofline
        from polishbench import trace as trace_mod

        events = trace_mod.device_events(window.path)
        os.remove(window.path)
        red = trace_mod.reduce_window(events, window.host_start)
        kernel_s = {kind: sum((e - s) * 1e-6 for name, cat, s, e
                              in red["ops"] if cat == "kernel" and is_(name))
                    for kind, is_ in (("chunk", roofline.is_chunk_kernel),
                                      ("kmer", roofline.is_kmer_kernel))}
        chunk_s = kernel_s["chunk"]
        ctx = {"bases": bases, "stages": dict(probes.stages),
               "stats": stats, "trace": red, "chunk_kernel_s": chunk_s,
               "kmer_kernel_s": kernel_s["kmer"],
               "bytes": dict(probes.bytes)}
        metrics = per_layer(cell, ctx)
        dev_info["busy_s"] = red["busy_s"]
        dev_info["window_s"] = red["window_s"]
        breakdown = {"device_ops": trace_mod.top_ops(red["ops"]),
                     "idle_gaps": trace_mod.idle_gaps(
                         red, probes.stages.intervals)}
        _log(f"trace: {len(red['ops'])} device ops, busy "
             f"{red['busy_s']:.6f} of {red['window_s']:.6f} s, markers "
             f"{'found' if red['offset'] is not None else 'missing'}; "
             f"bytes {dict(probes.bytes)}; chunk kernels {chunk_s:.6f} s, "
             f"k-mer kernels {kernel_s['kmer']:.6f} s")
        _log("stage thread-seconds: " + json.dumps(
            {k: round(v, 4) for k, v in sorted(probes.stages.items(),
                                               key=lambda kv: -kv[1])}))
        probes = window = ctx = red = events = None
    else:
        metrics = {
            "polish_rate": {"value": bases / 1e6 / span, "unit": "Mbp/s"},
            "peak_rss": {"value": peak_rss / 1e9, "unit": "GB"},
            "setup_s": {"value": t_start - T0, "unit": "s"},
        }
        metrics = {m.name: metrics[m.name] for m in cell.end_to_end}

    # the check, once the window has closed and the program's state is
    # freed: every polished contig on its own worker, the passthrough
    # contigs together
    stats = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    meta = files["meta"]
    min_len = int(overrides.get("min_ctg_len", 1_000_000))
    polished = [n for n, l in zip(meta["contigs"], meta["asm_lengths"])
                if l >= min_len]
    rest = [n for n in meta["contigs"] if n not in polished]
    groups = [[n] for n in polished] + ([rest] if rest else [])
    t_ref = time.time()
    reference = polish_parallel(files["fa"], files["bam"], files["yaks"],
                                overrides, groups,
                                workers=min(len(groups), os.cpu_count() or 1))
    correct, failed, checks = compare.compare(
        digests, last, meta["contigs"], reference, read_truth(d), polished)
    _log(f"reference: {len(polished)} polished and {len(rest)} passthrough "
         f"contigs in {time.time() - t_ref:.3f} s")
    result = {"correct": correct, "attempted": len(digests), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from polishbench.spec import resolve

    cell = resolve(a.workload)
    why = missing_cards(cell.chips)
    if why:
        _log(f"no result: {why}")
        return 3
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        _log(f"no result: loaded {', '.join(bad)}")
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
