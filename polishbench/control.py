"""The control of a cell's comparison: the plain reference, with one of the
configuration's guarantees broken, put in the program's place, at the
cell's own size. It has to come out not correct.

    python3 polishbench/control.py --workload CELL --seeds N [N ...]

For each seed: the cell's inputs (made as a run makes them), the
reference and the control over every contig (all seeds' contigs spread
over one pool of worker processes), and the comparison a run makes, with
the control's output as the one pass; beside it, the reference's own
reading against the truth (truth.py). Prints one JSON line a seed. Needs no
card: the reference and the control run on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_checks(cell, seeds, control: str, workers: int):
    """{seed: (correct, checks)} of `control` on `seeds` of `cell`: every
    seed's reference and control contigs in one pool of workers."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from polishbench import compare, inputs
    from polishbench.reference.worker import polish_contigs
    from polishbench.truth import read_truth

    overrides = dict(cell.config.get("polish", {}))
    min_len = int(overrides.get("min_ctg_len", 1_000_000))
    dirs = {s: inputs.ensure_inputs(
        cell, s, keep=max(len(seeds), inputs.KEEP_SEEDS)) for s in seeds}
    files = {s: inputs.input_files(dirs[s], cell.config["ks"]) for s in seeds}
    tasks = [(s, kind, n) for s in seeds for kind in (None, control)
             for n in files[s]["meta"]["contigs"]]
    got = {}
    with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing
                             .get_context("spawn")) as ex:
        futs = {t: ex.submit(polish_contigs, files[t[0]]["fa"],
                             files[t[0]]["bam"], files[t[0]]["yaks"],
                             overrides, [t[2]], t[1]) for t in tasks}
        for t, f in futs.items():
            got[t] = f.result()[t[2]]
    out = {}
    for s in seeds:
        names = files[s]["meta"]["contigs"]
        ref = {n: got[(s, None, n)] for n in names}
        data = b"".join(compare.fasta_record(n, *got[(s, control, n)])
                        for n in names)
        meta = files[s]["meta"]
        polished = [n for n, ln in zip(names, meta["asm_lengths"])
                    if ln >= min_len]
        correct, _, checks = compare.compare(
            [compare.digest(data)], data, names, ref, read_truth(dirs[s]),
            polished)
        reference = b"".join(compare.fasta_record(n, *ref[n]) for n in names)
        _, _, ref_checks = compare.compare(
            [compare.digest(reference)], reference, names, ref,
            read_truth(dirs[s]), polished)
        out[s] = (correct, checks, ref_checks[-1][1])
    return out


def main(argv=None) -> int:
    from polishbench.reference.worker import CONTROLS
    from polishbench.spec import resolve

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    cell = resolve(a.workload)
    (control,) = CONTROLS
    t = time.time()
    for seed, (correct, checks, ref_truth) in control_checks(
            cell, a.seeds, control, os.cpu_count() or 1).items():
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control": control, "correct": correct,
                          "checks": {k: v for k, v, _ in checks},
                          "reference_truth_kmers_missing": ref_truth,
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
