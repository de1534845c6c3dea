"""Polish one generated contig through the CLI and compare it with its
truth: the port's chromosome-scale run.

    python3 -m nextpolish2_tpu_torch.utils.scale_run PREFIX [--whole] \\
        [--run LABEL:KEY=VAL[,KEY=VAL] ...]

PREFIX.{fa,bam,k21.yak,truth.fa} is one contig long enough that the default
routing (NP2_SEG_MIN, 48 Mb) segments it, made beforehand by
`python3 -m nextpolish2_tpu_torch.tools.make_big_fixture PREFIX --contigs 1
--size 80000000 --small 0 --cov 30 --seed 11` (a 62.2 Mb contig). The contig is polished by
`python -m nextpolish2_tpu_torch.cli ... -L 1000 --timing` on the card at
the default settings, once more for each --run under its environment
settings, and with --whole under NP2_NO_SEG=1 (the whole-contig engine).
One JSON line per polish: wall and CPU seconds, peak RSS, the stage table,
kernel launches and engine counters as the CLI reports them, the resident
set sampled each second, and whether the output equals PREFIX.truth.fa byte
for byte. A polish whose resident set passes MAX_RSS_GB is stopped and
reported. Exit code 1 when an output differs or a polish fails.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# a polish whose resident set passes this is stopped and reported, not left
# to the OOM killer
MAX_RSS_GB = 80.0


def parse_report(stderr: str) -> dict:
    """The CLI's --timing report and resource line, as numbers."""
    out: dict = {"stages_s": {}}
    for m in re.finditer(r"^\s+(\S+)\s+([\d.]+)s\s+x(\d+)$", stderr, re.M):
        out["stages_s"][m.group(1)] = float(m.group(2))
    for key, pat in (("launches", r"kernel launches: (\{.*\})"),
                     ("engine", r"\[np2 timing\] engine: (\{.*\})")):
        m = re.search(pat, stderr)
        out[key] = ast.literal_eval(m.group(1)) if m else None
    m = re.search(r"Real time: ([\d.]+) sec; CPU: ([\d.]+) sec; "
                  r"Peak RSS: ([\d.]+) GB", stderr)
    if m:
        out.update(wall_s=float(m.group(1)), cpu_s=float(m.group(2)),
                   peak_rss_gb=float(m.group(3)))
    return out


def _rss_gb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / (1 << 20)
    except OSError:
        pass
    return 0.0


def polish_once(prefix: str, label: str, env_extra: dict) -> dict:
    from ..io.fastx import read_fastx

    out_fa = f"{prefix}.{label}.out.fa"
    if os.path.exists(out_fa):
        os.remove(out_fa)
    env = dict(os.environ, **env_extra)
    err_path = f"{prefix}.{label}.stderr"
    sampled = 0.0
    with open(err_path, "w") as err:
        p = subprocess.Popen(
            [sys.executable, "-m", "nextpolish2_tpu_torch.cli",
             f"{prefix}.bam", f"{prefix}.fa", f"{prefix}.k21.yak", "-L",
             "1000", "--timing", "-o", out_fa],
            cwd=_ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)
        while p.poll() is None:
            sampled = max(sampled, _rss_gb(p.pid))
            if sampled > MAX_RSS_GB:
                p.kill()
            time.sleep(1)
    with open(err_path) as f:
        stderr = f.read()
    res = {"run": label, "env": env_extra, "rc": p.returncode,
           "sampled_peak_rss_gb": sampled, **parse_report(stderr)}
    if p.returncode != 0:
        res["stderr_tail"] = stderr[-4000:]
        res["killed_over_rss_gb"] = MAX_RSS_GB if sampled > MAX_RSS_GB \
            else None
        res["identical"] = False
        return res
    got = dict(read_fastx(out_fa))
    want = dict(read_fastx(f"{prefix}.truth.fa"))
    res["contig_bases"] = {n: len(s) for n, s in want.items()}
    res["identical"] = got == want
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("prefix")
    ap.add_argument("--whole", action="store_true",
                    help="also polish with NP2_NO_SEG=1 (whole-contig)")
    ap.add_argument("--run", action="append", default=[],
                    metavar="LABEL:KEY=VAL[,KEY=VAL]",
                    help="one more polish under these environment settings "
                         "(repeatable), e.g. seg4m:NP2_SEG_LEN=4194304")
    a = ap.parse_args(argv)
    runs = [("segmented_default", {})]
    for spec in a.run:
        label, _, pairs = spec.partition(":")
        runs.append((label, dict(kv.split("=", 1)
                                 for kv in pairs.split(",") if kv)))
    if a.whole:
        runs.append(("whole_contig",
                     {"NP2_NO_SEG": "1", "NP2_SEG_FORCE": ""}))
    ok = True
    for label, extra in runs:
        res = polish_once(a.prefix, label, extra)
        ok &= res["identical"]
        print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
