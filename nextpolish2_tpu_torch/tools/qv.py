"""Assembly QV estimation against a short-read yak table (merqury-style).

Usage: python -m nextpolish2_tpu_torch.tools.qv assembly.fa[.gz] \\
           short.reads.yak [-k MIN_COUNT] [--device cuda|cpu]

The table's lookups run on the card (--device cuda, the default): a contig's
batch of NP2_KMER_DEVICE_MIN k-mers or more is probed in the device-resident
table by the kmer_lookup kernel, smaller ones on the host. Without CUDA it
raises unless --device cpu is given, which sends the same batches through
the lookup's plain PyTorch twin.
"""

from __future__ import annotations

import argparse

from ..eval.qv import QvResult, estimate_qv
from ..io.fastx import read_fastx
from ..io.yak import load_yak
from ..utils.torchcfg import resolve_device


def qv_of(fa: str, yak: str, min_count: int = 5,
          device="cuda") -> QvResult:
    """estimate_qv of the assembly `fa` against the table `yak`, the table
    marked for `device` as the orchestrator marks its tables."""
    dev = resolve_device(device)  # raises before any work without CUDA
    table = load_yak(yak)
    table.use_device = True
    table.device = dev
    seqs = [s for _, s in read_fastx(fa)]
    return estimate_qv(seqs, table, min_count)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("fa")
    p.add_argument("yak")
    p.add_argument("-k", "--min_kmer_count", type=int, default=5)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the table's lookups; 'cpu' runs the "
                        "lookup kernel's plain PyTorch twin")
    a = p.parse_args(argv)
    print(qv_of(a.fa, a.yak, a.min_kmer_count, a.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
