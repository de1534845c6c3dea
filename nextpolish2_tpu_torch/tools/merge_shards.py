"""Merge multi-host output shards (OUT.shard<h>) into OUT in input contig order.

Usage: python -m nextpolish2_tpu_torch.tools.merge_shards OUT N_HOSTS \\
           assembly.fa[.gz] [--out_pos]
"""

from __future__ import annotations

import sys

from ..io.fastx import read_fastx
from ..parallel.distributed import merge_shards


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out, n_hosts, fa = argv[0], int(argv[1]), argv[2]
    names = [n for n, _ in read_fastx(fa)]
    merge_shards(out, n_hosts, names, out_pos="--out_pos" in argv[3:])
    print(f"merged {n_hosts} shards -> {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
