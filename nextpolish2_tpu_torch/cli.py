"""CLI mirroring the reference nextPolish2 interface (src/utils/option.rs:43-228).

    nextpolish2 [-o FILE] [options] HiFi.map.bam genome.fa[.gz] short.read.yak...

All reference flags are supported plus engine knobs (--engine, --device,
--window-len, --mesh, --profile-dir). -t N polishes N contigs at a time
through one cross-contig device batcher. The engine's DP formulation follows
the environment, as in the JAX package: NP2_DP_DYNK=1 (dynamic-K kernel on
dense tables) or NP2_DP_BASE=1 (base formulation); the output is the same.

Several processes split an assembly's contigs when NP2_COORDINATOR
("host:port" of process 0), NP2_NUM_PROCESSES and NP2_PROCESS_ID are set
(parallel/distributed.py): each writes -o FILE.shard<h>, and process 0
merges the shards into FILE once all are done (unless NP2_NO_AUTOMERGE is
set; the file system must be shared).
Run as `python -m nextpolish2_tpu_torch.cli ...`.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from . import __version__
from .config import PolishConfig, parse_min_map_len


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nextpolish2",
        description="Repeat-aware polishing genomes assembled using HiFi long reads "
                    "(PyTorch/CUDA port)",
    )
    p.add_argument("bam", help="HiFi-to-ref mapping file in sorted BAM format.")
    p.add_argument("fa", help="genome assembly file in [GZIP] FASTA format.")
    p.add_argument("yak", nargs="+",
                   help="one or more k-mer dataset in yak format.")
    p.add_argument("-o", "--out", default="stdout", help="output file.")
    p.add_argument("-u", "--uppercase", action="store_true",
                   help="output in uppercase sequences.")
    p.add_argument("--out_pos", action="store_true",
                   help="output each base and its position.")
    p.add_argument("-k", "--min_kmer_count", type=int, default=5,
                   help="filter kmers in k-mer dataset with count <= INT.")
    p.add_argument("-t", "--thread", type=int, default=1, help="number of threads.")
    p.add_argument("-i", "--iter_count", type=int, default=2,
                   help="number of iterations to attempt phasing.")
    p.add_argument("-m", "--model", choices=["ref", "len"], default="ref",
                   type=str.lower, help="phasing model.")
    p.add_argument("-l", "--min_read_len", type=int, default=1000,
                   help="filter reads with length <= INT.")
    p.add_argument("-L", "--min_ctg_len", type=int, default=1_000_000,
                   help="don't correct reference sequences with length <= INT.")
    p.add_argument("-n", "--max_indel_len", type=int, default=20,
                   help="ignore indel errors with length > INT.")
    p.add_argument("-s", "--use_supplementary", action="store_true",
                   help="use supplementary alignments.")
    p.add_argument("-S", "--use_secondary", action="store_true",
                   help="use secondary alignments, consider setting "
                        "`min_map_qual` to -1 when using this option.")
    p.add_argument("-a", "--min_map_len", type=float, default=500.5,
                   help="filter alignments with alignment length <= "
                        "min(INT, FLOAT * read_length).")
    p.add_argument("-q", "--min_map_qual", type=int, default=1,
                   help="filter alignments with mapping quality <= INT.")
    p.add_argument("-c", "--max_clip_len", type=int, default=100,
                   help="filter alignments with unaligned length >= INT.")
    p.add_argument("-r", "--use_all_reads", action="store_true",
                   help="use all unfiltered reads, reads with different haplotypes "
                        "from the reference assembly are discarded by default.")
    p.add_argument("--min_base_cov", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--engine", choices=["cuda", "oracle"], default="cuda",
                   help="compute engine: device windowed (default) or host "
                        "oracle.")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the windowed engine; 'cpu' runs the "
                        "kernels' plain PyTorch versions.")
    p.add_argument("--window-len", type=int, default=1024,
                   help="device window target length (columns).")
    p.add_argument("--mesh", default="auto",
                   help="device mesh 'WINxKMER' (e.g. 4x2) over the visible "
                        "cards, 'auto' (all cards on the win axis; tables "
                        "too large for one card shard over the kmer axis), "
                        "or 'off' (one card). Used with --device cuda only.")
    p.add_argument("--resume", action="store_true",
                   help="append to an existing -o FILE, skipping contigs "
                        "already present (crash recovery).")
    p.add_argument("--verbose", action="store_true",
                   help="per-contig progress to stderr.")
    p.add_argument("--timing", action="store_true",
                   help="per-stage timing summary to stderr.")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (Chrome format) to "
                        "this directory.")
    p.add_argument("--version", action="version", version=__version__)
    return p


def args_to_config(a: argparse.Namespace) -> PolishConfig:
    mml, mmf = parse_min_map_len(a.min_map_len)
    return PolishConfig(
        min_kmer_count=a.min_kmer_count,
        iter_count=a.iter_count,
        min_read_len=a.min_read_len,
        min_ctg_len=a.min_ctg_len,
        max_indel_len=a.max_indel_len,
        use_supplementary=a.use_supplementary,
        use_secondary=a.use_secondary,
        use_all_reads=a.use_all_reads,
        min_map_qual=a.min_map_qual,
        min_map_len=mml,
        min_map_fra=mmf,
        max_clip_len=a.max_clip_len,
        model=a.model,
        uppercase=a.uppercase,
        out_pos=a.out_pos,
        min_base_cov=a.min_base_cov,
        window_len=a.window_len,
        threads=a.thread,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for path in [args.bam, args.fa] + args.yak:
        if not os.path.exists(path):
            print(f"{path!r} does not exist!", file=sys.stderr)
            return 2
    # canonicalize inputs at parse time (option.rs:294-306 to_abspath_string):
    # later chdirs (or worker threads with their own cwd) must not re-resolve
    args.bam = os.path.abspath(args.bam)
    args.fa = os.path.abspath(args.fa)
    args.yak = [os.path.abspath(y) for y in args.yak]
    if args.out != "stdout":
        args.out = os.path.abspath(args.out)

    from .io.native import available as native_available

    if not native_available():
        print("nextpolish2: WARNING: native io module unavailable "
              "(io/_native build failed); falling back to the pure-Python "
              "BAM/aggregation path, which is much slower.", file=sys.stderr)
    if args.out != "stdout" and os.path.exists(args.out) and not args.resume:
        print(f"{args.out!r} already exists!", file=sys.stderr)  # option.rs:312-316
        return 2
    cfg = args_to_config(args)

    if args.engine == "cuda":
        from .utils.torchcfg import resolve_device

        resolve_device(args.device)  # raise before any output is written

    if args.engine == "cuda" and args.device == "cuda" and args.mesh != "off":
        from .parallel.mesh import (auto_mesh, axis_size, make_mesh,
                                    set_active_mesh)

        if args.mesh == "auto":
            # kmer-axis width from the table footprint: shard tables that
            # would not fit replicated on one card (parallel/mesh.py)
            yak_bytes = sum(os.path.getsize(p) for p in args.yak)
            mesh = auto_mesh(yak_bytes=yak_bytes)
            if axis_size(mesh, "kmer") > 1:
                print(f"[np2] mesh auto: {axis_size(mesh, 'win')}x"
                      f"{axis_size(mesh, 'kmer')} (tables "
                      f"{yak_bytes/1e9:.1f} GB shard over the kmer axis)",
                      file=sys.stderr)
            set_active_mesh(mesh)
        else:
            n_win, n_kmer = (int(x) for x in args.mesh.lower().split("x"))
            set_active_mesh(make_mesh(n_win=n_win, n_kmer=n_kmer))

    from .parallel.distributed import init_distributed, shutdown_distributed

    shard = init_distributed()  # nothing unless NP2_COORDINATOR is set
    try:
        return _polish_shard(args, cfg, shard)
    finally:
        shutdown_distributed()


def _polish_shard(args, cfg, shard) -> int:
    """Polish this process's contigs into its output (the whole -o FILE, or
    its shard), merge the shards on process 0, and report."""
    from .parallel.distributed import finalize_shards
    from .pipeline.orchestrator import PolishStats, completed_contigs, polish
    from .utils.resource import resource_str

    out_path = args.out
    if shard.n_hosts > 1 and args.out != "stdout":
        out_path = shard.shard_path(args.out)
        # a stale .done sentinel from a crashed earlier run would let
        # process 0 merge while this one is still polishing: clear ours
        try:
            os.remove(f"{args.out}.shard{shard.host_id}.done")
        except OSError:
            pass
    skip = None
    if args.resume and out_path != "stdout":
        from .pipeline.orchestrator import trim_partial_output

        # trim FIRST: a record truncated mid-write must be re-polished, so it
        # must not be counted complete (and then silently lost to the trim)
        trim_partial_output(out_path, out_pos=cfg.out_pos)
        skip = completed_contigs(out_path, out_pos=cfg.out_pos)
        if skip:
            print(f"resume: skipping {len(skip)} completed contigs",
                  file=sys.stderr)
    out = sys.stdout.buffer if out_path == "stdout" else open(
        out_path, "ab" if args.resume else "wb")
    stats = PolishStats()
    from .utils import timing

    if args.timing:
        timing.enable()
    trace = (timing.profiler_trace(args.profile_dir) if args.profile_dir
             else contextlib.nullcontext())
    try:
        with trace:
            polish(args.fa, args.bam, args.yak, cfg, engine=args.engine,
                   out=out, stats=stats, skip_contigs=skip,
                   verbose=args.verbose, device=args.device,
                   host_shard=shard if shard.n_hosts > 1 else None)
    finally:
        if out is not sys.stdout.buffer:
            out.close()
    if shard.n_hosts > 1 and args.out != "stdout" and \
            not os.environ.get("NP2_NO_AUTOMERGE"):
        if finalize_shards(args.out, shard, args.fa, out_pos=cfg.out_pos):
            print(f"merged {shard.n_hosts} host shards -> {args.out}",
                  file=sys.stderr)
    if args.timing:
        timing.report()
        from .ops.consensus_cuda import LAUNCHES
        from .pipeline.engine import STATS

        print(f"[np2 timing] kernel launches: {dict(LAUNCHES)}",
              file=sys.stderr)
        print(f"[np2 timing] engine: {dict(STATS)}", file=sys.stderr)
    print(resource_str(__version__), file=sys.stderr)
    print(f"Contigs: {stats.contigs} ({stats.polished} polished, "
          f"{stats.passthrough} passthrough); bases {stats.in_bases} -> "
          f"{stats.out_bases}", file=sys.stderr)
    if stats.batches:
        dense = (f", dense fallbacks: {stats.dense_reasons}"
                 if stats.dense_reasons else "")
        print(f"Device batches: {stats.batches} (cross-contig lane fill "
              f"{stats.batch_fill:.1%}, {stats.csr_batches} CSR-direct"
              f"{dense})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
