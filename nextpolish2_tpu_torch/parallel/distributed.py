"""Multi-process scale-out: process-group start-up and contig striping.

Scale-out has two layers:

1. Within a process: chunks shard their windows over the mesh's 'win' axis
   and a large k-mer table shards over its 'kmer' axis (parallel/mesh.py,
   parallel/sharded_kmer.py). The mesh spans the process's own devices
   only.
2. Across processes (on one host or several): contigs are assigned round
   robin by input order (process h polishes contigs with index % n == h),
   and each process writes its own output shard `OUT.shard<h>`;
   merge_shards restores input order. Assignment needs no communication:
   every process reads the BAM, but polishes only its contigs. No
   collective follows the start-up.

init_distributed reads NP2_COORDINATOR ("host:port"), NP2_NUM_PROCESSES and
NP2_PROCESS_ID, or explicit arguments; without a coordinator it does nothing.
(The JAX package's copy, nextpolish2_tpu/parallel/distributed.py, starts
jax.distributed instead; the shard and merge steps are the same.)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class HostShard:
    host_id: int
    n_hosts: int

    def owns(self, contig_index: int) -> bool:
        return contig_index % self.n_hosts == self.host_id

    def shard_path(self, out_path: str) -> str:
        if self.n_hosts == 1:
            return out_path
        return f"{out_path}.shard{self.host_id}"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> HostShard:
    """Join the process group when a coordinator is configured; return this
    process's shard. torch.distributed's gloo group, reached at
    tcp://<coordinator>, blocks until every process has joined, as
    jax.distributed.initialize does; nothing else goes through it."""
    coordinator = coordinator or os.environ.get("NP2_COORDINATOR")
    if coordinator is None:
        return HostShard(0, 1)
    import torch.distributed as dist

    num_processes = int(num_processes or os.environ["NP2_NUM_PROCESSES"])
    process_id = int(process_id if process_id is not None
                     else os.environ["NP2_PROCESS_ID"])
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return HostShard(process_id, num_processes)


def shutdown_distributed() -> None:
    """Leave the process group init_distributed joined, if any."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def merge_shards(out_path: str, n_hosts: int, contig_names: List[str],
                 out_pos: bool = False) -> None:
    """Concatenate per-process shard files back into input contig order.

    out_pos: shards hold `tid\\tbase\\tpos` TSV lines (write_pos_records)
    instead of FASTA. A missing shard or contig is an error: silently
    dropping a process's output would corrupt the assembly."""
    records: dict = {}
    for h in range(n_hosts):
        path = f"{out_path}.shard{h}"
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"merge_shards: missing shard {path} (host {h} incomplete?)")
        with open(path, "rb") as f:
            data = f.read()
        if out_pos:
            # group consecutive TSV lines by tid (each contig is contiguous)
            for line in data.split(b"\n"):
                if not line:
                    continue
                name = line.split(b"\t", 1)[0].decode()
                records.setdefault(name, []).append(line)
        else:
            # record boundaries: shard files are our own single-line FASTA
            name = None
            header = b""
            for line in data.split(b"\n"):
                if line.startswith(b">"):
                    name = line[1:].split()[0].decode()
                    header = line
                elif name is not None and line:
                    records[name] = (header, line)
                    name = None
    missing = [n for n in contig_names if n not in records]
    if missing:
        raise ValueError(f"merge_shards: {len(missing)} contigs absent from "
                         f"shards (first: {missing[0]!r})")
    with open(out_path, "wb") as f:
        for name in contig_names:
            if out_pos:
                f.write(b"\n".join(records[name]) + b"\n")
            else:
                header, seq = records[name]
                f.write(header + b"\n" + seq + b"\n")


def finalize_shards(out_path: str, shard: HostShard, fa_path: str,
                    out_pos: bool = False,
                    timeout_s: Optional[float] = None) -> bool:
    """Completion barrier of the processes + auto-merge by process 0.

    REQUIRES A SHARED FILESYSTEM (whatever already holds the shard files):
    the sentinels and shards of every process must be visible to process 0
    at `out_path`'s directory. Without one, set NP2_NO_AUTOMERGE=1 and merge
    the shards (merge_shards) after copying them to one machine.

    Every process drops a `<out>.shard<h>.done` sentinel when its shard is
    complete; process 0 waits for all sentinels (logging the pending set to
    stderr every NP2_MERGE_LOG_S seconds, default 60), then merges the
    shards into `out_path` in input contig order (merge_shards) and removes
    the sentinels. Shard files are kept. Returns True on the process that
    wrote the merged output. A timeout (default env NP2_MERGE_TIMEOUT_S or
    86400) raises: shipping a partial assembly silently is worse than
    failing loudly."""
    import sys
    import time

    if shard.n_hosts <= 1:
        return True
    sentinel = f"{out_path}.shard{shard.host_id}.done"
    with open(sentinel, "w") as f:
        f.write("done\n")
    if shard.host_id != 0:
        return False
    if timeout_s is None:
        timeout_s = float(os.environ.get("NP2_MERGE_TIMEOUT_S", "86400"))
    log_every = float(os.environ.get("NP2_MERGE_LOG_S", "60"))
    t0 = time.time()
    next_log = t0 + log_every
    pending = set(range(shard.n_hosts))
    while pending:
        pending = {h for h in pending
                   if not os.path.exists(f"{out_path}.shard{h}.done")}
        if not pending:
            break
        now = time.time()
        if now >= next_log:
            print(f"[np2] finalize_shards: waiting on host(s) "
                  f"{sorted(pending)} ({now - t0:.0f}s elapsed)",
                  file=sys.stderr, flush=True)
            next_log = now + log_every
        if now - t0 > timeout_s:
            raise TimeoutError(
                f"finalize_shards: hosts {sorted(pending)} incomplete after "
                f"{timeout_s:.0f}s (no .done sentinel)")
        time.sleep(1.0)
    from ..io.fastx import read_fastx

    contig_names = [name for name, _ in read_fastx(fa_path)]
    merge_shards(out_path, shard.n_hosts, contig_names, out_pos=out_pos)
    for h in range(shard.n_hosts):
        try:
            os.remove(f"{out_path}.shard{h}.done")
        except OSError:
            pass
    return True
