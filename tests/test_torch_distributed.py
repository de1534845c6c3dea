"""The port's multi-process contig striping (parallel/distributed.py), the
CLI's shard and merge steps, and the profiler trace, on the CPU. Outputs are
compared byte for byte (tolerance 0):

  - HostShard's round-robin ownership, and polish(host_shard=) on every
    shard merged back into input order equals the one-process polish; the
    contig index counts every FASTA record, before the resume skip set and
    the short-contig passthrough;
  - merge_shards (a missing shard, a missing contig, --out_pos shards) and
    finalize_shards (the sentinel barrier and process 0's merge, the
    timeout), as the JAX package's tests/test_distributed.py holds them;
  - two CLI processes joined through NP2_COORDINATOR on a loopback port:
    their merged output equals the one-process output, and no sentinel is
    left; each process has its own wait(timeout=) and is killed past it;
  - the CLI's --mesh stays off on --device cpu, and init_distributed does
    nothing without a coordinator;
  - utils.timing.profiler_trace writes a Chrome trace.
"""

import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from nextpolish2_tpu_torch import cli
from nextpolish2_tpu_torch.config import PolishConfig
from nextpolish2_tpu_torch.io.bam import BamRecord, BamWriter
from nextpolish2_tpu_torch.io.yak import count_kmers, write_yak
from nextpolish2_tpu_torch.parallel import mesh as tm
from nextpolish2_tpu_torch.parallel.distributed import (HostShard,
                                                        finalize_shards,
                                                        init_distributed,
                                                        merge_shards)
from nextpolish2_tpu_torch.pipeline import orchestrator
from nextpolish2_tpu_torch.pipeline.orchestrator import PolishStats, polish

# one OpenMP thread per test worker: see test_torch_consensus.py
torch.set_num_threads(1)

BASE = os.path.abspath("testdata")
REPO = os.path.dirname(BASE)


def test_host_shard_partition():
    shards = [HostShard(h, 3) for h in range(3)]
    owned = [[i for i in range(10) if s.owns(i)] for s in shards]
    assert owned == [[0, 3, 6, 9], [1, 4, 7], [2, 5, 8]]
    assert HostShard(0, 1).shard_path("/x/out.fa") == "/x/out.fa"
    assert HostShard(2, 3).shard_path("/x/out.fa") == "/x/out.fa.shard2"


def _fixture(tmp_path, n=6):
    """n contigs of 400 random bases (the fourth one 80: below min_ctg_len,
    a passthrough) with 3 error-free reads each, and their k21 table."""
    rng = np.random.default_rng(90)
    contigs = [(f"c{i}", bytes(rng.choice(list(b"ACGT"),
                                          size=80 if i == 3 else 400)
                               .astype(np.uint8))) for i in range(n)]
    fa = tmp_path / "a.fa"
    with open(fa, "wb") as f:
        for name, s in contigs:
            f.write(b">" + name.encode() + b"\n" + s + b"\n")
    bam = tmp_path / "e.bam"
    with BamWriter(str(bam), [(name, len(s)) for name, s in contigs]) as w:
        for tid, (name, s) in enumerate(contigs):
            for r in range(3):
                w.write(BamRecord(qname=f"{name}r{r}".encode(), flag=0,
                                  tid=tid, pos=0, mapq=60,
                                  cigar=[(0, len(s))], seq=s))
    h, c = count_kmers([s for _, s in contigs], 21)
    yak = tmp_path / "t.yak"
    write_yak(str(yak), 21, h, c)
    return str(fa), str(bam), str(yak), contigs


def test_sharded_polish_and_merge(tmp_path):
    """Each shard polishes the contigs it owns by input index; merged, the
    shards equal the one-process output, in input order."""
    fa, bam, yak, contigs = _fixture(tmp_path)
    cfg = PolishConfig(min_ctg_len=100, min_read_len=50, min_map_len=50)
    want = io.BytesIO()
    polish(fa, bam, [yak], cfg, out=want, device="cpu")
    out = str(tmp_path / "out.fa")
    stats = []
    for hid in range(2):
        shard = HostShard(hid, 2)
        st = PolishStats()
        with open(shard.shard_path(out), "wb") as f:
            polish(fa, bam, [yak], cfg, out=f, host_shard=shard, stats=st,
                   device="cpu")
        stats.append(st)
    # shard 1 owns c1, c3 (the passthrough) and c5
    assert [(s.polished, s.passthrough) for s in stats] == [(3, 0), (2, 1)]
    merge_shards(out, 2, [name for name, _ in contigs])
    with open(out, "rb") as f:
        assert f.read() == want.getvalue()
    # the index counts every record, before the skip set
    st = PolishStats()
    sink = io.BytesIO()
    polish(fa, bam, [yak], cfg, out=sink, host_shard=HostShard(1, 2),
           skip_contigs={"c1"}, stats=st, device="cpu")
    names = [ln[1:].split()[0] for ln in sink.getvalue().splitlines()
             if ln.startswith(b">")]
    assert names == [b"c3", b"c5"]


def test_merge_shards_missing_is_error(tmp_path):
    out = str(tmp_path / "o.fa")
    with open(out + ".shard0", "wb") as f:
        f.write(b">c0 start:0 end:3\nACGT\n")
    with pytest.raises(FileNotFoundError):
        merge_shards(out, 2, ["c0", "c1"])
    with pytest.raises(ValueError):
        merge_shards(out, 1, ["c0", "c1"])  # c1 absent from shards


def test_merge_shards_out_pos(tmp_path):
    out = str(tmp_path / "o.pos")
    with open(out + ".shard0", "wb") as f:
        f.write(b"c0\tA\t0\nc0\tC\t1\n")
    with open(out + ".shard1", "wb") as f:
        f.write(b"c1\tG\t0\n")
    merge_shards(out, 2, ["c0", "c1"], out_pos=True)
    with open(out, "rb") as f:
        assert f.read() == b"c0\tA\t0\nc0\tC\t1\nc1\tG\t0\n"


def test_finalize_shards_barrier_and_merge(tmp_path):
    fa = str(tmp_path / "asm.fa")
    with open(fa, "wb") as f:
        f.write(b">c0\nAAAA\n>c1\nCCCC\n>c2\nGGGG\n")
    out = str(tmp_path / "out.fa")
    with open(out + ".shard0", "wb") as f:
        f.write(b">c0 start:0 end:3\nAAAA\n>c2 start:0 end:3\nGGGG\n")
    with open(out + ".shard1", "wb") as f:
        f.write(b">c1 start:0 end:3\nCCCC\n")
    assert finalize_shards(out, HostShard(1, 2), fa) is False
    assert os.path.exists(out + ".shard1.done")
    assert finalize_shards(out, HostShard(0, 2), fa, timeout_s=10) is True
    with open(out, "rb") as f:
        assert f.read() == (b">c0 start:0 end:3\nAAAA\n>c1 start:0 end:3\n"
                            b"CCCC\n>c2 start:0 end:3\nGGGG\n")
    assert not os.path.exists(out + ".shard0.done")
    assert not os.path.exists(out + ".shard1.done")
    assert finalize_shards(out, HostShard(0, 1), fa) is True  # one process


def test_finalize_shards_timeout(tmp_path):
    fa = str(tmp_path / "asm.fa")
    with open(fa, "wb") as f:
        f.write(b">c0\nAAAA\n")
    out = str(tmp_path / "out.fa")
    with open(out + ".shard0", "wb") as f:
        f.write(b">c0 start:0 end:3\nAAAA\n")
    with pytest.raises(TimeoutError):   # process 1 never completes
        finalize_shards(out, HostShard(0, 2), fa, timeout_s=1.5)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cli_equals_one_process(tmp_path):
    """Two CLI processes on m20 (-t 2 each) meet at the coordinator, each
    polishes its contigs into its shard, process 0 merges: the output
    equals the one-process polish, and the sentinels are gone."""
    out = str(tmp_path / "merged.fa")
    port = _free_port()
    procs = []
    for h in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   NP2_COORDINATOR=f"127.0.0.1:{port}",
                   NP2_NUM_PROCESSES="2", NP2_PROCESS_ID=str(h),
                   NP2_MERGE_TIMEOUT_S="240")
        env.pop("NP2_NO_AUTOMERGE", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nextpolish2_tpu_torch.cli",
             f"{BASE}/m20.bam", f"{BASE}/m20.fa", f"{BASE}/m20.k21.yak",
             "-L", "1000", "-t", "2", "--device", "cpu", "-o", out],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    # the one-process output, made while the two run
    want = io.BytesIO()
    polish(f"{BASE}/m20.fa", f"{BASE}/m20.bam", [f"{BASE}/m20.k21.yak"],
           PolishConfig(min_ctg_len=1000, threads=4), out=want,
           device="cpu")
    errs = []
    for h, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            errs.append(f"process {h}: timed out\n{err.decode()[-2000:]}")
            continue
        if p.returncode != 0:
            errs.append(f"process {h}: rc={p.returncode}\n"
                        f"{err.decode()[-2000:]}")
        elif h == 0:
            assert "merged 2 host shards" in err.decode()
    assert not errs, "\n".join(errs)
    with open(out, "rb") as f:
        merged = f.read()
    assert merged == want.getvalue()
    assert merged.count(b">") == 20
    for h in range(2):
        assert os.path.exists(f"{out}.shard{h}")
        assert not os.path.exists(f"{out}.shard{h}.done")


def test_cli_mesh_stays_off_on_cpu_and_no_coordinator(monkeypatch,
                                                      tmp_path):
    seen = {}

    def fake_polish(*args, host_shard=None, device=None, **kwargs):
        seen.update(mesh=tm.get_active_mesh(), host_shard=host_shard,
                    device=device)

    monkeypatch.setattr(orchestrator, "polish", fake_polish)
    monkeypatch.delenv("NP2_COORDINATOR", raising=False)
    assert init_distributed() == HostShard(0, 1)
    assert cli.main([f"{BASE}/slice.bam", f"{BASE}/slice.fa",
                     f"{BASE}/k21.yak", "--device", "cpu", "--mesh", "4x2",
                     "-o", str(tmp_path / "o.fa")]) == 0
    assert seen == {"mesh": None, "host_shard": None, "device": "cpu"}
    assert not torch.distributed.is_initialized()


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    from nextpolish2_tpu_torch.ops.consensus_cuda import consensus_dp_v2
    from nextpolish2_tpu_torch.utils.timing import profiler_trace

    key = torch.full((2, 8, 4), -1, dtype=torch.int32)
    key[:, :, 0] = 0
    z = torch.zeros(2, dtype=torch.int32)
    with profiler_trace(str(tmp_path / "prof")):
        consensus_dp_v2(key, torch.ones_like(key),
                        torch.ones((2, 8), dtype=torch.int32), z,
                        torch.zeros(2, dtype=torch.uint8), z + 8)
    files = os.listdir(tmp_path / "prof")
    assert files == [f"np2_trace.{os.getpid()}.json"]
    with open(tmp_path / "prof" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::where" for e in events)
