"""The port's data-prep and evaluation tools (nextpolish2_tpu_torch/tools/,
pipeline/hifi_align.py) vs the JAX package and the repository's tools/, on
the CPU. Tolerance: exact — the same alignments, the same file bytes (BAM,
.yak, FASTA, .het.tsv) and the same standard output.

One parametrised test per tool. The repository's scripts run as
subprocesses; the port's generators run in this process through main().
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nextpolish2_tpu.pipeline import hifi_align as jal
from nextpolish2_tpu_torch.pipeline import hifi_align as tal
from nextpolish2_tpu_torch.tools import kmer_count as t_kmer_count
from nextpolish2_tpu_torch.tools import make_big_fixture as t_make_big
from nextpolish2_tpu_torch.tools import make_fixture as t_make_fixture
from nextpolish2_tpu_torch.utils.seqcodes import revcomp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "testdata")
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)


def _run(argv, cwd=REPO):
    return subprocess.run(argv, cwd=cwd, env=ENV, capture_output=True,
                          timeout=300)


def _ref_tool(name, *args, cwd=REPO):
    return _run([sys.executable, os.path.join(REPO, "tools", name + ".py"),
                 *args], cwd)


def _port_tool(name, *args, cwd=REPO):
    return _run([sys.executable, "-m", f"nextpolish2_tpu_torch.tools.{name}",
                 *args], cwd)


def _rand_seq(rng, n):
    return bytes(rng.choice(list(b"ACGT"), size=n).astype(np.uint8))


def _mutate(rng, seq: bytes, n_sub: int, indels: int) -> bytes:
    s = bytearray(seq)
    for _ in range(n_sub):
        p = int(rng.integers(len(s)))
        s[p] = int(rng.choice(list(b"ACGT")))
    for _ in range(indels):
        p = int(rng.integers(50, len(s) - 50))
        if rng.random() < 0.5:
            s[p:p] = _rand_seq(rng, int(rng.integers(1, 4)))
        else:
            del s[p : p + int(rng.integers(1, 4))]
    return bytes(s)


def _aligner_cases():
    """(target, reads) with seeded reads: forward, reverse-complement,
    with indels, running off either end of the target (soft clips), with
    random bases before or after a stretch inside it (the semi-global end
    patches), and one that maps nowhere."""
    rng = np.random.default_rng(31)
    target = _rand_seq(rng, 6000)
    reads = {
        "forward": target[1000:3500],
        "reverse": revcomp(target[2000:4200]),
        "indels": _mutate(rng, target[500:3000], 6, 6),
        "reverse_indels": revcomp(_mutate(rng, target[3000:5800], 4, 5)),
        "clip_start": _rand_seq(rng, 120) + target[0:2000],
        "clip_end": target[4500:6000] + _rand_seq(rng, 90),
        "free_start": _rand_seq(rng, 30) + target[1000:3000],
        "free_end": target[3000:5000] + _rand_seq(rng, 40),
        "head_patch": _mutate(rng, target[200:260], 3, 0) + target[260:2600],
        "unmapped": _rand_seq(rng, 1500),
    }
    return target, reads


def _result_tuple(r):
    return None if r is None else (r.pos, r.cigar, r.reverse, r.nmatch)


@pytest.mark.parametrize("case", ["forward", "reverse", "indels",
                                  "reverse_indels", "clip_start", "clip_end",
                                  "free_start", "free_end", "head_patch",
                                  "unmapped", "edit_align"])
def test_aligner_matches_jax(case):
    target, reads = _aligner_cases()
    if case == "edit_align":
        rng = np.random.default_rng(32)
        for i in range(12):
            t = _rand_seq(rng, int(rng.integers(0, 40)))
            q = _mutate(rng, t, 2, 0) if len(t) > 2 else _rand_seq(rng, 5)
            fs, fe = bool(i & 1), bool(i & 2)
            assert tal._edit_align(q, t, fs, fe) == jal._edit_align(q, t, fs,
                                                                    fe)
        return
    got = tal.align_read(tal.TargetIndex.build(target), target, reads[case])
    want = jal.align_read(jal.TargetIndex.build(target), target, reads[case])
    assert _result_tuple(got) == _result_tuple(want)
    assert (got is None) == (case == "unmapped")
    if case.startswith("reverse"):
        assert got.reverse


def test_align_to_bam_bytes_match_jax(tmp_path):
    target, reads = _aligner_cases()
    rng = np.random.default_rng(33)
    targets = [("t0", target), ("t1", _rand_seq(rng, 3000))]
    named = [(f"r_{k}", v) for k, v in reads.items()]
    named.append(("r_t1", revcomp(targets[1][1][400:2400])))
    n_t = tal.align_to_bam(targets, named, str(tmp_path / "port.bam"))
    n_j = jal.align_to_bam(targets, named, str(tmp_path / "jax.bam"))
    assert n_t == n_j == len(named) - 1
    assert (tmp_path / "port.bam").read_bytes() == \
        (tmp_path / "jax.bam").read_bytes()

    # the command-line tools: FASTA files in, BAM and stderr line out
    def fa(path, recs):
        with open(path, "wb") as f:
            for n, s in recs:
                f.write(b">" + n.encode() + b"\n" + s + b"\n")

    fa(tmp_path / "asm.fa", targets)
    fa(tmp_path / "reads.fa", named)
    for tool, out in ((_port_tool, "p.bam"), (_ref_tool, "j.bam")):
        res = tool("align", "asm.fa", "reads.fa", out, cwd=tmp_path)
        assert res.returncode == 0, res.stderr
        assert res.stderr.endswith(
            f"mapped {n_t}/{len(named)} reads -> {out}\n".encode())
    assert (tmp_path / "p.bam").read_bytes() == \
        (tmp_path / "port.bam").read_bytes()
    assert (tmp_path / "j.bam").read_bytes() == \
        (tmp_path / "port.bam").read_bytes()


@pytest.mark.parametrize("args", [["-k", "21", "-k", "31"],
                                  ["-k", "17", "--rounds", "3"]])
def test_kmer_count_yak_bytes_match_jax(tmp_path, args):
    rng = np.random.default_rng(34)
    genome = _rand_seq(rng, 30000)
    with open(tmp_path / "reads.fq", "wb") as f:
        for i in range(120):
            st = int(rng.integers(0, len(genome) - 2000))
            r = _mutate(rng, genome[st : st + 2000], 3, 0)
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)))
    with open(tmp_path / "more.fa", "wb") as f:
        f.write(b">x\n" + genome[:5000].replace(b"A", b"N", 3) + b"\n")
    reads = ["reads.fq", "more.fa"]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert t_kmer_count.main([*args, "-o", "port", *reads]) == 0
    finally:
        os.chdir(cwd)
    res = _ref_tool("kmer_count", *args, "-o", "jax", *reads, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    for k in (v for a, v in zip(args, args[1:]) if a == "-k"):
        port = (tmp_path / f"port.k{k}.yak").read_bytes()
        assert port == (tmp_path / f"jax.k{k}.yak").read_bytes()
        assert len(port) > 4096


FIXTURES = {
    "make_fixture": ["--contigs", "1", "--size", "20000", "--cov", "8",
                     "--seed", "3"],
    "make_fixture_het": ["--contigs", "2", "--size", "15000", "--cov", "8",
                         "--seed", "4", "--het-rate", "0.002"],
    "make_big_fixture": ["--contigs", "1", "--size", "20000", "--small", "1",
                         "--small-size", "5000", "--cov", "8", "--seed", "5"],
    "make_big_fixture_het": ["--contigs", "1", "--size", "20000", "--small",
                             "0", "--cov", "8", "--seed", "6", "--het-bp",
                             "500", "--repeats", "1", "--repeat-len", "2000",
                             "-k", "17"],
}


@pytest.mark.parametrize("case", list(FIXTURES))
def test_fixture_files_match_jax_tool(tmp_path, case):
    tool = case.removesuffix("_het")
    args = FIXTURES[case]
    main = {"make_fixture": t_make_fixture.main,
            "make_big_fixture": t_make_big.main}[tool]
    assert main([str(tmp_path / "port" / "fx"), *args]) == 0
    res = _ref_tool(tool, str(tmp_path / "jax" / "fx"), *args)
    assert res.returncode == 0, res.stderr
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    k = args[args.index("-k") + 1] if "-k" in args else "21"
    want = {"fx.bam", "fx.fa", "fx.truth.fa", f"fx.k{k}.yak"}
    if case.endswith("_het"):
        want.add("fx.het.tsv")
    assert set(names) == want
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port", tmp_path / "jax", names, shallow=False)
    assert match == names, (mismatch, errors)


def _write_shards(tmp_path, truth: str, out_pos: bool):
    """Two shards of a polished output whose contigs are split between the
    processes out of order, for merge_shards."""
    from nextpolish2_tpu_torch.io.fastx import read_fastx

    recs = list(read_fastx(os.path.join(DATA, truth)))
    order = np.random.default_rng(35).permutation(len(recs))
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        for h in range(2):
            with open(tmp_path / d / f"out.fa.shard{h}", "wb") as f:
                for i in order[h::2]:
                    name, seq = recs[i]
                    if out_pos:
                        for p in range(0, 40, 7):
                            f.write(f"{name}\t{chr(seq[p])}\t{p}\n".encode())
                    else:
                        f.write(b">" + name.encode() + b"\n" + seq + b"\n")


def _louvain_edges(path):
    """Two communities of 6 reads, positive weights inside, negative
    between, and a loose node."""
    rng = np.random.default_rng(36)
    with open(path, "w") as f:
        for a in range(13):
            for b in range(a + 1, 13):
                same = (a < 6) == (b < 6) and a != 12 and b != 12
                w = float(rng.integers(1, 5)) if same else -float(
                    rng.integers(1, 3))
                if a == 12 and rng.random() < 0.6:
                    continue
                f.write(f"x {a} {b} {w}\nx {b} {a} {w}\n")


def _switch_inputs(tmp_path):
    """A diploid fixture (port generator) and a polished file that keeps
    hap1 at some sites, carries the hap2 allele at others and loses one."""
    assert t_make_fixture.main([str(tmp_path / "d"), "--contigs", "1",
                                "--size", "20000", "--cov", "6", "--seed",
                                "9", "--het-rate", "0.002"]) == 0
    from nextpolish2_tpu_torch.io.fastx import read_fastx

    name, seq = next(iter(read_fastx(str(tmp_path / "d.truth.fa"))))
    rows = [ln.split("\t") for ln in
            (tmp_path / "d.het.tsv").read_text().splitlines()]
    s = bytearray(seq)
    for i, (_n, pos, _a1, a2) in enumerate(rows):
        if i % 3 == 1:
            s[int(pos)] = ord(a2)
        elif i == 5:
            s[int(pos) - 3] = ord("A") if s[int(pos) - 3] != ord("A") \
                else ord("C")
    with open(tmp_path / "pol.fa", "wb") as f:
        f.write(b">" + name.encode() + b"\n" + bytes(s) + b"\n")
    return [str(tmp_path / "pol.fa"), str(tmp_path / "d.truth.fa"),
            str(tmp_path / "d.het.tsv")]


def _data(*names):
    return [os.path.join(DATA, n) for n in names]


TOOL_RUNS = {
    "check_against_truth_oracle": ("check_against_truth", lambda t: _data(
        "slice.golden.fa", "slice.golden.fa") + ["--oracle-spot"] + _data(
        "slice.bam", "slice.fa", "k21.yak") + ["1"]),
    "check_against_truth_mismatch": ("check_against_truth", lambda t: _data(
        "m20.fa", "m20.truth.fa")),
    "merge_shards": ("merge_shards", lambda t: ["out.fa", "2"] + _data(
        "m20.fa")),
    "merge_shards_out_pos": ("merge_shards", lambda t: ["out.fa", "2"]
                             + _data("m20.fa") + ["--out_pos"]),
    "remove_low_depth": ("remove_low_depth", lambda t: _data(
        "slice.fa", "slice.bam") + ["-d", "3", "-l", "1000"]),
    "remove_low_depth_m20": ("remove_low_depth", lambda t: _data(
        "m20.fa", "m20.bam") + ["-d", "25", "-l", "300"]),
    "phasing_debug": ("phasing_debug", lambda t: _data(
        "slice.bam", "slice.fa", "k21.yak") + ["-L", "1000"]),
    "louvain_check": ("louvain_check", lambda t: [str(t / "edges.txt")]),
    "switch_eval": ("switch_eval", _switch_inputs),
}


@pytest.mark.parametrize("case", list(TOOL_RUNS))
def test_tool_output_matches_jax_tool(tmp_path, case):
    tool, make_args = TOOL_RUNS[case]
    if tool == "merge_shards":
        _write_shards(tmp_path, "m20.truth.fa", case.endswith("out_pos"))
    if tool == "louvain_check":
        _louvain_edges(tmp_path / "edges.txt")
    args = make_args(tmp_path)
    cwd = {d: (tmp_path / d if tool == "merge_shards" else REPO)
           for d in ("port", "jax")}
    port = _port_tool(tool, *args, cwd=cwd["port"])
    ref = _ref_tool(tool, *args, cwd=cwd["jax"])
    assert port.returncode == ref.returncode, (port.stderr, ref.stderr)
    assert port.stdout == ref.stdout
    if tool == "merge_shards":
        assert port.stderr == ref.stderr
        merged = (tmp_path / "port" / "out.fa").read_bytes()
        assert merged == (tmp_path / "jax" / "out.fa").read_bytes()
        assert merged.count(b"\n") >= 20
    else:
        assert port.stdout, port.stderr
    if tool in ("check_against_truth", "switch_eval"):
        assert ref.returncode == {"check_against_truth_oracle": 0}.get(
            case, 1)
