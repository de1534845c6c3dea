"""The generator copy: the same seed gives the same bytes, every seed the
same sizes, and each read's CIGAR re-derives the assembly."""

import gzip
import os
import struct
import sys

import numpy as np
import pytest

from polishbench.spec import BENCH_DIR

sys.path.insert(0, os.path.join(BENCH_DIR, "gen"))
import fixture  # noqa: E402
import seqio  # noqa: E402

from conftest import READ_ERRORS  # noqa: E402

TRAFFIC = {"contigs": [20000, 26000], "passthrough": [4000], "err_bp": 1500,
           "het_bp": 800, "repeats": 1, "repeat_len": 2000, "cov": 10,
           "read_len": 4000, "read_errors": READ_ERRORS, "kmer_cov": 30}
NO_READ_ERRORS = dict(READ_ERRORS, sub=0.0, ins=0.0, **{"del": 0.0})
FILES = ("asm.fa", "truth.fa", "reads.bam", "k21.yak", "k31.yak", "het.tsv")


def _read(d, name):
    with open(os.path.join(d, name), "rb") as f:
        return f.read()


def test_same_seed_same_bytes_other_seed_same_sizes(tmp_path):
    a = fixture.generate(TRAFFIC, [21, 31], 2**31 + 11, str(tmp_path / "a"))
    b = fixture.generate(TRAFFIC, [21, 31], 2**31 + 11, str(tmp_path / "b"))
    c = fixture.generate(TRAFFIC, [21, 31], 7, str(tmp_path / "c"))
    for f in FILES:
        assert _read(tmp_path / "a", f) == _read(tmp_path / "b", f), f
    assert _read(tmp_path / "a", "asm.fa") != _read(tmp_path / "c", "asm.fa")
    for k in ("errors", "het_sites", "contigs"):
        assert a[k] == c[k], k
    assert a["reads"] == b["reads"]
    assert [abs(x - y) <= a["errors"] for x, y in
            zip(a["asm_lengths"], c["asm_lengths"])] == [True] * 3


def _records(path):
    """(qname, tid, pos, cigar ops, seq) of every BAM record."""
    with gzip.open(path, "rb") as f:
        data = f.read()
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4 + l_name + 4
    out = []
    codes = b"=ACMGRSVTWYHKDBN"
    while off < len(data):
        (bs,) = struct.unpack_from("<i", data, off)
        rec = data[off + 4: off + 4 + bs]
        off += 4 + bs
        tid, pos, l_name, _, _, n_cig, _, l_seq = struct.unpack_from(
            "<iiBBHHHi", rec, 0)
        qname = rec[32: 32 + l_name - 1].decode()
        p = 32 + l_name
        cig = [(c & 0xF, c >> 4) for c in struct.unpack_from(
            f"<{n_cig}I", rec, p)]
        p += 4 * n_cig
        packed = rec[p: p + (l_seq + 1) // 2]
        seq = bytes(codes[x] for b in packed for x in (b >> 4, b & 0xF))
        out.append((qname, tid, pos, cig, seq[:l_seq]))
    return out


def test_cigars_rederive_the_assembly(tmp_path):
    """With error-free haploid reads, walking each read's CIGAR over the
    assembly uses every read base and no assembly base twice, and finds
    one mismatch, I or D column per assembly error inside the read's truth
    span: the edits the generator drew for that contig (redrawn here from
    the seed for contig 0, as the generator draws them)."""
    t = dict(TRAFFIC, het_bp=0, read_errors=NO_READ_ERRORS, repeats=0)
    d = str(tmp_path / "h")
    fixture.generate(t, [21], 5, d)
    rng = np.random.default_rng(5)
    size0 = t["contigs"][0]
    fixture.BASES[rng.integers(0, 4, size=size0)]
    epos, _, _ = fixture.make_edits(rng, size0, t["err_bp"])
    asm = [l for l in _read(d, "asm.fa").split(b"\n") if l and l[0:1] != b">"]
    n = 0
    for qname, tid, pos, cig, seq in _records(os.path.join(d, "reads.bam")):
        a = asm[tid]
        q, r, cols = 0, pos, 0
        for op, ln in cig:
            if op == 0:
                x = np.frombuffer(seq[q:q + ln], np.uint8)
                y = np.frombuffer(a[r:r + ln], np.uint8)
                cols += int(np.count_nonzero(x != y))
                q, r = q + ln, r + ln
            elif op == 1:
                cols, q = cols + ln, q + ln
            elif op == 2:
                cols, r = cols + ln, r + ln
            elif op == 4:
                q += ln
        assert q == len(seq) and r <= len(a)
        if tid == 0:
            ra = int(qname.rsplit("_", 1)[1])
            rb = ra + len(seq)
            inside = int(np.count_nonzero((epos > ra) & (epos < rb - 1)))
            edge = int(np.count_nonzero((epos >= ra) & (epos < rb)))
            assert inside <= cols <= edge, (qname, cols, inside, edge)
            n += 1
    assert n > 0


def _walk(cig, seq, a, pos):
    """Mismatch columns, I and D operations of a CIGAR walked over the
    assembly; asserts that it uses every read base."""
    q, r, cols = 0, pos, [0, 0, 0]
    for op, ln in cig:
        if op == 0:
            x = np.frombuffer(seq[q:q + ln], np.uint8)
            y = np.frombuffer(a[r:r + ln], np.uint8)
            cols[0] += int(np.count_nonzero(x != y))
            q, r = q + ln, r + ln
        elif op == 1:
            cols[1] += 1
            q += ln
        elif op == 2:
            cols[2] += 1
            r += ln
        elif op == 4:
            q += ln
    assert q == len(seq) and r <= len(a)
    assert cig[0][0] in (0, 4) and cig[-1][0] in (0, 4)
    return cols


def test_read_errors_keep_the_cigars_exact(tmp_path):
    """With the measured HiFi errors and one assembly error a contig, each
    read's CIGAR walks its bases over the assembly with mismatches,
    insertions and deletions at the rates the traffic states."""
    t = dict(TRAFFIC, het_bp=0, err_bp=10**9, repeats=0, cov=30)
    d = str(tmp_path / "e")
    fixture.generate(t, [21], 2**31 + 5, d)
    asm = [l for l in _read(d, "asm.fa").split(b"\n") if l and l[0:1] != b">"]
    tot, n = np.zeros(3), 0
    for _, tid, pos, cig, seq in _records(os.path.join(d, "reads.bam")):
        tot += _walk(cig, seq, asm[tid], pos)
        n += len(seq)
    for got, k in zip(tot / n, ("sub", "ins", "del")):
        assert got == pytest.approx(READ_ERRORS[k], rel=0.25), k


def test_read_profile_measures_what_the_generator_drew(tmp_path):
    """read_profile.py, run on generated reads, gives back the traffic's
    per-base rates."""
    sys.path.insert(0, os.path.join(BENCH_DIR, "gen"))
    import read_profile

    t = dict(TRAFFIC, contigs=[120000], passthrough=[], het_bp=0,
             err_bp=10**9, repeats=0, cov=30, read_len=6000)
    d = str(tmp_path / "p")
    fixture.generate(t, [21], 2**31 + 9, d)
    got = read_profile.profile(os.path.join(d, "reads.bam"))
    for k in ("sub", "ins", "del"):
        assert got[k] == pytest.approx(READ_ERRORS[k], rel=0.25), k
    assert got["del_hp"] == pytest.approx(READ_ERRORS["del_hp"], abs=0.1)
    assert got["measured"]["het_snp_columns"] == 0


def test_yak_tables_count_the_truth(tmp_path):
    d = str(tmp_path / "y")
    meta = fixture.generate(dict(TRAFFIC, het_bp=0), [21], 9, d)
    truth = [l for l in _read(d, "truth.fa").split(b"\n")
             if l and l[0:1] != b">"]
    h, c = seqio.count_kmers(truth, 21)
    raw = _read(d, "k21.yak")
    assert raw[:4] == b"YAK\x02"
    n = 0
    off = 16
    for _ in range(1 << 10):
        (size,) = struct.unpack_from("<I", raw, off + 4)
        off += 8 + 8 * size
        n += size
    assert n == len(h) == meta["distinct_kmers"]["21"]


def test_canonical_kmers_window_by_window():
    rng = np.random.default_rng(3)
    s = bytes(np.frombuffer(b"ACGTN", np.uint8)[
        rng.choice(5, size=3000, p=[.24, .24, .24, .24, .04])])
    comp = {ord("A"): 3, ord("C"): 2, ord("G"): 1, ord("T"): 0}
    code = {ord("A"): 0, ord("C"): 1, ord("G"): 2, ord("T"): 3}
    for k in (1, 2, 5, 16, 21, 31):
        want = []
        for j in range(k - 1, len(s)):
            w = s[j - k + 1: j + 1]
            if b"N" in w:
                continue
            f = r = 0
            for t, b in enumerate(w):
                f = (f << 2) | code[b]
                r |= comp[b] << (2 * t)
            want.append(min(f, r))
        got = seqio.canonical_kmers(s, k)
        assert got.tolist() == want, k
