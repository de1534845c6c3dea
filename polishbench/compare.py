"""The comparison that decides `correct`: the polished FASTA of every pass
in the window against the plain reference's, byte for byte.

Each number compared has the limit 0 (an exact comparison):
- passes_differing: passes whose output differs from the reference's;
- contigs_missing: assembly contigs absent from the last pass's output,
  or out of input order;
- contigs_differing: contigs whose bases or coordinates differ;
- bases_differing: over those contigs, positions whose base differs plus
  the difference in length.

One more number holds both polishers to the generator's truth
(truth.py), so that a fault the reference shares with the program shows:
- truth_kmers_missing: distinct 21-mers of the last pass's polished contigs
  that the truth lacks; its limit is set from readings (PERF.md).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

LIMITS = {"passes_differing": 0, "contigs_missing": 0,
          "contigs_differing": 0, "bases_differing": 0,
          "truth_kmers_missing": 300}


def fasta_record(name: str, seq: bytes, start: int, end: int) -> bytes:
    """A record as the polisher writes it (header, then one line)."""
    return f">{name} start:{start} end:{end}\n".encode() + seq + b"\n"


def parse_records(data: bytes) -> List[Tuple[str, int, int, bytes]]:
    """(name, start, end, seq) of each record of the polisher's FASTA."""
    out = []
    lines = data.split(b"\n")
    for i in range(0, len(lines) - 1, 2):
        head = lines[i].decode()
        if not head.startswith(">"):
            raise ValueError(f"not a FASTA header: {head[:80]!r}")
        name, start, end = head[1:].split(" ")
        out.append((name, int(start.split(":")[1]), int(end.split(":")[1]),
                    lines[i + 1]))
    return out


def digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def base_diff(a: bytes, b: bytes) -> int:
    """Positions that differ over the common length, plus the length
    difference."""
    import numpy as np

    n = min(len(a), len(b))
    x = np.frombuffer(a[:n], dtype=np.uint8)
    y = np.frombuffer(b[:n], dtype=np.uint8)
    return int(np.count_nonzero(x != y)) + abs(len(a) - len(b))


def compare(pass_digests: Sequence[str], last_output: bytes,
            contig_order: Sequence[str],
            reference: Dict[str, Tuple[bytes, int, int]],
            truth_seqs: Dict[str, list], polished: Sequence[str]):
    """Returns (correct, failed passes, checks): checks are
    [name, value, limit] in the order of LIMITS. `truth_seqs` is
    truth.read_truth's, `polished` the contigs the polisher polishes."""
    from .truth import kmers_missing

    ref_bytes = b"".join(fasta_record(n, *reference[n]) for n in contig_order)
    ref_digest = digest(ref_bytes)
    failed = sum(1 for d in pass_digests if d != ref_digest)
    got = parse_records(last_output)
    names = [r[0] for r in got]
    missing = sum(1 for i, n in enumerate(contig_order)
                  if i >= len(names) or names[i] != n)
    by_name = {r[0]: r for r in got}
    contigs_diff = bases_diff = 0
    for n in contig_order:
        seq, start, end = reference[n]
        r = by_name.get(n)
        if r is None:
            continue
        if r[3] != seq or r[1] != start or r[2] != end:
            contigs_diff += 1
            bases_diff += base_diff(r[3], seq)
    values = {"passes_differing": failed, "contigs_missing": missing,
              "contigs_differing": contigs_diff, "bases_differing": bases_diff,
              "truth_kmers_missing": kmers_missing(
                  {r[0]: r[3] for r in got}, truth_seqs, polished)}
    checks = [[k, values[k], LIMITS[k]] for k in LIMITS]
    correct = bool(pass_digests) and all(v <= lim for _, v, lim in checks)
    return correct, failed, checks
