"""Base-code tables and sequence codecs (vectorized).

The reference keeps one dual-purpose 128-entry table SEQ_NUM translating
ACGTU-NM -> 0..6 and, at indices 0..6, code -> ASCII (reference src/utils/kmer.rs:11-22).
We split it into two explicit numpy tables; semantics are identical:
    A/a->0  C/c->1  G/g->2  T/t/U/u->3  '-'->4  N/n->5  M/m->6, everything else->4.
"""

from __future__ import annotations

import numpy as np

# code -> ASCII byte, for codes 0..6 (A C G T - N M)
CODE2ASCII = np.frombuffer(b"ACGT-NM", dtype=np.uint8).copy()

# ASCII byte -> code (0..6; 4 for anything unrecognized, matching kmer.rs table)
ASCII2CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT-NM"):
    ASCII2CODE[_b] = _i
for _i, _b in enumerate(b"acgt-nm"):
    ASCII2CODE[_b] = _i
ASCII2CODE[ord("U")] = 3
ASCII2CODE[ord("u")] = 3

# ASCII byte -> complement ASCII byte (reference src/utils/secondary.rs:66-80:
# A/a->T, T/t->A, G/g->C, C/c->G — lowercase folds to the UPPERCASE complement;
# other bytes unchanged)
REVCOMP_ASCII = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ATGCatgc", b"TACGTACG"):
    REVCOMP_ASCII[_a] = _b


def seq_to_codes(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes (0..6)."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    return ASCII2CODE[arr]


def codes_to_seq(codes: np.ndarray) -> bytes:
    """uint8 codes (0..6) -> ASCII bytes."""
    return CODE2ASCII[codes].tobytes()


def revcomp(seq: bytes) -> bytes:
    """Reverse complement of an ASCII sequence (reference secondary.rs:66-80)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return REVCOMP_ASCII[arr][::-1].tobytes()
