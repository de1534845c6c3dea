"""FASTA/FASTQ reading and FASTA writing (gzip-transparent).

Replaces the reference's kseq-based input thread (main.rs:1703-1715) and the
stdout FASTA writer (main.rs:607-645).
"""

from __future__ import annotations

import gzip
from typing import IO, Iterator, Tuple


def _open(path: str) -> IO[bytes]:
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")  # type: ignore[return-value]
    return f


def read_fastx(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, seq) from FASTA or FASTQ (plain or gzipped).

    Name is the first whitespace-delimited token of the header, matching kseq's
    record.head() used by the reference input thread.
    """
    with _open(path) as f:
        first = f.read(1)
        if not first:
            return
        if first == b">":
            name = None
            parts: list[bytes] = []
            for line in _iter_lines(f, first_prefix=b">" ):
                if line.startswith(b">"):
                    if name is not None:
                        yield name, b"".join(parts)
                    name = line[1:].split()[0].decode()
                    parts = []
                else:
                    parts.append(line.strip())
            if name is not None:
                yield name, b"".join(parts)
        elif first == b"@":
            # FASTQ: 4-line records (no multi-line support, like kseq fast path)
            buf = first + f.readline()
            while buf:
                name = buf[1:].split()[0].decode()
                seq = f.readline().strip()
                f.readline()  # +
                f.readline()  # qual
                yield name, seq
                buf = f.readline()
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _iter_lines(f: IO[bytes], first_prefix: bytes) -> Iterator[bytes]:
    rest = f.readline()
    yield first_prefix + rest
    for line in f:
        if line.strip():
            yield line
