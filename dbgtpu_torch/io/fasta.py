"""Read-file parsing with the reference's acceptance rules.

FASTA (reference getReads, aligner.cpp:70-115):
  - record = header line + all following lines concatenated until the
    next '>' line or EOF,
  - accepted iff len(seq) > 2, every char in {A,C,G,T,N}, and
    len(seq) > k.

FASTQ (reference aligner.cpp:50-69):
  - 4-line records; accepted iff len(seq) > 2 and charset ok (note: the
    reference does NOT apply the len > k rule to fastq).
  - Deliberate deviation (documented in SURVEY.md §4.1.7): the reference
    re-processes the last record when the file lacks a trailing
    newline-terminated 4th line (EOF defect).  We parse correctly.

Rejected reads are silently dropped, like the reference.
"""

from __future__ import annotations

from typing import Iterator, Tuple

_ALLOWED = frozenset(b"ACGTN")


def _charset_ok(seq: bytes) -> bool:
    return not (set(seq) - _ALLOWED)


def iter_fasta(path: str, k: int) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (header_line_without_newline, sequence) for accepted records."""
    header = None
    parts: list[bytes] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if line.startswith(b">"):
                if header is not None:
                    seq = b"".join(parts)
                    if len(seq) > 2 and len(seq) > k and _charset_ok(seq):
                        yield header, seq
                header = line
                parts = []
            else:
                parts.append(line)
        if header is not None:
            seq = b"".join(parts)
            if len(seq) > 2 and len(seq) > k and _charset_ok(seq):
                yield header, seq


def iter_fastq(path: str, k: int) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (header_line, sequence) for accepted 4-line fastq records."""
    with open(path, "rb") as f:
        while True:
            header = f.readline()
            if not header:
                return
            seq = f.readline().rstrip(b"\n")
            plus = f.readline()
            qual = f.readline()
            if not plus or not qual:
                # truncated record: reference behavior here is the EOF
                # defect; we just stop (documented deviation).
                if len(seq) > 2 and _charset_ok(seq):
                    yield header.rstrip(b"\n"), seq
                return
            if len(seq) > 2 and _charset_ok(seq):
                yield header.rstrip(b"\n"), seq


def iter_reads(path: str, k: int, fastq: bool) -> Iterator[Tuple[bytes, bytes]]:
    return iter_fastq(path, k) if fastq else iter_fasta(path, k)
