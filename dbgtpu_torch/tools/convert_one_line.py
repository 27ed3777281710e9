"""Join multi-line FASTA records onto one line (convertOneLineFasta.py)."""

from __future__ import annotations

import sys
from typing import IO


def convert(inp: IO[bytes], out: IO[bytes]) -> None:
    seq = b""
    for line in inp:
        line = line.rstrip(b"\r\n")
        if line.startswith(b">"):
            if seq:
                out.write(seq + b"\n")
            out.write(line + b"\n")
            seq = b""
        else:
            seq += line
    out.write(seq + b"\n")


def main(argv: list[str] | None = None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 1:
        print("usage: convert_one_line FASTA", file=sys.stderr)
        return 2
    with open(args[0], "rb") as f:
        convert(f, sys.stdout.buffer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
