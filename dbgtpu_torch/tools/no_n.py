"""Drop one-line FASTA records whose sequence contains N (noN.py)."""

from __future__ import annotations

import sys
from typing import IO


def no_n(inp: IO[bytes], out: IO[bytes]) -> None:
    header = b""
    for line in inp:
        line = line.rstrip(b"\r\n")
        if line.startswith(b">"):
            header = line
        elif b"N" not in line:
            out.write(header + b"\n" + line + b"\n")


def main(argv: list[str] | None = None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 1:
        print("usage: no_n FASTA", file=sys.stderr)
        return 2
    with open(args[0], "rb") as f:
        no_n(f, sys.stdout.buffer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
