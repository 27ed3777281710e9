"""Concatenate unitigs longer than L into one `>N` pseudo-reference.

Equivalent of getLargeUnitigs.cpp:40-57 (used by the GGMAP pipeline to
give bowtie2 a target for reads bgreat could not place).  Deviations
from the reference, deliberate: it truncated the last character of
every included line (substr(0, size-1), a CR-stripping off-by-one,
getLargeUnitigs.cpp:50) and applied the length test to header lines
too; we include full sequence lines only.
"""

from __future__ import annotations

import sys


def get_large_unitigs(inp: str, out: str, length: int) -> None:
    with open(inp, "rb") as f, open(out, "wb") as o:
        o.write(b">N\n")
        for line in f:
            line = line.rstrip(b"\r\n")
            if not line.startswith(b">") and len(line) > length:
                o.write(line.upper())
        o.write(b"\n")


def main(argv: list[str] | None = None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 3:
        print("usage: get_large_unitigs IN OUT LENGTH", file=sys.stderr)
        return 2
    get_large_unitigs(args[0], args[1], int(args[2]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
