"""GGMAP: map reads on the graph, then rescue leftovers with bowtie2.

Python-3 equivalent of GGMAP.py:18-26 (which is broken as shipped — it
references an undefined `k`, GGMAP.py:19).  Phase 1 runs the dbgtpu_torch
mapper in-process (on the GPU; without one it stops there); phase 2
builds the large-unitig pseudo-reference and maps `notAligned.fa` with
bowtie2 when it is installed.
"""

from __future__ import annotations

import shutil
import subprocess
import sys

from .get_large_unitigs import get_large_unitigs


def main(argv: list[str] | None = None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) < 3:
        print(
            "usage: ggmap READS UNITIGS K [MIN_UNITIG_LEN=100]",
            file=sys.stderr,
        )
        return 2
    reads, unitigs, k = args[0], args[1], int(args[2])
    min_len = int(args[3]) if len(args) > 3 else 100

    from .. import cli

    print("PHASE 1 : map reads on graph")
    rc = cli.main(["-r", reads, "-g", unitigs, "-k", str(k)])
    if rc:
        return rc

    print("PHASE 2 : map leftovers on big unitigs with bowtie2")
    get_large_unitigs(unitigs, "big.fa", min_len)
    if shutil.which("bowtie2") and shutil.which("bowtie2-build"):
        subprocess.run(
            ["bowtie2-build", "big.fa", "index", "-q"], check=True
        )
        subprocess.run(
            ["bowtie2", "-f", "--very-fast", "-x", "index",
             "-U", "notAligned.fa", "-t", "-S", "out.sam"],
            check=True,
        )
    else:
        print(
            "bowtie2 not on PATH; wrote big.fa, skipping rescue mapping",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
