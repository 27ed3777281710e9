"""Graph construction pipeline: k-mer counting -> unitigs.

Python-3 equivalent of DBGconstruction.py:17-28 (dsk -> dsk2ascii ->
bcalm).  The external tools are not bundled; this wrapper shells out to
whatever is on PATH and fails with a clear message otherwise.  Modern
BCALM2 subsumes the dsk step, so when only `bcalm` is present we run it
directly.
"""

from __future__ import annotations

import shutil
import subprocess
import sys


def have(tool: str) -> bool:
    return shutil.which(tool) is not None


def build_graph_files(
    read_file: str, k: int, min_abundance: int, output: str
) -> None:
    if have("bcalm"):
        # modern bcalm2 counts k-mers itself
        subprocess.run(
            ["bcalm", "-in", read_file, "-kmer-size", str(k),
             "-abundance-min", str(min_abundance), "-out", output],
            check=True,
        )
        return
    if have("dsk") and have("dsk2ascii"):
        subprocess.run(
            ["dsk", "-file", read_file, "-kmer-size", str(k),
             "-abundance-min", str(min_abundance),
             "-max-memory", "5000", "-out", "reads"],
            check=True,
        )
        subprocess.run(
            ["dsk2ascii", "-file", "reads.h5", "-out", "kmers"],
            check=True,
        )
        raise SystemExit(
            "legacy bcalm (v1) required to build unitigs from 'kmers'; "
            "install bcalm2 instead"
        )
    raise SystemExit(
        "no graph construction tool found on PATH (need bcalm, or "
        "dsk + dsk2ascii + legacy bcalm)"
    )


def main(argv: list[str] | None = None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 4:
        print(
            "usage: dbg_construction READS K MIN_ABUNDANCE OUT",
            file=sys.stderr,
        )
        return 2
    build_graph_files(args[0], int(args[1]), int(args[2]), args[3])
    return 0


if __name__ == "__main__":
    sys.exit(main())
