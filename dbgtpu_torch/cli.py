"""bgreat-compatible command line of the torch port.

Takes dbgtpu's flags for mapping on one device:
  -r reads (comma-separated), -k k, -g unitigs, -m mismatches,
  -t threads (accepted; batching replaces it), -e effort, -f paths
  file, -a notAligned file, -q fastq, -c correction, -G anchor (dog)
  mode, -b exhaustive mode, -i partial (with -b), --batch-size,
  --json-summary, --index-layout scan|mphf, and --device (where the
  kernels run; default cuda).
As in dbgtpu, -b wins over -G, and -i affects only -b.  The flags of
features outside the port (path modes, meshes, persistence, ...) are
recognised and refused with exit code 2, naming the flag.  Without a
GPU the command stops unless `--device cpu` asks for the plain torch
versions of the kernels.
"""

from __future__ import annotations

import argparse
import sys

# dbgtpu flags whose engines lie outside this port: (option strings,
# argparse keywords)
_REFUSED = (
    (("-p",), dict(action="store_true")),
    (("--mesh",), dict()),
    (("--shard-index",), dict(action="store_true")),
    (("--num-processes",), dict()),
    (("--coordinator",), dict()),
    (("--merge-shards",), dict()),
    (("--save-index",), dict()),
    (("--load-index",), dict()),
    (("--resume",), dict(action="store_true")),
    (("--profile-dir",), dict()),
)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dbgtpu_torch",
        description="de Bruijn graph read mapper (BGREAT-compatible), "
        "PyTorch and CUDA port of dbgtpu: greedy, anchor (-G) and "
        "exhaustive (-b) modes, scan and mphf index layouts, one device",
    )
    p.add_argument("-r", dest="reads", required=True,
                   help="read file(s), comma separated")
    p.add_argument("-k", dest="k", type=int, default=30, help="k value (30)")
    p.add_argument("-g", dest="unitigs", default="unitig.fa",
                   help="unitig file (unitig.fa)")
    p.add_argument("-m", dest="mismatches", type=int, default=2,
                   help="allowed mismatches (2)")
    p.add_argument("-t", dest="threads", type=int, default=1,
                   help="accepted for compatibility; device batching "
                        "replaces host threads")
    p.add_argument("-e", dest="effort", type=int, default=2,
                   help="mapping effort / anchors tried (2)")
    p.add_argument("-f", dest="paths_file", default="paths",
                   help="paths output file (paths)")
    p.add_argument("-a", dest="not_aligned_file", default="notAligned.fa",
                   help="not-aligned output file (notAligned.fa)")
    p.add_argument("-q", dest="fastq", action="store_true",
                   help="fastq input")
    p.add_argument("-c", dest="correction", action="store_true",
                   help="output corrected reads instead of paths")
    p.add_argument("-G", dest="dog_mode", action="store_true",
                   help="anchor (dog) mode: whole k-mer anchors")
    p.add_argument("-b", dest="exhaustive", action="store_true",
                   help="exhaustive (branch-and-bound) mode")
    p.add_argument("-i", dest="partial", action="store_true",
                   help="with -b: accept partial alignments")
    p.add_argument("--batch-size", type=int, default=32768,
                   help="reads per device batch (32768)")
    p.add_argument("--json-summary", metavar="FILE",
                   help="write a structured run summary (JSON)")
    p.add_argument("--index-layout", choices=["scan", "mphf"],
                   default="scan",
                   help="junction index layout: 'scan' (one-row lookups) "
                        "or 'mphf' (compact minimal perfect hash; MPHF "
                        "dog anchors at any keyset size)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the kernels (cuda); 'cpu' runs "
                        "their plain torch versions")
    for flags, kw in _REFUSED:
        p.add_argument(*flags, dest="refused_" + flags[0].lstrip("-")
                       .replace("-", "_"), default=None,
                       help=argparse.SUPPRESS, **kw)
    return p


def main(argv: list[str] | None = None) -> int:
    parser = make_parser()
    args = parser.parse_args(argv)
    for flags, _ in _REFUSED:
        val = getattr(args, "refused_" + flags[0].lstrip("-")
                      .replace("-", "_"))
        if val not in (None, False):
            print(f"dbgtpu_torch: {flags[0]} needs an engine outside this "
                  "port (greedy, -G and -b modes, one device); "
                  "use dbgtpu", file=sys.stderr)
            return 2
    if not 2 <= args.k <= 32:
        parser.error(
            f"-k {args.k} is out of range: supported k is 2..32 "
            "(kmers are 64-bit, as in the reference)"
        )

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("dbgtpu_torch: no CUDA device is available; pass "
              "--device cpu to run the plain torch kernels on the CPU",
              file=sys.stderr)
        return 1

    from .pipeline import run_pipeline

    reads_files = args.reads.split(",")
    mode = ("exhaustive" if args.exhaustive
            else "anchors" if args.dog_mode else "greedy")
    paths, na, stats = run_pipeline(
        reads_files, args.unitigs, k=args.k, m=args.mismatches,
        effort=args.effort, fastq=args.fastq,
        correction=args.correction, batch_size=args.batch_size,
        device=device, mode=mode, partial=args.partial,
        index_layout=args.index_layout,
    )
    with open(args.paths_file, "wb") as f:
        f.write(paths)
    with open(args.not_aligned_file, "wb") as f:
        f.write(na)
    print(f"Indexing in seconds : {int(stats.index_seconds)}")
    for rf in reads_files:
        print(rf)
    sys.stdout.write(stats.summary())
    if args.json_summary:
        import json

        with open(args.json_summary, "w") as f:
            json.dump(stats.as_dict(), f, indent=2)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
