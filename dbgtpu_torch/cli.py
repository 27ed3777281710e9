"""bgreat-compatible command line of the torch port.

Takes dbgtpu's flags:
  -r reads (comma-separated), -k k, -g unitigs, -m mismatches,
  -t threads (accepted; batching replaces it), -e effort, -f paths
  file, -a notAligned file, -q fastq, -c correction, -G anchor (dog)
  mode, -b exhaustive mode, -i partial (with -b), -p path mode (with -b:
  exhaustive path mode), --impl auto|jax|python, --batch-size,
  --json-summary, --index-layout scan|mphf, --save-index / --load-index
  (a persisted index; -g and -k are then ignored), --resume (journaled
  run), --progress N, --num-processes / --process-id (this process maps
  its share of every input file and writes <out>.shard<id>),
  --coordinator HOST:PORT (with --num-processes > 1: the processes join
  one torch.distributed group, gloo over TCP, and process 0 prints the
  stats block summed over all of them; the others print none, and each
  writes its --json-summary, process 0's with the sums), --merge-shards
  N, --mesh N (each batch split over the first N local devices, -1 all;
  on the CPU, N shards), --shard-index (with --mesh: the junction and
  probe tables cut over the mesh's devices), --profile-dir DIR (a
  torch.profiler Chrome trace of the whole run, CPU activity and, on a
  card, CUDA activity, with the program's spans (spans.py) of both host
  threads on its clock, written into DIR), and --device (where the
  kernels run; default cuda).
As in dbgtpu, -p wins over -b, -b over -G, and -i affects only -b and -p.
`--impl python` runs every mode on the host spec; `auto` and `jax` run
the device modes' kernels.  The path modes have no device engine: they
run on the host spec too.  A run on the host spec launches no kernel and
reports `"device": "host-spec"` in --json-summary; `--resume` refuses
`--impl python`, as dbgtpu does.
dbgtpu's multi-device flags take its types and defaults.  `--shard-index`
without a mesh changes nothing; with one, of any size, it takes dbgtpu's
guards (greedy mode, the scan layout, row counts the device count
divides) and fails with dbgtpu's ValueError outside them; over more than
one device each card holds its range of the two tables and reads the
others' through peer access (on the CPU, N row ranges).  `--coordinator`
with one process changes nothing; `--resume` refuses more than one
process, as dbgtpu does.  Without a GPU the command stops unless
`--device cpu` asks for the plain torch versions of the kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dbgtpu_torch",
        description="de Bruijn graph read mapper (BGREAT-compatible), "
        "PyTorch and CUDA port of dbgtpu: greedy, anchor (-G) and "
        "exhaustive (-b) modes on a device or a mesh of local devices, "
        "path modes (-p) on the host, scan and mphf index layouts, "
        "persisted, resumable and coordinated runs",
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
    p.add_argument("-p", dest="paths_mode", action="store_true",
                   help="simple-path mode (with -b: exhaustive path "
                        "mode); runs on the host spec, no kernel")
    p.add_argument("--impl", choices=["auto", "python", "jax"],
                   default="auto",
                   help="alignment engine: auto (default) and jax run the "
                        "device kernels, python the executable spec on the "
                        "host (no kernel)")
    p.add_argument("--batch-size", type=int, default=32768,
                   help="reads per device batch (32768)")
    p.add_argument("--save-index", metavar="FILE",
                   help="persist the built index (npz) and continue")
    p.add_argument("--load-index", metavar="FILE",
                   help="load a persisted index instead of rebuilding "
                        "(-g/-k are then ignored)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="total processes of a sharded run; this process "
                        "maps a contiguous record range of every input "
                        "file and writes <out>.shard<process-id>")
    p.add_argument("--process-id", type=int, default=0,
                   help="this process's id in a sharded run")
    p.add_argument("--merge-shards", type=int, default=0, metavar="N",
                   help="merge <paths>.shard0..N-1 and "
                        "<notAligned>.shard0..N-1 written by a sharded "
                        "run, then exit")
    p.add_argument("--progress", type=int, default=0, metavar="N",
                   help="print a stats line to stderr every N completed "
                        "device batches (reads done, aligned count/%%, "
                        "reads/s), and the index-build phase log")
    p.add_argument("--resume", action="store_true",
                   help="journaled run: append output per segment and "
                        "record (file, read offset) in "
                        "<paths>.resume.json; the same command with "
                        "--resume after a crash continues mid-file and "
                        "writes the bytes of an uninterrupted run")
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
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="split each batch over the first N local devices "
                        "(-1: all; 0: no mesh, the default); the index is "
                        "replicated unless --shard-index; with --device "
                        "cpu, N shards")
    p.add_argument("--shard-index", action="store_true",
                   help="with --mesh: cut the junction and probe tables "
                        "into one bucket range per device (greedy mode, "
                        "scan layout; cards read each other's ranges "
                        "through peer access); without a mesh it changes "
                        "nothing")
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="with --num-processes > 1: join the processes "
                        "into one torch.distributed group (gloo, TCP; "
                        "environment fallbacks JAX_COORDINATOR, "
                        "JAX_NUM_PROCESSES, JAX_PROCESS_ID) and print one "
                        "global stats block, on process 0")
    p.add_argument("--profile-dir", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the "
                        "mapping call into DIR")
    return p


def _finish(args, reads_files, stats, print_summary=True) -> int:
    """The stats block on stdout, unless `print_summary` is false (a
    coordinated run's processes other than 0), and --json-summary on
    every process, as dbgtpu writes them (dbgtpu/cli.py:285-295)."""
    if print_summary:
        print(f"Indexing in seconds : {int(stats.index_seconds)}")
        for rf in reads_files:
            print(rf)
        sys.stdout.write(stats.summary())
    if args.json_summary:
        with open(args.json_summary, "w") as f:
            json.dump(stats.as_dict(), f, indent=2)
            f.write("\n")
    return 0


@contextlib.contextmanager
def _profiled(profile_dir: str | None, device, spans):
    """The run's root span, `job`; with `profile_dir`, torch.profiler
    over it (CPU activity, and CUDA activity on a card) inside a
    `dbgtpu.job` range, its Chrome trace written into `profile_dir` as
    dbgtpu_torch.<pid>.pt.trace.json with the run's spans added
    (`_add_spans`)."""
    if not profile_dir:
        with spans.span("job"):
            yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with torch.profiler.record_function("dbgtpu.job"), \
                spans.span("job") as job:
            yield
    path = os.path.join(profile_dir,
                        f"dbgtpu_torch.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, spans, job.start)


def _add_spans(path: str, spans, job_start: float) -> None:
    """Adds the closed spans of `spans` to the Chrome trace at `path` as
    complete events (category `dbgtpu`, one thread row per host thread,
    the batch, the card and the span's counters as arguments), shifted
    onto the trace's clock by the one offset between the `dbgtpu.job`
    range's start there and the `job` span's start, which open together
    (a few microseconds apart)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    job = next(e for e in events if e.get("name") == "dbgtpu.job"
               and e.get("ph") == "X"
               and not e.get("cat", "").startswith("gpu"))
    offset_us = float(job["ts"]) - job_start * 1e6
    tids = {"main": job["tid"], "drain": spans.tids.get("drain")}
    if tids["drain"] is not None:
        events.append({"ph": "M", "name": "thread_name", "pid": job["pid"],
                       "tid": tids["drain"],
                       "args": {"name": "dbgtpu drain"}})
    for (name, thread, batch, card, start, end, _, _,
         counters) in spans.trace()["spans"]:
        events.append({
            "ph": "X", "cat": "dbgtpu", "name": name,
            "pid": job["pid"], "tid": tids[thread],
            "ts": start * 1e6 + offset_us, "dur": (end - start) * 1e6,
            "args": {"batch": batch, "card": card, **counters}})
    with open(path, "w") as f:
        json.dump(doc, f)


def main(argv: list[str] | None = None) -> int:
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.load_index is None and not 2 <= args.k <= 32:
        parser.error(
            f"-k {args.k} is out of range: supported k is 2..32 "
            "(kmers are 64-bit, as in the reference)"
        )
    if args.progress:
        # --progress also shows the index-build phase log on stderr
        import logging

        logging.basicConfig(stream=sys.stderr)
        logging.getLogger("dbgtpu_torch").setLevel(logging.INFO)

    if args.merge_shards:
        from .dist.multihost import merge_shards

        merge_shards(args.paths_file, args.merge_shards)
        merge_shards(args.not_aligned_file, args.merge_shards)
        return 0

    mode = (
        ("paths-exhaustive" if args.exhaustive else "paths")
        if args.paths_mode
        else "exhaustive" if args.exhaustive
        else "anchors" if args.dog_mode
        else "greedy"
    )
    host = args.paths_mode or args.impl == "python"
    if args.resume:
        if args.impl == "python":
            print("--resume requires --impl jax or auto", file=sys.stderr)
            return 2
        if args.paths_mode:
            print("--resume takes a device mode; -p runs on the host spec",
                  file=sys.stderr)
            return 2
        if args.num_processes > 1:
            print("--resume does not combine with multi-process runs "
                  "(each process journals its own shard files instead)",
                  file=sys.stderr)
            return 2

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not host and not torch.cuda.is_available():
        print("dbgtpu_torch: no CUDA device is available; pass "
              "--device cpu to run the plain torch kernels on the CPU",
              file=sys.stderr)
        return 1

    if host and device.type == "cuda":
        print("dbgtpu_torch: " + ("path modes (-p)" if args.paths_mode
                                  else "--impl python")
              + f" run on the host spec; --device {args.device} is not used",
              file=sys.stderr)

    coordinated = False
    if args.num_processes > 1 and args.coordinator:
        from .dist.multihost import init_distributed

        coordinated = init_distributed(
            args.coordinator, args.num_processes, args.process_id)
    try:
        return _run(args, mode, device, coordinated)
    finally:
        if coordinated:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, mode, device, coordinated) -> int:
    """The run (index load, pipeline, output files) in its `job` span,
    then its stats block and --json-summary."""
    from .spans import Recorder

    spans = Recorder.for_run(args.profile_dir)
    with _profiled(args.profile_dir, device, spans):
        stats = _map(args, mode, device, spans)
    print_summary = True
    if coordinated:
        # the counters summed over the processes (the reference's shared
        # atomics, aligner.h:68): one global stats block, on process 0
        import numpy as np

        from .dist.multihost import global_stats_sum

        tot = global_stats_sum(np.array(
            [stats.read_number, stats.aligned, stats.not_aligned,
             stats.no_overlap], np.int64))
        if args.process_id == 0:
            (stats.read_number, stats.aligned, stats.not_aligned,
             stats.no_overlap) = (int(v) for v in tot)
        else:
            print_summary = False
    return _finish(args, args.reads.split(","), stats, print_summary)


def _map(args, mode, device, spans):
    """The index load, the mapping and the output files: the run's
    stats."""
    from .pipeline import run_pipeline, run_pipeline_resumable

    graph = None
    if args.load_index:
        from .index.persist import load_index

        with spans.span("index.load"):
            graph = load_index(args.load_index, spans)
        args.k = graph.k

    reads_files = args.reads.split(",")
    common = dict(
        k=args.k, m=args.mismatches, effort=args.effort, fastq=args.fastq,
        correction=args.correction, batch_size=args.batch_size, graph=graph,
        device=device, mode=mode, partial=args.partial,
        index_layout=args.index_layout, progress_every=args.progress,
        mesh_devices=args.mesh, shard_index=args.shard_index, spans=spans,
    )
    if args.resume:
        return run_pipeline_resumable(
            reads_files, args.unitigs, paths_file=args.paths_file,
            na_file=args.not_aligned_file, **common)

    paths, na, stats = run_pipeline(
        reads_files, args.unitigs, save_index=args.save_index,
        process_id=args.process_id, num_processes=args.num_processes,
        impl=args.impl, **common)
    paths_file, na_file = args.paths_file, args.not_aligned_file
    if args.num_processes > 1:
        from .dist.multihost import shard_path

        paths_file = shard_path(paths_file, args.process_id)
        na_file = shard_path(na_file, args.process_id)
    with spans.span("write"):
        with open(paths_file, "wb") as f:
            f.write(paths)
        with open(na_file, "wb") as f:
            f.write(na)
    return stats


if __name__ == "__main__":
    sys.exit(main())
