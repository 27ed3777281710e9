"""End-to-end mapping on one torch device: parse -> align -> format
(counterpart of dbgtpu/pipeline.py run_pipeline, _run_file_bulk and
run_pipeline_resumable for the greedy, anchor (-G) and exhaustive (-b,
-i) modes and both index layouts; a persisted index, a progress line,
record sharding over processes, a mesh of local devices, and journaled
runs that resume).

Parsing, graph build and output formatting are this package's copies
of dbgtpu's host modules (native C where available).  Output bytes
equal dbgtpu's `run_pipeline` with `impl="python"` or `"jax"`, and this
package's own spec pipeline (spec.py).  The path modes (-p) have no
device engine in dbgtpu, which runs them on its python spec whatever
`--impl` says; here they run on spec.py likewise and launch no kernel,
as every mode does under `impl="python"`.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import ClassVar

import numpy as np
import torch

from . import native
from .constants import STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC
from .dist.mesh import mesh_of
from .dist.multihost import shard_ranges
from .engine.runner import align_bulk, get_device_index, mesh_index
from .index.build import UnitigGraph, build_graph
from .index.device import hbm_report
from .index.persist import save_index as persist_index
from .spans import Recorder
from .spec import (
    _CHARS, RunStats, _count_stats, _format_outputs,
    run_pipeline as spec_pipeline,
)

DEVICE_MODES = ("greedy", "anchors", "exhaustive")
PATH_MODES = ("paths", "paths-exhaustive")     # host spec only
HOST_SPEC = "host-spec"     # `device` of a run that launched no kernel
IMPLS = ("auto", "python", "jax")   # dbgtpu's --impl choices


@dataclass
class TorchRunStats(RunStats):
    """RunStats plus the port's phase split and the run's span recorder
    (spans.py).  Each `*_seconds` leg of LEGS is the wall time of its
    spans (`leg`); index_seconds (the graph's build or load and its save) and
    map_seconds are set from the spans as each ends.  The phases below
    lie inside map_seconds, as the device index build and upload do in
    dbgtpu."""

    device: str = ""
    spans: Recorder = field(default_factory=Recorder)
    # bytes of index tables each device holds (one entry per device of
    # the mesh, or the one device): the whole index, or under
    # --shard-index its own ranges of the two large tables and the rest
    index_card_bytes: list | None = None

    # leg -> the span it sums; the runner's legs (engine/runner.py
    # align_bulk) lie inside align and are summed over batches
    LEGS: ClassVar[dict] = {
        "device_index_seconds": "index.device",  # device index build (host)
        "upload_seconds": "index.upload",   # index tensors onto the devices
        "parse_seconds": "parse",           # read files -> packed records
        "align_seconds": "align",           # pack, kernels, unpack, format
        "launch_seconds": "launch",         # pack, upload, launch, queue copies
        "drain_seconds": "drain",           # rebuild, recompute, format
        "format_seconds": "format",         # the output text, in the drain
        "wait_seconds": "fetch",            # the drain's waits and copies
        "stall_seconds": "stall",           # the launch thread's waits
    }
    INDEX_SPANS: ClassVar[tuple] = ("index.load", "graph.build",
                                    "index.save")

    def leg(self, name: str) -> float:
        """Seconds of leg `name` of LEGS: the wall time of its spans."""
        return self.spans.total(self.LEGS[name])

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["device"] = self.device
        d.update((leg, round(self.leg(leg), 3)) for leg in self.LEGS)
        if self.index_card_bytes is not None:
            d["index_card_bytes"] = self.index_card_bytes
        trace = self.spans.trace()
        if trace is not None:
            d["trace"] = trace
        return d


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_progress_printer(every_batches: int):
    """Periodic in-run stats line (the reference prints a stats block
    every 10 read-batches, alignerExhaustive.cpp:306-316).  Returns an
    align_bulk `progress` callback printing to stderr every
    `every_batches` completed batches (and on the final batch), or None
    when disabled (copy of dbgtpu/pipeline.py make_progress_printer)."""
    if not every_batches:
        return None

    t0 = time.monotonic()
    # `done`/`total`/`aligned` reset on every align_bulk call (one call
    # per file / per resumable segment) while t0 spans the whole run;
    # callers mark call boundaries via progress.segment() so the line
    # reports cumulative counts against the cumulative elapsed time
    seen = {"n": 0, "done": 0, "total": 0, "aligned": 0,
            "prev": (0, 0, 0)}

    def segment():
        d, t, a = seen["prev"]
        seen["done"] += d
        seen["total"] += t
        seen["aligned"] += a
        seen["prev"] = (0, 0, 0)

    def progress(done, total, aligned):
        seen["n"] += 1
        seen["prev"] = (done, total, aligned)
        if seen["n"] % every_batches and done < total:
            return
        d = seen["done"] + done
        t = seen["total"] + total
        a = seen["aligned"] + aligned
        dt = max(time.monotonic() - t0, 1e-9)
        pct = 100.0 * a / max(d, 1)
        print(
            f"[progress] reads {d}/{t} | aligned {a} "
            f"({pct:.1f}%) | {d / dt:,.0f} reads/s",
            file=sys.stderr, flush=True,
        )

    progress.segment = segment
    return progress


def _add_xfer(stats, xfer) -> None:
    """One align_bulk call's payload bytes into stats."""
    stats.payload_h2d_bytes += xfer["h2d_bytes"]
    stats.payload_d2h_bytes += xfer["d2h_bytes"]


def _run_file(graph, rf, m, effort, fastq, correction, batch_size, device,
              mode, partial, index_layout, stats, paths_out, na_out,
              rec_range=None, progress=None, mesh=None, shard_index=False):
    spans = stats.spans
    with spans.span("parse"):
        parsed = native.parse_reads(rf, graph.k, fastq, spans.count)
        spans.count("bytes", os.path.getsize(rf))
        if rec_range is not None:
            s, e = rec_range(parsed.n)
            parsed = parsed.slice_records(s, e)
        spans.count("reads", parsed.n)
    on_batch = None
    parts_p: dict = {}
    parts_n: dict = {}
    if native.available():
        # per-batch native formatting (dbgtpu pipeline._run_file_bulk)
        # in the runner's `format` span: the paths text, the
        # notAligned image (base letters and N, in numpy) and the
        # notAligned text, each in its own span
        def on_batch(slot, s0, nb, status_b, counts_b, flat_b):
            ho = parsed.hdr_off[s0 : s0 + nb + 1]
            with spans.span("format.paths"):
                po = np.zeros(nb + 1, np.int64)
                np.cumsum(counts_b, out=po[1:])
                if correction:
                    parts_p[slot] = native.format_corrected_native(
                        parsed.headers, ho, status_b, po, flat_b,
                        parsed.seq_off[s0 : s0 + nb + 1],
                        graph.pool, graph.offsets, graph.lengths, graph.k,
                    )
                else:
                    parts_p[slot] = native.format_paths_native(
                        parsed.headers, ho, status_b, po, flat_b,
                    )
            with spans.span("format.na_image"):
                al = (status_b == STATUS_ALIGNED_FWD) | (
                    status_b == STATUS_ALIGNED_RC)
                chars = None
                if not al.all():
                    so = parsed.seq_off[s0 : s0 + nb + 1]
                    chars = _CHARS[parsed.codes[so[0] : so[-1]]].copy()
                    chars[parsed.nmask[so[0] : so[-1]]] = ord("N")
            with spans.span("format.na_text"):
                parts_n[slot] = b"" if chars is None else (
                    native.format_notaligned_native(
                        parsed.headers, ho, status_b, chars, so - so[0]))

    xfer: dict = {}
    with spans.span("align"):
        status, path_off, flat = align_bulk(
            graph, parsed, m, effort, batch_size=batch_size, device=device,
            mode=mode, partial=partial, index_layout=index_layout,
            mesh=mesh, shard_index=shard_index, on_batch=on_batch,
            xfer=xfer, progress=progress, spans=spans,
        )
    _add_xfer(stats, xfer)
    aligned = _count_stats(stats, status)
    if on_batch is not None:
        with spans.span("write"):
            paths_out.append(b"".join(parts_p[i] for i in sorted(parts_p)))
            na_out.append(b"".join(parts_n[i] for i in sorted(parts_n)))
    else:
        with spans.span("format"):
            pb, nab = _format_outputs(
                graph, parsed, status, path_off, flat, correction, aligned
            )
        paths_out.append(pb)
        na_out.append(nab)


def _upload_index(graph, index_layout, device, mesh, mode, shard_index,
                  stats) -> None:
    """The graph's device index in `index_layout`, built unless the graph
    carries it, and its tensors on `device` or on each device of `mesh`
    (memoized; cut over the mesh under `shard_index`, after dbgtpu's
    guards, runner.mesh_index)."""
    spans = stats.spans
    with spans.span("index.device"):
        di = get_device_index(graph, index_layout, spans)
    with spans.span("index.upload"):
        devices = mesh or [device]
        ixs = mesh_index(graph, index_layout, devices, mode, bool(mesh),
                         shard_index)
        for d in devices:
            _sync(d)
        stats.index_card_bytes = [ix.held_bytes() for ix in ixs]
        spans.count("bytes", sum(stats.index_card_bytes))
    stats.index_hbm = hbm_report(di)


def run_pipeline(
    reads_files: list[str],
    unitig_file: str,
    k: int,
    m: int = 2,
    effort: int = 2,
    fastq: bool = False,
    correction: bool = False,
    batch_size: int = 32768,
    graph: UnitigGraph | None = None,
    device="cuda",
    mode: str = "greedy",
    partial: bool = False,
    index_layout: str = "scan",
    save_index: str | None = None,
    process_id: int = 0,
    num_processes: int = 1,
    progress_every: int = 0,
    impl: str = "auto",
    mesh_devices: int = 0,
    shard_index: bool = False,
    spans: Recorder | None = None,
):
    """Returns (paths_bytes, not_aligned_bytes, TorchRunStats).

    `device` is where the kernels run: a CUDA device, or "cpu" for the
    plain torch versions of the kernels (tests and small runs).  `mode`
    is "greedy", "anchors" (-G) or "exhaustive" (-b); `partial` (-i)
    applies to exhaustive mode.  "paths" and "paths-exhaustive" (-p) run
    on the host spec and launch no kernel: their stats say `device` =
    "host-spec".  So does every mode under `impl` "python" (dbgtpu's
    `--impl python`); "auto" and "jax" run the device modes' kernels on
    `device`.  `index_layout` is "scan" or "mphf" (the compact MPHF
    junction table, and MPHF dog anchors at any size).  A graph passed in
    (a loaded index) for anchor mode must be built with dog_mode=True.
    `save_index` persists the graph with its device index in
    `index_layout` (inside index_seconds).  With `num_processes` > 1 this
    process maps a contiguous record range of every input file; the
    caller merges the processes' outputs in order
    (dist.multihost.merge_shards) for the bytes of a single run.
    `progress_every` prints a stats line every that many batches.
    `mesh_devices` (dbgtpu's `--mesh`) shards every batch over the first
    that many local devices of `device`'s kind (-1: all; 0: no mesh; on
    the CPU that many shards, dist/mesh.py).  `shard_index` (dbgtpu's
    `--shard-index`) on a mesh takes dbgtpu's guards and, over more than
    one device, cuts the index's junction and probe tables over the
    mesh's devices (engine/index.py sharded_index_tensors); without a
    mesh it changes nothing.  `spans` is the run's span recorder (a new
    one, on under an active torch.profiler, by default)."""
    if mode not in DEVICE_MODES + PATH_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    device = torch.device(device)
    stats = _stats(device, spans)
    spans = stats.spans
    if graph is None:
        with spans.span("graph.build"):
            graph = build_graph(unitig_file, k,
                                dog_mode=(mode == "anchors"))
    if save_index:
        with spans.span("index.save"):
            persist_index(graph, save_index, layout=index_layout)
    stats.index_seconds = spans.total(*stats.INDEX_SPANS)

    rec_range = None
    if num_processes > 1:
        def rec_range(n):
            return shard_ranges(n, num_processes)[process_id]

    if mode in PATH_MODES or impl == "python":
        stats.device = HOST_SPEC
        with spans.span("map") as sp:
            paths, na, host = spec_pipeline(
                reads_files, unitig_file, k, m=m, effort=effort,
                fastq=fastq, correction=correction, graph=graph, mode=mode,
                partial=partial, rec_range=rec_range)
        for name in ("read_number", "aligned", "not_aligned", "no_overlap"):
            setattr(stats, name, getattr(host, name))
        stats.map_seconds = sp.seconds
        return paths, na, stats

    paths_out: list[bytes] = []
    na_out: list[bytes] = []
    with spans.span("map") as sp:
        mesh = mesh_of(mesh_devices, device)
        _upload_index(graph, index_layout, device, mesh, mode, shard_index,
                      stats)
        progress = make_progress_printer(progress_every)
        for rf in reads_files:
            if progress is not None:
                progress.segment()
            _run_file(graph, rf, m, effort, fastq, correction, batch_size,
                      device, mode, partial, index_layout, stats, paths_out,
                      na_out, rec_range=rec_range, progress=progress,
                      mesh=mesh, shard_index=shard_index)
    stats.map_seconds = sp.seconds
    with spans.span("write"):
        return b"".join(paths_out), b"".join(na_out), stats


def _stats(device, spans) -> TorchRunStats:
    """A run's stats on `device`, holding `spans` or a new recorder (on
    under an active torch.profiler)."""
    return TorchRunStats(device=str(device),
                         spans=Recorder.for_run() if spans is None else spans)


def _journal_fingerprint(reads_files, unitig_file, k, m, effort, mode,
                         fastq, correction, partial) -> str:
    """Every parameter that affects the output must be in this blob:
    --resume is right only if the fingerprint rejects a resume whose
    records would be computed differently from the journaled ones (a
    run killed without -i and resumed with -i would mix partial and
    non-partial alignments).  The blob is dbgtpu's."""
    blob = repr((list(reads_files), unitig_file, k, m, effort, mode,
                 bool(fastq), bool(correction), bool(partial))).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def run_pipeline_resumable(
    reads_files: list[str],
    unitig_file: str,
    k: int,
    paths_file: str,
    na_file: str,
    m: int = 2,
    effort: int = 2,
    fastq: bool = False,
    correction: bool = False,
    batch_size: int = 32768,
    graph: UnitigGraph | None = None,
    device="cuda",
    mode: str = "greedy",
    partial: bool = False,
    index_layout: str = "scan",
    segment_records: int = 0,
    progress_every: int = 0,
    mesh_devices: int = 0,
    shard_index: bool = False,
    spans: Recorder | None = None,
) -> TorchRunStats:
    """Crash-resumable mapping run (counterpart of dbgtpu/pipeline.py
    run_pipeline_resumable; same journal, so either package resumes the
    other's run).

    Output is written per segment of `segment_records` reads and
    progress is journaled to `<paths_file>.resume.json`: append outputs
    -> flush+fsync -> atomically replace the journal (tmp + rename) with
    the new (file index, record offset, output byte offsets, running
    stats).  A killed run restarts with the same command + --resume:
    outputs are truncated to the journaled byte offsets (dropping any
    torn tail past the last fsync) and mapping continues at the
    journaled record offset, so the final bytes equal a single
    uninterrupted run's.  The journal is removed on completion.
    `mesh_devices`, `shard_index` and `spans` are run_pipeline's."""
    if mode not in DEVICE_MODES:
        raise ValueError(f"a resumable run takes a device mode, not {mode!r}")
    device = torch.device(device)
    stats = _stats(device, spans)
    spans = stats.spans
    if graph is None:
        with spans.span("graph.build"):
            graph = build_graph(unitig_file, k,
                                dog_mode=(mode == "anchors"))
    if not segment_records:
        segment_records = 4 * batch_size
    segment_records = max(segment_records, batch_size)

    journal_file = paths_file + ".resume.json"
    fp = _journal_fingerprint(
        reads_files, unitig_file, k, m, effort, mode, fastq, correction,
        partial,
    )
    state = {
        "version": 1, "fingerprint": fp, "file_idx": 0, "record_off": 0,
        "paths_bytes": 0, "na_bytes": 0,
        "stats": dict(read_number=0, aligned=0, not_aligned=0,
                      no_overlap=0),
    }
    if os.path.exists(journal_file):
        with open(journal_file) as f:
            prev = json.load(f)
        if prev.get("fingerprint") != fp:
            raise ValueError(
                f"--resume journal {journal_file} was written by a run "
                "with different inputs/parameters; delete it to start "
                "fresh"
            )
        state = prev

    # truncate any torn tail beyond the last journaled fsync, then
    # append from there
    for path, off in ((paths_file, state["paths_bytes"]),
                      (na_file, state["na_bytes"])):
        if os.path.exists(path):
            with open(path, "r+b") as f:
                f.truncate(off)
        elif off:
            raise ValueError(
                f"--resume journal expects {off} bytes in {path}, "
                "but the file is missing; delete the journal to start "
                "fresh"
            )
    for name, val in state["stats"].items():
        setattr(stats, name, val)
    stats.index_seconds = spans.total(*stats.INDEX_SPANS)
    with spans.span("map") as sp, open(paths_file, "ab") as pf, \
            open(na_file, "ab") as naf:
        mesh = mesh_of(mesh_devices, device)
        _upload_index(graph, index_layout, device, mesh, mode, shard_index,
                      stats)
        progress = make_progress_printer(progress_every)
        for fi, rf in enumerate(reads_files):
            if fi < state["file_idx"]:
                continue
            with spans.span("parse"):
                parsed_all = native.parse_reads(rf, graph.k, fastq,
                                                spans.count)
                spans.count("reads", parsed_all.n)
                spans.count("bytes", os.path.getsize(rf))
            start = state["record_off"] if fi == state["file_idx"] else 0
            for s0 in range(start, parsed_all.n, segment_records):
                e0 = min(s0 + segment_records, parsed_all.n)
                parsed = parsed_all.slice_records(s0, e0)
                if progress is not None:
                    progress.segment()
                xfer: dict = {}
                with spans.span("align"):
                    status, path_off, flat = align_bulk(
                        graph, parsed, m, effort, batch_size=batch_size,
                        device=device, mode=mode, partial=partial,
                        index_layout=index_layout, mesh=mesh,
                        shard_index=shard_index, progress=progress,
                        xfer=xfer, spans=spans,
                    )
                    aligned = _count_stats(stats, status)
                    with spans.span("format"):
                        pb, nab = _format_outputs(
                            graph, parsed, status, path_off, flat,
                            correction, aligned,
                        )
                _add_xfer(stats, xfer)
                with spans.span("write"):
                    pf.write(pb)
                    pf.flush()
                    os.fsync(pf.fileno())
                    naf.write(nab)
                    naf.flush()
                    os.fsync(naf.fileno())
                    state.update(
                        file_idx=fi, record_off=e0,
                        paths_bytes=state["paths_bytes"] + len(pb),
                        na_bytes=state["na_bytes"] + len(nab),
                        stats=dict(
                            read_number=stats.read_number,
                            aligned=stats.aligned,
                            not_aligned=stats.not_aligned,
                            no_overlap=stats.no_overlap,
                        ),
                    )
                    tmp = journal_file + ".tmp"
                    with open(tmp, "w") as jf:
                        json.dump(state, jf)
                        jf.flush()
                        os.fsync(jf.fileno())
                    os.replace(tmp, journal_file)
            state["file_idx"] = fi + 1
            state["record_off"] = 0
    stats.map_seconds = sp.seconds
    if os.path.exists(journal_file):
        os.remove(journal_file)
    return stats

