"""The executable-spec pipeline and the output helpers the port shares
with it: parse -> align one read at a time on the host -> format.

Copy of the module-level helpers of dbgtpu/pipeline.py (`RunStats`,
`_count_stats`, `_format_outputs`, `_CHARS`) and of the `impl="python"`
branch of its `run_pipeline`, for the three modes the port runs on the
device (greedy, anchors, exhaustive) and the two path modes (-p), which
have no device engine in either package and run here.  `run_pipeline`
here is the reference the device pipeline (dbgtpu_torch/pipeline.py)
must equal byte for byte; it shares no code with the kernels or their
plain versions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from . import native
from .anchors import align_read_greedy_anchors
from .constants import (
    STATUS_ALIGNED_FWD,
    STATUS_ALIGNED_RC,
    STATUS_FAILED,
    STATUS_NO_OVERLAP_FWD,
    STATUS_RC_NO_OVERLAP,
)
from .exhaustive import align_read_exhaustive
from .index.build import UnitigGraph, build_graph
from .io.fasta import iter_reads
from .model import align_read_greedy, format_path, recover_path
from .seq import decode, encode, n_mask, rc_codes


@dataclass
class RunStats:
    read_number: int = 0
    aligned: int = 0
    not_aligned: int = 0
    no_overlap: int = 0
    index_seconds: float = 0.0
    map_seconds: float = 0.0
    index_hbm: dict | None = None     # per-artifact device-index bytes
    # per-run host<->device payload (read batches up, results down;
    # excludes the one-time index upload)
    payload_h2d_bytes: int = 0
    payload_d2h_bytes: int = 0

    def summary(self) -> str:
        """Same shape as the reference's end-of-run block
        (aligner.cpp:588-596)."""
        rn = self.read_number
        got = self.aligned + self.not_aligned

        def pct(a, b):
            return (100.0 * a) / b if b else float("nan")

        return (
            "The End\n"
            f"Reads : {rn}\n"
            f"No overlap : {self.no_overlap} Percent : {_fmt(pct(self.no_overlap, rn))}\n"
            f"Got overlap : {got} Percent : {_fmt(pct(got, rn))}\n"
            f"Overlap and aligned : {self.aligned} Percent : {_fmt(pct(self.aligned, got))}\n"
            f"Overlap but not aligned : {self.not_aligned} Percent : {_fmt(pct(self.not_aligned, got))}\n"
            f"Reads/seconds : {int(rn / (int(self.map_seconds) + 1))}\n"
            f"Mapping in seconds : {int(self.map_seconds)}\n"
        )

    def as_dict(self) -> dict:
        """Structured run summary (SURVEY.md §5 observability note)."""
        return {
            "reads": self.read_number,
            "aligned": self.aligned,
            "not_aligned": self.not_aligned,
            "no_overlap": self.no_overlap,
            "index_seconds": round(self.index_seconds, 3),
            "map_seconds": round(self.map_seconds, 3),
            "reads_per_second": (
                round(self.read_number / self.map_seconds, 1)
                if self.map_seconds > 0 else None
            ),
            **({"index_hbm_bytes": self.index_hbm}
               if self.index_hbm else {}),
            **({"payload_h2d_bytes": self.payload_h2d_bytes,
                "payload_d2h_bytes": self.payload_d2h_bytes}
               if self.payload_h2d_bytes else {}),
        }


def _fmt(x: float) -> str:
    # C++ cout default: 6 significant digits
    if x != x:
        return "-nan"
    return f"{x:.6g}"


_NO_OVERLAP_STATUSES = (STATUS_NO_OVERLAP_FWD, STATUS_RC_NO_OVERLAP)

_CHARS = np.frombuffer(b"ACGT", np.uint8)


def _format_paths_python(headers, hdr_off, status, path_off, flat):
    out = []
    for i in range(len(status)):
        if status[i] not in (STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC):
            continue
        h = headers[hdr_off[i] : hdr_off[i + 1]]
        p = flat[path_off[i] : path_off[i + 1]]
        out.append(h + b"\n" + ("".join(f"{v}." for v in p) + "\n").encode())
    return b"".join(out)


def _count_stats(stats, status):
    aligned = (status == STATUS_ALIGNED_FWD) | (status == STATUS_ALIGNED_RC)
    stats.read_number += len(status)
    stats.aligned += int(aligned.sum())
    stats.no_overlap += int(np.isin(status, _NO_OVERLAP_STATUSES).sum())
    stats.not_aligned += int((status == STATUS_FAILED).sum())
    return aligned


def _format_outputs(graph, parsed, status, path_off, flat, correction,
                    aligned):
    """(paths_bytes, not_aligned_bytes) for one aligned record block
    (byte format per SURVEY §4.1 items 1-3)."""
    paths_out: list[bytes] = []
    na_out: list[bytes] = []
    if correction:
        if native.available():
            paths_out.append(
                native.format_corrected_native(
                    parsed.headers, parsed.hdr_off, status, path_off,
                    flat, parsed.seq_off, graph.pool, graph.offsets,
                    graph.lengths, graph.k,
                )
            )
        else:
            for i in np.nonzero(aligned)[0]:
                h = parsed.headers[parsed.hdr_off[i] : parsed.hdr_off[i + 1]]
                path = [int(v) for v in flat[path_off[i] : path_off[i + 1]]]
                rlen = int(parsed.seq_off[i + 1] - parsed.seq_off[i])
                corrected = recover_path(graph, path, rlen)
                if status[i] == STATUS_ALIGNED_RC:
                    corrected = rc_codes(corrected)
                paths_out.append(
                    h + b"\n" + decode(corrected).encode() + b"\n"
                )
    elif native.available():
        paths_out.append(
            native.format_paths_native(
                parsed.headers, parsed.hdr_off, status, path_off, flat
            )
        )
    else:
        paths_out.append(
            _format_paths_python(
                parsed.headers, parsed.hdr_off, status, path_off, flat
            )
        )

    if not aligned.all():
        chars = _CHARS[parsed.codes].copy()
        chars[parsed.nmask] = ord("N")
        if native.available():
            na_out.append(
                native.format_notaligned_native(
                    parsed.headers, parsed.hdr_off, status, chars,
                    parsed.seq_off,
                )
            )
        else:
            cb = chars.tobytes()
            for i in np.nonzero(~aligned)[0]:
                h = parsed.headers[parsed.hdr_off[i] : parsed.hdr_off[i + 1]]
                s, e = int(parsed.seq_off[i]), int(parsed.seq_off[i + 1])
                na_out.append(h + b"\n" + cb[s:e] + b"\n")
    return b"".join(paths_out), b"".join(na_out)


def spec_for(mode: str, m: int, effort: int, partial: bool):
    """The executable spec of `mode` for one read: (graph, codes, nm) ->
    (status, path or None)."""
    if mode == "greedy":
        return lambda g, codes, nm: align_read_greedy(g, codes, nm, m, effort)
    if mode == "anchors":
        return lambda g, codes, nm: align_read_greedy_anchors(
            g, codes, nm, m, effort)
    if mode == "exhaustive":
        return lambda g, codes, nm: align_read_exhaustive(
            g, codes, nm, m, partial)
    if mode == "paths":
        from .paths_mode import align_read_greedy_path

        return lambda g, codes, nm: align_read_greedy_path(
            g, codes, nm, m, effort, partial)
    if mode == "paths-exhaustive":
        from .paths_mode import align_read_exhaustive_path

        return lambda g, codes, nm: align_read_exhaustive_path(
            g, codes, nm, m, partial)
    raise ValueError(f"unknown mode {mode!r}")


def run_pipeline(
    reads_files: list[str],
    unitig_file: str,
    k: int,
    m: int = 2,
    effort: int = 2,
    fastq: bool = False,
    correction: bool = False,
    graph: UnitigGraph | None = None,
    mode: str = "greedy",
    partial: bool = False,
    rec_range=None,
):
    """Returns (paths_bytes, not_aligned_bytes, RunStats), every read
    aligned on the host by the executable spec of `mode` ("greedy",
    "anchors", "exhaustive", "paths" or "paths-exhaustive").
    `rec_range(n) -> (start, end)` keeps that record range of every
    input file (process sharding)."""
    stats = RunStats()
    t0 = time.monotonic()
    if graph is None:
        graph = build_graph(unitig_file, k, dog_mode=(mode == "anchors"))
    stats.index_seconds = time.monotonic() - t0
    align = spec_for(mode, m, effort, partial)

    paths_out: list[bytes] = []
    na_out: list[bytes] = []
    t1 = time.monotonic()
    for rf in reads_files:
        records = iter_reads(rf, k, fastq)
        if rec_range is not None:
            records = list(records)
            s, e = rec_range(len(records))
            records = records[s:e]
        for header, seq in records:
            status, path = align(graph, encode(seq), n_mask(seq))
            stats.read_number += 1
            if status in (STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC):
                stats.aligned += 1
                if correction:
                    corrected = recover_path(graph, path, len(seq))
                    if status == STATUS_ALIGNED_RC:
                        corrected = rc_codes(corrected)
                    paths_out.append(
                        header + b"\n" + decode(corrected).encode() + b"\n"
                    )
                else:
                    paths_out.append(header + b"\n" + format_path(path))
            else:
                if status in _NO_OVERLAP_STATUSES:
                    stats.no_overlap += 1
                elif status == STATUS_FAILED:
                    stats.not_aligned += 1
                na_out.append(header + b"\n" + seq + b"\n")
    stats.map_seconds = time.monotonic() - t1
    return b"".join(paths_out), b"".join(na_out), stats
