"""End-to-end mapping on one torch device: parse -> align -> format
(counterpart of dbgtpu/pipeline.py run_pipeline and _run_file_bulk for
the greedy, anchor (-G) and exhaustive (-b, -i) modes and both index
layouts).

Parsing, graph build and output formatting are this package's copies
of dbgtpu's host modules (native C where available).  Output bytes
equal dbgtpu's `run_pipeline` with `impl="python"` or `"jax"`, and this
package's own spec pipeline (spec.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from . import native
from .constants import STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC
from .engine.index import index_tensors
from .engine.runner import align_bulk, get_device_index
from .index.build import UnitigGraph, build_graph
from .index.device import hbm_report
from .spec import _CHARS, RunStats, _count_stats, _format_outputs


@dataclass
class TorchRunStats(RunStats):
    """RunStats plus the port's phase split.  The phases below
    lie inside map_seconds, as the device index build and upload do in
    dbgtpu."""

    device: str = ""
    device_index_seconds: float = 0.0   # build_device_index (host)
    upload_seconds: float = 0.0         # index tensors onto the device
    parse_seconds: float = 0.0          # read files -> packed records
    align_seconds: float = 0.0          # pack + kernels + unpack + format

    def as_dict(self) -> dict:
        d = super().as_dict()
        d.update(
            device=self.device,
            device_index_seconds=round(self.device_index_seconds, 3),
            upload_seconds=round(self.upload_seconds, 3),
            parse_seconds=round(self.parse_seconds, 3),
            align_seconds=round(self.align_seconds, 3),
        )
        return d


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_file(graph, rf, m, effort, fastq, correction, batch_size, device,
              mode, partial, index_layout, stats, paths_out, na_out):
    t = time.monotonic()
    parsed = native.parse_reads(rf, graph.k, fastq)
    stats.parse_seconds += time.monotonic() - t
    on_batch = None
    parts_p: dict = {}
    parts_n: dict = {}
    if native.available():
        # per-batch native formatting (dbgtpu pipeline._run_file_bulk)
        def on_batch(slot, s0, nb, status_b, counts_b, flat_b):
            po = np.zeros(nb + 1, np.int64)
            np.cumsum(counts_b, out=po[1:])
            ho = parsed.hdr_off[s0 : s0 + nb + 1]
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
            al = (status_b == STATUS_ALIGNED_FWD) | (
                status_b == STATUS_ALIGNED_RC)
            if al.all():
                parts_n[slot] = b""
            else:
                so = parsed.seq_off[s0 : s0 + nb + 1]
                chars = _CHARS[parsed.codes[so[0] : so[-1]]].copy()
                chars[parsed.nmask[so[0] : so[-1]]] = ord("N")
                parts_n[slot] = native.format_notaligned_native(
                    parsed.headers, ho, status_b, chars, so - so[0],
                )

    xfer: dict = {}
    t = time.monotonic()
    status, path_off, flat = align_bulk(
        graph, parsed, m, effort, batch_size=batch_size, device=device,
        mode=mode, partial=partial, index_layout=index_layout,
        on_batch=on_batch, xfer=xfer,
    )
    stats.align_seconds += time.monotonic() - t
    stats.payload_h2d_bytes += xfer["h2d_bytes"]
    stats.payload_d2h_bytes += xfer["d2h_bytes"]
    aligned = _count_stats(stats, status)
    if on_batch is not None:
        paths_out.append(b"".join(parts_p[i] for i in sorted(parts_p)))
        na_out.append(b"".join(parts_n[i] for i in sorted(parts_n)))
    else:
        pb, nab = _format_outputs(
            graph, parsed, status, path_off, flat, correction, aligned
        )
        paths_out.append(pb)
        na_out.append(nab)


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
):
    """Returns (paths_bytes, not_aligned_bytes, TorchRunStats).

    `device` is where the kernels run: a CUDA device, or "cpu" for the
    plain torch versions of the kernels (tests and small runs).  `mode`
    is "greedy", "anchors" (-G) or "exhaustive" (-b); `partial` (-i)
    applies to exhaustive mode.  `index_layout` is "scan" or "mphf"
    (the compact MPHF junction table, and MPHF dog anchors at any size).
    A graph passed in for anchor mode must be built with
    dog_mode=True."""
    device = torch.device(device)
    stats = TorchRunStats(device=str(device))
    t0 = time.monotonic()
    if graph is None:
        graph = build_graph(unitig_file, k, dog_mode=(mode == "anchors"))
    stats.index_seconds = time.monotonic() - t0

    t1 = time.monotonic()
    di = get_device_index(graph, index_layout)
    stats.device_index_seconds = time.monotonic() - t1
    t = time.monotonic()
    index_tensors(di, device)
    _sync(device)
    stats.upload_seconds = time.monotonic() - t
    stats.index_hbm = hbm_report(di)

    paths_out: list[bytes] = []
    na_out: list[bytes] = []
    for rf in reads_files:
        _run_file(graph, rf, m, effort, fastq, correction, batch_size,
                  device, mode, partial, index_layout, stats, paths_out,
                  na_out)
    stats.map_seconds = time.monotonic() - t1
    return b"".join(paths_out), b"".join(na_out), stats
