"""K8 compact_result: the compact layout of a batch's result rows.

Counterpart of dbgtpu/engine/core.py _compact_result: the fused rows
[B, 2 + pmax] become `meta` [B, 2] (status, true plen) and `flat`
[B * pmax], whose leading sum(counts) entries carry every real path
slot, so the host fetches `meta` and that prefix only.  Layout:
counts = min(plen, pmax) for an aligned row (status 1 or 2), else 0;
rows ordered by count descending, stable by row index; column j holds
slot j of the first n_j = #(count > j) rows of that order; the columns
lie back to back; the tail is zero.  `expand_compact` is the host side:
it rebuilds the padded rows from the counts alone, so the stable order
is part of the format.

The kernel is csrc/compact.cu (a counting sort over the counts and a
scatter, one cooperative launch); `compact_ref` is its plain torch
version (a stable argsort, cumulative sums and an indexed assignment).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC
from ..kernels import build


def compact_ref(fused: torch.Tensor, pmax: int):
    """Plain torch version of K8 -> (meta [B, 2], flat [B * pmax]) of
    fused's dtype."""
    B = fused.shape[0]
    status = fused[:, 0].to(torch.int64)
    plen = fused[:, 1].to(torch.int64)
    aligned = (status == STATUS_ALIGNED_FWD) | (status == STATUS_ALIGNED_RC)
    counts = torch.where(aligned, plen.clamp(max=pmax), 0)
    order = torch.argsort(-counts, stable=True)
    sp = fused[:, 2:][order]                          # [B, pmax], counts desc
    cs = counts[order]
    j = torch.arange(pmax, device=fused.device)
    n_j = (counts[:, None] > j[None, :]).sum(0)       # [pmax]
    col_off = torch.cumsum(n_j, 0) - n_j
    live = cs[:, None] > j[None, :]                   # row i holds slot j
    rank = torch.arange(B, device=fused.device)[:, None]
    flat = torch.zeros(B * pmax, dtype=fused.dtype, device=fused.device)
    flat[(col_off[None, :] + rank)[live]] = sp[live]
    return fused[:, :2].clone(), flat


def compact_result(fused: torch.Tensor, pmax: int):
    """K8 on fused's device: the kernel on CUDA, the plain version on the
    CPU, an error anywhere else."""
    dev = fused.device
    if dev.type == "cpu":
        return compact_ref(fused, pmax)
    if dev.type != "cuda":
        raise ValueError(f"no compact_result kernel for device {dev}")
    if fused.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"unsupported result dtype {fused.dtype}")
    if fused.dim() != 2 or fused.shape[1] != 2 + pmax or pmax < 1:
        raise ValueError(f"fused {tuple(fused.shape)} is not [B, 2 + {pmax}]")
    launch, out = compact_result_launch(fused, pmax)
    if fused.shape[0]:
        launch()
        build.count("compact_result")
    return out


def compact_scratch_ints(B: int, pmax: int) -> int:
    """int32 scratch of K8's C entry point for B rows: (pmax + 1) x
    (ceil(B / 256) + 1).  The one-launch kernel uses (pmax + 1) x grid of
    it (its grid is at most one block per 256 rows); the three-pass
    kernel of earlier trees, which a measurement may time beside it
    through the same entry point, all of it."""
    n_tiles = (B + build.COMPACT_TILE - 1) // build.COMPACT_TILE
    return (pmax + 1) * (n_tiles + 1)


# K8's scratch per (device, stream), grown as batches need: the kernel
# reads only what it wrote in the same launch, so it needs no initial
# value, and launches on one stream never overlap
_scratch: dict = {}


def _scratch_for(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (dev, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < n:
        buf = _scratch[key] = torch.empty(n, dtype=torch.int32, device=dev)
    return buf


def compact_result_launch(fused: torch.Tensor, pmax: int):
    """K8's allocation on checked CUDA tensors: (build.Launch into the
    outputs, (meta, flat)).  meta and flat are views of one allocation
    (flat starts 16-byte aligned, as the kernel needs), the scratch is
    kept per device and stream; fused is copied only where it does not
    start 16-byte aligned."""
    dev = fused.device
    fused = fused.contiguous()
    if fused.data_ptr() % 16:
        fused = fused.clone()
    B = fused.shape[0]
    lead = -(-2 * B // 8) * 8           # meta's elements, padded to 16 B
    buf = torch.empty(lead + B * pmax, dtype=fused.dtype, device=dev)
    meta, flat = buf[: 2 * B].view(B, 2), buf[lead:]
    stream = build.stream_ptr(dev)
    scratch = _scratch_for(dev, stream, compact_scratch_ints(B, pmax))
    launch = build.Launch("compact_result", "dbg_compact_result", (
        fused.data_ptr(), B, pmax, int(fused.dtype == torch.int16),
        scratch.data_ptr(), meta.data_ptr(), flat.data_ptr(), stream,
    ), (fused, buf, scratch))
    return launch, (meta, flat)


def compact_counts(meta: np.ndarray, pmax: int) -> np.ndarray:
    """Path slots each row holds in `flat`: int64 [B] from meta [B, 2]."""
    status = meta[:, 0].astype(np.int32)
    plen = meta[:, 1].astype(np.int64)
    aligned = (status == STATUS_ALIGNED_FWD) | (status == STATUS_ALIGNED_RC)
    return np.where(aligned, np.minimum(plen, pmax), 0)


def expand_compact(meta: np.ndarray, prefix: np.ndarray,
                   pmax: int) -> np.ndarray:
    """Host side of K8: meta [B, 2] and the populated prefix of flat
    (sum(counts) entries) -> the padded path slots [B, pmax] (a numpy
    restatement of dbgtpu/engine/runner.py:526-544)."""
    B = meta.shape[0]
    counts = compact_counts(meta, pmax)
    paths = np.zeros((B, pmax), meta.dtype)
    # device order: counts descending, stable by row index
    order = np.argsort(-counts, kind="stable")
    n_j = np.searchsorted(-counts[order], -np.arange(pmax), side="left")
    off = 0
    for j in range(pmax):
        nj = int(n_j[j])                  # rows with count > j
        if nj == 0:
            break
        paths[order[:nj], j] = prefix[off : off + nj]
        off += nj
    return paths
