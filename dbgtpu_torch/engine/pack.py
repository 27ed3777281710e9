"""K4 pack_paths: the fused per-read result rows.

Counterpart of dbgtpu/engine/core.py pack_paths and of the fused output
of align_batch_packed: row b is [status, true plen, offset, reversed
left ids, right ids], zero-padded to 2 + pmax columns, with
plen = 1 + llen + rlen unclamped.  The kernel is csrc/pack.cu (one
16-byte chunk of the rows per thread); `pack_ref` is its plain torch
version.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .walk import Walks


def out_dtype_for(n_unitig_rows: int, L: int) -> torch.dtype:
    """int16 when every signed id (|id| < U), offset (< L) and true plen
    (<= 2L+1) fits, else int32 (core.align_batch_packed :1521-1526)."""
    if n_unitig_rows <= 32767 and 2 * L + 1 <= 32767:
        return torch.int16
    return torch.int32


def pack_ref(walks: Walks, *, pmax: int, dtype: torch.dtype) -> torch.Tensor:
    """Plain torch version of K4 -> [B, 2 + pmax] of `dtype`."""
    B, P = walks.lbuf.shape
    dev = walks.lbuf.device
    llen = walks.llen.to(torch.int64)[:, None]
    plen = 1 + walks.llen.to(torch.int64) + walks.rlen.to(torch.int64)
    j = torch.arange(pmax, device=dev)[None, :]
    left = walks.lbuf.gather(1, (llen - j).clamp(0, P - 1))
    right = walks.rbuf.gather(1, (j - llen - 1).clamp(0, P - 1))
    path = torch.where(j == 0, walks.offset.to(torch.int32)[:, None],
                       torch.where(j <= llen, left, right))
    path = torch.where((j < plen[:, None]) & (j < P), path, 0)
    return torch.cat([walks.status[:, None].to(torch.int32),
                      plen[:, None].to(torch.int32), path], dim=1).to(dtype)


def pack_paths(walks: Walks, *, pmax: int, dtype: torch.dtype) -> torch.Tensor:
    """K4 on the walks' device: the kernel on CUDA, the plain version on
    the CPU, an error anywhere else."""
    dev = walks.lbuf.device
    if dev.type == "cpu":
        return pack_ref(walks, pmax=pmax, dtype=dtype)
    if dev.type != "cuda":
        raise ValueError(f"no pack_paths kernel for device {dev}")
    if dtype not in (torch.int16, torch.int32):
        raise TypeError(f"unsupported output dtype {dtype}")
    if any(t.dtype != torch.int32 for t in walks):
        raise TypeError("walk outputs must be int32")
    launch, out = pack_paths_launch(walks, pmax=pmax, dtype=dtype)
    if walks.lbuf.shape[0]:
        launch()
        build.count("pack_paths")
    return out


def pack_paths_launch(walks: Walks, *, pmax: int, dtype: torch.dtype):
    """K4's allocation on checked CUDA tensors: (build.Launch into the
    output, the output)."""
    dev = walks.lbuf.device
    walks = Walks(*(t.contiguous() for t in walks))
    B, P = walks.lbuf.shape
    out = torch.empty((B, 2 + pmax), dtype=dtype, device=dev)
    launch = build.Launch("pack_paths", "dbg_pack_paths", (
        walks.status.data_ptr(), walks.offset.data_ptr(),
        walks.llen.data_ptr(), walks.rlen.data_ptr(),
        walks.lbuf.data_ptr(), walks.rbuf.data_ptr(), B, P, pmax,
        int(dtype == torch.int16), out.data_ptr(), build.stream_ptr(dev),
    ), (walks, out))
    return launch, out
