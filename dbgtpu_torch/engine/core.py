"""Batched greedy alignment on one torch device (counterpart of
dbgtpu/engine/core.py align_batch and align_batch_packed, greedy mode,
scan index layout).

A batch runs through four stages, each a hand-written CUDA kernel on a
GPU and its plain torch version on the CPU:

  K1 read_scan   packed words -> read images + anchor-scan (k-1)-mers
  K2 member      junction membership at every scan position
  K3 greedy_walk anchor pick + greedy junction walk, per read
  K4 pack_paths  fused [B, 2 + pmax] result rows

The stages take and return tensors on the device of their input; no
stage falls back to another device or to the host spec.
"""

from __future__ import annotations

import torch

from .index import IndexTensors
from .member import member
from .pack import out_dtype_for, pack_paths
from .read_scan import read_scan
from .walk import Walks, greedy_walk


def align_batch(ix: IndexTensors, words, nmbits, lens, *, k: int, m: int,
                effort: int, L: int) -> Walks:
    """K1-K3 on a packed batch: words int32 [B, ceil(L/16)] (2-bit codes,
    uint32 bits), nmbits int32 [B, ceil(L/32)] or [B, 0] (no N in the
    batch), lens [B].  Returns the per-read walk results."""
    lens = lens.to(torch.int32)
    k1 = k - 1
    scan = read_scan(words, nmbits, lens, L=L, k1=k1)
    member1, member2 = member(ix, scan, lens, L=L, k1=k1)
    return greedy_walk(ix, scan, member1, member2, lens, k=k, m=m,
                       effort=effort, L=L)


def align_batch_packed(ix: IndexTensors, words, nmbits, lens, *,
                       mode: str = "greedy", k: int, m: int, effort: int = 2,
                       L: int, pmax: int) -> torch.Tensor:
    """The production entry: one fused [B, 2 + pmax] array per batch —
    col 0 status, col 1 the TRUE path length (rows with plen > pmax are
    recomputed on the host by the caller), cols 2: the packed path — as
    int16 when every value provably fits, else int32."""
    if mode != "greedy":
        raise ValueError(f"dbgtpu_torch supports greedy mode only, not {mode!r}")
    walks = align_batch(ix, words, nmbits, lens, k=k, m=m, effort=effort, L=L)
    return pack_paths(walks, pmax=pmax,
                      dtype=out_dtype_for(ix.umeta.shape[0], L))
