"""Batched alignment on one torch device (counterpart of
dbgtpu/engine/core.py align_batch, align_batch_packed and
align_batches_packed_compact, either index layout), in the three modes
of dbgtpu's device engines.

A batch runs through hand-written CUDA kernels on a GPU, and their
plain torch versions on the CPU:

  K1 read_scan      packed words -> read images + anchor-scan (k-1)-mers
  K2 member         junction membership at every scan position
  K3 greedy_walk    greedy junction walk from per-anchor inits, per read
                    (on a sharded index, from a stage of the junction
                    table's remote ranges where its plan stages: K13's
                    pull, on a side stream from the batch's start)
  K4 pack_paths     fused [B, 2 + pmax] result rows
  K5 dog_anchors    k-mer anchor lookup + placement inits (dog mode)
  K6 exhaustive_dfs branch-and-bound DFS per read (exhaustive mode)
  K7 mphf_slots     MPHF lookup: the check of each MPHF table at upload;
                    its device function runs inside K2, K3, K5 and K6
                    when the index holds an MPHF layout
  K8 compact_result rows -> (meta, flat) for the compact result fetch

  greedy:     K1 -> K2 -> K3 (greedy entry) -> K4
  anchors:    K1 -> K5 -> K3 (from inits)   -> K4
  exhaustive: K1 -> K2 (exhaustive mode) -> K6 -> K4
  every mode, in the runner's entry: -> K8

The stages take and return tensors on the device of their input; no
stage falls back to another device or to the host spec.
"""

from __future__ import annotations

import torch

from .compact import compact_result
from .dog import dog_anchors
from .exhaustive import exhaustive_dfs
from .index import IndexTensors
from .member import inter, member
from .pack import out_dtype_for, pack_paths
from .read_scan import read_scan
from .walk import Walks, greedy_walk, walk_inits, walk_stage

MODES = ("greedy", "anchors", "exhaustive")


def align_batch(ix: IndexTensors, words, nmbits, lens, *, mode: str = "greedy",
                k: int, m: int, effort: int, L: int,
                partial: bool = False) -> Walks:
    """The kernels of `mode` up to the walk results, on a packed batch:
    words int32 [B, ceil(L/16)] (2-bit codes, uint32 bits), nmbits int32
    [B, ceil(L/32)] or [B, 0] (no N in the batch), lens [B].  `partial`
    (-i) applies to exhaustive mode only."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    lens = lens.to(torch.int32)
    k1 = k - 1
    # greedy on a sharded index: K3's stage (where its plan stages) is
    # pulled on a side stream from here on, beside K1 and K2
    stage = (walk_stage(ix, words.shape[0], words.device)
             if mode == "greedy" else None)
    scan = read_scan(words, nmbits, lens, L=L, k1=k1)
    if mode == "anchors":
        inits = dog_anchors(ix, scan.rows, lens, k=k, m=m, effort=effort,
                            L=L)
        return walk_inits(ix, scan.rows, lens, inits, k=k, L=L)
    if mode == "exhaustive":
        mask = inter(ix, scan, lens, L=L, k1=k1)
        return exhaustive_dfs(ix, scan, mask, lens, k=k, m=m,
                              partial=partial, L=L)
    member1, member2 = member(ix, scan, lens, L=L, k1=k1)
    return greedy_walk(ix, scan, member1, member2, lens, k=k, m=m,
                       effort=effort, L=L, stage=stage)


def align_batch_packed(ix: IndexTensors, words, nmbits, lens, *,
                       mode: str = "greedy", k: int, m: int, effort: int = 2,
                       L: int, pmax: int, partial: bool = False) -> torch.Tensor:
    """The production entry: one fused [B, 2 + pmax] array per batch —
    col 0 status, col 1 the TRUE path length (rows with plen > pmax are
    recomputed on the host by the caller), cols 2: the packed path — as
    int16 when every value provably fits, else int32."""
    walks = align_batch(ix, words, nmbits, lens, mode=mode, k=k, m=m,
                        effort=effort, L=L, partial=partial)
    return pack_paths(walks, pmax=pmax,
                      dtype=out_dtype_for(ix.umeta.shape[0], L))


def align_batch_packed_compact(ix: IndexTensors, words, nmbits, lens, *,
                               mode: str = "greedy", k: int, m: int,
                               effort: int = 2, L: int, pmax: int,
                               partial: bool = False):
    """align_batch_packed followed by the compact result layout (K8):
    (meta [B, 2], flat [B * pmax]); the runner fetches meta and only the
    populated prefix of flat (engine/compact.py)."""
    fused = align_batch_packed(ix, words, nmbits, lens, mode=mode, k=k, m=m,
                               effort=effort, L=L, pmax=pmax, partial=partial)
    return compact_result(fused, pmax)
