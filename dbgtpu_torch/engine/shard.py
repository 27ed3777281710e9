"""K13 sharded_rows: the row gather from a table cut into bucket ranges
over the cards of a mesh (`--shard-index`).

Counterpart of dbgtpu/engine/core.py _sharded_rows.  Under
`--shard-index` the fused junction scan table `st_fused` and the
closure-probe table `pt_rows` are each cut into D contiguous bucket
ranges of nb_local rows, shard s on card s (engine/index.py
sharded_index_tensors), as dbgtpu shards them
(dbgtpu/dist/mesh.py:152-159); every other table is replicated.  A
lookup's global bucket b lies in shard b // nb_local at row
b - shard * nb_local.

dbgtpu answers the lookups with a collective between lockstep walk
steps.  The port's K3 walks each read to completion in one launch, so
its lookups read the other cards' shards from inside the kernels,
through peer pointers (csrc/common.cuh scan_row; csrc/shard.cu says
why).  The kernel here, csrc/shard.cu, is that read on its own: the
check of each sharded table at upload (`check_sharded_table`, one launch
per card and table) and the yardstick of the peer reads.
`sharded_rows_ref` is its plain torch version: it restates dbgtpu's
function as written, each shard answering the ids in its own range with
zeros elsewhere and the answers summed (psum_scatter's meaning); the
plain versions of K2 and K3 read a sharded index through it
(`scan_rows_ref`).
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import numpy as np
import torch

from ..kernels import build
from .kmer import mix32_ref


def sharded_rows_ref(shards: Sequence[torch.Tensor],
                     b: torch.Tensor) -> torch.Tensor:
    """Plain version of K13: int32 [*b.shape, W], row b of the table cut
    into `shards` (each [nb_local, W], possibly on other devices) for
    each global bucket id in `b`, zeros for an id outside the table."""
    nbl, W = shards[0].shape
    b = b.to(torch.int64)
    out = torch.zeros(b.shape + (W,), dtype=torch.int32, device=b.device)
    for s, shard in enumerate(shards):
        local = b.to(shard.device) - s * nbl
        mine = (local >= 0) & (local < nbl)
        rows = shard[torch.where(mine, local, 0)]
        out += torch.where(mine[..., None], rows, 0).to(b.device)
    return out


def scan_rows_ref(table: torch.Tensor, shards: Sequence[torch.Tensor],
                  seed: int, hi: torch.Tensor, lo: torch.Tensor):
    """The rows of keys (hi, lo)'s buckets in a fused scan table: `table`
    whole, or, where `shards` is not empty, the table they cut into
    bucket ranges, whose global bucket mask is nb_local * D - 1
    (core.py:389-391)."""
    h = mix32_ref(hi ^ seed, lo)
    if not shards:
        return table[h & (table.shape[0] - 1)]
    return sharded_rows_ref(shards, h & (shards[0].shape[0] * len(shards) - 1))


def sharded_rows_launch(shards: Sequence[torch.Tensor], b: torch.Tensor):
    """K13's checks and allocation on a CUDA id tensor, with its card
    current: (build.Launch into the output, out int32 [*b.shape, W]).
    Every shard must be a contiguous int32 [nb_local, W] tensor on b's
    card or on a card b's card can read (enable_peer_access)."""
    dev = b.device
    if dev.type != "cuda":
        raise ValueError(f"no sharded_rows kernel for device {dev}")
    if torch.cuda.current_device() != dev.index:
        # the launch goes to the current card's stream
        raise ValueError(f"sharded_rows on {dev} must launch with {dev} "
                         "current")
    if b.dtype != torch.int32:
        raise TypeError("bucket ids must be int32")
    if not 1 <= len(shards) <= build.MAX_SHARDS:
        raise ValueError(f"{len(shards)} shards; the kernel takes 1 to "
                         f"{build.MAX_SHARDS}")
    shape = shards[0].shape
    for s in shards:
        if (s.dtype != torch.int32 or s.dim() != 2 or s.shape != shape
                or not s.is_contiguous() or s.device.type != "cuda"):
            raise ValueError("shards must be contiguous int32 CUDA tensors "
                             "of one shape [nb_local, W]")
        if s.device != dev and not torch.cuda.can_device_access_peer(
                dev.index, s.device.index):
            raise ValueError(f"{dev} cannot read the shard on {s.device}")
    if shape[0] < 1 or shape[1] < 1:
        raise ValueError("shards must hold at least one row of one word")
    b = b.contiguous()
    table = build.ShardTableC(n_shards=len(shards), nb_local=shape[0],
                              cols=shape[1])
    for i, s in enumerate(shards):
        table.shards[i] = s.data_ptr()
    out = torch.empty(b.shape + (shape[1],), dtype=torch.int32, device=dev)
    launch = build.Launch("sharded_rows", "dbg_sharded_rows", (
        ctypes.addressof(table), b.data_ptr(), b.numel(), out.data_ptr(),
        build.stream_ptr(dev)), (table, tuple(shards), b, out))
    return launch, out


def sharded_rows(shards: Sequence[torch.Tensor],
                 b: torch.Tensor) -> torch.Tensor:
    """K13 on b's device: the kernel on CUDA, the plain version on the
    CPU, an error anywhere else."""
    if b.device.type == "cpu":
        return sharded_rows_ref(shards, b)
    launch, out = sharded_rows_launch(shards, b)
    if b.numel():
        launch()
        build.count("sharded_rows")
    return out


def enable_peer_access(devices: Sequence[torch.device]) -> None:
    """Let every card of `devices` read every other's memory (peer access
    over NVLink).  Raises naming the first pair that cannot: a sharded
    index is never quietly replicated instead."""
    from ..dist.mesh import check_peers

    cards = sorted({torch.device(d).index for d in devices})
    check_peers([torch.device("cuda", i) for i in cards])
    lib = build.load()
    for i in cards:
        for j in cards:
            if i != j:
                err = lib.dbg_enable_peer_access(i, j)
                if err:
                    raise RuntimeError(
                        f"cuda:{i} cannot enable peer access to cuda:{j}: "
                        f"{lib.dbg_error_string(err).decode()}")


def check_sharded_table(shards: Sequence[torch.Tensor], host: np.ndarray,
                        dev: torch.device, what: str) -> None:
    """A sharded table as card `dev` reads it: the first and last row of
    every shard, read through `dev`'s pointers (K13: one launch on a
    card), must equal the host table's rows.  Raises ValueError naming
    the reading card and the card of the shard otherwise."""
    nbl = shards[0].shape[0]
    ids = np.unique(np.concatenate([np.arange(len(shards)) * nbl,
                                    np.arange(1, len(shards) + 1) * nbl - 1]))
    got = sharded_rows(shards, torch.from_numpy(ids.astype(np.int32)).to(
        dev)).cpu().numpy()
    want = np.ascontiguousarray(host[ids]).view(np.int32)
    for i in np.nonzero((got != want).any(axis=1))[0]:
        s = int(ids[i]) // nbl
        raise ValueError(f"the sharded {what} table: {dev} reads row "
                         f"{int(ids[i])} of the shard on {shards[s].device} "
                         "wrong")
