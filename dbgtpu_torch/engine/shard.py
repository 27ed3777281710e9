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
K2 and K3 read the other cards' shards from inside the kernels through
peer pointers, one lookup at a time, each row where it lies
(csrc/common.cuh scan_row; csrc/shard.cu says why).  The kernel here,
csrc/shard.cu, answers a whole set of ids at once and need not read a
remote row more than once: its host plan (`shard_plan`, `ShardPlan`)
takes the direct path (one launch, each row read where it lies) when
every shard is on the reading card or the ids cannot repeat much, else
the staged path (each remote row that an id asks for crosses NVLink
once into scratch on the reading card, and out is written from there).
Its bound is out's local write for a set of ids larger than the table.
It is the check of each sharded table at upload (`check_sharded_table`,
one launch per card and table, direct) and the yardstick of the sharded
gather in chip_smoke.py.  `sharded_rows_ref` is its plain torch
version: it restates dbgtpu's function as written, each shard answering
the ids in its own range with zeros elsewhere and the answers summed
(psum_scatter's meaning); the plain versions of K2 and K3 read a
sharded index through it (`scan_rows_ref`).
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence
from dataclasses import dataclass

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


@dataclass(frozen=True)
class ShardPlan:
    """How K13 answers a set of ids; csrc/shard.cu `ShardPlan`, field for
    field."""
    staged: int        # 0: the direct path, every row read where it lies
    remote_rows: int   # stage rows: nb_local for each staged shard
    stage_base: tuple  # per shard its first stage row, -1: read in place
    remote: tuple      # the staged shards, in stage order

    @property
    def direct(self) -> bool:
        return not self.staged

    def scratch_words(self, W: int) -> int:
        """int32 words of scratch a call allocates: a flag and a row of W
        words per stage row."""
        return self.remote_rows * (1 + W)


def shard_plan(Q: int, nb_local: int, W: int, local: Sequence[bool],
               staged: bool | None = None) -> ShardPlan:
    """K13's path for Q ids over D = len(local) shards of nb_local rows of
    W words, `local[s]` saying whether shard s lies on the reading card.

    The staged path when some shard lies on another card and the ids can
    repeat: Q above the table's nb_local * D rows, that is, more ids
    expected in the remote shards (Q * remote / D) than they have rows.
    Else the direct path: staging would only add local traffic (the
    upload check's 2 * D ids among those).  `staged` True or False takes
    that path whatever the rule says (a measurement of both); a staged
    plan stages every shard that is not local."""
    D = len(local)
    remote = tuple(s for s in range(D) if not local[s])
    if staged is None:
        staged = bool(remote) and Q > nb_local * D
    if not staged:
        return ShardPlan(staged=0, remote_rows=0, stage_base=(-1,) * D,
                         remote=())
    base = [-1] * D
    for i, s in enumerate(remote):
        base[s] = i * nb_local
    return ShardPlan(staged=1, remote_rows=len(remote) * nb_local,
                     stage_base=tuple(base), remote=remote)


def plan_for(shards: Sequence[torch.Tensor], b: torch.Tensor,
             staged: bool | None = None) -> ShardPlan:
    """`shard_plan` for ids `b` read on b's card."""
    nbl, W = shards[0].shape
    return shard_plan(b.numel(), nbl, W, [s.device == b.device
                                           for s in shards], staged)


def _plan_c(plan: ShardPlan) -> build.ShardPlanC:
    c = build.ShardPlanC(staged=plan.staged, remote_rows=plan.remote_rows,
                         n_remote=len(plan.remote))
    for s in range(build.MAX_SHARDS):
        c.stage_base[s] = (plan.stage_base[s] if s < len(plan.stage_base)
                           else -1)
        c.remote[s] = plan.remote[s] if s < len(plan.remote) else -1
    return c


def sharded_rows_launch(shards: Sequence[torch.Tensor], b: torch.Tensor,
                        plan: ShardPlan | None = None):
    """K13's checks and allocation on a CUDA id tensor, with its card
    current: (build.Launch into the output, out int32 [*b.shape, W]).
    Every shard must be a contiguous int32 [nb_local, W] tensor on b's
    card or on a card b's card can read (enable_peer_access).  `plan`
    (default `plan_for(shards, b)`) chooses the path.  A staged plan
    allocates its scratch here through PyTorch's caching allocator,
    `plan.scratch_words(W)` int32 words on b's card: a flag per stage
    row and the stage, uint32 [remote_rows, W].  The plan stages only
    where Q exceeds the table's rows, so the scratch is never more than
    out plus 4 bytes per table row."""
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
    plan = plan_for(shards, b) if plan is None else plan
    if len(plan.stage_base) != len(shards):
        raise ValueError(f"a plan for {len(plan.stage_base)} shards, not "
                         f"{len(shards)}")
    flags = torch.empty(plan.remote_rows, dtype=torch.int32, device=dev)
    stage = torch.empty(plan.remote_rows, shape[1], dtype=torch.int32,
                        device=dev)
    out = torch.empty(b.shape + (shape[1],), dtype=torch.int32, device=dev)
    args = build.ShardArgsC(
        table=build.ShardTableC(n_shards=len(shards), nb_local=shape[0],
                                cols=shape[1]),
        plan=_plan_c(plan), ids=b.data_ptr(), Q=b.numel(),
        flags=flags.data_ptr(), stage=stage.data_ptr(), out=out.data_ptr(),
        stream=build.stream_ptr(dev))
    for i, s in enumerate(shards):
        args.table.shards[i] = s.data_ptr()
    launch = build.Launch("sharded_rows", "dbg_sharded_rows",
                          (ctypes.addressof(args),),
                          (args, tuple(shards), b, flags, stage, out))
    return launch, out


def sharded_rows(shards: Sequence[torch.Tensor],
                 b: torch.Tensor) -> torch.Tensor:
    """K13 on b's device: the kernel on CUDA (by the host's plan), the
    plain version on the CPU, an error anywhere else."""
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
