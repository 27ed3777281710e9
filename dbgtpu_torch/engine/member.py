"""K2 member: per-position junction membership of the anchor scan.

Counterpart of dbgtpu/engine/core.py _closure_member, _st_member /
_st_member_positions and the choice between them (align_batch
:1033-1051): closure probes into `pt_rows` (one probe answers W
positions) when the batch holds no N and a probe table exists, exact
per-position lookups of rep1 and rep2 in the junction table otherwise
(`st_fused`, or under the mphf layout the MPHF slot and the stored-key
verify in `mph_jrows`; core.py:434-435, 454-456).  The kernel is
csrc/member.cu; `member_ref` is its plain torch version.  A sharded
index (`--shard-index`) is read through engine/shard.py scan_rows_ref
here and through csrc/common.cuh scan_row in the kernel, by one of two
paths that the host plan (`member_plan`) picks before the launch: direct
(each remote row read over NVLink where it lies, once per probe of it)
or staged (csrc/shard.cu dbg_member_staged: a stage pass copies each
remote row the batch's keys hit, once, into scratch on the reading card,
and K2 reads it there).  On the CPU `member_ref` is the plain version of
both.

The kernel's second mode serves exhaustive mode (-b): the one mask
`inter` of dbgtpu/engine/exhaustive.py:118-148.  Without N it is the
same closure probe; with N (or without a probe table) it looks up the
canonical of the bug scan against ITS OWN reverse complement,
canonical(bug, rcb(bug)) (:130-136), not greedy's canonical(bug, rcs),
and position 0 is always set: every read tries its first anchor.
"""

from __future__ import annotations

import ctypes
import math
from collections.abc import Sequence
from dataclasses import dataclass

import torch

from ..index.device import PT_SLOTS
from ..kernels import build
from ..kernels.measure import HBM_BYTES_PER_S, NVLINK_BYTES_PER_S
from .index import LOOKUP_CHUNK, IndexTensors, c_index_arg
from .kmer import M32, as_i32, rcb_ref, split_ref
from .mphf import _signed32, mphf_rows_ref
from .read_scan import Scan, unpack_fields
from .shard import ShardPlan, _plan_c, scan_rows_ref, shard_plan

# wrapper calls on CUDA by K2's path ("direct": dbg_member as uploaded,
# "staged": dbg_member_staged); a run's check that it took the plan's path
calls = {"direct": 0, "staged": 0}


def junction_vals_ref(ix: IndexTensors, keys: torch.Tensor):
    """Junction lookup of canonical int64 (k-1)-mers of any shape, under
    the index's layout (core._junction_vals): (found bool, vals8 int64
    [..., 8] = 4 left + 4 right id slots; meaningful where found)."""
    if ix.mph_meta is not None:
        found, row = mphf_rows_ref(ix.mph_rows, ix.mph_f, ix.mph_jrows,
                                   ix.mph_meta, keys)
        return found, _signed32(row[..., 2:10])
    S = ix.st_slots
    hi, lo = split_ref(keys)
    row = scan_rows_ref(ix.st_fused, ix.st_shards, ix.st_seed, hi, lo)
    ok = (row[..., :S] == as_i32(hi)[..., None]) & (
        row[..., S : 2 * S] == as_i32(lo)[..., None])
    vals = row[..., 2 * S :].reshape(ok.shape + (8,)).to(torch.int64) & M32
    vals8 = torch.where(ok[..., None], vals, 0).sum(dim=-2) & M32
    return ok.any(dim=-1), _signed32(vals8)


def st_member_ref(ix: IndexTensors, keys: torch.Tensor) -> torch.Tensor:
    """Exact membership of int64 k-mers [B, Lk] in the junction table,
    LOOKUP_CHUNK positions at a time."""
    out = torch.empty(keys.shape, dtype=torch.bool, device=keys.device)
    chunk = LOOKUP_CHUNK
    for c0 in range(0, keys.shape[1], chunk):
        out[:, c0 : c0 + chunk] = junction_vals_ref(
            ix, keys[:, c0 : c0 + chunk])[0]
    return out


def _closure_member_ref(ix: IndexTensors, scan: Scan, L: int,
                        k1: int) -> torch.Tensor:
    """core._closure_member: position i is answered by the probe of
    p = min(W*(i//W)+1, Lk-1) at offset d = i - p, through the
    neighbour bits of index/device.py ProbeTable."""
    S = PT_SLOTS
    W = ix.pt_window
    B, Lk = scan.rep1.shape
    dev = scan.rep1.device
    i = torch.arange(Lk, device=dev)
    p = torch.clamp(W * (i // W) + 1, max=Lk - 1)
    d = i - p
    hi, lo = split_ref(scan.rep1[:, p])                 # [B, Lk]
    row = scan_rows_ref(ix.pt_rows, ix.pt_shards, ix.pt_seed, hi, lo)
    ok = (row[..., :S] == as_i32(hi ^ M32)[..., None]) & (
        row[..., S : 2 * S] == as_i32(lo)[..., None]
    )
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def word(c):
        return torch.where(ok, row[..., c * S : (c + 1) * S].to(torch.int64)
                           & M32, zero).sum(dim=-1) & M32

    w0 = word(2)
    w1 = word(3) if W == 4 else torch.zeros_like(w0)
    onum = 1 - scan.le1[:, p].to(torch.int64)
    codes = unpack_fields(scan.rows[0], 2, L)

    def base(cols):
        return codes[:, cols]

    fb = base(torch.clamp(p - 1, min=0))
    c1 = base(torch.clamp(p + k1, max=L - 1))
    c2 = base(torch.clamp(p + k1 + 1, max=L - 1))
    idx = torch.where(
        d < 0, 9 + 4 * onum + fb,
        torch.where(d == 0, zero,
                    torch.where(d == 1, 1 + 4 * onum + c1,
                                17 + 16 * onum + ((c1 << 2) | c2))),
    )
    bit = torch.where(idx < 32, w0 >> idx.clamp(max=31),
                      w1 >> (idx - 32).clamp(min=0)) & 1
    return bit.bool()


def member_ref(ix: IndexTensors, scan: Scan, lens, *, L: int, k1: int):
    """Plain torch version of K2 -> (member1, member2) uint8 [B, Lk]."""
    Lk = scan.rep1.shape[1]
    valid = (torch.arange(Lk, device=lens.device)[None, :]
             <= (lens.to(torch.int64) - k1)[:, None])
    if ix.pt_rows.shape[0] == 0 or bool(scan.has_n.item()):
        m1 = st_member_ref(ix, scan.rep1) & valid
        m2 = st_member_ref(ix, scan.rep2) & valid
    else:
        m1 = _closure_member_ref(ix, scan, L, k1) & valid
        m2 = m1
    return m1.to(torch.uint8), m2.to(torch.uint8)


def inter_ref(ix: IndexTensors, scan: Scan, lens, *, L: int,
              k1: int) -> torch.Tensor:
    """Plain torch version of K2's exhaustive mode -> inter uint8 [B, Lk]:
    (member & valid) | (column == 0)."""
    Lk = scan.bug.shape[1]
    col = torch.arange(Lk, device=lens.device)[None, :]
    valid = col <= (lens.to(torch.int64) - k1)[:, None]
    if ix.pt_rows.shape[0] == 0 or bool(scan.has_n.item()):
        rb = rcb_ref(scan.bug, k1)
        m = st_member_ref(ix, torch.minimum(scan.bug, rb))
    else:
        m = _closure_member_ref(ix, scan, L, k1)
    return ((m & valid) | (col == 0)).to(torch.uint8)


@dataclass(frozen=True)
class MemberPlan:
    """K2's path on a sharded index: csrc/shard.cu MemberStage's two
    plans, one for each table K2 may read: `probe`, the probe table of
    path (a), and `scan`, the junction scan table of path (b).  The
    batch's N flag picks the table on the card."""
    probe: ShardPlan
    scan: ShardPlan

    @property
    def direct(self) -> bool:
        return self.probe.direct and self.scan.direct

    def scratch_words(self, pt_cols: int, st_cols: int) -> tuple[int, int]:
        """(flag words, stage words) of int32 a staged call allocates: a
        flag per stage row and the stage, one for both tables, since a
        batch reads one of them."""
        return (max(self.probe.remote_rows, self.scan.remote_rows),
                max(self.probe.remote_rows * pt_cols,
                    self.scan.remote_rows * st_cols))


def stage_pays(Q: int, nb: int, cols: int, remote_share: float,
               probe_bytes: int) -> bool:
    """Whether Q lookups into a table of nb rows of `cols` words, a
    `remote_share` of its rows on other cards, take less time staged
    than read where they lie.  Staged: the expected distinct remote rows
    of Q uniform buckets, remote_share * nb * (1 - e^(-Q/nb)), cross
    NVLink once (cols * 4 bytes each) and are written to the stage and
    read from it at the memory rate, after the mark pass reads the Q
    keys (8 bytes each).  Direct: each remote lookup moves `probe_bytes`
    over NVLink."""
    if remote_share <= 0 or Q < 1 or nb < 1:
        return False
    pulled = remote_share * nb * -math.expm1(-Q / nb) * cols * 4
    t_staged = (pulled / NVLINK_BYTES_PER_S
                + (2 * pulled + 8 * Q) / HBM_BYTES_PER_S)
    t_direct = remote_share * Q * probe_bytes / NVLINK_BYTES_PER_S
    return t_staged < t_direct


def member_plan(B: int, Lk: int, pt_shape: Sequence[int],
                st_shape: Sequence[int], local: Sequence[bool],
                staged: bool | None = None) -> MemberPlan:
    """K2's plan for a batch of B reads of Lk scan positions on an index
    cut into D = len(local) ranges, `local[s]` saying whether range s lies
    on the reading card; `pt_shape` and `st_shape` are (rows, cols) of
    one range of the probe table (0 rows: none) and of the junction
    table.

    Path (a) probes Q = B * ceil(Lk / W) windows, each reading its row's
    S key-hi and S key-lo words and, on a hit, W - 2 neighbour words;
    path (b) looks up Q = B * Lk positions, each reading the 2S key
    words of its row (found only; rep2's lookups on reads with N are
    not counted).  Each table is staged where `stage_pays`, every range
    not on the card (engine/shard.py shard_plan's layout: range s at
    stage row stage_base[s]).  `staged` True or False takes that path
    for both tables whatever the rule says (a measurement); with every
    range on the card nothing is staged."""
    D = len(local)
    share = sum(not x for x in local) / D

    def one(shape, Q, probe_bytes):
        nb_local, cols = shape
        stage = (staged if staged is not None else
                 stage_pays(Q, nb_local * D, cols, share, probe_bytes))
        return shard_plan(Q, nb_local, cols, local,
                          staged=bool(stage) and nb_local > 0 and share > 0)

    W = 4 if pt_shape[1] == 4 * PT_SLOTS else 3
    return MemberPlan(
        probe=one(pt_shape, B * -(-Lk // W), 4 * (2 * PT_SLOTS + W - 2)),
        scan=one(st_shape, B * Lk, 4 * 2 * (st_shape[1] // 10)))


def plan_for(ix: IndexTensors, scan: Scan, staged: bool | None = None,
             local: Sequence[bool] | None = None) -> MemberPlan:
    """`member_plan` for K2 on `scan`'s batch, read on scan's device (or,
    `local` given, as if the ranges it names False lay on other cards);
    an index that is not sharded is read directly."""
    if not ix.st_shards:
        local = [True]
    elif local is None:
        local = [s.device == scan.rep1.device for s in ix.st_shards]
    B, Lk = scan.rep1.shape
    return member_plan(B, Lk, ix.pt_rows.shape, ix.st_fused.shape, local,
                       staged)


def member(ix: IndexTensors, scan: Scan, lens, *, L: int, k1: int):
    """K2 on the scan's device: the kernel on CUDA, the plain version on
    the CPU, an error anywhere else."""
    return _member(ix, scan, lens, L=L, k1=k1, exhaustive=False)


def inter(ix: IndexTensors, scan: Scan, lens, *, L: int, k1: int):
    """K2's exhaustive mode on the scan's device, as `member`."""
    return _member(ix, scan, lens, L=L, k1=k1, exhaustive=True)


def _member(ix: IndexTensors, scan: Scan, lens, *, L: int, k1: int,
            exhaustive: bool):
    dev = scan.rep1.device
    if dev.type == "cpu":
        if exhaustive:
            return inter_ref(ix, scan, lens, L=L, k1=k1)
        return member_ref(ix, scan, lens, L=L, k1=k1)
    if dev.type != "cuda":
        raise ValueError(f"no member kernel for device {dev}")
    launch, out = member_launch(ix, scan, lens, L=L, k1=k1,
                                exhaustive=exhaustive)
    if scan.rep1.shape[0]:
        launch()
        build.count("member")
        calls["staged" if launch.entry == "dbg_member_staged"
              else "direct"] += 1
    return out


def member_launch(ix: IndexTensors, scan: Scan, lens, *, L: int, k1: int,
                  exhaustive: bool, plan: MemberPlan | None = None,
                  passes: int = 7):
    """K2's checks and allocation on CUDA tensors: (build.Launch into the
    outputs, inter or (member1, member2)).  `plan` (default
    `plan_for(ix, scan)`) picks the path on a sharded index.  A staged
    plan launches dbg_member_staged with its card current (`passes`:
    mark 1, pull 2, K2 4; a measurement of the parts runs 1 and 3, which
    leave the outputs unwritten), and allocates its scratch here through
    PyTorch's caching allocator on the card's current stream, the one
    both launches go to: a later batch's stage reuses the memory only
    behind this batch's K2 (the launch's tensors end with the flags and
    the stage)."""
    dev = scan.rep1.device
    if lens.device != dev:
        raise ValueError("index, scan and lens must share a device")
    if lens.dtype != torch.int32:
        raise TypeError("lens must be int32")
    B, Lk = scan.rep1.shape
    lens = lens.contiguous()
    scan = Scan(*(t.contiguous() for t in scan))
    m1 = torch.empty((B, Lk), dtype=torch.uint8, device=dev)
    m2 = None if exhaustive else torch.empty_like(m1)
    out = m1 if exhaustive else (m1, m2)
    plan = plan_for(ix, scan) if plan is None else plan
    if plan.direct:
        launch = build.Launch("member", "dbg_member", (
            scan.rep1.data_ptr(), scan.le1.data_ptr(), scan.rep2.data_ptr(),
            scan.bug.data_ptr(), int(exhaustive),
            scan.rows[0].data_ptr(), scan.rows.shape[2], lens.data_ptr(), B,
            L, k1, c_index_arg(ix, dev), scan.has_n.data_ptr(),
            m1.data_ptr(), None if m2 is None else m2.data_ptr(),
            build.stream_ptr(dev),
        ), (ix, scan, lens, m1, m2))
        return launch, out
    if torch.cuda.current_device() != dev.index:
        # the stage pass is sized by, and launches on, the current card
        raise ValueError(f"a staged member on {dev} must launch with {dev} "
                         "current")
    D = len(ix.st_shards)
    if ix.mph_meta is not None or any(
            len(p.stage_base) != D for p in (plan.probe, plan.scan)):
        raise ValueError(f"a staged member needs the scan layout cut into "
                         f"ranges and a plan for its {D} ranges")
    n_flags, n_stage = plan.scratch_words(ix.pt_rows.shape[1],
                                          ix.st_fused.shape[1])
    flags = torch.empty(n_flags, dtype=torch.int32, device=dev)
    stage = torch.empty(n_stage, dtype=torch.int32, device=dev)
    args = build.MemberStageArgsC(
        rep1=scan.rep1.data_ptr(), le1=scan.le1.data_ptr(),
        rep2=scan.rep2.data_ptr(), bug=scan.bug.data_ptr(),
        rwf=scan.rows[0].data_ptr(), lens=lens.data_ptr(),
        index=c_index_arg(ix, dev), has_n=scan.has_n.data_ptr(),
        member1=m1.data_ptr(), member2=None if m2 is None else m2.data_ptr(),
        stream=build.stream_ptr(dev), flags=flags.data_ptr(),
        stage=stage.data_ptr(), exhaustive=int(exhaustive),
        RWr=scan.rows.shape[2], B=B, L=L, k1=k1, passes=passes)
    args.plan[0] = _plan_c(plan.probe)
    args.plan[1] = _plan_c(plan.scan)
    launch = build.Launch("member", "dbg_member_staged",
                          (ctypes.addressof(args),),
                          (ix, scan, lens, m1, m2, args, flags, stage))
    return launch, out
