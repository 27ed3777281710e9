"""K7 mphf_slots: the minimal-perfect-hash lookup on the device.

Counterpart of dbgtpu/engine/core.py _mphf_slot_arrays (and
index/mphf.py device_lookup, which tests pin equal to it): a k-mer ->
its slot in [0, n), or a negative value when it misses every level and
the final table.  Per level: hash with the level's seeds, test the bit,
rank = the rank-group row's base + popcounts of the words below; the
first level whose bit is set wins; then the two-choice final table.  A
key outside the build set may alias another key's slot, so every caller
verifies against the key stored at the slot (`mphf_rows_ref`; in CUDA
csrc/mphf.cuh mphf_row).

The kernel is csrc/mphf.cu (`mphf_plan`: 1, 2 or 4 queries a thread,
their row loads in flight together, and the block size); the mapping
kernels call the same device function inline.  `mphf_slot_ref` is the plain
torch version: like the JAX one it evaluates every level for every
query.  The kernel's check mode (`mphf_check`, plain version
`mphf_check_ref`) counts the stored keys of an MPHF-backed table that
come back at another slot than their row: the check of each table at
upload (`check_mphf_table`), one launch and a 4-byte read per table.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import TYPE_CHECKING

import torch

from ..kernels import build
from .kmer import M32, mix32_ref, split_ref

if TYPE_CHECKING:
    from .index import MphfMeta

_H2A, _H2B = 0x7FEB352D, 0x846CA68B
# stored keys the plain check looks up at a time (bounds host memory)
CHECK_CHUNK = 1 << 22
# an H100 SM's most resident threads, and K7's most threads per block
# (csrc/mphf.cu kThreads) and fewest
SM_THREADS, MPHF_THREADS, MPHF_MIN_THREADS = 2048, 256, 64


@dataclass(frozen=True)
class MphfPlan:
    """K7's launch: `per_thread` keys a thread (1, 2 or 4) in blocks of
    `threads`."""
    per_thread: int
    threads: int


def mphf_block(n: int, per_thread: int, sms: int) -> int:
    """Threads per block for n keys at `per_thread` a thread on `sms`
    SMs: MPHF_THREADS, halved down to MPHF_MIN_THREADS while the blocks
    would not reach every SM twice, so that a small table spreads over
    the whole card."""
    threads = MPHF_THREADS
    while (threads > MPHF_MIN_THREADS
           and -(-n // (per_thread * threads)) < 2 * sms):
        threads //= 2
    return threads


def mphf_plan(n: int, sms: int) -> MphfPlan:
    """K7's launch for n keys on `sms` SMs: 2 keys a thread where that
    still leaves every SM a full set of resident threads (n >= 2 * sms *
    SM_THREADS), else 1 (a small table is a launch and two dependent
    trips, which more keys a thread only lengthen).  The kernel also
    takes 4 keys a thread, which measured slower than 2 on an H100 at
    every table size tried (48 registers, 40 warps per SM; PERF.md);
    chip_smoke.py times it beside the plan."""
    per_thread = 2 if n >= 2 * sms * SM_THREADS else 1
    return MphfPlan(per_thread, mphf_block(n, per_thread, sms))


def plan_mphf(n: int, dev: torch.device) -> MphfPlan:
    """`mphf_plan` for n keys on CUDA device `dev`."""
    from .gather import _card_of

    return mphf_plan(n, _card_of(dev)[0])


def mix32b_ref(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Second hash of a k-mer pair (kmer32.mix32b) on int64 lanes holding
    32-bit values."""
    return mix32_ref(lo ^ _H2A, hi ^ _H2B)


def _popc32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of 32-bit values held in int64 lanes."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _signed32(x: torch.Tensor) -> torch.Tensor:
    """32-bit values in int64 lanes, read as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def mphf_slot_ref(rows: torch.Tensor, frows: torch.Tensor, meta: MphfMeta,
                  keys: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K7: int64 k-mers of any shape -> int32
    slots, negative = not found.  rows int32 [ng, 5], frows int32
    [nbf, 12] (uint32 bits)."""
    hi, lo = split_ref(keys)
    res = torch.full(keys.shape, -1, dtype=torch.int64, device=keys.device)
    for lvl in range(meta.n_levels):
        pos = (mix32_ref(hi ^ meta.seeds_hi[lvl], lo ^ meta.seeds_lo[lvl])
               & meta.masks[lvl])
        w = pos >> 5
        sh = pos & 31
        row = rows[meta.row_offs[lvl] + (w >> 2)].to(torch.int64) & M32
        wsel = w & 3
        word = row[..., 1:5].gather(-1, wsel[..., None])[..., 0]
        below = (torch.ones_like(sh) << sh) - 1     # sh <= 31: no overflow
        rank = _signed32(row[..., 0])
        for j in range(4):
            wordj = row[..., 1 + j]
            rank = rank + torch.where(
                wsel > j, _popc32(wordj),
                torch.where(wsel == j, _popc32(wordj & below), 0))
        res = torch.where((res < 0) & (((word >> sh) & 1) == 1), rank, res)
    if meta.final_nb:
        fval = torch.full_like(res, -1)
        for hfn in (mix32_ref, mix32b_ref):
            frow = frows[hfn(hi, lo) & (meta.final_nb - 1)].to(
                torch.int64) & M32
            ok = (frow[..., 0:4] == hi[..., None]) & (
                frow[..., 4:8] == lo[..., None])
            # values of every matching slot are summed (empty slots hold
            # the all-ones key and value 0); the first bucket with a
            # match wins
            v = _signed32(torch.where(ok, frow[..., 8:12], 0).sum(-1) & M32)
            fval = torch.where((fval < 0) & ok.any(-1), v, fval)
        res = torch.where(res < 0, fval, res)
    return res.to(torch.int32)


def _tables_on(dev: torch.device, rows, frows, meta: MphfMeta) -> None:
    """Raise unless K7 takes these MPHF tensors on CUDA device `dev`."""
    if dev.type != "cuda":
        raise ValueError(f"no mphf_slots kernel for device {dev}")
    if rows.device != dev or frows.device != dev:
        raise ValueError("the MPHF tables and the keys must share a device")
    if rows.dtype != torch.int32 or frows.dtype != torch.int32:
        raise TypeError("the MPHF tables must be int32")
    if rows.shape[1:] != (5,) or frows.shape[1:] != (12,):
        raise ValueError("rows must be [ng, 5] and frows [nbf, 12]")
    if meta.n_levels and not rows.shape[0]:
        raise ValueError("the MPHF has levels but no rank-group rows")
    if meta.final_nb != frows.shape[0]:
        raise ValueError("frows does not have meta.final_nb buckets")


def mphf_slots_launch(rows, frows, meta: MphfMeta, keys, out,
                      plan: MphfPlan) -> build.Launch:
    """K7 on checked CUDA tensors (keys int64, n > 0, out int32 of keys'
    size, both contiguous) as one `build.Launch`, its stream bound now."""
    return build.Launch("mphf_slots", "dbg_mphf_slots", (
        rows.data_ptr(), frows.data_ptr(), ctypes.addressof(meta.c_struct),
        keys.data_ptr(), keys.numel(), plan.per_thread, plan.threads,
        out.data_ptr(), build.stream_ptr(keys.device)),
        (rows, frows, keys, out, meta))


def mphf_check_launch(rows, frows, vrows, meta: MphfMeta, bad,
                      plan: MphfPlan) -> build.Launch:
    """K7's check mode on checked CUDA tensors (vrows int32 [n, cols], n
    > 0, contiguous; bad int32 [1]) as one `build.Launch`, its stream
    bound now."""
    return build.Launch("mphf_slots", "dbg_mphf_check", (
        rows.data_ptr(), frows.data_ptr(), ctypes.addressof(meta.c_struct),
        vrows.data_ptr(), vrows.shape[1], vrows.shape[0], plan.per_thread,
        plan.threads, bad.data_ptr(), build.stream_ptr(vrows.device)),
        (rows, frows, vrows, bad, meta))


def mphf_slots(rows: torch.Tensor, frows: torch.Tensor, meta: MphfMeta,
               keys: torch.Tensor) -> torch.Tensor:
    """K7 on the keys' device: the kernel on CUDA, the plain version on
    the CPU, an error anywhere else."""
    dev = keys.device
    if dev.type == "cpu":
        return mphf_slot_ref(rows, frows, meta, keys)
    rows, frows = rows.contiguous(), frows.contiguous()
    _tables_on(dev, rows, frows, meta)
    if keys.dtype != torch.int64:
        raise TypeError("keys must be int64")
    keys = keys.contiguous()
    out = torch.empty(keys.shape, dtype=torch.int32, device=dev)
    if keys.numel():
        mphf_slots_launch(rows, frows, meta, keys, out,
                          plan_mphf(keys.numel(), dev))()
        build.count("mphf_slots")
    return out


def mphf_check_ref(rows, frows, vrows, meta: MphfMeta) -> int:
    """Plain version of K7's check mode: how many of the keys stored in
    `vrows` (the first two words of each row) `mphf_slot_ref` sends to
    another slot than their row, over the whole table, CHECK_CHUNK keys
    at a time."""
    n, bad = vrows.shape[0], 0
    for s0 in range(0, n, CHECK_CHUNK):
        part = vrows[s0 : s0 + CHECK_CHUNK, :2].to(torch.int64) & M32
        slots = mphf_slot_ref(rows, frows, meta,
                              (part[:, 0] << 32) | part[:, 1])
        want = torch.arange(s0, s0 + part.shape[0], dtype=torch.int32,
                            device=slots.device)
        bad += int((slots != want).sum())
    return bad


def mphf_check(rows, frows, vrows, meta: MphfMeta) -> int:
    """K7's check mode on vrows's device (int32 [n, cols], the key's hi
    and lo words first): how many stored keys come back at another slot
    than their row.  The kernel on CUDA (one launch, counted as
    mphf_slots, and a 4-byte read), the plain version on the CPU, an
    error anywhere else."""
    dev = vrows.device
    if dev.type == "cpu":
        return mphf_check_ref(rows, frows, vrows, meta)
    rows, frows = rows.contiguous(), frows.contiguous()
    _tables_on(dev, rows, frows, meta)
    if vrows.dtype != torch.int32 or vrows.dim() != 2 or vrows.shape[1] < 2:
        raise ValueError("vrows must be int32 [n, cols >= 2]")
    if not vrows.shape[0]:
        return 0
    vrows = vrows.contiguous()
    bad = torch.empty(1, dtype=torch.int32, device=dev)
    mphf_check_launch(rows, frows, vrows, meta, bad,
                      plan_mphf(vrows.shape[0], dev))()
    build.count("mphf_slots")
    return int(bad.item())


def check_mphf_table(rows, frows, vrows, meta: MphfMeta, what: str) -> None:
    """An MPHF-backed table as it lies on its device: every key stored in
    `vrows` (its first two words) must come back from the lookup at its
    own row (`mphf_check`: on CUDA one K7 launch for the whole table).
    Raises ValueError otherwise, naming the table and the count of keys
    at the wrong slot."""
    n = vrows.shape[0]
    if n != meta.n_keys:
        raise ValueError(f"the {what} MPHF has {meta.n_keys} keys and its "
                         f"table {n} rows")
    bad = mphf_check(rows, frows, vrows, meta)
    if bad:
        raise ValueError(f"the {what} MPHF on {vrows.device} returns "
                         f"{bad} of its own keys at the wrong slot")


def mphf_rows_ref(rows, frows, vrows, meta: MphfMeta, keys):
    """MPHF-backed table lookup: (found bool, row int64 [..., cols] with
    32-bit values) — the slot's row of `vrows` where the key stored in
    its first two words is the query (core._junction_vals :409-412,
    dog._anchor_lookup :68-79)."""
    hi, lo = split_ref(keys)
    slot = mphf_slot_ref(rows, frows, meta, keys).to(torch.int64)
    n = vrows.shape[0]
    if n == 0:
        return (torch.zeros(keys.shape, dtype=torch.bool, device=keys.device),
                torch.zeros(keys.shape + (vrows.shape[1],),
                            dtype=torch.int64, device=keys.device))
    row = vrows[slot.clamp(0, n - 1)].to(torch.int64) & M32
    found = ((slot >= 0) & (slot < n) & (row[..., 0] == hi)
             & (row[..., 1] == lo))
    return found, row
