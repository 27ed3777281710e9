"""K9-K12: the gather kernels of the member-stage experiments.

Counterparts of the four Pallas kernels of scripts/exp_r5_pallas.py and
scripts/archive/exp_pallas_gather.py, which asked whether a hand-written
gather beats the compiler's on the member stage's access pattern (random
96-byte rows of the closure probe table).  Tables are uint32 bits held
in int32 tensors, as everywhere in the port; indices are int32; every
sum wraps mod 2^32.

  K9  gather_rows(tbl [NB, W], idx [n], G)      -> [n * G, W]
        out[i*G+g, :] = tbl[idx[i]*G+g, :]      (exp_r5_pallas.py `kern`)
  K10 gather_rowsum(tbl [NB, W], idx [N], CH)   -> [N // CH, 1]
        out[c] = sum of the rows tbl[idx[c*CH : (c+1)*CH]]
                                                (exp_r5_pallas.py `kern_vmem`)
  K11 gather_rows_sum(tbl [NB, W], idx [B, J], reps) -> [B]
        out[b] = reps * sum_j sum_c tbl[idx[b, j], c]
                                                (exp_pallas_gather.py `kernel`)
  K12 gather_take_sum(tbl1 [NB], idx [B, J], reps)   -> [B]
        out[b] = reps * sum_j tbl1[idx[b, j]]  (exp_pallas_gather.py `kernel2`)

Each function is defined by its plain torch version here (`*_ref`), which
tests hold equal to the Pallas body in interpret mode.  Two `out_shape`s
of the scripts are not carried over: `kern` declares N // G output rows
while its grid writes G rows per step, and both archive calls declare one
tile of output while their grid has B // TILE steps; the outputs here are
[n * G, W] and [B].  The kernels are csrc/gather.cu.  K10 is one launch
of a persistent grid whose warps take equal ranges of rows
(`rowsum_plan`); K11 and K12 do the gather `reps` times, as the Pallas
bodies do, from shared memory, under a plan made here on the host
(`gather_plan`: the table in slices, the direct or the bucketed path,
the entry width, the grids).  On the card, K9 does not range-check its
indices; K10, K11 and K12 take an index outside [0, NB) as NB - 1
(`in_table`), so that a stray one stays inside their buffers.  The
plain versions index as torch does.

Each wrapper checks its arguments, allocates its output (K11 and K12
also their plan's scratch, `gather_scratch`) and calls its `launch_*`
function (K10: `rowsum_launch`), which is the bound C entry point on
tensors the caller holds and nothing more: what a measurement of the
kernel alone calls back to back (tools/exp_gather.py).  Only the
wrappers count launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import astuple, dataclass

import torch

from ..kernels import build
from .kmer import M32

# K10: warps per block (csrc/gather.cu kRowsumThreads / 32) and the rows
# of one index window, the fewest a warp is given where N allows
ROWSUM_WARPS = 8
ROWSUM_WINDOW = 32
# rows of idx gathered at a time by the plain K11 (bounds its int64 rows)
_REF_ROWS = 4096
# K11 / K12 (`gather_plan`)
SLICE_BYTES = 64 * 1024     # most table bytes a bucketed slice holds
ACC_MIN_SLICE = 16 * 1024   # smallest slice worth the sums in shared memory
ACC_MIN_ENTRIES = 4096      # fewest entries per slice worth them
GATHER_THREADS = 1024       # a direct or `acc` gather block
SLICE_THREADS = 256         # any other bucketed gather block (csrc/gather.cu
#                             kGatherThreads, kSliceThreads: their launch
#                             bounds)
COUNT_THREADS = 1024        # csrc/gather.cu kCountThreads
SCATTER_PER = 16            # csrc/gather.cu kScatterPer
MAX_SLICES = 16384          # a count block's histogram: 64 KB
STATIC_SMEM = 256           # a block's static shared memory, with room
SM_RESERVED = 1024          # shared memory the card keeps per block
SM_THREADS = 2048           # resident threads per SM
# the passes of the bucketed path, as the C entry points take them
PASSES = {"count": 1, "scatter": 2, "gather": 4}
ALL_PASSES = 7


def _wrap32(s: torch.Tensor) -> torch.Tensor:
    """int64 sums -> int32 holding their low 32 bits."""
    s = s & M32
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def gather_rows_ref(tbl: torch.Tensor, idx: torch.Tensor,
                    G: int = 1) -> torch.Tensor:
    """Plain torch version of K9."""
    g = torch.arange(G, device=idx.device)
    rows = (idx.to(torch.int64)[:, None] * G + g[None, :]).reshape(-1)
    return tbl[rows]


def gather_rowsum_ref(tbl: torch.Tensor, idx: torch.Tensor,
                      CH: int) -> torch.Tensor:
    """Plain torch version of K10."""
    n_chunks = _n_chunks(idx, CH)
    per_row = tbl[idx.to(torch.int64)].to(torch.int64).sum(-1)
    return _wrap32(per_row.reshape(n_chunks, CH).sum(1))[:, None]


def gather_rows_sum_ref(tbl: torch.Tensor, idx: torch.Tensor,
                        reps: int = 1) -> torch.Tensor:
    """Plain torch version of K11."""
    parts = [tbl[idx[b0 : b0 + _REF_ROWS].to(torch.int64)]
             .to(torch.int64).sum((1, 2))
             for b0 in range(0, idx.shape[0], _REF_ROWS)]
    total = (torch.cat(parts) if parts
             else torch.zeros(0, dtype=torch.int64, device=idx.device))
    return _wrap32((total & M32) * reps)


def gather_take_sum_ref(tbl1: torch.Tensor, idx: torch.Tensor,
                        reps: int = 1) -> torch.Tensor:
    """Plain torch version of K12."""
    total = tbl1[idx.to(torch.int64)].to(torch.int64).sum(1)
    return _wrap32((total & M32) * reps)


def in_table(idx: torch.Tensor, NB: int) -> torch.Tensor:
    """The indices K10, K11 and K12 take on the card for idx into a table
    of NB rows: any outside [0, NB) as NB - 1."""
    return torch.where((idx < 0) | (idx >= NB), NB - 1, idx)


def _n_chunks(idx: torch.Tensor, CH: int) -> int:
    if CH < 1 or idx.dim() != 1 or idx.shape[0] % CH:
        raise ValueError(f"idx {tuple(idx.shape)} is not a whole number of "
                         f"chunks of {CH}")
    return idx.shape[0] // CH


def _check(name: str, tbl: torch.Tensor, idx: torch.Tensor, tbl_dim: int,
           idx_dim: int):
    """The device of a launch, or None for the plain version (CPU
    tensors); raises on what the kernel does not take."""
    dev = idx.device
    if tbl.device != dev:
        raise ValueError("tbl and idx must share a device")
    if tbl.dim() != tbl_dim or idx.dim() != idx_dim:
        raise ValueError(f"{name}: tbl must have {tbl_dim} and idx "
                         f"{idx_dim} dimensions")
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    if tbl.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError("tbl and idx must be int32")
    if not (tbl.is_contiguous() and idx.is_contiguous()):
        raise ValueError("tbl and idx must be contiguous")
    if tbl.numel() == 0 and idx.numel():
        raise ValueError("cannot gather from an empty table")
    return dev


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple[int, int]:
    """(SM count, most dynamic shared memory a block may ask for) of CUDA
    device `index`, asked once: the query costs as much as a kernel."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def _card_of(dev: torch.device) -> tuple[int, int]:
    return _card(torch.cuda.current_device() if dev.index is None
                 else dev.index)


@dataclass(frozen=True)
class RowsumPlan:
    """K10's one launch: `blocks` blocks of ROWSUM_WARPS warps, of which
    the first `warps` take rows [N w / warps, N (w + 1) / warps) each and
    add the sum of each chunk's segment of them into out."""
    blocks: int
    warps: int


def rowsum_plan(N: int, CH: int, sms: int, resident: int) -> RowsumPlan:
    """K10 over N = n_chunks * CH rows on a card of `sms` SMs that holds
    `resident` of its blocks per SM: a persistent grid of resident x sms
    blocks (one wave), fewer where N would give a warp less than one
    index window of rows."""
    if CH < 1 or N < CH or N % CH:
        raise ValueError(f"{N} rows are not a whole number of chunks of "
                         f"{CH}")
    if resident < 1:
        raise ValueError("the K10 kernel fits no block on an SM")
    warps = max(1, min(resident * sms * ROWSUM_WARPS,
                       -(-N // ROWSUM_WINDOW)))
    return RowsumPlan(blocks=-(-warps // ROWSUM_WARPS), warps=warps)


def rowsum_vec(tbl: torch.Tensor) -> bool:
    """K10 moves 16-byte vectors (else words): csrc/gather.cu vec_ok."""
    return tbl.shape[1] % 4 == 0 and tbl.data_ptr() % 16 == 0


@functools.lru_cache(maxsize=None)
def _rowsum_resident(index: int, vec: bool) -> int:
    """K10's resident blocks per SM on CUDA device `index` (its own
    occupancy), asked once per device and load width."""
    with torch.cuda.device(index):
        n = build.load().dbg_gather_rowsum_occupancy(int(vec))
    if n < 0:
        build.check(-n, "gather_rowsum occupancy")
    return n


def plan_rowsum(tbl: torch.Tensor, idx: torch.Tensor, CH: int) -> RowsumPlan:
    """K10's plan for tbl and idx on idx's card."""
    dev = idx.device
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return rowsum_plan(idx.shape[0], CH, _card(index)[0],
                       _rowsum_resident(index, rowsum_vec(tbl)))


def launch_gather_rows(tbl, idx, G: int, out, lib=None) -> None:
    err = (lib or build.load()).dbg_gather_rows(
        tbl.data_ptr(), idx.data_ptr(), idx.shape[0], G, tbl.shape[1],
        out.data_ptr(), build.stream_ptr(idx.device))
    build.check(err, "gather_rows")


def rowsum_launch(tbl, idx, CH: int, plan: RowsumPlan, out) -> build.Launch:
    """K10 on these tensors as one `build.Launch`, its arguments (the
    stream too) bound now: the C entry point zeroes out, then launches."""
    return build.Launch("gather_rowsum", "dbg_gather_rowsum", (
        tbl.data_ptr(), tbl.shape[0], idx.data_ptr(), idx.shape[0] // CH, CH,
        tbl.shape[1], plan.blocks, plan.warps, out.data_ptr(),
        build.stream_ptr(idx.device)), (tbl, idx, out))


@dataclass(frozen=True)
class GatherPlan:
    """How K11 / K12 gather a table of NB rows (K12: words) from shared
    memory; csrc/gather.cu `GatherPlan`, field for field."""
    S: int            # rows per slice (the whole table on the direct path)
    sbits: int        # log2(S) on the bucketed path, else 0
    P: int            # slices; 1 = the direct path
    share: int        # work items (blocks' turns) per slice
    grid: int         # gather blocks
    threads: int      # gather block size
    entry_bits: int   # bits of a bucketed entry (b, row): 32 or 64; 0 direct
    tiles: int        # count / scatter blocks
    tile: int         # indices per count / scatter block
    smem: int         # dynamic shared memory of a gather block, bytes
    scatter_smem: int  # ... of a scatter block
    buf_words: int    # words of one slice buffer (the slice and 4 more)
    acc: int          # 1: sums per b in shared memory first, two slice
    #                   buffers (the next item's staged early)

    @property
    def direct(self) -> bool:
        return self.P == 1

    def count_words(self) -> int:
        """int32 words of scratch: per-slice counts, starts, tile offsets."""
        return 0 if self.direct else 2 * self.P + 1 + self.tiles * self.P

    def entry_words(self, n: int) -> int:
        """int32 words of the entries of n indices."""
        return n * self.entry_bits // 32

    def passes(self) -> dict[str, int]:
        """The passes a run of this plan launches, by name, as the C entry
        points take them (their sum runs all of them)."""
        return {"gather": PASSES["gather"]} if self.direct else dict(PASSES)


def _words4(n: int) -> int:
    return (n + 3) // 4 * 4


def direct_rows_max(W: int, smem_optin: int) -> int:
    """The most rows of W words that K11 / K12 gather on the direct path
    (a slice buffer holds the table and 4 words more)."""
    return ((smem_optin - STATIC_SMEM) // 4 - 4) // 4 * 4 // W


def gather_plan(NB: int, W: int, B: int, J: int, sms: int,
                smem_optin: int) -> GatherPlan:
    """The plan of K11 (rows of W words) or K12 (W = 1) for idx [B, J] on
    a card of `sms` SMs whose blocks may ask for `smem_optin` bytes of
    shared memory.

    The direct path when the table fits one block: every block stages it
    whole and takes the indices of B / grid rows.  Else the table is cut
    into slices of S rows, the largest power of two within SLICE_BYTES
    and within what a block has: `acc` when a shared-memory copy of out
    leaves two slice buffers of ACC_MIN_SLICE and the slices get
    ACC_MIN_ENTRIES entries on average (one block of GATHER_THREADS per
    SM, two buffers); else blocks of SLICE_THREADS, one buffer, as many
    per SM as shared memory holds.  A slice is shared by several work
    items when there are fewer slices than blocks.  Entries take 32 bits
    while b and the row fit together (B*S <= 2^32), else 64.  Count and
    scatter tiles hold at most SCATTER_PER indices per thread and what a
    scatter block's shared memory holds, in whole waves over the SMs.
    Raises ValueError for what the kernels do not take."""
    row, N = 4 * W, B * J
    if N >= 1 << 31:
        raise ValueError(f"{B} x {J} indices: at most 2^31 - 1")
    room = smem_optin - STATIC_SMEM
    per_sm = smem_optin + SM_RESERVED

    def resident(smem: int, threads: int) -> int:
        return max(1, min(SM_THREADS // threads,
                          per_sm // (smem + STATIC_SMEM + SM_RESERVED)))

    def rows_within(budget: int) -> int:
        if budget < row:
            raise ValueError(f"a row of {W} words does not fit a block's "
                             "shared memory")
        return (budget // row).bit_length() - 1

    buf_words = _words4(NB * W) + 4
    if 4 * buf_words <= room:
        grid = max(1, min(sms * resident(4 * buf_words, GATHER_THREADS), B))
        return GatherPlan(S=NB, sbits=0, P=1, share=grid, grid=grid,
                          threads=GATHER_THREADS, entry_bits=0, tiles=0,
                          tile=0, smem=4 * buf_words, scatter_smem=0,
                          buf_words=buf_words, acc=0)
    acc_bytes = 4 * _words4(B)
    acc_budget = min(SLICE_BYTES, (room - acc_bytes) // 2 - 16)
    acc = (acc_budget >= max(ACC_MIN_SLICE, row)
           and N >= ACC_MIN_ENTRIES * -(-NB // (1 << rows_within(acc_budget))))
    sbits = rows_within(acc_budget if acc else min(SLICE_BYTES, room - 16))
    S = 1 << sbits
    P = -(-NB // S)
    if P > MAX_SLICES:
        raise ValueError(f"{NB} rows make {P} slices of {S}: at most "
                         f"{MAX_SLICES}")
    buf_words = _words4(S * W) + 4
    if acc:
        threads, smem = GATHER_THREADS, 8 * buf_words + acc_bytes
    else:
        threads, smem = SLICE_THREADS, 4 * buf_words
    cap = sms * resident(smem, threads)
    share = max(1, cap // P)
    # a scatter block holds its tile's entries, their 2-byte slice ids
    # and two counts per slice; its threads SCATTER_PER indices each
    entry_bits = 32 if B * S <= 1 << 32 else 64
    per_entry = entry_bits // 8 + 2
    tile_max = min(SCATTER_PER * COUNT_THREADS,
                   (smem_optin - 8 * P - STATIC_SMEM) // per_entry)
    tiles = -(-N // tile_max)
    tiles = max(1, min(-(-tiles // sms) * sms, -(-N // COUNT_THREADS)))
    tile = -(-N // tiles)
    return GatherPlan(S=S, sbits=sbits, P=P, share=share,
                      grid=min(P * share, cap), threads=threads,
                      entry_bits=entry_bits, tiles=tiles, tile=tile,
                      smem=smem,
                      scatter_smem=_words4(tile * per_entry) + 8 * P,
                      buf_words=buf_words, acc=int(acc))


def plan_for(tbl: torch.Tensor, idx: torch.Tensor) -> GatherPlan:
    """The plan of K11 (tbl [NB, W]) or K12 (tbl [NB]) on idx's card."""
    B, J = idx.shape
    sms, smem = _card_of(idx.device)
    return gather_plan(tbl.shape[0], tbl.shape[1] if tbl.dim() == 2 else 1,
                       B, J, sms, smem)


def gather_scratch(plan: GatherPlan, idx: torch.Tensor):
    """(counts, entries): the scratch of `plan` for idx, on its device."""
    def empty(n):
        return torch.empty(n, dtype=torch.int32, device=idx.device)
    return empty(plan.count_words()), empty(plan.entry_words(idx.numel()))


@functools.lru_cache(maxsize=64)
def _plan_c(plan: GatherPlan) -> build.GatherPlanC:
    c = build.GatherPlanC(*astuple(plan))
    c.entry64 = int(plan.entry_bits == 64)
    return c


def sum_launch(tbl, idx, reps: int, out, plan: GatherPlan, counts, entries,
               passes: int = ALL_PASSES) -> build.Launch:
    """K11 (tbl [NB, W]) or K12 (tbl [NB]) on these tensors as one
    `build.Launch`: its arguments bound once, so that a run of launches
    (the timer of the kernel alone) costs the host as little as it can."""
    B, J = idx.shape
    head = (tbl.data_ptr(), tbl.shape[0], idx.data_ptr(), B, J)
    tail = (ctypes.addressof(_plan_c(plan)), counts.data_ptr(),
            entries.data_ptr(), passes, out.data_ptr(),
            build.stream_ptr(idx.device))
    tensors = (tbl, idx, out, counts, entries, _plan_c(plan))
    if tbl.dim() == 2:
        return build.Launch("gather_rows_sum", "dbg_gather_rows_sum",
                            head + (tbl.shape[1], reps) + tail, tensors)
    return build.Launch("gather_take_sum", "dbg_gather_take_sum",
                        head + (reps,) + tail, tensors)


def launch_gather_rows_sum(tbl, idx, reps: int, out, plan, counts,
                           entries) -> None:
    sum_launch(tbl, idx, reps, out, plan, counts, entries)()


def launch_gather_take_sum(tbl1, idx, reps: int, out, plan, counts,
                           entries) -> None:
    sum_launch(tbl1, idx, reps, out, plan, counts, entries)()


def gather_rows(tbl: torch.Tensor, idx: torch.Tensor,
                G: int = 1) -> torch.Tensor:
    """K9 on idx's device: the kernel on CUDA, the plain version on the
    CPU, an error anywhere else."""
    if G < 1:
        raise ValueError("G must be at least 1")
    dev = _check("gather_rows", tbl, idx, 2, 1)
    if dev is None:
        return gather_rows_ref(tbl, idx, G)
    out = torch.empty((idx.shape[0] * G, tbl.shape[1]), dtype=torch.int32,
                      device=dev)
    if out.numel():
        launch_gather_rows(tbl, idx, G, out)
        build.count("gather_rows")
    return out


def gather_rowsum(tbl: torch.Tensor, idx: torch.Tensor,
                  CH: int) -> torch.Tensor:
    """K10 on idx's device: the kernel on CUDA, the plain version on the
    CPU, an error anywhere else."""
    dev = _check("gather_rowsum", tbl, idx, 2, 1)
    if dev is None:
        return gather_rowsum_ref(tbl, idx, CH)
    n_chunks = _n_chunks(idx, CH)
    out = torch.empty((n_chunks, 1), dtype=torch.int32, device=dev)
    if n_chunks:
        rowsum_launch(tbl, idx, CH, plan_rowsum(tbl, idx, CH), out)()
        build.count("gather_rowsum")
    return out


def gather_rows_sum(tbl: torch.Tensor, idx: torch.Tensor,
                    reps: int = 1) -> torch.Tensor:
    """K11 on idx's device: the kernel on CUDA, the plain version on the
    CPU, an error anywhere else."""
    dev = _check("gather_rows_sum", tbl, idx, 2, 2)
    if dev is None:
        return gather_rows_sum_ref(tbl, idx, reps)
    out = torch.empty(idx.shape[0], dtype=torch.int32, device=dev)
    if out.numel():
        plan = plan_for(tbl, idx)
        launch_gather_rows_sum(tbl, idx, reps, out, plan,
                               *gather_scratch(plan, idx))
        build.count("gather_rows_sum")
    return out


def gather_take_sum(tbl1: torch.Tensor, idx: torch.Tensor,
                    reps: int = 1) -> torch.Tensor:
    """K12 on idx's device: the kernel on CUDA, the plain version on the
    CPU, an error anywhere else."""
    dev = _check("gather_take_sum", tbl1, idx, 1, 2)
    if dev is None:
        return gather_take_sum_ref(tbl1, idx, reps)
    out = torch.empty(idx.shape[0], dtype=torch.int32, device=dev)
    if out.numel():
        plan = plan_for(tbl1, idx)
        launch_gather_take_sum(tbl1, idx, reps, out, plan,
                               *gather_scratch(plan, idx))
        build.count("gather_take_sum")
    return out
