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
[n * G, W] and [B].  The kernels are csrc/gather.cu; K11 and K12 do the
gather `reps` times, as the Pallas bodies do.  Indices are not
range-checked on the card.

Each wrapper checks its arguments, allocates its output and calls its
`launch_*` function, which is the bound C entry point on tensors the
caller holds and nothing more: what a measurement of the kernel alone
calls back to back (tools/exp_gather.py).  Only the wrappers count
launches.
"""

from __future__ import annotations

import functools

import torch

from ..kernels import build
from .kmer import M32

# K10: blocks per SM aimed at when a chunk is split, and the fewest rows
# a block is given
ROWSUM_BLOCKS_PER_SM = 8
ROWSUM_MIN_ROWS = 64
# rows of idx gathered at a time by the plain K11 (bounds its int64 rows)
_REF_ROWS = 4096


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


def rowsum_split(n_chunks: int, CH: int, dev: torch.device) -> int:
    """Blocks that share one chunk of K10 on `dev`."""
    sms = _card_of(dev)[0]
    return max(1, min(CH // ROWSUM_MIN_ROWS,
                      -(-ROWSUM_BLOCKS_PER_SM * sms // n_chunks)))


def launch_gather_rows(tbl, idx, G: int, out) -> None:
    err = build.load().dbg_gather_rows(
        tbl.data_ptr(), idx.data_ptr(), idx.shape[0], G, tbl.shape[1],
        out.data_ptr(), build.stream_ptr(idx.device))
    build.check(err, "gather_rows")


def launch_gather_rowsum(tbl, idx, CH: int, split: int, part, out) -> None:
    """`part` holds n_chunks * split words when split > 1."""
    err = build.load().dbg_gather_rowsum(
        tbl.data_ptr(), idx.data_ptr(), idx.shape[0] // CH, CH, tbl.shape[1],
        split, part.data_ptr(), out.data_ptr(), build.stream_ptr(idx.device))
    build.check(err, "gather_rowsum")


def launch_gather_rows_sum(tbl, idx, reps: int, out) -> None:
    B, J = idx.shape
    err = build.load().dbg_gather_rows_sum(
        tbl.data_ptr(), idx.data_ptr(), B, J, tbl.shape[1], reps,
        out.data_ptr(), build.stream_ptr(idx.device))
    build.check(err, "gather_rows_sum")


def launch_gather_take_sum(tbl1, idx, reps: int, out) -> None:
    B, J = idx.shape
    sms, smem = _card_of(idx.device)
    err = build.load().dbg_gather_take_sum(
        tbl1.data_ptr(), tbl1.shape[0], idx.data_ptr(), B, J, reps, sms, smem,
        out.data_ptr(), build.stream_ptr(idx.device))
    build.check(err, "gather_take_sum")


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
        split = rowsum_split(n_chunks, CH, dev)
        part = torch.empty(n_chunks * split if split > 1 else 0,
                           dtype=torch.int32, device=dev)
        launch_gather_rowsum(tbl, idx, CH, split, part, out)
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
        launch_gather_rows_sum(tbl, idx, reps, out)
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
        launch_gather_take_sum(tbl1, idx, reps, out)
        build.count("gather_take_sum")
    return out
