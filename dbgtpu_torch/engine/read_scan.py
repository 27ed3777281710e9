"""K1 read_scan: per-read packed images and anchor-scan (k-1)-mers.

Counterpart of dbgtpu/engine/core.py _unpack_words, _read_images,
_scan_kmer_pairs_words + rcb_pair, the rolled-in-N `_scan_kmer_pairs`
bug scan and the pair_le canonical choice (align_batch :955-1019).
The kernel is csrc/read_scan.cu; `read_scan_ref` is its plain torch
version.  `read_scan` launches the kernel for CUDA tensors and uses the
plain version only for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import build
from .kmer import M32, as_i32, rcb_ref


class Scan(NamedTuple):
    rows: torch.Tensor   # int32 [3, B, 2*Lw+1]: packed forward, reverse-
    #                      complement (RC of N is A) and N-mask rows,
    #                      16 bases per word (uint32 bits), zero padded
    bug: torch.Tensor    # int64 [B, Lk] forward (k-1)-mers with the
    #                      reference's rolled-in-N quirk
    rcs: torch.Tensor    # int64 [B, Lk] reverse complement of the std scan
    rep1: torch.Tensor   # int64 [B, Lk] canonical of (bug, rcs)
    le1: torch.Tensor    # uint8 [B, Lk] 1 where bug <= rcs
    rep2: torch.Tensor   # int64 [B, Lk] canonical of (std, rcs)
    has_n: torch.Tensor  # int32 [1] 1 when the batch holds an N


def _check(words, nmbits, lens, L: int, k1: int):
    B, Lw = words.shape
    if words.dtype != torch.int32 or nmbits.dtype != torch.int32:
        raise TypeError("words and nmbits must be int32 (uint32 bits)")
    if lens.dtype != torch.int32 or lens.shape != (B,):
        raise TypeError("lens must be int32 [B]")
    if Lw != (L + 15) // 16:
        raise ValueError(f"words width {Lw} != ceil(L/16) for L={L}")
    if nmbits.shape[0] != B or nmbits.shape[1] not in (0, (L + 31) // 32):
        raise ValueError(f"nmbits shape {tuple(nmbits.shape)} for L={L}")
    if not 1 <= k1 <= 31 or L < k1:
        raise ValueError(f"unsupported k-1={k1} for L={L}")
    dev = words.device
    if nmbits.device != dev or lens.device != dev:
        raise ValueError("words, nmbits and lens must share a device")


def unpack_fields(words: torch.Tensor, nbits: int, L: int) -> torch.Tensor:
    """[B, n] uint32-bit words -> [B, L] int64 fields of `nbits` bits."""
    B, n = words.shape
    per = 32 // nbits
    sh = nbits * torch.arange(per, device=words.device, dtype=torch.int64)
    w = words.to(torch.int64) & M32
    f = (w[:, :, None] >> sh) & ((1 << nbits) - 1)
    return f.reshape(B, n * per)[:, :L]


def _pack_rows(vals: torch.Tensor, out_words: int) -> torch.Tensor:
    """[B, L] 2-bit values -> [B, out_words] int32 words (core._pack_rows)."""
    B, L = vals.shape
    Lw = (L + 15) // 16
    v = torch.nn.functional.pad(vals, (0, Lw * 16 - L))
    sh = 2 * torch.arange(16, device=vals.device, dtype=torch.int64)
    words = (v.reshape(B, Lw, 16) << sh).sum(dim=2)
    out = torch.zeros((B, out_words), dtype=torch.int32, device=vals.device)
    out[:, :Lw] = as_i32(words)
    return out


def _scan(codes: torch.Tensor, n: int) -> torch.Tensor:
    """n-mer value at every position of [B, L] codes (core._scan_kmer_pairs)."""
    Lk = codes.shape[1] - n + 1
    v = torch.zeros((codes.shape[0], Lk), dtype=torch.int64,
                    device=codes.device)
    for j in range(n):
        v = (v << 2) | codes[:, j : j + Lk]
    return v


def read_scan_ref(words, nmbits, lens, *, L: int, k1: int) -> Scan:
    """Plain torch version of K1 (int64 lanes)."""
    _check(words, nmbits, lens, L, k1)
    B, Lw = words.shape
    RWr = 2 * Lw + 1
    dev = words.device
    codes = unpack_fields(words, 2, L)
    if nmbits.shape[1]:
        nm = unpack_fields(nmbits, 1, L).bool()
    else:
        nm = torch.zeros((B, L), dtype=torch.bool, device=dev)
    col = torch.arange(L, device=dev)[None, :]
    ln = lens.to(torch.int64).clamp(max=L)[:, None]
    src = (ln - 1 - col).clamp(min=0)
    rc = torch.where(col < ln, 3 - codes.gather(1, src), 0)
    rows = torch.stack([
        _pack_rows(codes, RWr), _pack_rows(rc, RWr),
        _pack_rows(nm.to(torch.int64), RWr),
    ])
    std = _scan(codes, k1)
    bug = _scan(torch.where(nm & (col >= k1), 0, codes), k1)
    rcs = rcb_ref(std, k1)
    le1 = bug <= rcs
    return Scan(
        rows=rows,
        bug=bug,
        rcs=rcs,
        rep1=torch.where(le1, bug, rcs),
        le1=le1.to(torch.uint8),
        rep2=torch.minimum(std, rcs),
        has_n=nm.any().to(torch.int32).reshape(1),
    )


def read_scan(words, nmbits, lens, *, L: int, k1: int) -> Scan:
    """K1 on `words`' device: the kernel on CUDA, the plain version on
    the CPU, an error anywhere else."""
    if words.device.type == "cpu":
        return read_scan_ref(words, nmbits, lens, L=L, k1=k1)
    if words.device.type != "cuda":
        raise ValueError(f"no read_scan kernel for device {words.device}")
    launch, scan = read_scan_launch(words, nmbits, lens, L=L, k1=k1)
    if words.shape[0]:
        launch()
        build.count("read_scan")
    return scan


def read_scan_launch(words, nmbits, lens, *, L: int, k1: int):
    """K1's checks and allocation on CUDA tensors: (build.Launch into the
    outputs, the Scan it fills)."""
    _check(words, nmbits, lens, L, k1)
    words, nmbits, lens = (t.contiguous() for t in (words, nmbits, lens))
    B, Lw = words.shape
    Lk = L - k1 + 1
    dev = words.device
    rows = torch.empty((3, B, 2 * Lw + 1), dtype=torch.int32, device=dev)
    kmers = torch.empty((4, B, Lk), dtype=torch.int64, device=dev)
    le1 = torch.empty((B, Lk), dtype=torch.uint8, device=dev)
    has_n = torch.zeros(1, dtype=torch.int32, device=dev)
    launch = build.Launch("read_scan", "dbg_read_scan", (
        words.data_ptr(), Lw, nmbits.data_ptr(), nmbits.shape[1],
        lens.data_ptr(), B, L, k1, rows.data_ptr(), kmers[0].data_ptr(),
        kmers[1].data_ptr(), kmers[2].data_ptr(), le1.data_ptr(),
        kmers[3].data_ptr(), has_n.data_ptr(), build.stream_ptr(dev),
    ), (words, nmbits, lens, rows, kmers, le1, has_n))
    return launch, Scan(rows, kmers[0], kmers[1], kmers[2], le1, kmers[3],
                        has_n)
