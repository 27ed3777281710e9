"""K-mer arithmetic on torch tensors: the plain counterparts of
dbgtpu/engine/kmer32.py and of the device helpers in csrc/common.cuh.

A k-mer of n <= 32 bases is carried as a single int64 holding its 2n
bits, first base in the highest occupied two bits (reference str2num
order), instead of kmer32's (hi, lo) uint32 pair.  A (k-1)-mer has at
most 62 bits and is non-negative; the k-mers of dog mode (-G) at k = 32
fill all 64 bits, so their int64 may be negative, and every helper
below treats the value as unsigned.  The hash tables are still hashed on the 32-bit halves, so
`mix32_ref` works on halves held in int64 lanes masked to 32 bits:
torch on the CPU has no `>>` for uint32 or uint64, and an int32
arithmetic shift would corrupt the hash.  int64 multiplication wraps
modulo 2**64, which keeps the low 32 bits exact.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_C1, _C2, _C3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35


def mix32_ref(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """murmur3-style finalizer of kmer32.mix32 on int64 tensors holding
    32-bit values; returns int64 in [0, 2**32)."""
    h = lo ^ ((hi * _C1) & M32)
    h = h ^ (h >> 16)
    h = (h * _C2) & M32
    h = h ^ (h >> 13)
    h = (h * _C3) & M32
    return h ^ (h >> 16)


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bits (the dtype
    the index tables are held in)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def split_ref(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 k-mer -> (hi, lo) 32-bit halves as int64 in [0, 2**32)."""
    return (v >> 32) & M32, v & M32


def _rev_groups(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 32 two-bit groups of a 64-bit value held in int64.
    Every right shift is masked with a pattern whose top bits are zero,
    so the arithmetic shift of a negative lane never leaks sign bits."""
    x = ((x >> 2) & 0x3333333333333333) | ((x & 0x3333333333333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0F) | ((x & 0x0F0F0F0F0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF00FF00FF) | ((x & 0x00FF00FF00FF00FF) << 8)
    x = ((x >> 16) & 0x0000FFFF0000FFFF) | ((x & 0x0000FFFF0000FFFF) << 16)
    return ((x >> 32) & M32) | (x << 32)


def _mask(n: int) -> int:
    """The 2n low bits as an int64 constant (-1 for n = 32: 2**64 - 1
    does not fit an int64)."""
    return -1 if n == 32 else (1 << (2 * n)) - 1


def rev_ref(v: torch.Tensor, n: int) -> torch.Tensor:
    """Two-bit-group reversal of an n-mer (kmer32.rev_pair), 1 <= n <= 32."""
    if n == 32:
        return _rev_groups(v)
    return (_rev_groups(v) >> (64 - 2 * n)) & _mask(n)


def rcb_ref(v: torch.Tensor, n: int) -> torch.Tensor:
    """Reverse complement of an n-mer (kmer32.rcb_pair), 1 <= n <= 32."""
    return rev_ref(v ^ _mask(n), n)


def le_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a <= b on k-mer values (kmer32.pair_le), compared on the
    32-bit halves: a 32-mer's int64 may be negative, where the signed
    compare is wrong."""
    ahi, alo = split_ref(a)
    bhi, blo = split_ref(b)
    return (ahi < bhi) | ((ahi == bhi) & (alo <= blo))
