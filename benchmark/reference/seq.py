"""Sequence primitives of the plain reference (numpy).

Frozen copy of the mapper's python spec (`seq.py`: encode, n_mask,
rc_codes, kmers_of, rcb, canonical, hamming).  Base codes A=0 C=1 G=2,
anything else 3; an 'N' mismatches every unitig base (literal-character
compare); the reverse complement maps code c to 3 - c.
"""

from __future__ import annotations

import numpy as np

_CODE_LUT = np.full(256, 3, dtype=np.uint8)
_CODE_LUT[ord("A")] = 0
_CODE_LUT[ord("C")] = 1
_CODE_LUT[ord("G")] = 2


def encode(seq: bytes) -> np.ndarray:
    return _CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def n_mask(seq: bytes) -> np.ndarray:
    return np.frombuffer(seq, dtype=np.uint8) == ord("N")


def rc_codes(codes: np.ndarray) -> np.ndarray:
    return (3 - np.asarray(codes, dtype=np.uint8))[::-1]


def kmers_of(codes: np.ndarray, n: int) -> np.ndarray:
    """All n-mers of a code array as uint64, first base in the high
    bits; along the last axis, so [..., L] -> [..., L - n + 1]."""
    codes = np.asarray(codes, dtype=np.uint64)
    L = codes.shape[-1]
    if L < n:
        return np.zeros(codes.shape[:-1] + (0,), dtype=np.uint64)
    Lk = L - n + 1
    out = np.zeros(codes.shape[:-1] + (Lk,), dtype=np.uint64)
    for j in range(n):
        out |= codes[..., j : j + Lk] << np.uint64(2 * (n - 1 - j))
    return out


_RC_M2 = np.uint64(0x3333333333333333)
_RC_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_RC_M8 = np.uint64(0x00FF00FF00FF00FF)
_RC_M16 = np.uint64(0x0000FFFF0000FFFF)


def rcb(v, n: int):
    """Numeric reverse complement of an n-mer, vectorized."""
    v = np.asarray(v, dtype=np.uint64)
    x = ~v
    x = ((x & _RC_M2) << np.uint64(2)) | ((x >> np.uint64(2)) & _RC_M2)
    x = ((x & _RC_M4) << np.uint64(4)) | ((x >> np.uint64(4)) & _RC_M4)
    x = ((x & _RC_M8) << np.uint64(8)) | ((x >> np.uint64(8)) & _RC_M8)
    x = ((x & _RC_M16) << np.uint64(16)) | ((x >> np.uint64(16)) & _RC_M16)
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    res = x >> np.uint64(64 - 2 * n)
    if res.ndim == 0:
        return np.uint64(res)
    return res


def canonical(v, n: int):
    return np.minimum(v, rcb(v, n))


def hamming(a: np.ndarray, b: np.ndarray, a_nmask: np.ndarray) -> int:
    d = (np.asarray(a) != np.asarray(b)) | np.asarray(a_nmask, dtype=bool)
    return int(d.sum())
