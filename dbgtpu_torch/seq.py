"""Host-side sequence primitives (numpy, vectorized).

These define the ground-truth semantics the device kernels must match;
unit-tested against trivial python oracles and, transitively, against
the compiled reference binary.

Semantics notes (behavioral parity with the reference, not code):
  - base encoding A=0 C=1 G=2 other=3 (reference str2num, utils.cpp:117);
    'N' and junk encode as 3 (T),
  - literal-character Hamming: the reference compares raw chars
    (utils.cpp:154-168), so an 'N' in a read mismatches every unitig
    base even though it *encodes* like 'T'.  We carry a per-position
    N-mask next to the codes and force mismatches there,
  - string reverse-complement maps everything that is not A/C/G to 'A'
    (reference revCompChar utils.cpp:52-59), so RC('N') == 'A'.  In code
    space that is exactly rc_code = 3 - code, and the RC'd read has an
    all-false N-mask.
"""

from __future__ import annotations

import numpy as np

# char -> 2-bit code lookup (256 entries). A=0, C=1, G=2, default 3.
_CODE_LUT = np.full(256, 3, dtype=np.uint8)
_CODE_LUT[ord("A")] = 0
_CODE_LUT[ord("C")] = 1
_CODE_LUT[ord("G")] = 2

_DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode(seq: bytes | str) -> np.ndarray:
    """Encode an ASCII sequence to 2-bit codes (uint8 array)."""
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _CODE_LUT[raw]


def n_mask(seq: bytes | str) -> np.ndarray:
    """Boolean mask of positions holding 'N' (literal-mismatch positions)."""
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8)
    return raw == ord("N")


def decode(codes: np.ndarray) -> str:
    """Decode 2-bit codes back to an ACGT string."""
    return _DECODE[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def rc_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement in code space: reverse order, code -> 3-code."""
    return (3 - np.asarray(codes, dtype=np.uint8))[::-1]


def codes_to_kmer(codes: np.ndarray) -> np.uint64:
    """Pack a code array (len <= 32) into a uint64, first base in the
    high bits (reference str2num shifts left as it scans)."""
    v = np.uint64(0)
    for c in np.asarray(codes, dtype=np.uint64):
        v = (v << np.uint64(2)) | c
    return v


def kmers_of(codes: np.ndarray, n: int) -> np.ndarray:
    """All n-mers of a code array as uint64, vectorized.

    Returns array of shape (len(codes) - n + 1,); empty if too short.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    L = len(codes)
    if L < n:
        return np.zeros(0, dtype=np.uint64)
    # weight of codes[i+j] in kmer i is 4^(n-1-j): n vectorized
    # shifted-window ORs instead of an L-iteration python rolling loop
    # (the dog-mode index scans the WHOLE unitig pool — ~65M bases at
    # 1M unitigs — where the rolling loop cost ~2.5 minutes)
    Lk = L - n + 1
    out = np.zeros(Lk, dtype=np.uint64)
    for j in range(n):
        out |= codes[j : j + Lk] << np.uint64(2 * (n - 1 - j))
    return out


_RC_M2 = np.uint64(0x3333333333333333)
_RC_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_RC_M8 = np.uint64(0x00FF00FF00FF00FF)
_RC_M16 = np.uint64(0x0000FFFF0000FFFF)


def rcb(v: np.uint64 | np.ndarray, n: int) -> np.uint64 | np.ndarray:
    """Numeric reverse complement of an n-mer (semantics of reference
    rcb, utils.cpp:182-192), vectorized over arrays.  O(1) bit-swizzle
    per element (complement = per-2-bit-group NOT; reverse = log-swap
    of 2-bit groups), not an O(n) base loop — the closure probe-table
    build calls this on ~10^8-element arrays."""
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


def canonical(v: np.uint64 | np.ndarray, n: int):
    """min(v, rcb(v)) — the canonical representative."""
    r = rcb(v, n)
    return np.minimum(v, r)


def hamming(a: np.ndarray, b: np.ndarray, a_nmask: np.ndarray | None = None) -> int:
    """Mismatch count between equal-length code windows; positions where
    a_nmask is set always mismatch (literal 'N' semantics)."""
    d = np.asarray(a) != np.asarray(b)
    if a_nmask is not None:
        d = d | np.asarray(a_nmask, dtype=bool)
    return int(d.sum())
