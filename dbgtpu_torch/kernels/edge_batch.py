"""A small seeded workload where the kernels' geometry has edges.

K2 answers Lk = L - k + 2 positions per read with one probe per window
of W = 3 or 4 positions, lane groups of 8 windows or positions; K5 scans
a read from both ends in chunks of 2, 4, 4, ... positions per direction
(twice that when one direction is left; scan anchors) or 16 (32; MPHF
anchors) and stops a direction at the chunk that completes E hits or
where the other direction found no hit ahead of it.  The cases below
put reads across those edges: Lk of 31, 32, 33 and 65 (k = 32 twice),
Lk not a multiple of W, reads of length k-1, k and k+1, reads with 0,
1, E and more than 32 anchor hits, hits only in a read's last chunk or
only at position len-k, efforts 1, 2 and 5, and planted N (which sends
K2 down its per-position branch).  A batch holds 45 reads, so warps and
lane groups end ragged.

`edge_cases()` is numpy alone (no torch, no test helper): chip_smoke.py
holds the kernels against their plain versions on it, and the CPU tests
hold the plain versions against the JAX package on the same cases.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

EDGE_SEED = 20261016
GENOME_LEN = 4000
_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


@dataclass(frozen=True)
class EdgeCase:
    name: str
    k: int
    L: int          # the batch's padded read length
    effort: int     # E of K5 (anchors tried per direction)
    unitigs: tuple[bytes, ...]
    reads: tuple[bytes, ...]

    @property
    def Lk(self) -> int:
        """K2's scan positions per read: (k-1)-mers of an L-base row."""
        return self.L - self.k + 2


# name, k, L, effort, plant N
_CASES = (
    ("k32_Lk33_E1", 32, 63, 1, False),
    ("k32_Lk65_E5_N", 32, 95, 5, True),
    ("k31_Lk32_E2", 31, 61, 2, False),
    ("k21_Lk31_E2_N", 21, 50, 2, True),
)


CASE_NAMES = tuple(c[0] for c in _CASES)


def _revcomp(s: bytes) -> bytes:
    return s.translate(_COMP)[::-1]


def _unitigs(genome: bytes, k: int, rng) -> list[bytes]:
    """A linear cover of the genome by unitigs of k+1 to 2k+8 bases that
    overlap by k-1 (short, so reads cross many junctions), some stored
    reverse-complemented."""
    out, pos = [], 0
    while pos + k <= len(genome):
        n = min(int(rng.integers(k + 1, 2 * k + 9)), len(genome) - pos)
        if n < k:
            break
        u = genome[pos : pos + n]
        out.append(_revcomp(u) if rng.random() < 0.3 else u)
        pos += n - (k - 1)
    return out


def _reads(genome: bytes, k: int, L: int, E: int, plant_n: bool,
           rng) -> list[bytes]:
    def rand(n):
        return _BASES[rng.integers(0, 4, n)].tobytes()

    def piece(n, errors=0):
        s = int(rng.integers(0, len(genome) - n + 1))
        r = bytearray(genome[s : s + n])
        for _ in range(errors):
            i = int(rng.integers(0, n))
            r[i] = _BASES[(int(np.nonzero(_BASES == r[i])[0][0])
                           + int(rng.integers(1, 4))) % 4]
        r = bytes(r)
        return _revcomp(r) if rng.random() < 0.5 else r

    def planted(seg, at):
        """A random L-base read with `seg` at `at` (None: random place)."""
        at = int(rng.integers(0, L - len(seg) + 1)) if at is None else at
        return rand(at) + seg + rand(L - at - len(seg))

    reads = [piece(n) for n in (k - 1, k - 1, k, k, k + 1, k + 1)]
    reads += [piece(L) for _ in range(4)]                 # every k-mer hits
    reads += [piece(L, int(rng.integers(1, 3))) for _ in range(4)]
    reads += [rand(L) for _ in range(2)]                  # no hit
    reads += [planted(piece(k), None) for _ in range(2)]  # one hit
    reads += [planted(piece(k + E - 1), None) for _ in range(2)]   # E hits
    reads += [planted(piece(k), L - k) for _ in range(2)]  # at len-k only
    reads += [planted(piece(k + 3), L - k - 3) for _ in range(2)]  # last chunk
    reads += [planted(piece(k + 2), 0) for _ in range(2)]  # first chunk only
    reads += [piece(int(rng.integers(k - 1, L + 1)), int(rng.integers(0, 2)))
              for _ in range(45 - len(reads))]
    if plant_n:
        for i in range(0, len(reads), 3):
            r = bytearray(reads[i])
            for _ in range(int(rng.integers(1, 3))):
                r[int(rng.integers(0, len(r)))] = ord("N")
            reads[i] = bytes(r)
    return reads


def edge_cases(seed: int = EDGE_SEED) -> list[EdgeCase]:
    """The cases of CASE_NAMES, in that order, from one seeded genome."""
    rng = np.random.default_rng(seed)
    genome = _BASES[rng.integers(0, 4, GENOME_LEN)].tobytes()
    out = []
    for name, k, L, E, plant_n in _CASES:
        out.append(EdgeCase(name, k, L, E, tuple(_unitigs(genome, k, rng)),
                            tuple(_reads(genome, k, L, E, plant_n, rng))))
    return out
