"""Hashing of k-mers held as (hi, lo) uint32 pairs, on numpy arrays.

The host-side part of dbgtpu/engine/kmer32.py (`split64`, `join64`,
`mix32`, `mix32b`): the device-index build (index/device.py) and the
MPHF build (index/mphf.py) place keys with these, and the kernels and
their plain versions (csrc/common.cuh, engine/kmer.py) must compute the
same bits when they look the keys up.

Conventions: an n-mer occupies the low 2n bits of the (hi, lo) pair,
first base in the highest occupied 2 bits.
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF


def split64(v):
    """uint64 array -> (hi, lo) uint32 arrays."""
    v = np.asarray(v, dtype=np.uint64)
    return ((v >> np.uint64(32)).astype(np.uint32),
            (v & np.uint64(_M32)).astype(np.uint32))


def join64(hi, lo):
    """(hi, lo) -> uint64."""
    return ((np.asarray(hi, np.uint64) << np.uint64(32))
            | np.asarray(lo, np.uint64))


_C1 = np.uint32(0x9E3779B9)
_C2 = np.uint32(0x85EBCA6B)
_C3 = np.uint32(0xC2B2AE35)


def mix32(hi, lo):
    """Hash of a k-mer pair -> uint32 (murmur3-style finalizer).  The
    constants carry dtype uint32 so numpy does not promote; products
    wrap at 32 bits."""
    h = lo ^ (hi * _C1)
    h ^= h >> 16
    h = h * _C2
    h ^= h >> 13
    h = h * _C3
    h ^= h >> 16
    return h


_H2A = np.uint32(0x7FEB352D)
_H2B = np.uint32(0x846CA68B)


def mix32b(hi, lo):
    """Second, independent hash of a k-mer pair (two-choice bucketing)."""
    return mix32(lo ^ _H2A, hi ^ _H2B)
