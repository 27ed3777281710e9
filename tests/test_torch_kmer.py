"""dbgtpu_torch.engine.kmer against dbgtpu.engine.kmer32 (numpy), exact."""

import numpy as np
import pytest
import torch

from dbgtpu.engine import kmer32
from dbgtpu_torch.engine import kmer

from .torch_parity import join


def _values(n: int, size: int = 300, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + n)
    v = rng.integers(0, 1 << (2 * n), size=size, dtype=np.uint64)
    v[:4] = [0, (1 << (2 * n)) - 1, 1, (1 << (2 * n)) >> 1]
    return v


def test_mix32_matches_kmer32():
    rng = np.random.default_rng(1)
    hi = rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    hi[:3] = [0, 0xFFFFFFFF, 0x3FFFFFFF]
    lo[:3] = [0, 0xFFFFFFFF, 0x80000000]
    want = kmer32.mix32(hi, lo)
    got = kmer.mix32_ref(torch.from_numpy(hi.astype(np.int64)),
                         torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", range(1, 33))
def test_rcb_rev_le_match_kmer32(n):
    v = _values(n)
    w = _values(n, seed=99)
    hi, lo = kmer32.split64(v)
    whi, wlo = kmer32.split64(w)
    tv = torch.from_numpy(v.astype(np.int64))
    tw = torch.from_numpy(w.astype(np.int64))
    np.testing.assert_array_equal(
        kmer.rcb_ref(tv, n).numpy(), join(*kmer32.rcb_pair(hi, lo, n)))
    np.testing.assert_array_equal(
        kmer.rev_ref(tv, n).numpy(), join(*kmer32.rev_pair(hi, lo, n)))
    np.testing.assert_array_equal(
        kmer.le_ref(tv, tw).numpy(), kmer32.pair_le(hi, lo, whi, wlo))
    sh, sl = kmer.split_ref(tv)
    np.testing.assert_array_equal(sh.numpy(), hi.astype(np.int64))
    np.testing.assert_array_equal(sl.numpy(), lo.astype(np.int64))
