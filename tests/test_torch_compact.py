"""K8 compact_result: the port's plain version and the host rebuild
against the JAX engine's _compact_result on the CPU, exact (tolerance 0).

The order of `flat` is part of the format (the host rebuilds rows from
the counts alone): rows by count descending, stable by row index.  The
JAX function runs op by op (no jit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgtpu.engine import core
from dbgtpu_torch.engine.compact import (
    compact_counts, compact_ref, compact_result, expand_compact,
)


def _fused(seed: int, B: int, pmax: int, dtype, case: str) -> np.ndarray:
    """Result rows [B, 2 + pmax] as pack_paths writes them: status, true
    plen, then plen path slots (nonzero) and a zero tail."""
    rng = np.random.default_rng(seed)
    status = rng.choice([1, 2, 3, 4, 5], size=B, p=[.4, .3, .1, .1, .1])
    plen = rng.integers(1, pmax + 1, size=B)
    if case == "unaligned":
        status = rng.choice([3, 4, 5], size=B)
    elif case == "over_pmax":
        # the true length exceeds the slots of the row: the row is full
        plen[rng.random(B) < 0.3] = pmax + rng.integers(1, 40)
    elif case == "equal_counts":
        plen[:] = 3                      # ties everywhere: stability decides
    elif case == "full":
        status = rng.choice([1, 2], size=B)
        plen[:] = pmax
    else:
        assert case == "mixed", case
    hi = 30000 if dtype == np.int16 else 2_000_000
    slots = rng.integers(1, hi, size=(B, pmax)) * rng.choice([-1, 1],
                                                             size=(B, pmax))
    aligned = (status == 1) | (status == 2)
    live = aligned[:, None] & (np.arange(pmax)[None, :] < plen[:, None])
    fused = np.zeros((B, 2 + pmax), dtype)
    fused[:, 0] = status
    fused[:, 1] = np.where(aligned, plen, 0)
    fused[:, 2:] = np.where(live, slots, 0)
    return fused


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("case,B,pmax", [
    ("mixed", 300, 30),
    ("mixed", 257, 7),
    ("unaligned", 64, 30),
    ("over_pmax", 200, 6),
    ("equal_counts", 130, 8),
    ("full", 40, 5),
    ("mixed", 1, 30),
])
def test_compact_ref_and_rebuild_match_jax(dtype, case, B, pmax):
    fused = _fused(B * 31 + pmax, B, pmax, dtype, case)
    meta, flat = compact_ref(torch.from_numpy(fused), pmax)
    jmeta, jflat = core._compact_result(jnp.asarray(fused), pmax)
    assert meta.numpy().dtype == dtype and flat.numpy().dtype == dtype
    np.testing.assert_array_equal(meta.numpy(), np.asarray(jmeta))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert flat.shape == (B * pmax,)

    # the host side: the populated prefix alone rebuilds the padded rows
    counts = compact_counts(meta.numpy(), pmax)
    S = int(counts.sum())
    assert not flat.numpy()[S:].any()
    paths = expand_compact(np.asarray(jmeta), np.asarray(jflat)[:S], pmax)
    assert paths.dtype == dtype
    np.testing.assert_array_equal(paths, fused[:, 2:])
    if case == "unaligned":
        assert S == 0
    if case == "over_pmax":
        assert (meta.numpy()[:, 1] > pmax).any() and counts.max() == pmax
    if case == "full":
        assert S == B * pmax

    # the wrapper takes the plain version on the CPU
    again = compact_result(torch.from_numpy(fused), pmax)
    assert torch.equal(again[0], meta) and torch.equal(again[1], flat)


def test_compact_order_is_stable_by_row_index():
    """Equal counts keep their row order: column j of flat lists slot j of
    the rows in index order."""
    pmax = 4
    fused = np.zeros((5, 2 + pmax), np.int32)
    fused[:, 0] = [1, 3, 2, 1, 2]
    fused[:, 1] = [2, 0, 3, 2, 3]
    for r in range(5):
        fused[r, 2 : 2 + fused[r, 1]] = 10 * (r + 1) + np.arange(fused[r, 1])
    _, flat = compact_ref(torch.from_numpy(fused), pmax)
    # order: rows 2, 4 (count 3), then 0, 3 (count 2); row 1 holds nothing
    assert flat.tolist() == [30, 50, 10, 40, 31, 51, 11, 41, 32, 52] + [0] * 10


def test_compact_result_wrapper_uses_plain_version_only_on_cpu():
    fused = torch.from_numpy(_fused(3, 8, 5, np.int16, "mixed"))
    with pytest.raises(ValueError, match="no compact_result kernel"):
        compact_result(fused.to("meta"), 5)
