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
    _scratch_for, compact_counts, compact_ref, compact_result,
    compact_scratch_ints, expand_compact,
)
from dbgtpu_torch.kernels.edge_batch import (
    RESULT_BATCHES, RESULT_PMAX, fused_rows,
)


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("case,B,pmax", [
    ("mixed", 300, 30),
    ("mixed", 257, 7),
    ("unaligned", 64, 30),
    ("over_pmax", 200, 6),
    ("equal_counts", 130, 8),
    ("full", 40, 5),
    ("mixed", 1, 30),
    # the kernel's tile (256 rows) +- 1, rows wider than a warp
    ("mixed", 255, 31),
    ("mixed", 257, 62),
    ("over_pmax", 256, 120),
    ("equal_counts", 257, 31),
    ("full", 255, 62),
    ("unaligned", 257, 120),
])
def test_compact_ref_and_rebuild_match_jax(dtype, case, B, pmax):
    fused = fused_rows(B * 31 + pmax, B, pmax, dtype, case)
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
    fused = torch.from_numpy(fused_rows(3, 8, 5, np.int16, "mixed"))
    with pytest.raises(ValueError, match="no compact_result kernel"):
        compact_result(fused.to("meta"), 5)


def test_compact_scratch_holds_both_kernel_designs():
    """The scratch of K8's C entry point: the three-pass kernel takes
    (pmax + 1) x (tiles + 1) ints, the one-launch kernel (pmax + 1) x its
    grid, at most one block per 256 rows."""
    for B in RESULT_BATCHES:
        for pmax in RESULT_PMAX:
            tiles = -(-B // 256)
            n = compact_scratch_ints(B, pmax)
            assert n == (pmax + 1) * (tiles + 1)
            assert n >= (pmax + 1) * tiles + (pmax + 1)


def test_compact_scratch_is_kept_per_device_and_stream():
    dev = torch.device("cpu")
    a = _scratch_for(dev, 0, 100)
    assert a.dtype == torch.int32 and a.numel() == 100
    assert _scratch_for(dev, 0, 60) is a            # reused, not shrunk
    b = _scratch_for(dev, 0, 300)                   # grown
    assert b.numel() == 300 and _scratch_for(dev, 0, 100) is b
    assert _scratch_for(dev, 1, 10) is not b        # another stream
