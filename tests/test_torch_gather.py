"""K9-K12 (dbgtpu_torch/engine/gather.py): each plain torch version
against the Pallas kernel it replaces, run in interpret mode on the CPU,
and against a numpy statement of the function.  Integers, tolerance 0.

The Pallas bodies are nested in `main()` of scripts/exp_r5_pallas.py or
run at import of scripts/archive/exp_pallas_gather.py, so they cannot be
imported; they are restated here word for word, with two `out_shape`s
corrected (the port computes the well-defined function):
  - exp_r5_pallas.py:95 declares (N // G, W) while the grid writes G rows
    per step, so at G=8 only the first eighth is in bounds; here the
    output is ((N // G) * G, W);
  - exp_pallas_gather.py:42 and :83 declare (TILE, 1) while the grid has
    B // TILE steps, so in interpret mode only the last tile survives;
    here the output is (B, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dbgtpu_torch.engine import gather as G
from dbgtpu_torch.kernels import build

from .torch_parity import as_u32, t32

NB, W, N, CH = 64, 24, 256, 32          # exp_r5_pallas.py at a small size
NB2, ROWW, B, TILE, REPS = 32, 16, 64, 16, 8   # exp_pallas_gather.py


def _r5_inputs(seed):
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 1 << 32, (NB, W), np.uint64).astype(np.uint32)
    idx = rng.integers(0, NB, N).astype(np.int32)
    return tbl, idx


def _archive_inputs(seed):
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 1 << 32, (NB2, ROWW), np.uint64).astype(np.uint32)
    tbl1 = rng.integers(0, 1 << 32, (NB2,), np.uint64).astype(np.uint32)
    idx = rng.integers(0, NB2, (B, 128)).astype(np.int32)
    return tbl, tbl1, idx


def pallas_rows(tbl, idxg, G_):
    """exp_r5_pallas.py `kern` (:81) under its grid spec (:84-91)."""
    n = idxg.shape[0]

    def kern(idx_ref, tbl_blk, out_blk):
        out_blk[...] = tbl_blk[...]

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(n,),
        in_specs=[
            pl.BlockSpec((G_, W), lambda i, idx_ref: (idx_ref[i], 0)),
        ],
        out_specs=pl.BlockSpec((G_, W), lambda i, idx_ref: (i, 0)),
    )
    call = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((n * G_, W), jnp.uint32),
        grid_spec=grid_spec,
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(idxg), jnp.asarray(tbl)))


def pallas_vmem(tbl, idx):
    """exp_r5_pallas.py `kern_vmem` (:122) under its grid spec (:131-136)."""

    def kern_vmem(idx_ref, tbl_ref, out_ref):
        j = pl.program_id(0)

        def body(t, acc):
            r = idx_ref[j * CH + t]
            acc = acc + jnp.sum(tbl_ref[r, :], dtype=jnp.uint32)
            return acc
        out_ref[0, 0] = jax.lax.fori_loop(0, CH, body, jnp.uint32(0))

    grid_spec2 = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(N // CH,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1), lambda i, idx_ref: (i, 0)),
    )
    call2 = pl.pallas_call(
        kern_vmem,
        out_shape=jax.ShapeDtypeStruct((N // CH, 1), jnp.uint32),
        grid_spec=grid_spec2,
        interpret=True,
    )
    return np.asarray(call2(jnp.asarray(idx), jnp.asarray(tbl)))


def pallas_rows_sum(tbl, idx):
    """exp_pallas_gather.py `kernel` (:28) under its specs (:44-51)."""

    def kernel(idx_ref, tbl_ref, out_ref):
        def body(r, acc):
            ii = idx_ref[:, :] ^ (r.astype(jnp.int32) & 0)
            g = tbl_ref[ii]
            return acc + jnp.sum(g.astype(jnp.uint32), axis=(1, 2))
        acc = jnp.zeros((TILE,), jnp.uint32)
        acc = jax.lax.fori_loop(0, REPS, body, acc)
        out_ref[:, 0] = acc

    f = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((B, 1), jnp.uint32),
        grid=(B // TILE,),
        in_specs=[
            pl.BlockSpec((TILE, 128), lambda i: (i, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((NB2, ROWW), lambda i: (0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((TILE, 1), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )
    return np.asarray(f(jnp.asarray(idx), jnp.asarray(tbl)))


def pallas_take_sum(tbl1, idx):
    """exp_pallas_gather.py `kernel2` (:70) under its specs (:85-92)."""

    def kernel2(idx_ref, tbl_ref, out_ref):
        def body(r, acc):
            ii = idx_ref[:, :]
            g = jnp.take(tbl_ref[:], ii, axis=0)
            return acc + jnp.sum(g, axis=1)
        acc = jnp.zeros((TILE,), jnp.uint32)
        acc = jax.lax.fori_loop(0, REPS, body, acc)
        out_ref[:, 0] = acc

    f2 = pl.pallas_call(
        kernel2,
        out_shape=jax.ShapeDtypeStruct((B, 1), jnp.uint32),
        grid=(B // TILE,),
        in_specs=[
            pl.BlockSpec((TILE, 128), lambda i: (i, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((NB2,), lambda i: (0,), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((TILE, 1), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )
    return np.asarray(f2(jnp.asarray(idx), jnp.asarray(tbl1)))


@pytest.mark.parametrize("G_", [1, 8])
def test_gather_rows_equals_pallas_and_numpy(G_):
    tbl, idx = _r5_inputs(11)
    idxg = (idx[: N // G_] % (NB // G_)).astype(np.int32)
    got = as_u32(G.gather_rows(t32(tbl), t32(idxg), G_))
    rows = (idxg[:, None].astype(np.int64) * G_ + np.arange(G_)).reshape(-1)
    np.testing.assert_array_equal(got, tbl[rows])
    assert got.shape == ((N // G_) * G_, W)
    np.testing.assert_array_equal(got, pallas_rows(tbl, idxg, G_))
    np.testing.assert_array_equal(
        got, as_u32(G.gather_rows_ref(t32(tbl), t32(idxg), G_)))


def test_gather_rowsum_equals_pallas_and_numpy():
    tbl, idx = _r5_inputs(12)
    got = as_u32(G.gather_rowsum(t32(tbl), t32(idx), CH))
    want = tbl[idx].sum(axis=1, dtype=np.uint32).reshape(
        N // CH, CH).sum(axis=1, dtype=np.uint32)[:, None]
    assert got.shape == (N // CH, 1) and want.max() > 1 << 31
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas_vmem(tbl, idx))
    with pytest.raises(ValueError):
        G.gather_rowsum(t32(tbl), t32(idx[:-1]), CH)


def test_gather_rows_sum_equals_pallas_and_numpy():
    tbl, _, idx = _archive_inputs(13)
    got = as_u32(G.gather_rows_sum(t32(tbl), t32(idx), REPS))
    want = (tbl[idx].sum(axis=(1, 2), dtype=np.uint32)
            * np.uint32(REPS)).astype(np.uint32)
    assert got.shape == (B,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas_rows_sum(tbl, idx)[:, 0])
    # one gather: the sum itself
    np.testing.assert_array_equal(
        as_u32(G.gather_rows_sum(t32(tbl), t32(idx))),
        tbl[idx].sum(axis=(1, 2), dtype=np.uint32))


def test_gather_take_sum_equals_pallas_and_numpy():
    _, tbl1, idx = _archive_inputs(14)
    got = as_u32(G.gather_take_sum(t32(tbl1), t32(idx), REPS))
    want = (tbl1[idx].sum(axis=1, dtype=np.uint32)
            * np.uint32(REPS)).astype(np.uint32)
    assert got.shape == (B,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas_take_sum(tbl1, idx)[:, 0])


def test_gather_sums_wrap_mod_2_32():
    """All-ones words: every partial sum is past 2^32."""
    tbl = np.full((8, 24), 0xFFFFFFFF, np.uint32)
    idx = np.zeros(64, np.int32)
    got = as_u32(G.gather_rowsum(t32(tbl), t32(idx), 32))
    assert got.tolist() == [[(0xFFFFFFFF * 24 * 32) & 0xFFFFFFFF]] * 2
    idx2 = np.zeros((4, 128), np.int32)
    got = as_u32(G.gather_rows_sum(t32(tbl), t32(idx2), 8))
    assert got.tolist() == [(0xFFFFFFFF * 24 * 128 * 8) & 0xFFFFFFFF] * 4
    got = as_u32(G.gather_take_sum(t32(tbl[:, 0].copy()), t32(idx2), 8))
    assert got.tolist() == [(0xFFFFFFFF * 128 * 8) & 0xFFFFFFFF] * 4


def test_gather_wrappers_validate_and_count_only_kernel_launches():
    """On CPU tensors the wrappers take the plain versions and count no
    launch; shapes the kernels do not take raise on any device."""
    tbl, idx = _r5_inputs(15)
    before = dict(build.launches)
    G.gather_rows(t32(tbl), t32(idx))
    G.gather_rowsum(t32(tbl), t32(idx), CH)
    assert build.launches == before
    assert {"gather_rows", "gather_rowsum", "gather_rows_sum",
            "gather_take_sum"} <= set(build.KERNELS)
    with pytest.raises(ValueError):
        G.gather_rows(t32(tbl)[0], t32(idx))
    with pytest.raises(ValueError):
        G.gather_rows(t32(tbl), t32(idx), 0)
    with pytest.raises(ValueError):
        G.gather_take_sum(t32(tbl), t32(idx)[None, :])
    with pytest.raises(ValueError):
        G.gather_rows(t32(tbl), t32(idx).to("meta"))
    # an empty index list gathers nothing
    assert G.gather_rows(t32(tbl), torch.zeros(0, dtype=torch.int32),
                         8).shape == (0, W)
    names = {p.name for p in build.sources()}
    assert "gather.cu" in names
    for fn in ("dbg_gather_rows", "dbg_gather_rowsum", "dbg_gather_rows_sum",
               "dbg_gather_take_sum"):
        assert fn in build._ARGTYPES
        assert f'extern "C" int {fn}(' in (
            build._CSRC / "gather.cu").read_text()


def test_exp_gather_tool_runs_on_the_cpu(capsys):
    from dbgtpu_torch.tools import exp_gather

    assert exp_gather.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("== plain version (exact)") == 5
    assert " ms" not in out        # no device time from a CPU run
    g = exp_gather.GEOMETRIES
    assert (g["scripts"]["NB"], g["scripts"]["W"], g["scripts"]["N"],
            g["scripts"]["CH"]) == (1 << 17, 24, 917504, 4096)
    assert (g["scripts"]["NB2"], g["scripts"]["W2"], g["scripts"]["B"],
            g["scripts"]["J"], exp_gather.REPS) == (1 << 15, 16, 32768, 128, 8)
    assert g["beyond_l2"]["NB"] * g["beyond_l2"]["W"] * 4 > 400e6


def test_exp_gather_bounds_count_what_the_function_needs():
    """Operations of a bound are the function's (no operation for K9's
    copy, one add per table word summed for K10-K12, REPS times where the
    function is REPS gathers), never an implementation's index
    arithmetic; rows count once on both sides of a comparison."""
    from dbgtpu_torch.kernels import measure
    from dbgtpu_torch.tools import exp_gather

    g = exp_gather.GEOMETRIES["small"]
    N, W, CH, B, J, W2 = g["N"], g["W"], g["CH"], g["B"], g["J"], g["W2"]
    R = exp_gather.REPS
    cases = exp_gather.cases(exp_gather.make_inputs("small", "cpu"))
    want = {
        "K9 gather_rows G=1": (N, (4 * N + 4 * N * W, 4 * N * W, 0)),
        "K9 gather_rows G=8": (N, (4 * (N // 8) + 4 * N * W, 4 * N * W, 0)),
        f"K10 gather_rowsum CH={CH}": (
            N, (4 * N + 4 * (N // CH), 4 * N * W, N * W)),
        f"K11 gather_rows_sum x{R}": (
            B * J, (4 * B * J + 4 * B, 4 * B * J * W2, R * B * J * W2)),
        f"K12 gather_take_sum x{R}": (
            B * J, (4 * B * J + 4 * B, 4 * B * J, R * B * J)),
    }
    assert [c["label"] for c in cases] == list(want)
    for case in cases:
        rows, (stream, touched, ops) = want[case["label"]]
        assert case["rows"] == rows
        assert case["bound"][:2] == (stream, touched)
        assert case["bound"][3] == ops
        ms, by = measure.bound_ms(*case["bound"])
        assert ms > 0 and by in ("bytes", "operations")
    # at the scripts' geometry K11's bound is its 8 x 32768 x 128 x 16 adds
    s = exp_gather.GEOMETRIES["scripts"]
    ops = R * s["B"] * s["J"] * s["W2"]
    ms, by = measure.bound_ms(4 * s["B"] * s["J"] + 4 * s["B"],
                              4 * s["B"] * s["J"] * s["W2"],
                              4 * s["NB2"] * s["W2"], ops)
    assert by == "operations" and ops == 536870912
    assert abs(ms - ops / 16.75e12 * 1e3) < 1e-12
    # touched rows never count beyond the table; bytes win without ops
    assert measure.bound_ms(335, 10 ** 9, 3015, 0) == measure.bound_ms(
        335, 3015, 3015, 0)
    ms, by = measure.bound_ms(335, 10 ** 9, 3015, 0)
    assert by == "bytes" and abs(ms - 1e-6) < 1e-15
