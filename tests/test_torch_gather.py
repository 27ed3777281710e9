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


def pallas_vmem(tbl, idx, CH=CH):
    """exp_r5_pallas.py `kern_vmem` (:122) under its grid spec (:131-136),
    idx in chunks of CH."""
    N = idx.shape[0]

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


# ---- K11 / K12: the plan and the bucketed schedule -----------------------

H100 = dict(sms=132, smem_optin=232448)   # torch.cuda.get_device_properties


def bucketed_schedule(tbl, idx, reps, plan):
    """The bucketed path of csrc/gather.cu in plain torch, step by step:
    (a) count the indices of each tile per slice; (b) scan the counts
    and scatter each index as one entry (b, slice-local row) into
    slice-major order, tile by tile; (c) take each entry's row from its
    slice `reps` times over and add the sums per b (mod 2^32).  An index
    outside the table is taken as its last row, as on the card.  Returns
    (out, entries, start)."""
    B, J = idx.shape
    S, N = plan.S, idx.numel()
    flat = G.in_table(idx, tbl.shape[0]).reshape(-1).to(torch.int64)
    p = flat >> plan.sbits
    pos = torch.arange(N)
    tile = pos // plan.tile
    assert N == 0 or int(tile.max()) < plan.tiles
    hist = torch.zeros(plan.tiles, plan.P, dtype=torch.int64)
    hist.index_put_((tile, p), torch.ones(N, dtype=torch.int64),
                    accumulate=True)
    rel = hist.cumsum(0) - hist                   # earlier tiles' entries
    start = torch.cat([torch.zeros(1, dtype=torch.int64),
                       hist.sum(0).cumsum(0)])
    # a tile's entries of one slice land at start[p] + rel[tile, p] + rank
    order = torch.argsort(p * plan.tiles + tile, stable=True)
    rank = torch.empty(N, dtype=torch.int64)
    rank[order] = torch.arange(N)
    within = rank - start[p] - rel[tile, p]
    assert bool(((within >= 0) & (within < hist[tile, p])).all())
    b, row = pos // J, flat & (S - 1)
    shift = 32 if plan.entry_bits == 64 else plan.sbits
    entries = ((b << shift) | row)[order]
    # (c) slice by slice: the entries of slice q are start[q]:start[q+1]
    out = torch.zeros(B, dtype=torch.int64)
    for q in range(plan.P):
        e = entries[start[q]:start[q + 1]]
        eb, erow = e >> shift, e & ((1 << shift) - 1)
        table = tbl[q * S:(q + 1) * S].to(torch.int64) & G.M32
        acc = torch.zeros(e.numel(), dtype=torch.int64)
        for _ in range(reps):                 # every round gathers again
            t = table[erow]
            acc += t.sum(1) if t.dim() == 2 else t
        out.index_add_(0, eb, acc)
    return G._wrap32(out), entries, start


def small_plan(tbl, idx):
    """A bucketed plan at the test's small sizes: a card with little
    shared memory."""
    B, J = idx.shape
    W = tbl.shape[1] if tbl.dim() == 2 else 1
    plan = G.gather_plan(tbl.shape[0], W, B, J, sms=4,
                         smem_optin=G.STATIC_SMEM + (256 if W > 1 else 128))
    assert not plan.direct and plan.P > 1
    return plan


@pytest.mark.parametrize("entry_bits", [32, 64])
def test_bucketed_schedule_equals_plain_and_pallas(entry_bits):
    import dataclasses

    tbl, tbl1, idx = _archive_inputs(21)
    for t, pallas, ref in ((tbl, pallas_rows_sum, G.gather_rows_sum_ref),
                           (tbl1, pallas_take_sum, G.gather_take_sum_ref)):
        plan = dataclasses.replace(small_plan(t32(t), t32(idx)),
                                   entry_bits=entry_bits)
        got, entries, start = bucketed_schedule(t32(t), t32(idx), REPS, plan)
        assert entries.numel() == idx.size and int(start[-1]) == idx.size
        np.testing.assert_array_equal(as_u32(got),
                                      as_u32(ref(t32(t), t32(idx), REPS)))
        np.testing.assert_array_equal(as_u32(got), pallas(t, idx)[:, 0])
        for reps in (0, 1):
            got, _, _ = bucketed_schedule(t32(t), t32(idx), reps, plan)
            np.testing.assert_array_equal(
                as_u32(got), as_u32(ref(t32(t), t32(idx), reps)))


# (name, NB, W, B, J): direct or bucketed, slice S, slices P, entry bits,
# shared-memory copy of out, on an H100 (132 SMs, 227 KB per block)
PLAN_CASES = [
    ("K12 scripts", 1 << 15, 1, 32768, 128, dict(
        direct=True, S=1 << 15, P=1, entry_bits=0, acc=0, grid=132)),
    ("K12 beyond_l2", 1 << 22, 1, 32768, 128, dict(
        direct=False, S=8192, P=512, entry_bits=32, acc=1, grid=132)),
    ("K11 scripts", 1 << 15, 16, 32768, 128, dict(
        direct=False, S=512, P=64, entry_bits=32, acc=1, share=2,
        grid=128)),
    ("K11 beyond_l2", 1 << 22, 16, 32768, 128, dict(
        direct=False, S=1024, P=4096, entry_bits=32, acc=0, grid=396)),
    ("K12 small", 1 << 9, 1, 256, 128, dict(direct=True, P=1)),
    ("K11 small", 1 << 9, 16, 256, 128, dict(direct=True, P=1)),
]


@pytest.mark.parametrize("name,NB,W,B,J,want", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_gather_plan_at_the_geometries(name, NB, W, B, J, want):
    plan = G.gather_plan(NB, W, B, J, **H100)
    assert plan.direct == want.pop("direct")
    for key, value in want.items():
        assert getattr(plan, key) == value, key
    _plan_invariants(plan, NB, W, B, J)


def _plan_invariants(plan, NB, W, B, J):
    optin = H100["smem_optin"]
    assert plan.smem + G.STATIC_SMEM <= optin
    assert plan.buf_words * 4 >= (plan.S * W + 3) * 4
    assert (plan.P - 1) * plan.S < NB <= plan.P * plan.S
    assert plan.grid <= plan.P * plan.share
    if plan.direct:
        assert plan.S == NB and plan.acc == 0 and plan.count_words() == 0
        return
    assert plan.S == 1 << plan.sbits and plan.S * W * 4 <= G.SLICE_BYTES
    assert plan.entry_bits == (32 if B * plan.S <= 1 << 32 else 64)
    assert plan.tiles * plan.tile >= B * J
    assert plan.tile <= G.SCATTER_PER * G.COUNT_THREADS
    assert plan.scatter_smem <= optin and plan.P <= G.MAX_SLICES
    assert sum(plan.passes().values()) == G.ALL_PASSES
    if plan.acc:
        assert plan.smem == 8 * plan.buf_words + 4 * -(-B // 4) * 4


def _gather_edges(W):
    from dbgtpu_torch.kernels.edge_batch import gather_edges

    D = G.direct_rows_max(W, H100["smem_optin"])
    S = G.gather_plan(D + 1, W, 300, 128, **H100).S
    return D, S, gather_edges(D, S)


@pytest.mark.parametrize("W", [1, 16])
def test_gather_plan_at_the_edges(W):
    """chip_smoke's edge set (kernels/edge_batch.py gather_edges) takes
    the paths it is named after."""
    from dbgtpu_torch.kernels.edge_batch import gather_edge_inputs

    D, S, edges = _gather_edges(W)
    assert G.gather_plan(D, W, 300, 128, **H100).direct
    assert not G.gather_plan(D + 1, W, 300, 128, **H100).direct
    plans = {}
    for case in edges:
        plan = plans[case.name] = G.gather_plan(case.NB, W, case.B, case.J,
                                                **H100)
        _plan_invariants(plan, case.NB, W, case.B, case.J)
        assert plan.direct == (case.name.endswith("direct")
                               or case.name in ("NB1", "direct_max")), case
        buf, idx = gather_edge_inputs(7, case, W, S)
        assert buf.size == case.offset + case.NB * W
        assert idx.shape == (case.B, case.J)
        inside = (0 <= idx) & (idx < case.NB)
        if case.pattern == "out_of_range":
            assert inside.any() and not inside.all()
            assert {case.NB, -1, -1 << 31} <= set(np.unique(idx[~inside]))
        else:
            assert inside.all()
        if case.pattern == "one_slice":
            assert (idx // S == 2).all()
        if case.pattern == "ends":
            assert set(np.unique(idx)) == {0, case.NB - 1}
    assert plans["entries64"].entry_bits == 64
    assert plans["out_beyond_shared"].acc == 0
    assert plans["NB5S+1"].P == plans["NB5S-1"].P + 1
    assert {p.acc for p in plans.values() if not p.direct} == {0, 1}
    names = {c.name for c in edges}
    assert {"B1_direct", "B1_bucketed", "J1_direct", "J31_bucketed",
            "J33_bucketed", "J128_direct", "unaligned_direct",
            "unaligned_bucketed", "out_of_range_direct",
            "out_of_range_bucketed"} <= names


@pytest.mark.parametrize("W", [1, 16])
def test_bucketed_schedule_at_the_edges(W):
    """The schedule restated in torch equals the plain versions on the
    edge set under the H100's plans (K11's 4M-row 64-bit case is left to
    the card: its plain version alone needs half a gigabyte here)."""
    from dbgtpu_torch.kernels.edge_batch import (
        GATHER_REPS, gather_edge_inputs,
    )

    D, S, edges = _gather_edges(W)
    ref = G.gather_rows_sum_ref if W > 1 else G.gather_take_sum_ref
    for n, case in enumerate(edges):
        plan = G.gather_plan(case.NB, W, case.B, case.J, **H100)
        if plan.direct or (W > 1 and case.name == "entries64"):
            continue
        buf, idx = gather_edge_inputs(n, case, W, S)
        tbl = t32(buf)[case.offset:]
        tbl = tbl.view(case.NB, W) if W > 1 else tbl
        taken = G.in_table(t32(idx), case.NB)
        for reps in GATHER_REPS:
            got, _, _ = bucketed_schedule(tbl, t32(idx), reps, plan)
            assert torch.equal(got, ref(tbl, taken, reps)), (case, reps)


@pytest.mark.parametrize("NB", [1, 5, 1 << 20])
def test_in_table_takes_stray_indices_as_the_last_row(NB):
    idx = torch.tensor([[0, NB - 1, NB, NB + 7, -1, (1 << 31) - 1, -1 << 31]],
                       dtype=torch.int32)
    got = G.in_table(idx, NB)
    assert got.dtype == torch.int32 and got.shape == idx.shape
    assert got.tolist() == [[0] + [NB - 1] * 6]


def test_gather_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        G.gather_plan(1 << 20, 1, 1 << 16, 1 << 15, **H100)   # 2^31 indices
    with pytest.raises(ValueError):
        G.gather_plan(1 << 30, 16, 1024, 128, **H100)        # too many slices
    with pytest.raises(ValueError):
        G.gather_plan(10, 1 << 15, 4, 4, **H100)             # a 128 KB row


# ---- K10: the one-launch schedule and its plan ---------------------------

# K10's resident blocks per SM on an H100 (56 registers in blocks of 256:
# `dbg_gather_rowsum_occupancy` on the card, NVIDIA H100 80GB HBM3)
H100_ROWSUM_RESIDENT = 4


def rowsum_schedule(tbl, idx, CH, plan):
    """csrc/gather.cu's K10 in plain torch, step by step: out zeroed; warp
    w of plan.warps sums rows [N w / warps, N (w + 1) / warps) (indices
    taken into the table) in tiles of 32 rows cut at chunk boundaries,
    and adds each chunk segment's sum into out[c] (mod 2^32).  Returns
    (out [n_chunks, 1], the segments (w, c, first row, end row))."""
    N = idx.shape[0]
    rows = (tbl[G.in_table(idx, tbl.shape[0]).to(torch.int64)]
            .to(torch.int64) & G.M32).sum(1)
    out = torch.zeros(N // CH, dtype=torch.int64)
    segments = []
    for w in range(plan.warps):
        r0, r1 = N * w // plan.warps, N * (w + 1) // plan.warps
        t, c, acc = r0, r0 // CH, 0
        while t < r1:
            end = min(r1, (c + 1) * CH)
            tile = min(end - t, 32)
            acc += int(rows[t:t + tile].sum())
            t += tile
            if t == end:                  # the segment of chunk c is done
                out[c] += acc & G.M32
                segments.append((w, c, max(r0, c * CH), end))
                c, acc = c + 1, 0
    return G._wrap32(out)[:, None], segments


def _rowsum_edge_cases():
    from dbgtpu_torch.kernels.edge_batch import rowsum_edges

    # a card of 4 SMs, one block each: 32 warps, so that the edges around
    # the warp count stay small here
    return rowsum_edges(4 * 1 * G.ROWSUM_WARPS)


@pytest.mark.parametrize("case", _rowsum_edge_cases(),
                         ids=lambda c: c.name)
def test_rowsum_schedule_at_the_edges(case):
    """The one-launch schedule equals the plain version on the edge set
    chip_smoke runs on the card (indices outside the table taken as its
    last row), under the plan of a 4-SM card."""
    from dbgtpu_torch.kernels.edge_batch import rowsum_edge_inputs

    buf, idx = rowsum_edge_inputs(3, case)
    tbl = t32(buf)[case.offset:].view(case.NB, case.W)
    plan = G.rowsum_plan(idx.size, case.CH, sms=4, resident=1)
    got, segments = rowsum_schedule(tbl, t32(idx), case.CH, plan)
    taken = G.in_table(t32(idx), case.NB)
    assert torch.equal(got, G.gather_rowsum_ref(tbl, taken, case.CH))
    if case.pattern == "ones":                 # every sum wraps
        assert (as_u32(got) == (case.CH * case.W * 0xFFFFFFFF)
                & 0xFFFFFFFF).all()
    if case.name.startswith("chunks_warps") or case.name.startswith("ranges"):
        assert plan.warps == 32          # the full grid
    # every row in exactly one segment, no segment across a boundary
    assert sum(e - s for _, _, s, e in segments) == idx.size
    assert all(s // case.CH == c and (e - 1) // case.CH == c
               for _, c, s, e in segments)
    if case.name == "ranges_on_boundaries":       # a segment per warp
        assert len(segments) == plan.warps
    if case.name == "ranges_across_boundaries":
        assert len(segments) > plan.warps


@pytest.mark.parametrize("CH,W,n_chunks", [(1, 24, 64), (31, 3, 9),
                                           (32, 24, 8), (33, 25, 7),
                                           (32, 1, 8)])
def test_rowsum_schedule_equals_plain_and_pallas(CH, W, n_chunks):
    """At the Pallas body's small size: the schedule, the plain version
    and `kern_vmem` in interpret mode agree."""
    rng = np.random.default_rng(CH * 100 + W)
    tbl = rng.integers(0, 1 << 32, (NB, W), np.uint64).astype(np.uint32)
    idx = rng.integers(0, NB, CH * n_chunks).astype(np.int32)
    plan = G.rowsum_plan(idx.size, CH, sms=2, resident=1)
    got, _ = rowsum_schedule(t32(tbl), t32(idx), CH, plan)
    np.testing.assert_array_equal(
        as_u32(got), as_u32(G.gather_rowsum_ref(t32(tbl), t32(idx), CH)))
    np.testing.assert_array_equal(as_u32(got), pallas_vmem(tbl, idx, CH))


@pytest.mark.parametrize("N,CH,want", [
    # the scripts' geometry on an H100: one full wave
    (917504, 4096, dict(blocks=132 * H100_ROWSUM_RESIDENT,
                        warps=132 * H100_ROWSUM_RESIDENT * 8)),
    # few rows: at least one index window per warp
    (100, 1, dict(blocks=1, warps=4)),
    (33, 33, dict(blocks=1, warps=2)),
    (1, 1, dict(blocks=1, warps=1)),
    (257 * 32, 32, dict(blocks=33, warps=257)),
])
def test_rowsum_plan(N, CH, want):
    plan = G.rowsum_plan(N, CH, sms=132, resident=H100_ROWSUM_RESIDENT)
    for key, value in want.items():
        assert getattr(plan, key) == value, key
    assert plan.warps <= N and plan.warps <= plan.blocks * G.ROWSUM_WARPS
    assert plan.blocks <= 132 * H100_ROWSUM_RESIDENT
    with pytest.raises(ValueError):
        G.rowsum_plan(N + 1 if CH > 1 else 0, CH, 132, 3)
    with pytest.raises(ValueError):
        G.rowsum_plan(N, CH, 132, 0)


@pytest.mark.parametrize("NB", [1, 5, 64])
def test_gather_rowsum_takes_stray_indices_as_the_last_row(NB):
    """K10's stray-index rule, as K11's and K12's: the kernel's function
    is the plain version on `in_table(idx)` (the plain version itself
    indexes as torch does)."""
    rng = np.random.default_rng(NB)
    tbl = rng.integers(0, 1 << 32, (NB, 24), np.uint64).astype(np.uint32)
    idx = rng.integers(0, NB, 96).astype(np.int32)
    idx[::7] = np.array([NB, NB + 1, -1, (1 << 31) - 1, -1 << 31] * 3)[
        : idx[::7].size]
    plan = G.rowsum_plan(idx.size, 32, sms=1, resident=1)
    got, _ = rowsum_schedule(t32(tbl), t32(idx), 32, plan)
    clean = np.where((idx < 0) | (idx >= NB), NB - 1, idx)
    np.testing.assert_array_equal(
        as_u32(got), as_u32(G.gather_rowsum_ref(t32(tbl), t32(clean), 32)))
