"""K13 sharded_rows' host plan and its staged path on the CPU.

`staged_schedule` restates csrc/shard.cu's staged path in plain torch,
pass by pass (mark, pull, write), in the manner of test_torch_gather's
`bucketed_schedule`.  It is held equal to K13's plain version
`sharded_rows_ref` and to dbgtpu's core._sharded_rows under
jax.shard_map on 2, 4 and 8 of conftest's virtual CPU devices, at
junction-width (320 words) and probe-width (96 words) rows, with each
device in turn as the reading card.  The plan (`shard_plan`) is checked
at the geometries chip_smoke.py measures and at its threshold, and the
schedule at the edges: one id, every id in one row, ids outside the
table, every shard's first and last row.  Inputs come from numpy seeds;
every comparison is exact (tolerance 0: the outputs are integers).  One
shard_map per device count keeps the JAX compiles of the module few
(tests/conftest.py)."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from dbgtpu.engine import core
from dbgtpu_torch.engine.shard import (
    ShardPlan, _plan_c, plan_for, shard_plan, sharded_rows, sharded_rows_ref,
)
from dbgtpu_torch.kernels import build

MESHES = [2, 4, 8]
SURVEY_Q = 917_504           # the survey batch's probe keys (chip_smoke.py)


def staged_schedule(shards, b, plan: ShardPlan):
    """The staged path of csrc/shard.cu in plain torch, pass by pass:
    (a) mark: each id inside the table whose shard the plan stages sets
    its stage row's flag; (b) pull: each flagged stage row is copied from
    its shard, once; (c) write: each id's row from its local shard or
    from the stage, zeros outside the table.  Stage rows no flag asks
    for keep what the allocator left (a fill that must never reach out).
    Returns (out, flags, pulled): pulled counts the copies of each stage
    row from its shard."""
    nbl, W = shards[0].shape
    D = len(shards)
    b = b.reshape(-1).to(torch.int64)
    inside = (b >= 0) & (b < nbl * D)
    s = torch.where(inside, b // nbl, 0)
    local = b - s * nbl
    base = torch.tensor(plan.stage_base, dtype=torch.int64)[s]
    staged = inside & (base >= 0)
    row = base + local
    # (a) mark
    flags = torch.zeros(plan.remote_rows, dtype=torch.int32)
    flags[row[staged]] = 1
    # (b) pull
    stage = torch.full((plan.remote_rows, W), 0x5A5A5A5A, dtype=torch.int32)
    pulled = torch.zeros(plan.remote_rows, dtype=torch.int64)
    for r in torch.nonzero(flags).reshape(-1).tolist():
        o = r // nbl
        stage[r] = shards[plan.remote[o]][r - o * nbl]
        pulled[r] += 1
    # (c) write
    out = torch.zeros(b.numel(), W, dtype=torch.int32)
    for sh in range(D):
        mine = inside & (base < 0) & (s == sh)
        out[mine] = shards[sh][local[mine]]
    out[staged] = stage[row[staged]]
    return out, flags, pulled


def _table(rng, nb: int, W: int) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=(nb, W), dtype=np.uint64).astype(
        np.uint32)


def _ids(rng, nb: int, D: int, Q: int) -> np.ndarray:
    """Q global bucket ids (Q a multiple of D): every shard's first and
    last row, one id on each side of the table, the rest at random."""
    nbl = nb // D
    edges = np.concatenate([np.arange(D) * nbl, np.arange(1, D + 1) * nbl - 1,
                            [-1, nb]])
    ids = rng.integers(0, nb, size=Q, dtype=np.int64)
    ids[: len(edges)] = edges
    return rng.permutation(ids).astype(np.int32)


def _check_staged(shards, b, plan, want=None):
    """The staged schedule on `plan` equals the plain version (and `want`):
    each remote row an id asks for is flagged and pulled exactly once,
    no other stage row is pulled."""
    got, flags, pulled = staged_schedule(shards, b, plan)
    ref = sharded_rows_ref(shards, b).reshape(got.shape)
    assert torch.equal(got, ref)
    if want is not None:
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    nbl = shards[0].shape[0]
    bb = b.reshape(-1).to(torch.int64)
    inside = (bb >= 0) & (bb < nbl * len(shards))
    sb = torch.tensor(plan.stage_base, dtype=torch.int64)[
        torch.where(inside, bb // nbl, 0)]
    asked = torch.unique((sb + bb % nbl)[inside & (sb >= 0)])
    assert int(flags.sum()) == asked.numel()
    assert torch.equal(torch.nonzero(pulled).reshape(-1), asked)
    assert bool((pulled <= 1).all())
    return got


@pytest.mark.parametrize("D", MESHES)
def test_staged_schedule_matches_ref_and_jax_sharded_rows(D):
    """dbgtpu's _sharded_rows (all_gather, the residents answered, zeros
    elsewhere, psum_scatter) on D virtual devices, for a junction-width
    (W 320) and a probe-width (W 96) table, against the staged schedule
    with each device in turn reading (the plan stages the D - 1 others:
    Q exceeds the table's rows) and against the plain K13, exact."""
    rng = np.random.default_rng(1300 + D)
    st, pt = _table(rng, 64, 320), _table(rng, 32, 96)
    b_st, b_pt = _ids(rng, 64, D, 96), _ids(rng, 32, D, 48)
    mesh = Mesh(np.array(jax.devices()[:D]), ("x",))
    fn = jax.shard_map(
        lambda s, p, bs, bp: (core._sharded_rows(s, bs, "x"),
                              core._sharded_rows(p, bp, "x")),
        mesh=mesh, in_specs=(P("x"),) * 4, out_specs=(P("x"), P("x")),
        check_vma=False)
    want = fn(jnp.asarray(st), jnp.asarray(pt), jnp.asarray(b_st),
              jnp.asarray(b_pt))
    for table, b, w in ((st, b_st, want[0]), (pt, b_pt, want[1])):
        shards = list(torch.from_numpy(table.view(np.int32)).chunk(D))
        nbl, W = shards[0].shape
        bt = torch.from_numpy(b)
        for reader in range(D):
            plan = shard_plan(b.size, nbl, W, [s == reader for s in range(D)])
            assert plan.staged and plan.remote_rows == (D - 1) * nbl
            assert reader not in plan.remote and len(plan.remote) == D - 1
            _check_staged(shards, bt, plan, np.asarray(w))
        # the wrapper on CPU tensors takes the plain version
        assert torch.equal(sharded_rows(shards, bt),
                           sharded_rows_ref(shards, bt))


# (name, Q, nb_local, W, shards on the reading card, path, scratch words)
GEOMETRIES = [
    # the survey tables over 4 cards at the batch's probe keys
    ("survey junction, 4 cards", SURVEY_Q, 1024, 320, [1, 0, 0, 0], "staged",
     3072 * 321),
    ("survey probe, 4 cards", SURVEY_Q, 8192, 96, [1, 0, 0, 0], "staged",
     24576 * 97),
    # the upload check: 2 * D ids (each shard's first and last row)
    ("upload check, 4 cards", 8, 1024, 320, [1, 0, 0, 0], "direct", 0),
    ("upload check, 8 cards", 16, 8192, 96, [0, 0, 0, 1, 0, 0, 0, 0],
     "direct", 0),
    # 8 ranges on one card, --mesh 1: nothing to stage
    ("8 ranges on one card", SURVEY_Q, 512, 320, [1] * 8, "direct", 0),
    ("1 range", SURVEY_Q, 4096, 320, [1], "direct", 0),
    # a 1,048,576-row probe table of 96 words (scale1M's size) over 4
    # cards: fewer ids than rows, so the ids cannot repeat much
    ("sparse, 4 cards", SURVEY_Q, 262_144, 96, [1, 0, 0, 0], "direct", 0),
    ("sparse, 2 cards", SURVEY_Q, 524_288, 96, [0, 1], "direct", 0),
]


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=[g[0] for g in
                                                     GEOMETRIES])
def test_plan_geometries(geometry):
    """The plan's path and scratch at the shapes chip_smoke.py times; a
    staged plan's scratch is never more than out plus 4 B a table row."""
    _, Q, nbl, W, local, path, words = geometry
    plan = shard_plan(Q, nbl, W, [bool(x) for x in local])
    assert ("direct" if plan.direct else "staged") == path
    assert plan.scratch_words(W) == words
    D = len(local)
    if plan.staged:
        assert plan.remote == tuple(s for s in range(D) if not local[s])
        assert 4 * plan.scratch_words(W) <= 4 * Q * W + 4 * nbl * D
        assert sorted(x for x in plan.stage_base if x >= 0) == [
            i * nbl for i in range(len(plan.remote))]
    else:
        assert plan.stage_base == (-1,) * D and plan.remote == ()


@pytest.mark.parametrize("D", [2, 4, 8])
def test_plan_threshold(D):
    """Q at the table's rows takes the direct path, one id more the staged
    one; all shards local is direct at any Q; `staged` forces a path."""
    nbl, W = 16, 96
    remote = [s != 0 for s in range(D)]
    local = [not r for r in remote]
    assert shard_plan(nbl * D, nbl, W, local).direct
    assert shard_plan(nbl * D + 1, nbl, W, local).staged
    assert shard_plan(10 * nbl * D, nbl, W, [True] * D).direct
    assert shard_plan(1, nbl, W, local, staged=True).staged
    assert shard_plan(10 * nbl * D, nbl, W, local, staged=False).direct


def _edge_cases(rng, nb, D):
    nbl = nb // D
    firsts, lasts = np.arange(D) * nbl, np.arange(1, D + 1) * nbl - 1
    return {
        "one id": np.array([nb - 1]),
        "every id in one row": np.full(3 * nb, nbl + 1),
        "ids outside the table": np.array([-1, nb, nb + 7, -(1 << 31),
                                           (1 << 31) - 1, 0, nb - 1]),
        "every shard's first and last row": np.concatenate(
            [firsts, lasts, lasts, firsts]),
        "Q at the threshold": rng.integers(0, nb, size=nb),
        "Q one past the threshold": rng.integers(-2, nb + 2, size=nb + 1),
    }


@pytest.mark.parametrize("W", [320, 96])
@pytest.mark.parametrize("D", [2, 4, 8])
def test_staged_schedule_edges(D, W):
    """The staged schedule, forced and by the plan, at the edges: equal to
    the plain version, the table's rows inside it, zeros outside."""
    rng = np.random.default_rng(1310 + D + W)
    nb = 8 * D
    table = _table(rng, nb, W).view(np.int32)
    shards = list(torch.from_numpy(table).chunk(D))
    local = [s == D - 1 for s in range(D)]
    for name, ids in _edge_cases(rng, nb, D).items():
        b = torch.from_numpy(ids.astype(np.int32))
        for plan in (shard_plan(b.numel(), nb // D, W, local, staged=True),
                     shard_plan(b.numel(), nb // D, W, local)):
            got = _check_staged(shards, b, plan)
            inside = (ids >= 0) & (ids < nb)
            np.testing.assert_array_equal(got.numpy()[inside],
                                          table[ids[inside]], err_msg=name)
            assert not got.numpy()[~inside].any(), name
        assert shard_plan(b.numel(), nb // D, W, local).staged == (
            b.numel() > nb), name


def test_plan_for_cpu_and_the_c_struct():
    """plan_for reads which shards lie on the ids' device (all of them on
    the CPU: direct); the C struct carries the plan field for field, -1
    past the last shard, inside one call's argument struct."""
    shards = list(torch.zeros(64, 8, dtype=torch.int32).chunk(4))
    assert plan_for(shards, torch.zeros(1000, dtype=torch.int32)).direct
    plan = shard_plan(1000, 16, 8, [False, True, False, False])
    c = _plan_c(plan)
    assert ctypes.sizeof(build.ShardPlanC) == 4 * (3 + 2 * build.MAX_SHARDS)
    # csrc/shard.cu ShardArgs: the table, the plan, then six 8-byte fields
    head = ctypes.sizeof(build.ShardTableC) + ctypes.sizeof(build.ShardPlanC)
    assert build.ShardArgsC.ids.offset == -(-head // 8) * 8
    assert ctypes.sizeof(build.ShardArgsC) == build.ShardArgsC.ids.offset + 48
    assert (c.staged, c.remote_rows, c.n_remote) == (1, 48, 3)
    assert list(c.stage_base) == [0, -1, 16, 32] + [-1] * 4
    assert list(c.remote) == [0, 2, 3] + [-1] * 5
