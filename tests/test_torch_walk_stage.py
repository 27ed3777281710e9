"""K3 greedy_walk's staged path on a sharded index (`--shard-index`) on the
CPU.

`staged_schedule` restates engine/walk.py walk_stage and the staged K3 in
plain torch, in the manner of test_torch_member_stage's restatement of
K2: (a) the pull, csrc/shard.cu dbg_walk_stage, copies every row of the
junction table's ranges that the plan stages (those not on the reading
card) into a stage, in stage order, with no mark pass; (b) K3's plain
version `walk_ref` reads an index whose staged `st_shards` are views of
that stage.  The stage starts as a poison, 0x5A5A5A5A words (a key there
is never found), so a row the pull leaves out shows.  The result must
equal dbgtpu's sharded walk (`_junction_vals` through `_sharded_rows`
under jax.shard_map: the whole sharded align of `sharded_packed_fn`, and
`_junction_vals` alone on every key the walk can look up) on 2, 4 and 8
of conftest's virtual CPU devices, and the plain K3 on the whole index,
with each device in turn as the reading card.  A stage row poisoned after
the pull changes the walk.  The plan (`walk_plan`) is checked at the
survey's, the quarter batch's and scale1M's geometries, with its
overrides; the bound of K3 on a sharded index counts only junction rows
as remote (`probe_bytes`, `measure.bound_ms`).  Inputs come from numpy
seeds; every comparison is exact (tolerance 0: the outputs are
integers)."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from dbgtpu.dist.mesh import make_mesh as jax_mesh, sharded_packed_fn
from dbgtpu.engine import core
from dbgtpu.index.build import build_graph_from_seqs
from dbgtpu_torch.engine.index import (
    C_BEG_HI, C_BEG_LO, C_END_HI, C_END_LO, C_RCB_HI, C_RCB_LO, C_RCE_HI,
    C_RCE_LO, index_tensors, sharded_index_tensors,
)
from dbgtpu_torch.engine.kmer import M32, mix32_ref, rcb_ref, split_ref
from dbgtpu_torch.engine.member import junction_vals_ref, member_ref
from dbgtpu_torch.engine.pack import out_dtype_for, pack_ref
from dbgtpu_torch.engine.read_scan import read_scan_ref
from dbgtpu_torch.engine.shard import stage_ranges_ref
from dbgtpu_torch.engine.walk import (
    EVALS_PER_READ, calls, greedy_walk, plan_for, probe_bytes, pull_pays,
    staged_index, walk_plan, walk_ref, walk_stage,
)
from dbgtpu_torch.kernels import build, measure
from dbgtpu_torch.kernels.edge_batch import WALK_CASE_NAMES, edge_cases

from .torch_parity import assert_walks_equal, batch, dataset, device_index, t32

MESHES = [2, 4, 8]
K, M, E, L = 21, 2, 2, 112
POISON = 0x5A5A5A5A
WALK_FIELDS = ("status", "orient", "offset", "llen", "rlen", "lbuf", "rbuf")


def staged_schedule(ix, plan, poison_row=None):
    """The staged path's index in plain torch: (a) the pull into a stage
    poisoned before it; (b) the index whose staged ranges are views of
    the stage, which walk_ref then reads.  `poison_row`: that stage row
    poisoned again after the pull (a pull that left it out).  -> (the
    stage, the index)"""
    nbl, cols = ix.st_shards[0].shape
    stage = torch.full((plan.remote_rows, cols), POISON, dtype=torch.int32)
    for o, s in enumerate(plan.remote):
        stage[o * nbl : (o + 1) * nbl] = ix.st_shards[s]
    if poison_row is not None:
        stage[poison_row] = POISON
    staged = tuple(stage[x : x + nbl] if x >= 0 else ix.st_shards[i]
                   for i, x in enumerate(plan.stage_base))
    return stage, dataclasses.replace(ix, st_shards=staged)


def _walk_keys(ix, scan, k1) -> torch.Tensor:
    """Every canonical (k-1)-mer a walk of this batch can look up: the
    scan's at each position (its anchors and the read's own junctions)
    and each unitig's end (k-1)-mers (a walk's next keys), as K3
    canonicalizes them."""
    meta = ix.umeta.to(torch.int64)

    def kmer(c_hi, c_lo):
        return ((meta[:, c_hi] & M32) << 32) | (meta[:, c_lo] & M32)

    ends = torch.cat([kmer(C_BEG_HI, C_BEG_LO), kmer(C_END_HI, C_END_LO),
                      kmer(C_RCB_HI, C_RCB_LO), kmer(C_RCE_HI, C_RCE_LO)])
    keys = torch.cat([scan.rep1.reshape(-1), scan.rep2.reshape(-1), ends])
    return torch.unique(torch.minimum(keys, rcb_ref(keys, k1)))


def _jax_junction_vals(di, keys, D):
    """dbgtpu's _junction_vals through _sharded_rows on D virtual devices,
    the junction table cut into D bucket ranges (P("x")) and the keys on
    every device -> (found bool, vals8 int64)."""
    jx = core.index_to_device(di)
    mesh = Mesh(np.array(jax.devices()[:D]), ("x",))
    k = keys.numpy()
    hi = jnp.asarray((k >> 32).astype(np.uint32))
    lo = jnp.asarray((k & 0xFFFFFFFF).astype(np.uint32))

    def fn(st, h, lw):
        return core._junction_vals(jx._replace(st_fused=st), None, h, lw,
                                   shard_axis="x")
    found, vals = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P("x"), P(), P()), out_specs=(P(), P()),
        check_vma=False))(jx.st_fused, hi, lo)
    return np.asarray(found), np.asarray(vals).astype(np.int64)


def _check_keys(sx, keys, want):
    found, vals = junction_vals_ref(sx, keys)
    np.testing.assert_array_equal(found.numpy(), want[0])
    np.testing.assert_array_equal(vals.numpy()[want[0]],
                                  want[1][want[0]])


def _busiest_staged_row(ix, scan, m1, plan, k1):
    """The stage row that the most reads' first forward anchor looks up
    first (every such read evaluates it), or None."""
    nbl = ix.st_shards[0].shape[0]
    D = len(ix.st_shards)
    first = m1.bool().to(torch.int64).argmax(dim=1)
    has = m1.bool().any(dim=1)
    cur = scan.bug[torch.arange(scan.bug.shape[0]), first][has]
    key = torch.minimum(cur, rcb_ref(cur, k1))
    hi, lo = split_ref(key)
    b = mix32_ref(hi ^ ix.st_seed, lo) & (nbl * D - 1)
    s = b // nbl
    base = torch.tensor(plan.stage_base, dtype=torch.int64)[s]
    rows = (base + b - s * nbl)[base >= 0]
    if not rows.numel():
        return None
    return int(torch.bincount(rows).argmax())


@pytest.fixture(scope="module")
def case():
    """A greedy dataset (a survey-like batch: reads with 1-2 errors and
    N, anchors on both strands) and the same reads without N."""
    graph, reads = dataset(seed=1501, k=K, n_reads=64, n_frac=0.15)
    di = device_index(graph)
    assert di.scan_tbl.keys.shape[0] >= 8 and di.probe_tbl is not None
    with_n = batch(reads, L, keep_empty_nmbits=True)
    clean = [r.replace(b"N", b"A").replace(b"n", b"a") for r in reads]
    no_n = batch(clean, L, keep_empty_nmbits=True)
    return di, {"with_n": with_n, "no_n": no_n}


@pytest.mark.parametrize("D", MESHES)
def test_staged_walk_matches_jax_sharded_walk(case, D):
    """On D ranges, each range in turn the reader's and the others staged
    (forced; the plan's rule stages them too), the staged schedule's
    index answers every key the walk can look up as dbgtpu's sharded
    _junction_vals does, and its stage is the plain range pull's; the
    walk from it (the last range the reader's) equals the plain K3 on
    the whole index, and on 8 ranges dbgtpu's sharded align on 8
    virtual devices (the fused rows); the busiest staged row poisoned
    after the pull changes the walk."""
    di, batches = case
    whole = index_tensors(di, "cpu")
    ixs = sharded_index_tensors(di, ["cpu"] * D)
    pmax = 6
    # dbgtpu's whole sharded align on the most ranges (test_torch_shard
    # holds the plain K3 to it on each count)
    fn = (sharded_packed_fn(jax_mesh(D), mode="greedy", k=K, m=M, effort=E,
                            L=L, pmax=pmax, shard_index=True)
          if D == max(MESHES) else None)
    jix = core.index_to_device(di)
    dtype = out_dtype_for(whole.umeta.shape[0], L)
    for name, (_, _, lens, words, nmbits) in batches.items():
        tl = t32(lens)
        scan = read_scan_ref(t32(words), t32(nmbits), tl, L=L, k1=K - 1)
        m1, m2 = member_ref(whole, scan, tl, L=L, k1=K - 1)
        want = walk_ref(whole, scan, m1, m2, tl, k=K, m=M, effort=E, L=L)
        fused = pack_ref(want, pmax=pmax, dtype=dtype).numpy()
        if fn is not None:
            np.testing.assert_array_equal(
                fused, np.asarray(fn(jix, jnp.asarray(words),
                                     jnp.asarray(nmbits),
                                     jnp.asarray(lens))[0]), err_msg=name)
        keys = _walk_keys(whole, scan, K - 1)
        want_keys = _jax_junction_vals(di, keys, D)
        for reader, ix in enumerate(ixs):
            local = [s == reader for s in range(D)]
            plan = plan_for(ix, SURVEY, torch.device("cpu"), staged=True,
                            local=local)
            assert plan == walk_plan(SURVEY, *ix.st_fused.shape, local)
            assert plan.staged and reader not in plan.remote
            assert plan.remote_rows == (D - 1) * ix.st_fused.shape[0]
            stage, sx = staged_schedule(ix, plan)
            assert torch.equal(stage, stage_ranges_ref(
                ix.st_shards, plan, torch.device("cpu")))
            # every lookup the walk can make, on every reading card
            _check_keys(sx, keys, want_keys)
            if reader == D - 1:
                got = walk_ref(sx, scan, m1, m2, tl, k=K, m=M, effort=E,
                               L=L)
                assert_walks_equal(got, {f: getattr(want, f).numpy()
                                         for f in WALK_FIELDS})
                np.testing.assert_array_equal(
                    pack_ref(got, pmax=pmax, dtype=dtype).numpy(), fused,
                    err_msg=name)
            if reader == 0 and name == "no_n":
                row = _busiest_staged_row(ix, scan, m1, plan, K - 1)
                _, bad_ix = staged_schedule(ix, plan, poison_row=row)
                bad = walk_ref(bad_ix, scan, m1, m2, tl, k=K, m=M, effort=E,
                               L=L)
                assert not all(torch.equal(getattr(bad, f), getattr(want, f))
                               for f in WALK_FIELDS)


_EDGE = {c.name: c for c in edge_cases()}


def _shard_count(di) -> int:
    nb_st = di.scan_tbl.keys.shape[0]
    nb_pt = di.probe_tbl.rows.shape[0] if di.probe_tbl is not None else 0
    return max(D for D in (1, 2, 4, 8)
               if nb_st >= D and not nb_st % D and not nb_pt % D
               and not 0 < nb_pt < D)


@pytest.mark.parametrize("name", WALK_CASE_NAMES)
def test_staged_walk_edge_batch(name):
    """K3's edge batch (Lk 31 to 65, reads of k-1 .. L bases, planted N,
    ties, junctions of 4 and 0 candidates, unitigs of k bases): on the
    scan index cut into the most ranges it allows, each range the
    reader's in turn, the staged schedule's (forced) index answers every
    key the walk can look up as dbgtpu's sharded _junction_vals does,
    and the walk from it (the last range the reader's) equals the plain
    K3 on the whole index."""
    c = _EDGE[name]
    k1 = c.k - 1
    di = device_index(build_graph_from_seqs(list(c.unitigs), c.k))
    D = _shard_count(di)
    assert D >= 2
    _, _, lens, words, nmbits = batch(list(c.reads), c.L)
    tl = t32(lens)
    scan = read_scan_ref(t32(words), t32(nmbits), tl, L=c.L, k1=k1)
    whole = index_tensors(di, "cpu")
    m1, m2 = member_ref(whole, scan, tl, L=c.L, k1=k1)
    want = walk_ref(whole, scan, m1, m2, tl, k=c.k, m=2, effort=c.effort,
                    L=c.L)
    keys = _walk_keys(whole, scan, k1)
    want_keys = _jax_junction_vals(di, keys, D)
    for reader, ix in enumerate(sharded_index_tensors(di, ["cpu"] * D)):
        plan = plan_for(ix, len(c.reads), torch.device("cpu"), staged=True,
                        local=[s == reader for s in range(D)])
        _, sx = staged_schedule(ix, plan)
        _check_keys(sx, keys, want_keys)
        if reader == D - 1:
            got = walk_ref(sx, scan, m1, m2, tl, k=c.k, m=2,
                           effort=c.effort, L=c.L)
            assert_walks_equal(got, {f: getattr(want, f).numpy()
                                     for f in WALK_FIELDS})


SURVEY, QUARTER = 32_768, 8_192   # chip_smoke's batch; a card's quarter
# (name, B, junction range (rows, cols), ranges on the reading card, path)
GEOMETRIES = [
    ("survey, 4 cards", SURVEY, (1_024, 320), [1, 0, 0, 0], "staged"),
    ("survey, 2 cards", SURVEY, (2_048, 320), [0, 1], "staged"),
    # 3.9 MB of remote rows against ~2.4 MB of direct reads: the pull,
    # charged in full, does not pay (launched from Python the overlapped
    # chain was slower there, PERF.md B15)
    ("survey, a quarter batch on 4 cards", QUARTER, (1_024, 320),
     [0, 0, 1, 0], "direct"),
    ("survey, 8 ranges on one card", SURVEY, (512, 320), [1] * 8, "direct"),
    ("survey, one range", SURVEY, (4_096, 320), [1], "direct"),
    # scale1M's junction table: 131,072 rows (168 MB), 126 MB remote on 4
    ("scale1M, 4 cards", SURVEY, (32_768, 320), [1, 0, 0, 0], "direct"),
    ("scale1M, a quarter batch on 4 cards", QUARTER, (32_768, 320),
     [1, 0, 0, 0], "direct"),
    # a batch too small to pay for the pull
    ("survey, 256 reads on 4 cards", 256, (1_024, 320), [1, 0, 0, 0],
     "direct"),
    ("scale1M, every range on one card", SURVEY, (32_768, 320), [1] * 4,
     "direct"),
]


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=[g[0] for g in
                                                     GEOMETRIES])
def test_plan_geometries(geometry):
    """The plan's path at chip_smoke's and scale1M's shapes; a staged plan
    stages every range not on the card, in order, whole."""
    _, B, (nbl, cols), local, path = geometry
    plan = walk_plan(B, nbl, cols, [bool(x) for x in local])
    assert ("direct" if plan.direct else "staged") == path
    if plan.staged:
        remote = tuple(s for s in range(len(local)) if not local[s])
        assert plan.remote == remote
        assert plan.remote_rows == nbl * len(remote)
        assert [plan.stage_base[s] for s in remote] == [
            i * nbl for i in range(len(remote))]
    if geometry[0] == "survey, 4 cards":
        # 3,072 remote junction rows of 1,280 B: 3,932,160 B a batch
        assert plan.remote_rows * cols * 4 == 3_932_160


def test_plan_rule_and_overrides():
    """`pull_pays`: never with every row local or no evaluations; more
    evaluations tip it to staged, a larger table back to direct; `staged`
    forces a path, but nothing is staged with every range on the card or
    on an unsharded index."""
    assert not pull_pays(10**6, 4_096, 320, 0.0)
    assert not pull_pays(0, 4_096, 320, 0.75)
    qs = (10**2, 10**3, 10**4, 10**5, 10**6, 10**7)
    for nb in (4_096, 131_072):
        flips = [q for q in qs if pull_pays(q, nb, 320, 0.75)]
        assert flips and flips == [q for q in qs if q >= flips[0]]
    assert pull_pays(SURVEY * EVALS_PER_READ, 4_096, 320, 0.75)
    assert not pull_pays(QUARTER * EVALS_PER_READ, 4_096, 320, 0.75)
    assert not pull_pays(SURVEY * EVALS_PER_READ, 131_072, 320, 0.75)
    local = [True, False, False, False]
    assert walk_plan(SURVEY, 32_768, 320, local, staged=True).staged
    assert walk_plan(SURVEY, 1_024, 320, local, staged=False).direct
    assert walk_plan(SURVEY, 1_024, 320, [True] * 4, staged=True).direct


def test_wrapper_on_cpu_and_the_c_structs(case):
    """On the CPU the wrapper is the plain version, `walk_stage` starts
    nothing and no call is counted; the pull counts as `walk_stage`; the plan of a CPU index is direct
    (every range on the one device).  K3's copy of the index struct
    differs from the uploaded one only in the staged ranges' pointers,
    which point into the stage at each range's first row; the pull's C
    struct lays out csrc/shard.cu WalkStageArgs; an older tree's K3 takes
    the uploaded index in place of the copy and nothing else."""
    di, batches = case
    _, _, lens, words, nmbits = batches["with_n"]
    tl = t32(lens)
    scan = read_scan_ref(t32(words), t32(nmbits), tl, L=L, k1=K - 1)
    whole = index_tensors(di, "cpu")
    ix = sharded_index_tensors(di, ["cpu"] * 4)[1]
    cpu = torch.device("cpu")
    assert plan_for(ix, SURVEY, cpu).direct
    assert plan_for(whole, SURVEY, cpu, staged=True).direct
    assert walk_stage(ix, SURVEY, cpu) is None
    m1, m2 = member_ref(whole, scan, tl, L=L, k1=K - 1)
    before = dict(calls)
    got = greedy_walk(ix, scan, m1, m2, tl, k=K, m=M, effort=E, L=L)
    want = walk_ref(whole, scan, m1, m2, tl, k=K, m=M, effort=E, L=L)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert calls == before
    # the range pull has a launch counter of its own, not K13's
    assert "walk_stage" in build.KERNELS and "walk_stage" in build.launches

    plan = plan_for(ix, SURVEY, cpu, staged=True,
                    local=[s == 1 for s in range(4)])
    rows = stage_ranges_ref(ix.st_shards, plan, cpu)
    c = staged_index(ix, plan, rows)
    row_bytes = ix.st_fused.shape[1] * 4
    for s in range(4):
        want_ptr = (ix.c_index.st_shards[s] if s == 1 else
                    rows.data_ptr() + plan.stage_base[s] * row_bytes)
        assert c.st_shards[s] == want_ptr
    off = build.IndexC.st_shards.offset
    size = ctypes.sizeof(build.IndexC.st_shards.size * ctypes.c_char)
    a, b = bytes(c), bytes(ix.c_index)
    assert a[:off] == b[:off] and a[off + size:] == b[off + size:]

    w = build.WalkStageArgsC
    assert (w.table.offset, w.plan.offset, w.stage.offset,
            w.stream.offset, ctypes.sizeof(w)) == (0, 80, 160, 168, 176)
    newer, argtypes, older = measure.OLDER_ENTRIES["dbg_greedy_walk"]
    assert newer == "dbg_walk_stage"
    assert argtypes == build._ARGTYPES["dbg_greedy_walk"]
    args = tuple(range(23))
    mapped, _ = older(build.Launch("greedy_walk", "dbg_greedy_walk", args,
                                   (ix,) + (None,) * 8))
    assert mapped == args[:9] + (ctypes.addressof(ix.c_index),) + args[10:]


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=[g[0] for g in
                                                     GEOMETRIES])
def test_plan_restates_the_cost_model(geometry):
    """The rule as its docstring states it, at each geometry: staged where
    the remote rows crossing NVLink once, written to the stage and read
    from it, take less time than one evaluation a read of a remote row's
    2S key words and a values sector over NVLink; the pull is charged in
    full (no credit for running beside K1 and K2)."""
    _, B, (nbl, cols), local, path = geometry
    D = len(local)
    share = (D - sum(local)) / D
    pulled = share * nbl * D * cols * 4
    t_staged = (pulled / measure.NVLINK_BYTES_PER_S
                + 2 * pulled / measure.HBM_BYTES_PER_S)
    t_direct = (share * B * EVALS_PER_READ * (2 * (cols // 10) * 4 + 32)
                / measure.NVLINK_BYTES_PER_S)
    want = "staged" if share > 0 and t_staged < t_direct else "direct"
    assert want == path
    plan = walk_plan(B, nbl, cols, [bool(x) for x in local])
    assert ("direct" if plan.direct else "staged") == want


@pytest.mark.parametrize("variant", ["embedded", "pool"])
def test_bound_counts_only_junction_rows_as_remote(case, variant):
    """K3's bytes split by table (`probe_bytes`): the junction rows its
    evaluations read, and umeta's or the pool's sectors of their
    candidates, which are replicated and so never cross NVLink.  The
    survey batch over 4 cards restated: 16,036,672 touched bytes of
    13,100,544 table bytes, 10,679,232 of them junction rows of its
    5,242,880: counting every table byte as 3/4 remote bounded K3 at
    0.0218 ms, the junction rows alone at 0.0087 ms."""
    graph, reads = dataset(seed=1502, k=K, n_reads=48, n_frac=0.1,
                           **({} if variant == "embedded" else
                              dict(min_unitig=21, max_unitig=60)))
    di = device_index(graph, variant)
    ix = sharded_index_tensors(di, ["cpu"] * 4)[0]
    assert (ix.seq_words > 0) == (variant == "embedded")
    _, _, lens, words, nmbits = batch(reads, L)
    tl = t32(lens)
    scan = read_scan_ref(t32(words), t32(nmbits), tl, L=L, k1=K - 1)
    m1, m2 = member_ref(ix, scan, tl, L=L, k1=K - 1)
    counts = {}
    walk_ref(ix, scan, m1, m2, tl, k=K, m=M, effort=E, L=L, counts=counts)
    assert counts["evals"] > 0 and counts["sectors"] > 0
    junction, other = probe_bytes(ix, counts)
    assert junction == (counts["evals"] * ix.st_slots * 4
                        + counts["found"] * 64)
    assert other == counts["sectors"] * 32
    j_table = 4 * sum(x.numel() for x in ix.st_shards)
    table = j_table + 4 * ix.umeta.numel()
    ms, _ = measure.bound_ms(0, junction + other, table, 0,
                             0.75 * min(junction, j_table))
    more = dict(counts, sectors=100 * counts["sectors"])
    assert probe_bytes(ix, more)[0] == junction
    ms_more, _ = measure.bound_ms(0, junction + 100 * other, table, 0,
                                  0.75 * min(junction, j_table))
    assert ms_more >= ms
    # the survey's figures
    nvlink = measure.NVLINK_BYTES_PER_S
    assert round(0.75 * 13_100_544 / nvlink * 1e3, 4) == 0.0218
    ms, by = measure.bound_ms(0, 16_036_672, 13_100_544, 0,
                              0.75 * min(10_679_232, 5_242_880))
    assert (round(ms, 4), by) == (0.0087, "bytes")
