"""K2 member's staged path on a sharded index (`--shard-index`) on the CPU.

`staged_schedule` restates csrc/shard.cu dbg_member_staged in plain
torch, pass by pass, in the manner of test_torch_shard_plan's restatement
of K13: (a) mark the buckets of the keys the batch's path will look up
(the probe path's live windows, or the per-position path's valid
positions and rep2 where it differs), the path chosen by the batch's N
flag as K2 chooses it; (b) pull each flagged row of the ranges the plan
stages into a stage, once; (c) K2's plain version `member_ref` (or
`inter_ref`) reading those ranges from the stage.  Stage rows that were
not marked keep a poison: 0x5A5A5A5A words (a key there is never found)
or the true row with its value words complemented (a key there is found
with the wrong neighbour bits).  The result must still equal dbgtpu's
sharded `_closure_member` / `_st_member_positions` under jax.shard_map on
2, 4 and 8 of conftest's virtual CPU devices, and the plain K2 on the
whole index, with each device in turn as the reading card: so the
restated K2 reads no row it did not mark.  A mark that leaves one row out
is caught.  The plan (`member_plan`) is checked at the survey's and
scale1M's geometries.  Inputs come from numpy seeds; every comparison is
exact (tolerance 0: the outputs are integers)."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from dbgtpu.engine import core
from dbgtpu.index.build import build_graph_from_seqs
from dbgtpu_torch.engine.index import index_tensors, sharded_index_tensors
from dbgtpu_torch.engine.kmer import mix32_ref, rcb_ref, split_ref
from dbgtpu_torch.engine.member import (
    MemberPlan, inter_ref, member, member_plan, member_ref, plan_for,
    stage_pays,
)
from dbgtpu_torch.engine.read_scan import read_scan_ref
from dbgtpu_torch.index.device import PT_SLOTS
from dbgtpu_torch.kernels import build, measure
from dbgtpu_torch.kernels.edge_batch import CASE_NAMES, edge_cases

from .torch_parity import batch, dataset, device_index, t32

MESHES = [2, 4, 8]
POISONS = ["5a", "flip"]
K, L = 21, 112


def _probes(ix, scan) -> bool:
    """The batch's path, as K2 reads it: (a) closure probes unless the
    batch holds an N or there is no probe table."""
    return ix.pt_rows.shape[0] > 0 and not bool(scan.has_n.item())


def _marked_keys(ix, scan, lens, k1, exhaustive):
    """The int64 keys the batch's path looks up (mark pass (a))."""
    B, Lk = scan.rep1.shape
    last = (lens.to(torch.int64) - k1)[:, None]   # valid: i <= last
    if _probes(ix, scan):
        i0 = torch.arange(0, Lk, ix.pt_window)
        p = torch.clamp(i0 + 1, max=Lk - 1)
        return scan.rep1[:, p][i0[None, :] <= last]
    pos = torch.arange(Lk)[None, :] <= last
    if exhaustive:
        return torch.minimum(scan.bug, rcb_ref(scan.bug, k1))[pos]
    return torch.cat([scan.rep1[pos],
                      scan.rep2[pos & (scan.rep2 != scan.rep1)]])


def _poison(shards, splan, S, how):
    """The stage before the pull: every row a poison."""
    nbl, cols = shards[0].shape
    if how == "5a":
        return torch.full((splan.remote_rows, cols), 0x5A5A5A5A,
                          dtype=torch.int32)
    rows = torch.cat([shards[s] for s in splan.remote])
    rows[:, 2 * S:] = ~rows[:, 2 * S:]
    return rows


def staged_schedule(ix, scan, lens, *, L, k1, plan: MemberPlan,
                    exhaustive=False, poison="5a", drop=False):
    """dbg_member_staged in plain torch: (a) mark, (b) pull, (c) K2 from
    the stage (see the module docstring).  `drop`: leave the most asked
    row unmarked (a broken mark pass).  Returns (K2's outputs, flags,
    pulled: the copies of each stage row from its range), the last two
    None where the path that runs reads every row in place."""
    run = inter_ref if exhaustive else member_ref
    probe = _probes(ix, scan)
    splan = plan.probe if probe else plan.scan
    if not splan.staged:
        return run(ix, scan, lens, L=L, k1=k1), None, None
    shards = ix.pt_shards if probe else ix.st_shards
    seed = ix.pt_seed if probe else ix.st_seed
    S = PT_SLOTS if probe else ix.st_slots
    nbl, cols = shards[0].shape
    D = len(shards)
    # (a) mark
    hi, lo = split_ref(_marked_keys(ix, scan, lens, k1, exhaustive))
    b = mix32_ref(hi ^ seed, lo) & (nbl * D - 1)
    s = b // nbl
    base = torch.tensor(splan.stage_base, dtype=torch.int64)[s]
    rows = (base + b - s * nbl)[base >= 0]
    flags = torch.zeros(splan.remote_rows, dtype=torch.int32)
    flags[rows] = 1
    if drop:
        flags[torch.bincount(rows, minlength=splan.remote_rows).argmax()] = 0
    # (b) pull: each flagged stage row r from row r % nbl of the range
    # the plan stages at r // nbl
    stage = _poison(shards, splan, S, poison)
    pull = torch.nonzero(flags).reshape(-1)
    stage[pull] = torch.cat([shards[s] for s in splan.remote])[pull]
    pulled = torch.zeros(splan.remote_rows, dtype=torch.int64).index_add_(
        0, pull, torch.ones_like(pull))
    # (c) K2 on its copy of the index, the staged ranges read from the stage
    staged = tuple(stage[x : x + nbl] if x >= 0 else shards[i]
                   for i, x in enumerate(splan.stage_base))
    sx = dataclasses.replace(ix, **{"pt_shards" if probe else "st_shards":
                                    staged})
    return run(sx, scan, lens, L=L, k1=k1), flags, pulled


def _split(v: torch.Tensor):
    v = v.numpy()
    return (jnp.asarray((v >> 32).astype(np.uint32)),
            jnp.asarray((v & 0xFFFFFFFF).astype(np.uint32)))


def _jax_sharded(di, scan, codes, k1, D):
    """dbgtpu's sharded membership on D virtual devices, the tables cut
    into D bucket ranges (P("x")) and the batch on every device:
    _closure_member where the batch takes the probe path, else
    _st_member_positions of rep1 and of rep2 -> (member1, member2) bool,
    before the valid mask."""
    jx = core.index_to_device(di)
    mesh = Mesh(np.array(jax.devices()[:D]), ("x",))
    if di.probe_tbl is not None and not bool(scan.has_n.item()):
        def fn(pt, rh, rl, le, c):
            return core._closure_member(jx._replace(pt_rows=pt), rh, rl, le,
                                        c, k1, "x")
        m = jax.jit(jax.shard_map(fn, mesh=mesh,
                                  in_specs=(P("x"),) + (P(),) * 4,
                                  out_specs=P(), check_vma=False))(
            jx.pt_rows, *_split(scan.rep1),
            jnp.asarray(scan.le1.numpy().astype(bool)),
            jnp.asarray(codes.astype(np.uint32)))
        return np.asarray(m), np.asarray(m)

    def fn(st, h1, l1, h2, l2):
        sx = jx._replace(st_fused=st)
        return (core._st_member_positions(sx, h1, l1, None, "x"),
                core._st_member_positions(sx, h2, l2, None, "x"))
    m1, m2 = jax.jit(jax.shard_map(fn, mesh=mesh,
                                   in_specs=(P("x"),) + (P(),) * 4,
                                   out_specs=(P(), P()), check_vma=False))(
        jx.st_fused, *_split(scan.rep1), *_split(scan.rep2))
    return np.asarray(m1), np.asarray(m2)


def _check(ix, scan, lens, *, L, k1, plan, want, exhaustive=False):
    """The staged schedule under both poisons equals `want`; each row it
    marks is pulled once, none other."""
    for poison in POISONS:
        got, flags, pulled = staged_schedule(ix, scan, lens, L=L, k1=k1,
                                             plan=plan, exhaustive=exhaustive,
                                             poison=poison)
        for g, w in zip(got if not exhaustive else (got,),
                        want if not exhaustive else (want,)):
            assert torch.equal(g, w), poison
        if flags is not None:
            assert torch.equal(pulled, flags.to(torch.int64))
    return flags


@pytest.fixture(scope="module")
def case():
    """A greedy dataset with N (batch `with_n`) and the same reads without
    N (batch `no_n`), packed with an all-zero N plane of the same shape."""
    graph, reads = dataset(seed=1401, k=K, n_reads=64, n_frac=0.15)
    di = device_index(graph)
    assert di.scan_tbl.keys.shape[0] >= 8 and di.probe_tbl is not None
    with_n = batch(reads, L, keep_empty_nmbits=True)
    clean = [r.replace(b"N", b"A").replace(b"n", b"a") for r in reads]
    no_n = batch(clean, L, keep_empty_nmbits=True)
    assert with_n[1].any() and not no_n[1].any()
    return di, {"with_n": with_n, "no_n": no_n}


@pytest.mark.parametrize("D", MESHES)
def test_staged_member_matches_jax_sharded_member(case, D):
    """On D ranges, each range in turn the reader's and the others staged
    (forced, and by the plan), the staged schedule on the N-free batch
    (probe path), on the batch with N (per-position path, planted N
    switching a probe index to it) and on the N-free batch without a
    probe table equals dbgtpu's sharded functions and the plain K2 on
    the whole index, under both poisons."""
    di, batches = case
    whole = index_tensors(di, "cpu")
    ixs = sharded_index_tensors(di, ["cpu"] * D)
    paths = set()
    for name, (codes, _, lens, words, nmbits) in batches.items():
        tl = t32(lens)
        scan = read_scan_ref(t32(words), t32(nmbits), tl, L=L, k1=K - 1)
        valid = (np.arange(scan.rep1.shape[1])[None, :]
                 <= (lens - (K - 1))[:, None])
        want_jax = _jax_sharded(di, scan, codes, K - 1, D)
        for reader, ix in enumerate(ixs):
            variants = [ix]
            if name == "no_n":
                variants.append(dataclasses.replace(
                    ix, pt_rows=ix.pt_rows[:0], pt_shards=()))
            for vx in variants:
                want = member_ref(whole if vx is ix else dataclasses.replace(
                    whole, pt_rows=whole.pt_rows[:0]), scan, tl, L=L,
                    k1=K - 1)
                if vx is ix:
                    for g, w in zip(want, want_jax):
                        np.testing.assert_array_equal(
                            g.numpy().astype(bool), w & valid, err_msg=name)
                local = [s == reader for s in range(D)]
                for staged in (True, None):
                    plan = plan_for(vx, scan, staged=staged, local=local)
                    assert not plan.direct
                    flags = _check(vx, scan, tl, L=L, k1=K - 1, plan=plan,
                                   want=want)
                    assert flags is not None and flags.any()
                paths.add(_probes(vx, scan))
    assert paths == {True, False}


@pytest.mark.parametrize("D", [2, 8])
def test_staged_member_catches_a_row_left_unmarked(case, D):
    """The poisons show a broken mark pass: with the most asked row left
    unmarked, K2 from the stage differs from the plain K2 on both
    paths."""
    di, batches = case
    whole = index_tensors(di, "cpu")
    ix = sharded_index_tensors(di, ["cpu"] * D)[0]
    local = [s == 0 for s in range(D)]
    for name, poison in (("no_n", "flip"), ("with_n", "5a")):
        _, _, lens, words, nmbits = batches[name]
        tl = t32(lens)
        scan = read_scan_ref(t32(words), t32(nmbits), tl, L=L, k1=K - 1)
        plan = plan_for(ix, scan, staged=True, local=local)
        got, _, _ = staged_schedule(ix, scan, tl, L=L, k1=K - 1, plan=plan,
                                    poison=poison, drop=True)
        want = member_ref(whole, scan, tl, L=L, k1=K - 1)
        assert not all(torch.equal(g, w) for g, w in zip(got, want)), name


_EDGE = {c.name: c for c in edge_cases()}


def _shard_count(di) -> int:
    nb_st = di.scan_tbl.keys.shape[0]
    nb_pt = di.probe_tbl.rows.shape[0] if di.probe_tbl is not None else 0
    return max(D for D in (1, 2, 4, 8)
               if nb_st >= D and not nb_st % D and not nb_pt % D
               and not 0 < nb_pt < D)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_staged_member_edge_batch(name):
    """The edge batch (Lk 31, 32, 33, 65; reads of k-1 .. L bases; the
    last window of a read; planted N): on the scan index cut into the
    most ranges it allows, with and without its probe table, each range
    the reader's in turn, the staged schedule (forced) of K2 and of its
    exhaustive mode equals dbgtpu's sharded functions, the plain K2 on the
    whole index and inter_ref, under both poisons."""
    c = _EDGE[name]
    k1 = c.k - 1
    di = device_index(build_graph_from_seqs(list(c.unitigs), c.k))
    D = _shard_count(di)
    assert D >= 2
    codes, _, lens, words, nmbits = batch(list(c.reads), c.L)
    tl = t32(lens)
    scan = read_scan_ref(t32(words), t32(nmbits), tl, L=c.L, k1=k1)
    assert bool(scan.has_n.item()) == name.endswith("_N")
    valid = (np.arange(c.Lk)[None, :] <= (lens - k1)[:, None])
    whole = index_tensors(di, "cpu")
    ixs = sharded_index_tensors(di, ["cpu"] * D)
    want_jax = _jax_sharded(di, scan, codes, k1, D)
    for probe in (True, False):
        wx = whole if probe else dataclasses.replace(
            whole, pt_rows=whole.pt_rows[:0])
        want = member_ref(wx, scan, tl, L=c.L, k1=k1)
        want_x = inter_ref(wx, scan, tl, L=c.L, k1=k1)
        if probe:
            for g, w in zip(want, want_jax):
                np.testing.assert_array_equal(g.numpy().astype(bool),
                                              w & valid)
        for reader, ix in enumerate(ixs):
            vx = ix if probe else dataclasses.replace(
                ix, pt_rows=ix.pt_rows[:0], pt_shards=())
            plan = plan_for(vx, scan, staged=True,
                            local=[s == reader for s in range(D)])
            _check(vx, scan, tl, L=c.L, k1=k1, plan=plan, want=want)
            _check(vx, scan, tl, L=c.L, k1=k1, plan=plan, want=want_x,
                   exhaustive=True)


SURVEY = (32_768, 83)          # chip_smoke's batch: B reads, Lk positions
QUARTER = (8_192, 83)          # one card's share of it under --mesh 4
# (name, (B, Lk), probe range, junction range, ranges on the reading card,
# probe path, junction path)
GEOMETRIES = [
    ("survey, 4 cards", SURVEY, (8_192, 96), (1_024, 320), [1, 0, 0, 0],
     "staged", "staged"),
    ("survey, 2 cards", SURVEY, (16_384, 96), (2_048, 320), [0, 1],
     "staged", "staged"),
    ("survey, a quarter batch on 4 cards", QUARTER, (8_192, 96), (1_024, 320),
     [0, 0, 1, 0], "staged", "staged"),
    ("survey, 8 ranges on one card", SURVEY, (4_096, 96), (512, 320),
     [1] * 8, "direct", "direct"),
    ("survey, one range", SURVEY, (32_768, 96), (4_096, 320), [1],
     "direct", "direct"),
    # scale1M: a probe table of 1,048,576 rows (403 MB) whose keys repeat
    # about once a batch, a junction table of 131,072 rows looked up ~20
    # times a row
    ("scale1M, 4 cards", SURVEY, (262_144, 96), (32_768, 320), [1, 0, 0, 0],
     "direct", "staged"),
    ("scale1M, a quarter batch on 4 cards", QUARTER, (262_144, 96),
     (32_768, 320), [1, 0, 0, 0], "direct", "direct"),
    ("scale1M, every range on one card", SURVEY, (262_144, 96),
     (32_768, 320), [1] * 4, "direct", "direct"),
]


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=[g[0] for g in
                                                     GEOMETRIES])
def test_plan_geometries(geometry):
    """The plan's path for each table at chip_smoke's and scale1M's
    shapes; a staged table stages every range not on the card, its
    scratch is a flag and a row per remote table row, one stage serving
    both tables."""
    _, (B, Lk), pt, st, local, want_pt, want_st = geometry
    plan = member_plan(B, Lk, pt, st, [bool(x) for x in local])
    got = ["direct" if p.direct else "staged" for p in (plan.probe,
                                                        plan.scan)]
    assert got == [want_pt, want_st]
    remote = tuple(s for s in range(len(local)) if not local[s])
    rows = []
    for p, (nbl, cols) in ((plan.probe, pt), (plan.scan, st)):
        if p.staged:
            assert p.remote == remote and p.remote_rows == nbl * len(remote)
        rows.append(p.remote_rows * cols)
    flags, words = plan.scratch_words(pt[1], st[1])
    assert words == max(rows)
    assert flags == max(plan.probe.remote_rows, plan.scan.remote_rows)
    if geometry[0] == "survey, 4 cards":
        # 24,576 remote probe rows of 384 B: 9.4 MB per card
        assert (flags, 4 * words) == (24_576, 9_437_184)


def test_plan_rule_and_overrides():
    """`stage_pays`: never with every row local or no lookups; more
    lookups of the same table tip it to staged; `staged` forces a path,
    but nothing is staged with every range on the card."""
    assert not stage_pays(10**6, 1024, 96, 0.0, 260)
    assert not stage_pays(0, 1024, 96, 0.75, 260)
    flips = [q for q in (10**3, 10**4, 10**5, 10**6, 10**7)
             if stage_pays(q, 2**20, 96, 0.75, 260)]
    assert flips and flips == [q for q in (10**3, 10**4, 10**5, 10**6, 10**7)
                               if q >= flips[0]]
    local = [True, False, False, False]
    forced = member_plan(*SURVEY, (262_144, 96), (32_768, 320), local,
                         staged=True)
    assert forced.probe.staged and forced.scan.staged
    assert member_plan(*SURVEY, (8_192, 96), (1_024, 320), local,
                       staged=False).direct
    assert member_plan(*SURVEY, (8_192, 96), (1_024, 320), [True] * 4,
                       staged=True).direct
    # no probe table: its plan stays direct
    assert member_plan(*SURVEY, (0, 96), (1_024, 320), local,
                       staged=True).probe.direct


def test_wrapper_on_cpu_and_the_c_struct(case):
    """On the CPU the wrapper is the plain version whatever the plan, and
    the plan of a CPU index is direct (every range on the one device);
    the C struct of a staged call lays out dbg_member's arguments, the
    two plans and the scratch as csrc/shard.cu MemberStageArgs; an older
    tree's K2 takes dbg_member's arguments from it."""
    di, batches = case
    _, _, lens, words, nmbits = batches["no_n"]
    tl = t32(lens)
    scan = read_scan_ref(t32(words), t32(nmbits), tl, L=L, k1=K - 1)
    ix = sharded_index_tensors(di, ["cpu"] * 4)[1]
    assert plan_for(ix, scan).direct
    assert plan_for(index_tensors(di, "cpu"), scan).direct
    got = member(ix, scan, tl, L=L, k1=K - 1)
    want = member_ref(index_tensors(di, "cpu"), scan, tl, L=L, k1=K - 1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    c = build.MemberStageArgsC
    assert c.exhaustive.offset == 13 * 8 and c.plan.offset == 13 * 8 + 24
    assert ctypes.sizeof(c) == -(-(c.plan.offset
                                   + 2 * ctypes.sizeof(build.ShardPlanC))
                                 // 8) * 8
    newer, argtypes, older, entry = measure.OLDER_ENTRIES["dbg_member_staged"]
    assert entry == "dbg_member"
    assert argtypes == build._ARGTYPES["dbg_member"]
    args = c(rep1=1, le1=2, rep2=3, bug=4, rwf=5, lens=6, index=7, has_n=8,
             member1=9, member2=10, stream=11, exhaustive=0, RWr=7, B=12,
             L=13, k1=14)
    launch = build.Launch("member", "dbg_member_staged",
                          (ctypes.addressof(args),),
                          (None,) * 5 + (args, None, None))
    mapped, _ = older(launch)
    assert mapped == (1, 2, 3, 4, 0, 5, 7, 6, 12, 13, 14, 7, 8, 9, 10, 11)
