"""K7 mphf_slots: the port's plain version against the JAX engine's
_mphf_slot_arrays and the host MPHF.lookup, and the MPHF-backed junction
and anchor lookups against core._junction_vals / dog._anchor_lookup, on
the CPU, exact (tolerance 0: every value is an integer).

The JAX functions run op by op (no jit), so the module costs no large
XLA compile.  A tight gamma with few levels sends keys to the two-choice
final table; gamma 16 with 3 levels (the layouts build_mphf_junction and
build_mphf_anchors build) sends almost none."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgtpu.engine import core, dog
from dbgtpu.engine.kmer32 import mix32b as jax_mix32b
from dbgtpu.engine.kmer32 import split64
from dbgtpu.index import mphf as ref_mphf
from dbgtpu.index.device import build_mphf_anchors, build_mphf_junction
from dbgtpu_torch.engine.index import (
    MphfMeta, fuse_mphf, index_tensors, mphf_meta_of,
)
from dbgtpu_torch.engine.dog import anchor_lookup_ref
from dbgtpu_torch.engine.kmer import split_ref
from dbgtpu_torch.engine.member import junction_vals_ref
from dbgtpu_torch.engine import mphf as mphf_mod
from dbgtpu_torch.engine.mphf import (
    check_mphf_table, mix32b_ref, mphf_rows_ref, mphf_slot_ref, mphf_slots,
)

from .torch_parity import t32

ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def _random_keys(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**63, size=2 * n + 2, dtype=np.uint64)
    return np.unique(keys)[:n]


def _queries(keys, seed):
    """Keys of the set, keys outside it, 0 and the all-ones key (the key
    empty final-table slots hold)."""
    absent = np.setdiff1d(_random_keys(len(keys) // 2 + 500, seed), keys)
    return np.concatenate([keys, absent,
                           np.array([0, ALL_ONES], np.uint64)])


def _i64(keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(keys).view(np.int64))


def _jax_slots(m, queries):
    rows, frows = core._fuse_mphf(m)
    qhi, qlo = split64(queries)
    return np.asarray(core._mphf_slot_arrays(
        jnp.asarray(rows), jnp.asarray(frows), core._mphf_meta(m),
        jnp.asarray(qhi), jnp.asarray(qlo)))


@pytest.mark.parametrize("case,n,gamma,max_levels,final", [
    ("gamma16_3_levels", 3000, 16.0, 3, False),
    ("tight_gamma_final_table", 4000, 1.05, 3, True),
    ("gamma1_2_levels", 3000, 1.0, 2, True),
    ("one_level", 500, 2.0, 1, True),
    ("one_key", 1, 2.0, 25, False),
    ("empty_keyset", 0, 2.0, 25, False),
])
def test_mphf_slot_ref_matches_jax_and_host(case, n, gamma, max_levels,
                                            final):
    keys = _random_keys(n, seed=n + 1)
    m = ref_mphf.build_mphf(keys, gamma=gamma, max_levels=max_levels)
    assert (m.final_tbl is not None) == final
    rows, frows = fuse_mphf(m)
    want_rows, want_frows = core._fuse_mphf(m)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(frows, want_frows)
    meta = mphf_meta_of(m)
    n_levels, masks, _, soffs, _, has_final, final_nb = core._mphf_meta(m)
    assert meta.n_levels == n_levels and meta.n_keys == n
    assert meta.masks == masks[:n_levels]
    assert meta.row_offs == soffs[:n_levels]
    assert meta.final_nb == final_nb and bool(meta.final_nb) == has_final
    assert meta.seeds_hi == tuple(
        int(x) for x in ref_mphf._SEEDS_HI[:n_levels])
    assert meta.seeds_lo == tuple(
        int(x) for x in ref_mphf._SEEDS_LO[:n_levels])

    queries = _queries(keys, seed=n + 2)
    got = mphf_slot_ref(t32(rows), t32(frows), meta, _i64(queries))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_slots(m, queries))
    # keys of the set: the host lookup's slots, a permutation of [0, n)
    host = m.lookup(keys)
    np.testing.assert_array_equal(got.numpy()[:n], host)
    assert sorted(got.numpy()[:n].tolist()) == list(range(n))
    # keys outside it: not found, or another key's slot, never >= n
    assert got.numpy()[n:].max(initial=-1) < max(n, 1)
    if final:
        # the final table answered some keys of the set
        no_final = mphf_slot_ref(
            t32(rows), t32(frows[:0]),
            MphfMeta(meta.seeds_hi, meta.seeds_lo, meta.masks, meta.row_offs,
                     0, meta.n_keys), _i64(keys))
        assert (no_final.numpy() < 0).any()
    # the wrapper takes the plain version on the CPU, any query shape
    q2 = _i64(queries[: 2 * (len(queries) // 2)]).reshape(2, -1)
    again = mphf_slots(t32(rows), t32(frows), meta, q2)
    np.testing.assert_array_equal(again.numpy().ravel(),
                                  got.numpy()[: q2.numel()])


def test_mphf_slots_wrapper_uses_plain_version_only_on_cpu():
    keys = _random_keys(200, seed=5)
    m = ref_mphf.build_mphf(keys, gamma=2.0)
    rows, frows = (t32(a) for a in fuse_mphf(m))
    with pytest.raises(ValueError, match="no mphf_slots kernel"):
        mphf_slots(rows, frows, mphf_meta_of(m), _i64(keys).to("meta"))
    with pytest.raises(ValueError, match="at most"):
        mphf_meta_of(type("M", (), dict(n_levels=26))())


def test_mix32b_ref_matches_jax():
    keys = _random_keys(4000, seed=9)
    qhi, qlo = split64(keys)
    hi, lo = split_ref(_i64(keys))
    np.testing.assert_array_equal(
        mix32b_ref(hi, lo).numpy().astype(np.uint32),
        np.asarray(jax_mix32b(jnp.asarray(qhi), jnp.asarray(qlo))))


class _DI:
    """Minimal DeviceIndex stand-in: MPHF tables and placeholders."""

    scan_tbl = None
    probe_tbl = None
    anchor_scan = None
    mphf_junction = None
    anchor_mphf = None
    umeta = np.zeros((1, 16), np.int32)
    pool_rows = np.zeros((1, 10), np.uint32)
    n_chunks = 1


@pytest.mark.parametrize("n", [3000, 0])
def test_mphf_junction_and_anchor_lookups_match_jax(n):
    """Stored-key verify: a key outside the set that aliases a slot is
    rejected; an empty table finds nothing."""
    keys = _random_keys(n, seed=31)
    rng = np.random.default_rng(32)
    vals8 = rng.integers(-5000, 5000, size=(n, 8)).astype(np.int32)
    vals3 = rng.integers(0, 1 << 20, size=(n, 3)).astype(np.int32)
    di = _DI()
    di.mphf_junction = build_mphf_junction(keys, vals8)
    di.anchor_mphf = build_mphf_anchors(keys, vals3)
    ix = index_tensors(di, "cpu")
    jx = core.index_to_device(di)
    assert ix.mph_meta is not None and ix.amph_meta is not None
    assert tuple(ix.st_fused.shape) == (0, 320)
    for f in ("mph_rows", "mph_jrows", "mph_f", "amph_rows", "amph_arows",
              "amph_f"):
        np.testing.assert_array_equal(
            getattr(ix, f).numpy().view(np.uint32), np.asarray(getattr(jx, f)),
            err_msg=f)
    queries = _queries(keys, seed=33).reshape(2, -1)[:, : (n + 100) // 2]
    qhi, qlo = (jnp.asarray(a) for a in split64(queries))
    q = _i64(queries)

    found, v8 = junction_vals_ref(ix, q)
    member, uid, upos, ucan = anchor_lookup_ref(ix, q)
    hit = member.numpy()
    if n:   # JAX cannot gather from the [0, 10] / [0, 5] rows of n = 0
        jfound, jv8 = core._junction_vals(jx, core.jl_meta_of(di), qhi, qlo)
        np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
        np.testing.assert_array_equal(v8.numpy()[found.numpy()],
                                      np.asarray(jv8)[found.numpy()])
        jm, juid, jupos, jucan = dog._anchor_lookup(jx, qhi, qlo,
                                                    core.al_meta_of(di))
        np.testing.assert_array_equal(hit, np.asarray(jm))
        for got, want in ((uid, juid), (upos, jupos), (ucan, jucan)):
            np.testing.assert_array_equal(got.numpy()[hit],
                                          np.asarray(want)[hit])
    # exactly the keys of the set are found, with their values
    in_set = np.isin(queries, keys)
    np.testing.assert_array_equal(found.numpy(), in_set)
    np.testing.assert_array_equal(hit, in_set)
    if n:
        first = queries.ravel()[0]
        np.testing.assert_array_equal(
            v8.numpy().reshape(-1, 8)[0], vals8[np.searchsorted(keys, first)])
        # aliasing happens (an absent key gets a slot) and the verify
        # rejects it
        slot = mphf_slot_ref(ix.amph_rows, ix.amph_f, ix.amph_meta, q)
        assert ((slot.numpy() >= 0) & ~in_set).any()
        assert not mphf_rows_ref(ix.amph_rows, ix.amph_f, ix.amph_arows,
                                 ix.amph_meta, q)[0].numpy()[~in_set].any()


@pytest.mark.parametrize("fault", ["none", "row_moved", "seeds", "n_keys"])
def test_check_mphf_table_at_upload(fault, monkeypatch):
    """index_tensors looks every stored key of an MPHF table up once (K7's
    check mode on the card, one launch for the table; its plain version
    here, CHECK_CHUNK keys at a time): a table whose rows, seeds or key
    count disagree with the lookup is refused, and the message counts
    the keys at the wrong slot over the whole table."""
    n = 3000
    keys = _random_keys(n, seed=41)
    vals8 = np.arange(8 * n, dtype=np.int32).reshape(n, 8)
    di = _DI()
    di.mphf_junction = build_mphf_junction(keys, vals8)
    monkeypatch.setattr(mphf_mod, "CHECK_CHUNK", 1024)   # three chunks
    calls = []
    real = mphf_mod.mphf_slot_ref
    monkeypatch.setattr(mphf_mod, "mphf_slot_ref",
                        lambda *a: calls.append(a[3].numel()) or real(*a))
    ix = index_tensors(di, "cpu")
    assert calls == [1024, 1024, n - 2048]
    rows, frows, jrows, meta = ix.mph_rows, ix.mph_f, ix.mph_jrows, ix.mph_meta
    if fault == "none":
        check_mphf_table(rows, frows, jrows, meta, "junction")
        return
    if fault == "row_moved":
        jrows = jrows.clone()
        jrows[[5, 2500]] = jrows[[2500, 5]]
        match = "returns 2 of its own keys"     # both chunks' keys
    elif fault == "seeds":
        meta = MphfMeta(meta.seeds_lo, meta.seeds_hi, meta.masks,
                        meta.row_offs, meta.final_nb, meta.n_keys)
        match = "of its own keys at the wrong slot"
    else:
        meta = MphfMeta(meta.seeds_hi, meta.seeds_lo, meta.masks,
                        meta.row_offs, meta.final_nb, n - 1)
        match = "2999 keys and its table 3000 rows"
    with pytest.raises(ValueError, match=match):
        check_mphf_table(rows, frows, jrows, meta, "junction")


@pytest.mark.parametrize("n,gamma,max_levels", [
    (0, 2.0, 25), (1, 2.0, 25), (31, 2.0, 25), (33, 2.0, 25),
    (2000, 1.0, 2)])
def test_mphf_check_counts_over_the_whole_table(n, gamma, max_levels,
                                                monkeypatch):
    """K7's check mode (plain version): the count of stored keys at
    another slot, over every chunk of the table, on chip_smoke's edge
    tables (the last one has keys in the final table) and dbgtpu's own
    MPHF build; rows swapped anywhere count 2 each time."""
    keys = _random_keys(n, seed=43 + n)
    m = ref_mphf.build_mphf(keys, gamma=gamma, max_levels=max_levels)
    rows, frows = (t32(a) for a in fuse_mphf(m))
    meta = mphf_meta_of(m)
    vrows = np.zeros((n, 5), np.uint32)
    slots = m.lookup(keys)
    vrows[slots, 0] = (keys >> np.uint64(32)).astype(np.uint32)
    vrows[slots, 1] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    vrows = t32(vrows)
    if max_levels == 2:
        assert m.final_tbl is not None
        assert (mphf_slot_ref(rows, frows[:0], MphfMeta(
            meta.seeds_hi, meta.seeds_lo, meta.masks, meta.row_offs, 0,
            meta.n_keys), _i64(keys)).numpy() < 0).any()
    monkeypatch.setattr(mphf_mod, "CHECK_CHUNK", 16)
    assert mphf_mod.mphf_check(rows, frows, vrows, meta) == 0
    check_mphf_table(rows, frows, vrows, meta, "test")
    if n < 2:
        return
    for a, b in ((0, n - 1), (1, n // 2)):
        swapped = vrows.clone()
        swapped[[a, b]] = swapped[[b, a]]
        assert mphf_mod.mphf_check_ref(rows, frows, swapped, meta) == 2
        with pytest.raises(ValueError, match="test MPHF on cpu returns 2 of"):
            check_mphf_table(rows, frows, swapped, meta, "test")


def test_mphf_check_edge_tables_hold_their_keys():
    """chip_smoke's edge tables for K7's check mode (kernels/edge_batch.py
    mphf_check_tables): every stored key at its own row, the tight-gamma
    table with keys in the final table."""
    from dbgtpu_torch.kernels.edge_batch import (
        MPHF_CHECK_SIZES, mphf_check_tables,
    )

    tables = mphf_check_tables()
    assert [v.shape[0] for _, _, v in tables] == [*MPHF_CHECK_SIZES, 2000]
    assert tables[-1][1].final_tbl is not None
    for name, m, vrows in tables:
        rows, frows = (t32(a) for a in fuse_mphf(m))
        assert mphf_mod.mphf_check(rows, frows, t32(vrows),
                                   mphf_meta_of(m)) == 0, name


# ---- K7's launch plan and its keys-a-thread schedule --------------------

@pytest.mark.parametrize("n,want", [
    # the survey junction table: one key a thread, blocks of 64 so that
    # 480 blocks reach all 132 SMs
    (30694, (1, 64)),
    # the survey anchor table: two keys a thread fill every SM
    (1969277, (2, 256)),
    (1, (1, 64)), (0, (1, 64)),
    (132 * 128 * 2, (1, 128)), (132 * 128 * 2 - 128, (1, 64)),
    (2 * 132 * 2048 - 1, (1, 256)), (2 * 132 * 2048, (2, 256)),
    (1 << 30, (2, 256)),
])
def test_mphf_plan(n, want):
    plan = mphf_mod.mphf_plan(n, sms=132)
    assert (plan.per_thread, plan.threads) == want
    assert plan.threads % 32 == 0
    assert mphf_mod.MPHF_MIN_THREADS <= plan.threads <= mphf_mod.MPHF_THREADS


@pytest.mark.parametrize("n,per_thread,threads", [
    (1, 1, 64), (31, 4, 64), (33, 2, 32), (1000, 4, 256), (30694, 1, 64),
    (4097, 4, 128)])
def test_mphf_key_indices_cover_every_key_once(n, per_thread, threads):
    """csrc/mphf.cu key_index: key q of thread t in block b is (b Q + q)
    T + t; over the plan's grid each key of [0, n) falls to exactly one
    (block, q, thread), the rest past the end."""
    blocks = -(-n // (per_thread * threads))
    b, q, t = np.meshgrid(np.arange(blocks), np.arange(per_thread),
                          np.arange(threads), indexing="ij")
    i = ((b * per_thread + q) * threads + t).ravel()
    np.testing.assert_array_equal(np.sort(i[i < n]), np.arange(n))
    assert (i >= n).sum() == blocks * per_thread * threads - n


def _levels(meta, first, last=None, final=True):
    """meta restricted to levels [first, last) (and its final table, or
    none)."""
    sl = slice(first, last)
    return MphfMeta(meta.seeds_hi[sl], meta.seeds_lo[sl], meta.masks[sl],
                    meta.row_offs[sl], meta.final_nb if final else 0,
                    meta.n_keys)


@pytest.mark.parametrize("n,gamma,max_levels", [
    (3000, 16.0, 3), (4000, 1.05, 3), (3000, 1.0, 2), (500, 2.0, 1),
    (1, 2.0, 25), (0, 2.0, 25)])
def test_mphf_two_step_lookup_matches_plain(n, gamma, max_levels):
    """The kernel's schedule restated: every key's level-0 probe first
    (address step, then the test), a hit's rank as its slot, and a miss
    looked up on from level 1 (csrc/mphf.cu slots_of, mphf.cuh
    mphf_slot_from) gives the plain version's slots."""
    keys = _random_keys(n, seed=n + 7)
    m = ref_mphf.build_mphf(keys, gamma=gamma, max_levels=max_levels)
    rows, frows = (t32(a) for a in fuse_mphf(m))
    meta = mphf_meta_of(m)
    queries = _i64(_queries(keys, seed=n + 8))
    want = mphf_slot_ref(rows, frows, meta, queries)
    if not meta.n_levels:
        return
    level0 = mphf_slot_ref(rows, frows[:0], _levels(meta, 0, 1, final=False),
                           queries)
    rest = mphf_slot_ref(rows, frows, _levels(meta, 1), queries)
    got = torch.where(level0 >= 0, level0, rest)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
