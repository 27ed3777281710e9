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
    """index_tensors looks every stored key of an MPHF table up once (K7
    on the card, its plain version here), in chunks: a table whose rows,
    seeds or key count disagree with the lookup is refused."""
    n = 3000
    keys = _random_keys(n, seed=41)
    vals8 = np.arange(8 * n, dtype=np.int32).reshape(n, 8)
    di = _DI()
    di.mphf_junction = build_mphf_junction(keys, vals8)
    monkeypatch.setattr(mphf_mod, "CHECK_CHUNK", 1024)   # three chunks
    calls = []
    real = mphf_mod.mphf_slots
    monkeypatch.setattr(mphf_mod, "mphf_slots",
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
        match = "1 of its own keys"     # the first chunk's
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
