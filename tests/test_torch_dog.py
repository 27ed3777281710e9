"""K5 dog_anchors and anchor mode (-G): the port's plain versions against
dbgtpu's JAX functions on the CPU and its python spec, exact.

Per case one jitted composition of the JAX anchor stage
(dog._anchor_lookup, core._first_k_hits / _last_k_hits_rc,
dog._dog_inits, as align_batch_anchors :193-252 chains them) and one
compile of dog.align_batch_anchors.  k = 32 makes whole 64-bit k-mers,
whose int64 may be negative (engine/kmer.py)."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgtpu.constants import STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC
from dbgtpu.engine import core, dog
from dbgtpu.engine.kmer32 import pair_le, rcb_pair
from dbgtpu.index.build import build_graph_from_seqs
from dbgtpu.pipeline import run_pipeline as dbgtpu_pipeline
from dbgtpu_torch.engine.core import align_batch
from dbgtpu_torch.engine.dog import (
    anchor_lookup_ref, dog_anchors, dog_anchors_ref,
)
from dbgtpu_torch.engine.index import index_tensors
from dbgtpu_torch.engine.kmer import le_ref, rcb_ref
from dbgtpu_torch.engine.read_scan import _scan, read_scan_ref
from dbgtpu_torch.engine.walk import INIT_FIELDS
from dbgtpu_torch.kernels.edge_batch import CASE_NAMES, edge_cases
from dbgtpu_torch.pipeline import run_pipeline

from . import synth
from .torch_parity import (
    assert_walks_equal, batch, dataset, device_index, join, t32,
)

# JAX init keys per port field (k-mers are (hi, lo) pairs there)
_JAX_FIELD = dict(cur0=("cur_hi0", "cur_lo0"), ra=("ra_hi", "ra_lo"))


@functools.partial(jax.jit, static_argnames=("k", "m", "E", "al_meta"))
def _jax_anchor_stage(ix, codes, nmask, lens, *, k, m, E, al_meta=None):
    """align_batch_anchors up to the walk: the lookup (its scan branch,
    or with `al_meta` its MPHF branch), first / last E hits, per-anchor
    inits."""
    B, L = codes.shape
    Lw = (L + 15) // 16
    _, _, rwf, rwr, nmw = core._read_images(codes, nmask, lens, 2 * Lw + 1)
    fhi, flo = core._scan_kmer_pairs_words(rwf, L, k)
    rhi, rlo = rcb_pair(fhi, flo, k)
    le_f = pair_le(fhi, flo, rhi, rlo)
    keys = (jnp.where(le_f, fhi, rhi), jnp.where(le_f, flo, rlo))
    lookup = dog._anchor_lookup(ix, *keys, al_meta)
    member, uid, upos, ucan = lookup
    col = jnp.arange(L - k + 1, dtype=jnp.int32)[None, :]
    member = member & (col <= (lens - k)[:, None])
    apos_f, (uid_f, upos_f, ucan_f, lef), n_f = core._first_k_hits(
        member, (uid, upos, ucan, le_f.astype(jnp.int32)), E)
    le_r = pair_le(rhi, rlo, fhi, flo)
    apos_r, (uid_r, upos_r, ucan_r, ler), n_r = core._last_k_hits_rc(
        member, (uid, upos, ucan, le_r.astype(jnp.int32)), lens, k, E)
    kw = dict(k=k, m=m, W2=Lw, Lw=Lw)
    ini_f = dog._dog_inits(ix, uid_f, upos_f, ucan_f, lef, apos_f, lens, rwf,
                           nmw, st_aligned=STATUS_ALIGNED_FWD, **kw)
    ini_r = dog._dog_inits(ix, uid_r, upos_r, ucan_r, ler, apos_r, lens, rwr,
                           None, st_aligned=STATUS_ALIGNED_RC, **kw)
    return keys, lookup, (ini_f, ini_r), (n_f, n_r)


def check_k5_and_anchor_batch_match_jax(seed, k, m, effort, n_frac, variant,
                                        kw):
    """dog_anchors_ref and align_batch(mode="anchors") against the JAX
    anchor stage and dog.align_batch_anchors on one dataset, under the
    index `variant`; the MPHF variants pass core's jl_meta / al_meta."""
    graph, reads = dataset(seed=seed, k=k, n_reads=48, n_frac=n_frac,
                           genome_len=8000, dog_mode=True, **kw)
    rng = np.random.default_rng(seed)
    # some reads shorter than k: no anchor, NO_OVERLAP
    reads = [r if i % 5 else r[: int(rng.integers(k - 3, k + 8))]
             for i, r in enumerate(reads)]
    di = device_index(graph, variant)
    ix = index_tensors(di, "cpu")
    jx = core.index_to_device(di)
    jl_meta, al_meta = core.jl_meta_of(di), core.al_meta_of(di)
    assert (al_meta is not None) == (ix.amph_meta is not None)
    assert (jl_meta is not None) == (ix.mph_meta is not None)
    L = 112
    codes, nm, lens, words, nmbits = batch(reads, L)
    scan = read_scan_ref(t32(words), t32(nmbits), t32(lens), L=L, k1=k - 1)
    j_keys, j_lookup, j_inits, j_n = _jax_anchor_stage(
        jx, jnp.asarray(codes), jnp.asarray(nm), jnp.asarray(lens), k=k, m=m,
        E=effort, al_meta=al_meta)

    # the lookup (dog._anchor_lookup, the index's branch) on every read
    # k-mer
    keys = join(*j_keys)
    member, uid, upos, ucan = anchor_lookup_ref(ix, torch.from_numpy(keys))
    f = _scan(torch.from_numpy(codes.astype(np.int64)), k)
    np.testing.assert_array_equal(
        torch.where(le_ref(f, rcb_ref(f, k)), f, rcb_ref(f, k)).numpy(), keys)
    hit = member.numpy()
    np.testing.assert_array_equal(hit, np.asarray(j_lookup[0]))
    for got, want in zip((uid, upos, ucan), j_lookup[1:]):
        np.testing.assert_array_equal(got.numpy()[hit], np.asarray(want)[hit])
    assert hit.any()
    if k == 32:   # whole 32-mers fill the int64, sign bit included
        assert (keys < 0).any()

    # the anchor pick and the inits (_first_k_hits / _last_k_hits_rc,
    # _dog_inits): rows e >= n are never read
    inits = dog_anchors_ref(ix, scan.rows, t32(lens), k=k, m=m,
                            effort=effort, L=L)
    np.testing.assert_array_equal(inits.n_f.numpy(), np.asarray(j_n[0]))
    np.testing.assert_array_equal(inits.n_r.numpy(), np.asarray(j_n[1]))
    for o, (jini, n) in enumerate(zip(j_inits, j_n)):
        used = np.arange(effort)[None, :] < np.asarray(n)[:, None]
        for name in INIT_FIELDS:
            jf = _JAX_FIELD.get(name)
            want = (join(jini[jf[0]], jini[jf[1]]) if jf
                    else np.asarray(jini[name]))
            got = inits.field(name)[o].numpy()
            np.testing.assert_array_equal(got[used], want[used],
                                          err_msg=f"{name} orient {o}")
    assert (inits.n_f > 0).any() and (inits.n_f == 0).any()
    again = dog_anchors(ix, scan.rows, t32(lens), k=k, m=m, effort=effort,
                        L=L)
    assert torch.equal(again.planes, inits.planes)

    # the whole anchors batch: K1 -> K5 -> K3 from inits
    got = align_batch(ix, t32(words), t32(nmbits), t32(lens), mode="anchors",
                      k=k, m=m, effort=effort, L=L)
    want = dog.align_batch_anchors(
        jx, jnp.asarray(codes), jnp.asarray(nm), jnp.asarray(lens), k=k,
        m=m, effort=effort, pmax=0, jl_meta=jl_meta, al_meta=al_meta)
    assert_walks_equal(got, want)
    status = got.status.numpy()
    assert (status == 1).any() and (status == 3).any()


@pytest.mark.parametrize("seed,k,m,effort,n_frac,variant,kw", [
    (61, 15, 0, 2, 0.0, "embedded", dict(min_unitig=15, max_unitig=60)),
    (62, 21, 1, 3, 0.2, "embedded", {}),
    (63, 31, 2, 2, 0.1, "pool", {}),
    (64, 32, 2, 2, 0.1, "embedded", {}),
])
def test_plain_k5_and_anchor_batch_match_jax(seed, k, m, effort, n_frac,
                                             variant, kw):
    check_k5_and_anchor_batch_match_jax(seed, k, m, effort, n_frac, variant,
                                        kw)


@pytest.mark.parametrize("variant", ["mphf", "anchor_mphf"])
def test_plain_k5_mphf_anchor_layout_matches_jax(variant):
    """K5's plain version and the anchors batch on an index with MPHF
    anchors, against dog._anchor_lookup / _dog_inits / align_batch_anchors
    called with al_meta_of(di) (and jl_meta_of(di) under the mphf junction
    layout).  In a process of its own: compiling the dog-mphf program
    inside a long suite process crashes XLA's CPU backend
    (tests/test_modes.py test_dog_mphf_anchor_layout_byte_parity)."""
    root = Path(__file__).resolve().parents[1]
    code = ("from tests.test_torch_dog import "
            "check_k5_and_anchor_batch_match_jax as check; "
            f"check(67, 21, 1, 3, 0.2, {variant!r}, {{}}); "
            f"check(68, 32, 2, 2, 0.1, {variant!r}, {{}}); print('equal')")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, timeout=900,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root)))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("equal")


@pytest.mark.parametrize("variant", ["mphf", "anchor_mphf"])
@pytest.mark.parametrize("seed,k,n_frac", [(62, 21, 0.2), (64, 32, 0.1)])
def test_plain_k5_mphf_anchor_layout_matches_scan(variant, seed, k, n_frac):
    """The MPHF anchor layout (under the mphf junction layout, and beside
    a scan junction table) gives the inits and walks of the scan layout,
    which the test above holds against JAX; the MPHF lookup itself is
    held against dog._anchor_lookup(al_meta) in test_torch_mphf.py, and
    the whole -G run against `--impl jax` in test_torch_slice.py."""
    graph, reads = dataset(seed=seed, k=k, n_reads=48, n_frac=n_frac,
                           genome_len=8000, dog_mode=True)
    reads = [r if i % 5 else r[: k + 3] for i, r in enumerate(reads)]
    L, m, effort = 112, 2, 3
    _, _, lens, words, nmbits = batch(reads, L)
    scan = read_scan_ref(t32(words), t32(nmbits), t32(lens), L=L, k1=k - 1)
    ix_scan = index_tensors(device_index(graph, "embedded"), "cpu")
    ix = index_tensors(device_index(graph, variant), "cpu")
    assert ix_scan.amph_meta is None and ix.amph_meta is not None
    assert (ix.mph_meta is not None) == (variant == "mphf")
    assert tuple(ix.at_fused.shape) == (0, 160) and ix.has_anchors
    kw = dict(k=k, m=m, effort=effort, L=L)
    want = dog_anchors_ref(ix_scan, scan.rows, t32(lens), **kw)
    got = dog_anchors(ix, scan.rows, t32(lens), **kw)
    assert torch.equal(got.n_f, want.n_f) and torch.equal(got.n_r, want.n_r)
    for o, n in enumerate((want.n_f, want.n_r)):
        used = torch.arange(effort)[None, :] < n[:, None]
        assert torch.equal(got.planes[:, o][:, used],
                           want.planes[:, o][:, used])
    assert (want.n_f > 0).any()
    args = (t32(words), t32(nmbits), t32(lens))
    w_got = align_batch(ix, *args, mode="anchors", **kw)
    w_want = align_batch(ix_scan, *args, mode="anchors", **kw)
    assert_walks_equal(w_got, {f: getattr(w_want, f).numpy()
                               for f in w_want._fields})
    assert (w_got.status == 1).any()


def test_k5_refuses_an_index_without_anchors():
    graph, reads = dataset(seed=65, k=21, n_reads=4)
    ix = index_tensors(device_index(graph), "cpu")
    L = 112
    _, _, lens, words, nmbits = batch(reads, L)
    scan = read_scan_ref(t32(words), t32(nmbits), t32(lens), L=L, k1=20)
    with pytest.raises(ValueError, match="dog mode"):
        dog_anchors(ix, scan.rows, t32(lens), k=21, m=2, effort=2, L=L)


@pytest.mark.parametrize("case,k,m,kw", [
    ("k21_with_N", 21, 1, dict(n_frac=0.2)),
    ("k32_long_reads", 32, 2, dict(n_frac=0.1, read_len=300,
                                   genome_len=20000)),
    ("correction", 31, 2, dict(n_frac=0.1)),
])
def test_anchor_pipeline_bytes_equal_spec_and_jax(tmp_path, case, k, m, kw):
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=66, genome_len=kw.pop("genome_len", 10000), k=k, n_reads=96,
        **kw)
    rf, uf = tmp_path / "reads.fa", tmp_path / "unitigs.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    args = dict(k=k, m=m, correction=case == "correction", mode="anchors")
    got = run_pipeline([str(rf)], str(uf), batch_size=40, device="cpu",
                       **args)
    assert got[2].aligned > 0 and got[2].read_number == 96
    for impl in ("python", "jax"):
        want = dbgtpu_pipeline([str(rf)], str(uf), impl=impl, batch_size=96,
                               **args)
        assert got[0] == want[0], impl
        assert got[1] == want[1], impl
        for f in ("read_number", "aligned", "not_aligned", "no_overlap"):
            assert getattr(got[2], f) == getattr(want[2], f), (impl, f)


# the edge batch: chunk boundaries of K5's scan (reads of length k-1 ..
# L, 0, 1, E and > 32 hits, hits only in a read's last chunk or only at
# position len-k, efforts 1, 2 and 5, planted N, k = 32)
_EDGE = {c.name: c for c in edge_cases()}


def _edge_batch(name):
    case = _EDGE[name]
    codes, nm, lens, words, nmbits = batch(list(case.reads), case.L)
    rows = read_scan_ref(t32(words), t32(nmbits), t32(lens), L=case.L,
                         k1=case.k - 1).rows
    return case, codes, nm, lens, rows


@pytest.mark.parametrize("name", CASE_NAMES)
def test_edge_batch_k5_matches_jax(name):
    """dog_anchors_ref on an edge case against the JAX anchor stage
    (scan anchors): counts and every used init field."""
    case, codes, nm, lens, rows = _edge_batch(name)
    k, L, E, m = case.k, case.L, case.effort, 2
    graph = build_graph_from_seqs(list(case.unitigs), k, dog_mode=True)
    di = device_index(graph, "embedded")
    ix = index_tensors(di, "cpu")
    _, _, j_inits, j_n = _jax_anchor_stage(
        core.index_to_device(di), jnp.asarray(codes), jnp.asarray(nm),
        jnp.asarray(lens), k=k, m=m, E=E)
    inits = dog_anchors_ref(ix, rows, t32(lens), k=k, m=m, effort=E, L=L)
    for o, (jini, n) in enumerate(zip(j_inits, j_n)):
        np.testing.assert_array_equal(
            (inits.n_f, inits.n_r)[o].numpy(), np.asarray(n))
        used = np.arange(E)[None, :] < np.asarray(n)[:, None]
        for f in INIT_FIELDS:
            jf = _JAX_FIELD.get(f)
            want = (join(jini[jf[0]], jini[jf[1]]) if jf
                    else np.asarray(jini[f]))
            np.testing.assert_array_equal(inits.field(f)[o].numpy()[used],
                                          want[used], err_msg=f"{f} {o}")
    n_f = inits.n_f.numpy()
    assert (n_f == 0).any() and (n_f == E).any()


@pytest.mark.parametrize("name", CASE_NAMES)
def test_edge_batch_k5_mphf_anchors_match_scan(name):
    """The MPHF anchor layout (mphf junction layout, and MPHF anchors
    beside a scan junction table) gives the scan layout's inits on an
    edge case; the test above holds the scan layout against JAX."""
    case, _, _, lens, rows = _edge_batch(name)
    graph = build_graph_from_seqs(list(case.unitigs), case.k, dog_mode=True)
    kw = dict(k=case.k, m=2, effort=case.effort, L=case.L)
    want = dog_anchors_ref(index_tensors(device_index(graph), "cpu"), rows,
                           t32(lens), **kw)
    for variant in ("mphf", "anchor_mphf"):
        ix = index_tensors(device_index(graph, variant), "cpu")
        assert ix.amph_meta is not None
        got = dog_anchors_ref(ix, rows, t32(lens), **kw)
        assert torch.equal(got.n_f, want.n_f)
        assert torch.equal(got.n_r, want.n_r)
        for o, n in enumerate((want.n_f, want.n_r)):
            used = torch.arange(case.effort)[None, :] < n[:, None]
            assert torch.equal(got.planes[:, o][:, used],
                               want.planes[:, o][:, used])
