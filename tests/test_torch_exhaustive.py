"""K2's exhaustive mode and K6 exhaustive_dfs (-b, -i): the port's plain
versions against dbgtpu's JAX engine on the CPU and its python spec,
exact, under the scan and the mphf junction layouts.

Per case one jitted composition of the JAX `inter` mask
(exhaustive.py:109-148) and one compile of align_batch_exhaustive.
With N in the batch the mask is the membership of canonical(bug,
rcb(bug)), not greedy's member1 of canonical(bug, rcs); the N cases show
that the two differ, so reusing member1 would fail here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgtpu.engine import core, exhaustive
from dbgtpu.engine.kmer32 import pair_le, rcb_pair
from dbgtpu.index.build import build_graph_from_seqs
from dbgtpu.pipeline import run_pipeline as dbgtpu_pipeline
from dbgtpu_torch.engine.core import align_batch
from dbgtpu_torch.engine.exhaustive import depth_for, exhaustive_dfs
from dbgtpu_torch.engine.index import index_tensors
from dbgtpu_torch.engine.member import inter, inter_ref, member_ref
from dbgtpu_torch.engine.read_scan import read_scan_ref
from dbgtpu_torch.kernels.edge_batch import edge_cases
from dbgtpu_torch.pipeline import run_pipeline

from . import synth
from .torch_parity import assert_walks_equal, batch, dataset, device_index, t32


@functools.partial(jax.jit, static_argnames=("k", "jl_meta"))
def _jax_inter(ix, codes, nmask, lens, *, k, jl_meta=None):
    """The interesting-anchor mask of align_batch_exhaustive."""
    B, L = codes.shape
    k1 = k - 1
    Lw = (L + 15) // 16
    codes32, _, rwf, _, _ = core._read_images(codes, nmask, lens, 2 * Lw + 1)
    col = jnp.arange(L, dtype=jnp.int32)[None, :]
    scan_col = jnp.arange(L - k1 + 1, dtype=jnp.int32)[None, :]
    valid = scan_col <= (lens - k1)[:, None]
    has_n = jnp.any(nmask)
    std_hi, std_lo = core._scan_kmer_pairs_words(rwf, L, k1)
    rcs_hi, rcs_lo = rcb_pair(std_hi, std_lo, k1)
    bug_hi, bug_lo = jax.lax.cond(
        has_n,
        lambda: core._scan_kmer_pairs(
            jnp.where(nmask & (col >= k1), jnp.uint32(0), codes32), k1,
            False),
        lambda: (std_hi, std_lo))

    def _slow():
        rbh, rbl = rcb_pair(bug_hi, bug_lo, k1)
        le = pair_le(bug_hi, bug_lo, rbh, rbl)
        return core._st_member_positions(ix, jnp.where(le, bug_hi, rbh),
                                         jnp.where(le, bug_lo, rbl), jl_meta)

    if ix.pt_rows.shape[0] > 0:
        def _fast():
            le1 = pair_le(std_hi, std_lo, rcs_hi, rcs_lo)
            return core._closure_member(
                ix, jnp.where(le1, std_hi, rcs_hi),
                jnp.where(le1, std_lo, rcs_lo), le1, codes32, k1)
        member = jax.lax.cond(has_n, _slow, _fast)
    else:
        member = _slow()
    return (member & valid) | (scan_col == 0)


def _n_on_junctions(ix, reads, k: int, L: int) -> list[bytes]:
    """Copies of N-free reads with one N where greedy's member1 and the
    exhaustive mask part: on an A at read position >= k-1 inside a
    junction (k-1)-mer whose canonical form is its reverse complement.
    The bug scan reads that N as the A it replaced, so the mask keeps
    the junction; member1 looks up a (k-1)-mer holding the N's code."""
    k1 = k - 1
    _, _, lens, words, nmbits = batch(reads, L)
    scan = read_scan_ref(t32(words), t32(nmbits), t32(lens), L=L, k1=k1)
    hit = inter_ref(ix, scan, t32(lens), L=L, k1=k1).bool() & (
        scan.rcs < scan.bug)
    out = []
    for i, r in enumerate(reads):
        for p in torch.nonzero(hit[i]).flatten().tolist():
            qs = [q for q in range(max(p, k1), p + k1) if r[q] == ord("A")]
            if p > 0 and qs and b"N" not in r:
                out.append(r[: qs[0]] + b"N" + r[qs[0] + 1 :])
                break
    return out


@pytest.mark.parametrize("seed,k,m,n_frac,variant,partial,kw", [
    (81, 21, 2, 0.2, "embedded", False, {}),
    (82, 21, 1, 0.2, "embedded", True, {}),
    (83, 31, 2, 0.0, "embedded", False, {}),
    (84, 21, 2, 0.1, "probeless", True, {}),
    (85, 15, 1, 0.0, "pool", False, dict(min_unitig=15, max_unitig=60)),
    # the mphf junction layout: the mask's per-position MPHF branch (N)
    # and the DFS's junction probes through the MPHF
    (87, 21, 2, 0.2, "mphf", False, {}),
    (88, 21, 1, 0.1, "mphf_probeless", True, {}),
])
def test_plain_k6_and_exhaustive_batch_match_jax(seed, k, m, n_frac, variant,
                                                 partial, kw):
    graph, reads = dataset(seed=seed, k=k, n_reads=48, n_frac=n_frac,
                           genome_len=8000, **kw)
    rng = np.random.default_rng(seed)
    # some reads shorter than k-1: NO_OVERLAP
    reads = [r if i % 5 else r[: int(rng.integers(k - 4, k + 6))]
             for i, r in enumerate(reads)]
    di = device_index(graph, variant)
    ix = index_tensors(di, "cpu")
    jx = core.index_to_device(di)
    jl = core.jl_meta_of(di)
    assert (ix.mph_meta is not None) == variant.startswith("mphf")
    L = 112
    k1 = k - 1
    if n_frac:
        planted = _n_on_junctions(ix, reads, k, L)[:8]
        assert planted
        reads = reads + planted
    codes, nm, lens, words, nmbits = batch(reads, L)
    scan = read_scan_ref(t32(words), t32(nmbits), t32(lens), L=L, k1=k1)

    # K2's exhaustive mode
    mask = inter_ref(ix, scan, t32(lens), L=L, k1=k1)
    want_mask = np.asarray(_jax_inter(jx, jnp.asarray(codes),
                                      jnp.asarray(nm), jnp.asarray(lens), k=k,
                                      jl_meta=jl))
    np.testing.assert_array_equal(mask.numpy().astype(bool), want_mask)
    assert torch.equal(inter(ix, scan, t32(lens), L=L, k1=k1), mask)
    if n_frac:
        # greedy's member1 is another mask on a batch with N
        m1, _ = member_ref(ix, scan, t32(lens), L=L, k1=k1)
        m1[:, 0] = 1
        assert not torch.equal(m1, mask)

    # K6 and the whole exhaustive batch: K1 -> K2 (inter) -> K6
    got = align_batch(ix, t32(words), t32(nmbits), t32(lens),
                      mode="exhaustive", k=k, m=m, effort=2, L=L,
                      partial=partial)
    assert got.lbuf.shape == (len(reads), depth_for(L, k))
    want = exhaustive.align_batch_exhaustive(
        jx, jnp.asarray(codes), jnp.asarray(nm), jnp.asarray(lens), k=k, m=m,
        partial=partial, pmax=0, jl_meta=jl)
    assert_walks_equal(got, want)
    again = exhaustive_dfs(ix, scan, mask, t32(lens), k=k, m=m,
                           partial=partial, L=L)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    status = got.status.numpy()
    assert (status == 1).any() and (status == 3).any()
    assert not (got.orient.numpy()).any()        # no RC retry
    if not partial:
        assert (status == 5).any()


_EDGE = {c.name: c for c in edge_cases()}


@pytest.mark.parametrize("name,variant,partial", [
    ("k21_branch_E2", "embedded", False),
    ("k15_stride1_E2_N", "pool", True),
])
def test_edge_batch_exhaustive_matches_jax(name, variant, partial):
    """The port's plain exhaustive batch (K1 -> K2 inter -> K6) on K6's
    edge cases against align_batch_exhaustive: candidates that tie on
    misses (the first achiever wins), 0 and 4 candidates, and DFS paths
    of L-k+1 levels, two below the depth bound D (unitigs of k bases),
    planted N, a pool-chunk index."""
    case = _EDGE[name]
    k, L = case.k, case.L
    di = device_index(build_graph_from_seqs(list(case.unitigs), k), variant)
    ix = index_tensors(di, "cpu")
    codes, nm, lens, words, nmbits = batch(list(case.reads), L)
    got = align_batch(ix, t32(words), t32(nmbits), t32(lens),
                      mode="exhaustive", k=k, m=2, effort=2, L=L,
                      partial=partial)
    want = exhaustive.align_batch_exhaustive(
        core.index_to_device(di), jnp.asarray(codes), jnp.asarray(nm),
        jnp.asarray(lens), k=k, m=2, partial=partial, pmax=0,
        jl_meta=core.jl_meta_of(di))
    assert_walks_equal(got, want)
    assert (got.status.numpy() == 1).any()
    if name.startswith("k15_stride1"):
        assert int(got.rlen.max()) == depth_for(L, k) - 2


@pytest.mark.parametrize("partial", [False, True])
def test_exhaustive_pipeline_bytes_equal_spec(tmp_path, partial):
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=86, genome_len=10000, k=21, n_reads=96, n_frac=0.2)
    rf, uf = tmp_path / "reads.fa", tmp_path / "unitigs.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    args = dict(k=21, m=2, mode="exhaustive", partial=partial)
    got = run_pipeline([str(rf)], str(uf), batch_size=40, device="cpu",
                       **args)
    want = dbgtpu_pipeline([str(rf)], str(uf), impl="python", **args)
    assert got[0] == want[0]
    assert got[1] == want[1]
    for f in ("read_number", "aligned", "not_aligned", "no_overlap"):
        assert getattr(got[2], f) == getattr(want[2], f), f
    assert got[2].aligned > 0
