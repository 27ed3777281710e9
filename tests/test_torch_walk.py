"""K3 greedy_walk: the port's plain version (read_scan_ref -> member_ref
-> walk_ref) against the JAX engine's align_batch(..., pmax=0) on the
CPU, exact, under the scan and the mphf junction layouts.  Only
lbuf[:llen] and rbuf[:rlen] are meaningful (buffer tails are stale
after a failed anchor), so only those are compared.  The same on the
edge batch's walk cases (dbgtpu_torch/kernels/edge_batch.py: branches
with tied and 4 candidates, dead ends, unitigs of k bases, pool chunks).
One JAX compile per case.  And the counters of the plain versions
(engine/walk.py count_probe, count_read_sectors) on a tiny graph and a
tiny plane, against counts made by hand."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgtpu.engine import core
from dbgtpu.index.build import build_graph_from_seqs
from dbgtpu_torch.engine.exhaustive import exhaustive_ref
from dbgtpu_torch.engine.index import index_tensors
from dbgtpu_torch.engine.member import inter_ref, member_ref
from dbgtpu_torch.engine.read_scan import read_scan_ref
from dbgtpu_torch.engine.walk import greedy_walk, walk_ref
from dbgtpu_torch.kernels.edge_batch import edge_cases

from .torch_parity import (
    assert_walks_equal, batch, dataset, device_index, t32,
)

_EDGE = {c.name: c for c in edge_cases()}


@pytest.mark.parametrize("seed,k,m,effort,n_frac,variant,kw", [
    (51, 31, 2, 2, 0.0, "embedded", {}),
    (52, 21, 1, 3, 0.3, "embedded", {}),
    (53, 15, 0, 2, 0.0, "pool", dict(min_unitig=15, max_unitig=40)),
    (54, 21, 2, 2, 0.2, "probeless", {}),
    # the mphf junction layout: closure probes (no N), and the
    # per-position MPHF branch (N, no probe table)
    (55, 31, 2, 2, 0.0, "mphf", {}),
    (56, 21, 1, 3, 0.2, "mphf_probeless", {}),
])
def test_walk_ref_matches_jax_align_batch(seed, k, m, effort, n_frac,
                                          variant, kw):
    graph, reads = dataset(seed=seed, k=k, n_reads=48, n_frac=n_frac,
                           genome_len=8000, **kw)
    rng = np.random.default_rng(seed)
    reads = [r if i % 3 else r[: int(rng.integers(k + 1, len(r)))]
             for i, r in enumerate(reads)]
    di = device_index(graph, variant)
    L = 112
    codes, nm, lens, words, nmbits = batch(reads, L)
    k1 = k - 1
    ix = index_tensors(di, "cpu")
    assert (ix.mph_meta is not None) == variant.startswith("mphf")
    scan = read_scan_ref(t32(words), t32(nmbits), t32(lens), L=L, k1=k1)
    m1, m2 = member_ref(ix, scan, t32(lens), L=L, k1=k1)
    got = walk_ref(ix, scan, m1, m2, t32(lens), k=k, m=m, effort=effort,
                   L=L)
    want = core.align_batch(
        core.index_to_device(di), jnp.asarray(codes), jnp.asarray(nm),
        jnp.asarray(lens), k=k, m=m, effort=effort, pmax=0,
        jl_meta=core.jl_meta_of(di),
    )
    for f in ("status", "orient", "offset", "llen", "rlen"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(want[f]), err_msg=f)
    lbuf = np.asarray(want["lbuf"]).astype(np.int32)
    rbuf = np.asarray(want["rbuf"]).astype(np.int32)
    assert got.lbuf.shape == lbuf.shape
    for i in range(len(reads)):
        ll, rl = int(got.llen[i]), int(got.rlen[i])
        np.testing.assert_array_equal(got.lbuf[i, :ll].numpy(), lbuf[i, :ll])
        np.testing.assert_array_equal(got.rbuf[i, :rl].numpy(), rbuf[i, :rl])
    status = got.status.numpy()
    assert (status == 1).any() and set(status) <= {1, 2, 3, 4, 5}
    # the wrapper takes the plain version on the CPU
    again = greedy_walk(ix, scan, m1, m2, t32(lens), k=k, m=m,
                        effort=effort, L=L)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("name,variant", [
    ("k21_branch_E2", "embedded"), ("k21_branch_E2", "mphf"),
    ("k15_stride1_E2_N", "pool"),
])
def test_edge_batch_walk_ref_matches_jax(name, variant):
    """walk_ref on K3's edge cases against the JAX engine: candidates
    that tie on misses (the earliest wins), junctions with 4 and with 0
    candidates, unitigs of k bases, planted N, a pool-chunk index."""
    case = _EDGE[name]
    k, L, E = case.k, case.L, case.effort
    di = device_index(build_graph_from_seqs(list(case.unitigs), k), variant)
    ix = index_tensors(di, "cpu")
    codes, nm, lens, words, nmbits = batch(list(case.reads), L)
    scan = read_scan_ref(t32(words), t32(nmbits), t32(lens), L=L, k1=k - 1)
    m1, m2 = member_ref(ix, scan, t32(lens), L=L, k1=k - 1)
    got = walk_ref(ix, scan, m1, m2, t32(lens), k=k, m=2, effort=E, L=L)
    want = core.align_batch(
        core.index_to_device(di), jnp.asarray(codes), jnp.asarray(nm),
        jnp.asarray(lens), k=k, m=2, effort=E, pmax=0,
        jl_meta=core.jl_meta_of(di))
    assert_walks_equal(got, want)
    status = got.status.numpy()
    assert (status == 1).any() and (status == 5).any()


def test_junction_evaluation_counter_by_hand():
    """count_probe through walk_ref and exhaustive_ref on two unitigs of
    20 and 23 bases (k = 5, overlapping by 4) and a read that is their
    union.  K3 (greedy, E = 1) anchors at position 0, where the left walk
    is done: RIGHT-FIRST at U1's begin (candidate U1, window 20 - 4 = 16
    bases: 1 word), then RIGHT-CONTINUE at the U1/U2 junction (U2, not
    ended: window min(23, 39 - 16) = 23 bases: 2 words), then aligned.
    K6 makes the same two evaluations, the second ended (window 19
    bases: 2 words).  Every lookup finds its key.  Sectors: U1 and U2
    are umeta rows 1 and 2 of 64 words (256 bytes; 16 metadata columns,
    then 24 sequence words per orientation); a header is the row's first
    40 bytes (bytes 256-295 and 512-551: 2 sectors each), and each
    window reads words 0-1 (K6's second: 0-2) of the row's forward
    sequence (bytes 320-327 and 576-583 or 576-587: 1 sector each).
    Anchors: K3 reads bug at its forward anchor (column 0, sector 0) and
    rcs at its RC anchor (the last column, 35: byte 280, sector 8); K6's
    one FETCHX reads bug at column 0."""
    from dbgtpu_torch.index.build import build_graph_from_seqs as port_graph
    from dbgtpu_torch.index.device import build_device_index

    rng = np.random.default_rng(7)
    u = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 39)].tobytes()
    graph = port_graph([u[:20], u[16:]], 5)
    ix = index_tensors(build_device_index(graph), "cpu")
    assert ix.umeta.shape[1] == 64 and ix.seq_words == 24
    _, _, lens, words, nmbits = batch([u], 48)
    scan = read_scan_ref(t32(words), t32(nmbits), t32(lens), L=48, k1=4)
    m1, m2 = member_ref(ix, scan, t32(lens), L=48, k1=4)
    counts = {}
    w = walk_ref(ix, scan, m1, m2, t32(lens), k=5, m=2, effort=1, L=48,
                 counts=counts)
    assert w.status.tolist() == [1] and w.rlen.tolist() == [2]
    assert counts == dict(evals=2, found=2, cands=2, words=3, sectors=6,
                          anchor_sectors=2)
    counts = {}
    x = exhaustive_ref(ix, scan, inter_ref(ix, scan, t32(lens), L=48, k1=4),
                       t32(lens), k=5, m=2, partial=False, L=48,
                       counts=counts)
    assert x.status.tolist() == [1] and x.rlen.tolist() == [2]
    assert counts == dict(evals=2, found=2, cands=2, words=3, sectors=6,
                          anchor_sectors=1)


def test_anchor_sector_counter_by_hand():
    """count_read_sectors on an int64 [2, 5] plane (rows of 40 bytes):
    elements (0,0) (0,3) (0,4) (1,0) (1,4) lie at bytes 0, 24, 32, 40 and
    72, in sectors 0, 0, 1, 1 and 2: three sectors, each once."""
    from dbgtpu_torch.engine.walk import count_read_sectors

    plane = torch.zeros((2, 5), dtype=torch.int64)
    read = torch.zeros((2, 5), dtype=torch.bool)
    read[0, [0, 3, 4]] = True
    read[1, [0, 4]] = True
    counts = {"anchor_sectors": 4}
    count_read_sectors(plane, read, counts)
    assert counts == {"anchor_sectors": 7}
