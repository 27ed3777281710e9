"""K3 greedy_walk: the port's plain version (read_scan_ref -> member_ref
-> walk_ref) against the JAX engine's align_batch(..., pmax=0) on the
CPU, exact, under the scan and the mphf junction layouts.  Only
lbuf[:llen] and rbuf[:rlen] are meaningful (buffer tails are stale
after a failed anchor), so only those are compared.
One JAX compile per case."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgtpu.engine import core
from dbgtpu_torch.engine.index import index_tensors
from dbgtpu_torch.engine.member import member_ref
from dbgtpu_torch.engine.read_scan import read_scan_ref
from dbgtpu_torch.engine.walk import greedy_walk, walk_ref

from .torch_parity import batch, dataset, device_index, t32


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
