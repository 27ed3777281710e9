"""K4 pack_paths: the port's plain version against the JAX engine's
pack_paths and the fused align_batch_packed array (int16 and int32,
rows with plen > pmax), on the CPU, exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgtpu.engine import core
from dbgtpu_torch.engine import core as tcore
from dbgtpu_torch.engine.index import index_tensors
from dbgtpu_torch.engine.pack import out_dtype_for, pack_paths, pack_ref
from dbgtpu_torch.engine.walk import Walks
from dbgtpu_torch.kernels.edge_batch import pack_walks

from .torch_parity import batch, dataset, device_index, t32

K, M, E, L = 15, 2, 2, 112


@pytest.fixture(scope="module")
def case():
    # short unitigs: long paths, so small pmax values overflow
    graph, reads = dataset(seed=61, k=K, n_reads=48, n_frac=0.1,
                           min_unitig=15, max_unitig=30)
    di = device_index(graph)
    _, _, lens, words, nmbits = batch(reads, L)
    ix = index_tensors(di, "cpu")
    walks = tcore.align_batch(ix, t32(words), t32(nmbits), t32(lens), k=K,
                              m=M, effort=E, L=L)
    return di, ix, lens, words, nmbits, walks


@pytest.mark.parametrize("pmax", [3, 8, 30, 31, 62, 112, 120])
def test_pack_ref_matches_jax_pack_paths(case, pmax):
    *_, walks = case
    res = {f: jnp.asarray(getattr(walks, f).numpy())
           for f in ("offset", "llen", "rlen", "lbuf", "rbuf")}
    paths, plen = core.pack_paths(res, pmax)
    got = pack_ref(walks, pmax=pmax, dtype=torch.int32)
    np.testing.assert_array_equal(got[:, 2:].numpy(), np.asarray(paths))
    np.testing.assert_array_equal(got[:, 1].numpy(), np.asarray(plen))
    np.testing.assert_array_equal(got[:, 0].numpy(), walks.status.numpy())
    if pmax == 3:
        aligned = (walks.status == 1) | (walks.status == 2)
        assert bool((aligned & (got[:, 1] > pmax)).any())


def test_fused_rows_match_jax_align_batch_packed(case):
    di, ix, lens, words, nmbits, walks = case
    pmax = 4
    want = np.asarray(core.align_batch_packed(
        core.index_to_device(di), jnp.asarray(words), jnp.asarray(nmbits),
        jnp.asarray(lens), mode="greedy", k=K, m=M, effort=E, L=L,
        pmax=pmax,
    ))
    assert want.dtype == np.int16
    got = tcore.align_batch_packed(ix, t32(words), t32(nmbits), t32(lens),
                                   k=K, m=M, effort=E, L=L, pmax=pmax)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 1] > pmax).any()            # overflow rows present
    wide = pack_paths(walks, pmax=pmax, dtype=torch.int32)
    assert wide.dtype == torch.int32
    np.testing.assert_array_equal(wide.numpy(), want.astype(np.int32))
    assert torch.equal(pack_paths(walks, pmax=pmax, dtype=torch.int16), got)


def test_out_dtype_rule():
    assert out_dtype_for(32767, 112) == torch.int16
    assert out_dtype_for(32768, 112) == torch.int32
    assert out_dtype_for(100, 16384) == torch.int32


@pytest.mark.parametrize("case,B,pmax", [
    # K4's tiles: 64 int16 / 32 int32 rows at pmax 30, 8 at pmax 120
    ("mixed", 65, 30),
    ("empty", 63, 31),
    ("short", 257, 3),
    ("long", 255, 62),
    ("long", 1, 120),
    ("mixed", 257, 120),
])
def test_pack_ref_matches_jax_on_edge_walks(case, B, pmax):
    """Walks with llen / rlen of 0, plen > pmax and pmax > P (the edge set
    of kernels/edge_batch.py), buffers nonzero past llen / rlen."""
    w = pack_walks(B * 7 + pmax, B, case)
    walks = Walks(*(torch.from_numpy(w[f]) for f in Walks._fields))
    res = {f: jnp.asarray(w[f]) for f in ("offset", "llen", "rlen", "lbuf",
                                          "rbuf")}
    paths, plen = core.pack_paths(res, pmax)
    got = pack_ref(walks, pmax=pmax, dtype=torch.int32)
    np.testing.assert_array_equal(got[:, 2:].numpy(), np.asarray(paths))
    np.testing.assert_array_equal(got[:, 1].numpy(), np.asarray(plen))
    np.testing.assert_array_equal(got[:, 0].numpy(), w["status"])
    narrow = pack_paths(walks, pmax=pmax, dtype=torch.int16)
    assert torch.equal(narrow, got.to(torch.int16))
    if case == "empty":
        assert (got[:, 1] == 1).all() and not got[:, 3:].any()
    if case == "long":
        assert (got[:, 1] > pmax).all()
