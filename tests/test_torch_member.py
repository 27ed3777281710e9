"""K2 member: the port's plain version against the JAX engine's
_closure_member (window 4 and window 3) and _st_member_positions (scan
and mphf junction layouts), on the CPU, exact; on synthetic datasets
and on the edge batch (dbgtpu_torch/kernels/edge_batch.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgtpu.engine import core
from dbgtpu.index.build import build_graph_from_seqs
from dbgtpu_torch.engine.index import index_tensors
from dbgtpu_torch.engine.member import (
    inter_ref, member, member_ref, st_member_ref,
)
from dbgtpu_torch.engine.read_scan import read_scan_ref
from dbgtpu_torch.kernels.edge_batch import edge_cases

from .test_torch_exhaustive import _jax_inter
from .torch_parity import batch, dataset, device_index, t32


def _split(v: torch.Tensor):
    v = v.numpy()
    return (jnp.asarray((v >> 32).astype(np.uint32)),
            jnp.asarray((v & 0xFFFFFFFF).astype(np.uint32)))


def _setup(seed, k, n_frac, variant, L=112):
    graph, reads = dataset(seed=seed, k=k, n_reads=48, n_frac=n_frac)
    di = device_index(graph, variant)
    codes, _, lens, words, nmbits = batch(reads, L)
    scan = read_scan_ref(t32(words), t32(nmbits), t32(lens), L=L, k1=k - 1)
    valid = (np.arange(L - k + 2)[None, :] <= (lens - (k - 1))[:, None])
    return di, codes, t32(lens), scan, valid


@pytest.mark.parametrize("variant,window", [("embedded", 3),
                                            ("window4", 4),
                                            ("mphf", 3)])
@pytest.mark.parametrize("k", [21, 31])
def test_closure_member_matches_jax(variant, window, k):
    di, codes, lens, scan, valid = _setup(30 + k, k, 0.0, variant)
    ix = index_tensors(di, "cpu")
    assert ix.pt_window == window and not scan.has_n.item()
    m1, m2 = member_ref(ix, scan, lens, L=112, k1=k - 1)
    want = np.asarray(core._closure_member(
        core.index_to_device(di), *_split(scan.rep1),
        jnp.asarray(scan.le1.numpy().astype(bool)),
        jnp.asarray(codes.astype(np.uint32)), k - 1,
    )) & valid
    np.testing.assert_array_equal(m1.numpy().astype(bool), want)
    assert torch.equal(m1, m2)
    # on an N-free batch the closure probes are exact membership
    np.testing.assert_array_equal(
        m1.numpy().astype(bool),
        st_member_ref(ix, scan.rep1).numpy() & valid)
    assert m1.sum() > 0


@pytest.mark.parametrize("variant,n_frac", [("embedded", 0.3),
                                            ("probeless", 0.3),
                                            ("probeless", 0.0),
                                            ("mphf", 0.3),
                                            ("mphf_probeless", 0.3),
                                            ("mphf_probeless", 0.0)])
def test_exact_member_matches_jax(variant, n_frac):
    k = 21
    di, _, lens, scan, valid = _setup(40, k, n_frac, variant)
    ix = index_tensors(di, "cpu")
    assert bool(scan.has_n.item()) == bool(n_frac)
    assert (ix.mph_meta is not None) == variant.startswith("mphf")
    m1, m2 = member_ref(ix, scan, lens, L=112, k1=k - 1)
    jx = core.index_to_device(di)
    jl = core.jl_meta_of(di)
    want1 = np.asarray(core._st_member_positions(jx, *_split(scan.rep1), jl))
    want2 = np.asarray(core._st_member_positions(jx, *_split(scan.rep2), jl))
    assert want1.any()
    np.testing.assert_array_equal(m1.numpy().astype(bool), want1 & valid)
    np.testing.assert_array_equal(m2.numpy().astype(bool), want2 & valid)
    # the rolled-in-N quirk makes rep1 differ from the std canonical
    assert torch.equal(scan.rep1, scan.rep2) != bool(n_frac)


def test_member_wrapper_uses_plain_version_only_on_cpu():
    di, _, lens, scan, _ = _setup(41, 21, 0.0, "embedded")
    ix = index_tensors(di, "cpu")
    got = member(ix, scan, lens, L=112, k1=20)
    want = member_ref(ix, scan, lens, L=112, k1=20)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    meta_scan = type(scan)(*(t.to("meta") for t in scan))
    with pytest.raises(ValueError, match="no member kernel"):
        member(ix, meta_scan, lens.to("meta"), L=112, k1=20)


# the edge batch: lane-group and window boundaries (Lk 31, 32, 33, 65,
# reads of length k-1 .. L, planted N), both K2 branches and layouts
_EDGE = {c.name: c for c in edge_cases()}


@pytest.mark.parametrize("name,variant", [
    ("k32_Lk33_E1", "embedded"), ("k32_Lk33_E1", "window4"),
    ("k32_Lk33_E1", "probeless"), ("k32_Lk65_E5_N", "embedded"),
    ("k32_Lk65_E5_N", "mphf"), ("k31_Lk32_E2", "mphf"),
    ("k31_Lk32_E2", "mphf_probeless"), ("k21_Lk31_E2_N", "embedded"),
    ("k21_Lk31_E2_N", "mphf_probeless"),
])
def test_edge_batch_member_and_inter_match_jax(name, variant):
    """member_ref and inter_ref on an edge case against core's
    _closure_member (N-free batch with a probe table) or
    _st_member_positions (otherwise) and the JAX `inter` mask."""
    case = _EDGE[name]
    k, L = case.k, case.L
    graph = build_graph_from_seqs(list(case.unitigs), k)
    di = device_index(graph, variant)
    ix = index_tensors(di, "cpu")
    codes, nm, lens, words, nmbits = batch(list(case.reads), L)
    scan = read_scan_ref(t32(words), t32(nmbits), t32(lens), L=L, k1=k - 1)
    assert scan.rep1.shape[1] == case.Lk
    assert bool(scan.has_n.item()) == name.endswith("_N")
    valid = (np.arange(case.Lk)[None, :] <= (lens - (k - 1))[:, None])
    m1, m2 = member_ref(ix, scan, t32(lens), L=L, k1=k - 1)
    jx = core.index_to_device(di)
    jl = core.jl_meta_of(di)
    if ix.pt_rows.shape[0] and not scan.has_n.item():
        want1 = np.asarray(core._closure_member(
            jx, *_split(scan.rep1), jnp.asarray(scan.le1.numpy().astype(bool)),
            jnp.asarray(codes.astype(np.uint32)), k - 1))
        want2 = want1
    else:
        want1 = np.asarray(core._st_member_positions(jx, *_split(scan.rep1),
                                                     jl))
        want2 = np.asarray(core._st_member_positions(jx, *_split(scan.rep2),
                                                     jl))
    np.testing.assert_array_equal(m1.numpy().astype(bool), want1 & valid)
    np.testing.assert_array_equal(m2.numpy().astype(bool), want2 & valid)
    assert m1.sum() > 0
    got = inter_ref(ix, scan, t32(lens), L=L, k1=k - 1)
    want = _jax_inter(jx, jnp.asarray(codes), jnp.asarray(nm),
                      jnp.asarray(lens), k=k, jl_meta=jl)
    np.testing.assert_array_equal(got.numpy().astype(bool), np.asarray(want))
