"""K2 member: the port's plain version against the JAX engine's
_closure_member (window 4 and window 3) and _st_member_positions (scan
and mphf junction layouts), on the CPU, exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgtpu.engine import core
from dbgtpu_torch.engine.index import index_tensors
from dbgtpu_torch.engine.member import member, member_ref, st_member_ref
from dbgtpu_torch.engine.read_scan import read_scan_ref

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
