"""dbgtpu_torch.engine.index.index_tensors against the JAX
index_to_device, field by field, exact, under the scan and the MPHF
layouts of the junction and the anchor table."""

import numpy as np
import pytest
import torch

from dbgtpu.engine.core import al_meta_of, index_to_device, jl_meta_of
from dbgtpu.index.build import build_graph_from_seqs
from dbgtpu.index import device as device_mod
from dbgtpu.index.device import build_device_index
from dbgtpu_torch.engine.index import index_tensors

from . import synth
from .torch_parity import as_u32, dataset, device_index, fasta_seqs


@pytest.fixture(scope="module")
def graph():
    return dataset(seed=11, k=21, n_reads=8)[0]


@pytest.mark.parametrize("variant",
                         ["embedded", "pool", "probeless", "window4"])
def test_index_tensors_equal_index_to_device(graph, variant):
    di = device_index(graph, variant)
    ix = index_tensors(di, "cpu")
    jx = index_to_device(di)
    for field in ("st_fused", "umeta", "pool_rows", "pt_rows"):
        got = getattr(ix, field)
        want = np.asarray(getattr(jx, field))
        assert got.dtype == torch.int32
        assert tuple(got.shape) == want.shape, field
        np.testing.assert_array_equal(
            as_u32(got) if want.dtype == np.uint32 else got.numpy(), want,
            err_msg=field)
    assert ix.st_seed == int(jx.st_seed)
    assert ix.pt_seed == int(jx.pt_seed)
    assert ix.n_chunks == int(jx.n_chunks)
    assert ix.st_slots == np.asarray(jx.st_fused).shape[1] // 10
    if variant == "pool":
        assert ix.seq_words == 0
    if variant == "window4":
        assert ix.pt_window == 4
    if variant == "embedded":
        assert ix.pt_window == 3 and ix.seq_words > 0


def test_index_tensors_memoized_per_device(graph):
    di = build_device_index(graph)
    assert index_tensors(di, "cpu") is index_tensors(di, torch.device("cpu"))


def test_index_tensors_accept_anchor_scan():
    """A dog-mode index uploads its anchor scan table as dbgtpu fuses it:
    [nba, 5*S] of S key-hi, S key-lo, S x (uid, upos, ucanon)."""
    _, ufa = synth.make_dataset(seed=13, genome_len=3000, k=21, n_reads=4)
    gd = build_graph_from_seqs(fasta_seqs(ufa), 21, dog_mode=True)
    di = build_device_index(gd)
    assert di.anchor_scan is not None
    ix = index_tensors(di, "cpu")
    jx = index_to_device(di)
    np.testing.assert_array_equal(as_u32(ix.at_fused), np.asarray(jx.at_fused))
    assert ix.at_seed == int(jx.at_seed)
    assert ix.at_slots == np.asarray(jx.at_fused).shape[1] // 5
    plain = index_tensors(build_device_index(build_graph_from_seqs(
        fasta_seqs(ufa), 21)), "cpu")
    assert tuple(plain.at_fused.shape) == (0, 160)


def _assert_mphf_fields(ix, jx, names):
    for field in names:
        got, want = getattr(ix, field), np.asarray(getattr(jx, field))
        assert got.dtype == torch.int32
        assert tuple(got.shape) == want.shape, field
        np.testing.assert_array_equal(as_u32(got), want, err_msg=field)


def _assert_meta(meta, jmeta):
    """engine.index.MphfMeta against core._mphf_meta's tuple."""
    n_levels, masks, _, soffs, _, has_final, final_nb = jmeta
    assert meta.n_levels == n_levels
    assert meta.masks == masks[:n_levels]
    assert meta.row_offs == soffs[:n_levels]
    assert meta.final_nb == final_nb and bool(final_nb) == has_final
    c = meta.c_struct
    assert c.n_levels == n_levels and c.n_keys == meta.n_keys
    assert list(c.mask[:n_levels]) == list(masks[:n_levels])
    assert c.final_mask == max(final_nb - 1, 0)


def test_index_tensors_carry_mphf_and_anchor_mphf(monkeypatch):
    """The inputs index_tensors used to refuse: the mphf junction layout,
    and a scan-layout dog index whose keyset takes the MPHF anchor
    layout; both now upload field by field as index_to_device does."""
    g, _ = dataset(seed=12, k=21, n_reads=4, genome_len=3000)
    di = build_device_index(g, layout="mphf")
    assert di.mphf_junction is not None and di.scan_tbl is None
    ix, jx = index_tensors(di, "cpu"), index_to_device(di)
    _assert_mphf_fields(ix, jx, ("st_fused", "mph_rows", "mph_jrows", "mph_f",
                                 "pt_rows", "amph_rows", "amph_arows",
                                 "amph_f"))
    _assert_meta(ix.mph_meta, jl_meta_of(di))
    assert ix.amph_meta is None and al_meta_of(di) is None
    assert tuple(ix.st_fused.shape) == (0, 320) and not ix.has_anchors
    assert ix.mph_meta.n_keys == len(di.mphf_junction.jrows)
    assert ix.pt_rows.shape[0] > 0       # the probe table under both layouts

    _, ufa = synth.make_dataset(seed=13, genome_len=3000, k=21, n_reads=4)
    gd = build_graph_from_seqs(fasta_seqs(ufa), 21, dog_mode=True)
    monkeypatch.setattr(device_mod, "ANCHOR_MPHF_MIN", 0)
    di = build_device_index(gd)
    assert di.anchor_mphf is not None and di.anchor_scan is None
    ix, jx = index_tensors(di, "cpu"), index_to_device(di)
    _assert_mphf_fields(ix, jx, ("st_fused", "at_fused", "amph_rows",
                                 "amph_arows", "amph_f", "mph_rows"))
    _assert_meta(ix.amph_meta, al_meta_of(di))
    assert ix.mph_meta is None and jl_meta_of(di) is None
    assert ix.has_anchors and tuple(ix.at_fused.shape) == (0, 160)
    assert ix.amph_meta.n_keys == len(di.anchor_mphf.arows)
    # the struct the kernels take names each table's layout
    c = ix.c_index
    assert (c.jl_mphf, c.al_mphf) == (0, 1)
    assert c.am.meta.n_keys == ix.amph_meta.n_keys and c.jm.meta.n_levels == 0
