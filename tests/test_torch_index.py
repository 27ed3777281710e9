"""dbgtpu_torch.engine.index.index_tensors against the JAX
index_to_device, field by field, exact."""

import numpy as np
import pytest
import torch

from dbgtpu.engine.core import index_to_device
from dbgtpu.index.build import build_graph_from_seqs
from dbgtpu.index import device as device_mod
from dbgtpu.index.device import build_device_index
from dbgtpu_torch.engine.index import UnsupportedIndex, index_tensors

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


def test_index_tensors_refuse_mphf_and_anchor_mphf(monkeypatch):
    g, _ = dataset(seed=12, k=21, n_reads=4, genome_len=3000)
    with pytest.raises(UnsupportedIndex, match="'mphf'.*B12"):
        index_tensors(build_device_index(g, layout="mphf"), "cpu")
    _, ufa = synth.make_dataset(seed=13, genome_len=3000, k=21, n_reads=4)
    gd = build_graph_from_seqs(fasta_seqs(ufa), 21, dog_mode=True)
    monkeypatch.setattr(device_mod, "ANCHOR_MPHF_MIN", 0)
    di = build_device_index(gd)
    assert di.anchor_mphf is not None and di.anchor_scan is None
    n = len(di.anchor_mphf.arows)
    with pytest.raises(UnsupportedIndex, match=f"{n:,} anchors.*B12"):
        index_tensors(di, "cpu")
