"""Shared inputs for the dbgtpu_torch parity tests (tests/test_torch_*.py).

Every dataset comes from a numpy seed (tests.synth); the same packed
batch goes through the JAX engine's functions (dbgtpu.engine.core, on
the CPU) and through the port's plain torch versions, and every
comparison is exact: all outputs are integers.
"""

from __future__ import annotations

import numpy as np
import torch

from dbgtpu.index import device as D
from dbgtpu.index.build import build_graph_from_seqs
from dbgtpu.seq import encode, n_mask

from . import synth


def fasta_seqs(fa: bytes) -> list[bytes]:
    return [ln for ln in fa.split(b"\n") if ln and not ln.startswith(b">")]


def dataset(seed: int, k: int, n_reads: int = 48, n_frac: float = 0.0,
            genome_len: int = 8000, dog_mode: bool = False, **kw):
    """(graph, read sequences) of a synthetic dataset; dog_mode builds
    the anchor table of -G."""
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=seed, genome_len=genome_len, k=k, n_reads=n_reads,
        n_frac=n_frac, **kw,
    )
    return (build_graph_from_seqs(fasta_seqs(unitigs_fa), k,
                                  dog_mode=dog_mode),
            fasta_seqs(reads_fa))


def assert_walks_equal(got, want: dict) -> None:
    """Port Walks against a JAX result dict: every scalar field, and
    lbuf[:llen] / rbuf[:rlen] (buffer tails are stale after a failed
    anchor)."""
    for f in ("status", "orient", "offset", "llen", "rlen"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(want[f]), err_msg=f)
    lbuf = np.asarray(want["lbuf"]).astype(np.int32)
    rbuf = np.asarray(want["rbuf"]).astype(np.int32)
    assert got.lbuf.shape == lbuf.shape and got.rbuf.shape == rbuf.shape
    for i in range(lbuf.shape[0]):
        ll, rl = int(got.llen[i]), int(got.rlen[i])
        np.testing.assert_array_equal(got.lbuf[i, :ll].numpy(), lbuf[i, :ll])
        np.testing.assert_array_equal(got.rbuf[i, :rl].numpy(), rbuf[i, :rl])


def device_index(graph, variant: str = "embedded") -> D.DeviceIndex:
    """DeviceIndex variants: "embedded" (unitig sequence in the umeta
    rows, window-3 probe table), "pool" (sequence in pool chunk rows),
    "probeless" (no closure probe table), "window4" (window-4 probes),
    "mphf" (the MPHF junction layout, and MPHF anchors for a dog-mode
    graph), "mphf_probeless" (the same without a probe table) and
    "anchor_mphf" (scan junction table, MPHF anchors: what a dog keyset
    of ANCHOR_MPHF_MIN keys or more gets)."""
    if variant == "pool":
        cap = D.EMBED_CAP_BASES
        D.EMBED_CAP_BASES = 8
        try:
            di = D.build_device_index(graph)
        finally:
            D.EMBED_CAP_BASES = cap
        assert di.umeta.shape[1] == 16
        return di
    if variant == "anchor_mphf":
        floor = D.ANCHOR_MPHF_MIN
        D.ANCHOR_MPHF_MIN = 1
        try:
            di = D.build_device_index(graph)
        finally:
            D.ANCHOR_MPHF_MIN = floor
        assert di.anchor_mphf is not None and di.scan_tbl is not None
        return di
    if variant.startswith("mphf"):
        di = D.build_device_index(graph, layout="mphf")
        assert di.mphf_junction is not None and di.scan_tbl is None
        if variant == "mphf_probeless":
            di.probe_tbl = None
        else:
            assert variant == "mphf", variant
        return di
    di = D.build_device_index(graph)
    if variant == "probeless":
        di.probe_tbl = None
    elif variant == "window4":
        keys = graph.jkeys
        di.probe_tbl = D.build_probe_table(keys, graph.k - 1, window=4)
        assert di.probe_tbl.rows.shape[1] == 4 * D.PT_SLOTS
    else:
        assert variant == "embedded", variant
    return di


def batch(reads: list[bytes], L: int, keep_empty_nmbits: bool = False):
    """Packed batch as the runner builds it: (codes uint8 [B, L],
    nmask bool [B, L], lens int32 [B], words uint32 [B, ceil(L/16)],
    nmbits uint32 [B, ceil(L/32)] or [B, 0] when the batch has no N)."""
    from dbgtpu_torch.engine.runner import pack_words_batch

    B = len(reads)
    codes = np.zeros((B, L), np.uint8)
    nm = np.zeros((B, L), bool)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(reads):
        codes[i, : len(s)] = encode(s)
        nm[i, : len(s)] = n_mask(s)
        lens[i] = len(s)
    words, nmbits = pack_words_batch(codes, nm)
    if not nmbits.any() and not keep_empty_nmbits:
        nmbits = np.zeros((B, 0), np.uint32)
    return codes, nm, lens, words, nmbits


def t32(a: np.ndarray) -> torch.Tensor:
    """numpy uint32/int32 -> torch int32 with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def join(hi, lo) -> np.ndarray:
    """JAX (hi, lo) uint32 pair -> int64 k-mer values."""
    return ((np.asarray(hi).astype(np.int64) << 32)
            | np.asarray(lo).astype(np.int64))


def as_u32(t: torch.Tensor) -> np.ndarray:
    """torch int32 (uint32 bits) -> numpy uint32."""
    return t.numpy().view(np.uint32)
