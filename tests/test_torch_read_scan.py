"""K1 read_scan: the port's plain version against the JAX engine's
_unpack_words, _read_images, _scan_kmer_pairs_words + rcb_pair, the
rolled-in-N _scan_kmer_pairs bug scan and pair_le (core.align_batch
:955-1019), on the CPU, exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbgtpu.engine import core, kmer32
from dbgtpu_torch.engine.read_scan import read_scan, read_scan_ref

from .torch_parity import batch, dataset, join, t32


def jax_scan(words, nmbits, lens, L, k1):
    """The anchor-scan front of core.align_batch, on the JAX CPU backend."""
    Lw = (L + 15) // 16
    codes, nm = core._unpack_words(jnp.asarray(words), jnp.asarray(nmbits), L)
    _, _, rwf, rwr, nmw = core._read_images(codes, nm, jnp.asarray(lens),
                                            2 * Lw + 1)
    std = core._scan_kmer_pairs_words(rwf, L, k1)
    rcs = kmer32.rcb_pair(*std, k1)
    col = jnp.arange(L)[None, :]
    has_n = bool(jnp.any(nm))
    if has_n:
        bcodes = jnp.where(nm & (col >= k1), jnp.uint32(0),
                           codes.astype(jnp.uint32))
        bug = core._scan_kmer_pairs(bcodes, k1, False)
    else:
        bug = std
    le1 = kmer32.pair_le(*bug, *rcs)
    le2 = kmer32.pair_le(*std, *rcs)
    bug, std, rcs = join(*bug), join(*std), join(*rcs)
    le1, le2 = np.asarray(le1), np.asarray(le2)
    return dict(
        rows=np.stack([np.asarray(rwf), np.asarray(rwr), np.asarray(nmw)]),
        bug=bug, rcs=rcs, rep1=np.where(le1, bug, rcs), le1=le1,
        rep2=np.where(le2, std, rcs), has_n=has_n,
    )


@pytest.mark.parametrize("seed,k,n_frac,L,keep_empty", [
    (21, 31, 0.0, 112, False),     # N-free batch: zero-width nmbits
    (22, 21, 0.4, 112, False),     # Ns, some in the first k-1 columns
    (23, 15, 0.3, 128, True),      # Ns, longer bucket than the reads
    (24, 31, 0.0, 112, True),      # all-zero but full-width nmbits
])
def test_read_scan_ref_matches_jax(seed, k, n_frac, L, keep_empty):
    _, reads = dataset(seed=seed, k=k, n_reads=40, n_frac=n_frac,
                       genome_len=4000)
    rng = np.random.default_rng(seed)
    # ragged lengths and N at the very first and k-1-th columns
    reads = [r[: int(rng.integers(k + 1, len(r) + 1))] for r in reads]
    if n_frac:
        reads[0] = b"N" + reads[0][1:]
        reads[1] = reads[1][: k - 1] + b"N" + reads[1][k:]
    reads.append(b"")                               # an empty padding row
    _, _, lens, words, nmbits = batch(reads, L, keep_empty_nmbits=keep_empty)
    k1 = k - 1
    want = jax_scan(words, nmbits, lens, L, k1)
    got = read_scan_ref(t32(words), t32(nmbits), t32(lens), L=L, k1=k1)
    np.testing.assert_array_equal(
        got.rows.numpy().view(np.uint32), want["rows"])
    for f in ("bug", "rcs", "rep1", "rep2"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                      err_msg=f)
    np.testing.assert_array_equal(got.le1.numpy(), want["le1"])
    assert bool(got.has_n.item()) == want["has_n"] == bool(n_frac)


def test_read_scan_wrapper_uses_plain_version_only_on_cpu():
    from dbgtpu_torch.kernels import build

    _, reads = dataset(seed=25, k=21, n_reads=6, genome_len=2000)
    _, _, lens, words, nmbits = batch(reads, 112)
    args = (t32(words), t32(nmbits), t32(lens))
    before = dict(build.launches)
    got = read_scan(*args, L=112, k1=20)
    want = read_scan_ref(*args, L=112, k1=20)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert build.launches == before            # no kernel launched
    with pytest.raises(ValueError, match="no read_scan kernel"):
        read_scan(*(a.to("meta") for a in args), L=112, k1=20)


def test_read_scan_rejects_bad_shapes():
    _, reads = dataset(seed=26, k=21, n_reads=4, genome_len=2000)
    _, _, lens, words, nmbits = batch(reads, 112)
    with pytest.raises(ValueError, match="words width"):
        read_scan_ref(t32(words), t32(nmbits), t32(lens), L=128, k1=20)
    with pytest.raises(TypeError):
        read_scan_ref(t32(words), t32(nmbits), torch.from_numpy(lens).long(),
                      L=112, k1=20)
