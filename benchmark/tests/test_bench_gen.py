"""The generators: a configuration's unitigs are its two haplotypes'
compacted de Bruijn graph, and the reads are drawn as the traffic says."""

import numpy as np
import pytest

from benchmark.gen import synth

COMP = synth._COMP.tobytes()


def _canonical(fasta: bytes) -> list:
    return [min(u, u.translate(COMP)[::-1]) for u in fasta.split(b"\n")[1::2]]


@pytest.mark.parametrize("seed,n,k,rate", [
    (1, 3000, 21, 0.02),    # bubbles apart
    (2, 5000, 15, 0.05),    # clusters, and bubbles meeting at a (k-1)-mer
    (3, 2000, 31, 0.0),     # no SNP: one unitig
    (4, 4000, 21, 0.04),
    (5, 6000, 31, 0.03),
])
def test_unitigs_are_the_compacted_graph(seed, n, k, rate):
    rng = np.random.default_rng(seed)
    genome = synth.make_genome(rng, n)
    sites = synth.snp_sites(genome, rng, k, rate)
    haps = synth.haplotypes(genome, sites)
    got = _canonical(synth.unitig_fasta(haps, sites[0], k, rng))
    assert len(got) == len(set(got))
    assert set(got) == synth.compact([h.tobytes() for h in haps], k)


def test_reads_follow_the_traffic():
    rng = np.random.default_rng(8)
    genome = synth.make_genome(rng, 20000)
    haps = synth.haplotypes(genome, synth.snp_sites(genome, rng, 31, 0.01))
    reads = synth.sample_reads(haps, np.random.default_rng(9), 4000, 100,
                               0.01)
    assert reads.shape == (4000, 100)
    texts = [h.tobytes() for h in haps]
    texts += [t.translate(COMP)[::-1] for t in texts]
    exact = sum(any(r.tobytes() in t for t in texts) for r in reads)
    # a read is exact with probability 0.99 ** 100 = 0.366
    assert 0.32 < exact / len(reads) < 0.41
    blob = synth.reads_fasta(reads)
    assert blob.count(b">r") == 4000 and blob.startswith(b">r0\n")
