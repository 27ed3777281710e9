"""Seeded genome, graph and read generators of the benchmark.

A configuration's graph is the compacted de Bruijn graph of two
haplotypes (two strains, or the two copies of a diploid genome): its
unitigs are the maximal non-branching paths of the k-mers of both, the
graph that BCALM2 writes for them.  Branching comes from the SNPs that
tell the haplotypes apart, and nowhere else:

- genome: i.i.d. uniform bases (no repeats of k bases, bar chance);
- SNPs: each base in [k, n - k) with probability `snp_rate`, the second
  haplotype's base one of the three others, uniform;
- SNPs closer than k bases to the next form one cluster; a cluster
  from position f to l is a bubble: two allele unitigs,
  hap[f - k + 1 : l + k] of each haplotype.  Between two clusters lies
  the shared flank genome[l + 1 : f'] where it holds a k-mer (f' - l > k);
  where f' - l = k the two bubbles' alleles meet at a shared (k - 1)-mer;
- orientation: each unitig reverse-complemented with probability 1/2,
  then all shuffled (BCALM2's order and strands are arbitrary);
- reads: start uniform over one haplotype, each haplotype with
  probability 1/2; each base substituted (by one of the three others)
  with probability `sub_rate`; then reverse-complemented with
  probability 1/2.

`compact` is the same graph built the slow way, k-mer by k-mer, for the
tests.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.zeros(256, np.uint8)
_CODE[BASES] = np.arange(4, dtype=np.uint8)
# complement of A, C, G, T (and N -> A, as the mapper's reverse does)
_COMP = np.arange(256, dtype=np.uint8)
for a, b in zip(b"ACGTN", b"TGCAA"):
    _COMP[a] = b


def make_genome(rng: np.random.Generator, n: int) -> np.ndarray:
    """uint8 ASCII bases [n]."""
    return BASES[rng.integers(0, 4, size=n, dtype=np.uint8)]


def _other_base(rng: np.random.Generator, bases: np.ndarray) -> np.ndarray:
    """A base other than each of `bases`, uniform over the three."""
    shift = rng.integers(1, 4, size=len(bases), dtype=np.uint8)
    return BASES[(_CODE[bases] + shift) % 4]


def snp_sites(genome: np.ndarray, rng: np.random.Generator, k: int,
              rate: float) -> tuple[np.ndarray, np.ndarray]:
    """(positions int64 sorted, second haplotype's bases uint8) of the
    SNPs: each position of [k, n - k) with probability `rate`."""
    span = len(genome) - 2 * k
    count = rng.binomial(span, rate) if span > 0 else 0
    pos = np.unique(rng.integers(k, k + span, size=count))
    return pos, _other_base(rng, genome[pos])


def haplotypes(genome: np.ndarray, sites) -> np.ndarray:
    """uint8 [2, n]: the genome and the haplotype with the SNPs."""
    pos, alt = sites
    haps = np.stack([genome, genome])
    haps[1, pos] = alt
    return haps


def unitig_spans(n: int, pos: np.ndarray, k: int):
    """(flanks, bubbles): int64 [F, 2] and [C, 2] half-open ranges of the
    genome; a flank is shared by both haplotypes, a bubble range is cut
    from each haplotype."""
    if len(pos) == 0:
        return np.array([[0, n]], np.int64), np.zeros((0, 2), np.int64)
    new = np.concatenate([[True], np.diff(pos) >= k])
    first = pos[new]
    last = pos[np.concatenate([new[1:], [True]])]
    flanks = np.stack([np.concatenate([[0], last + 1]),
                       np.concatenate([first, [n]])], axis=1)
    flanks = flanks[flanks[:, 1] - flanks[:, 0] >= k]
    bubbles = np.stack([first - k + 1, last + k], axis=1)
    return flanks, bubbles


def unitig_fasta(haps: np.ndarray, pos: np.ndarray, k: int,
                 rng: np.random.Generator) -> bytes:
    """The unitig FASTA (">u<i>" headers) of the two haplotypes' graph:
    flanks, then each bubble's two alleles, oriented and shuffled."""
    flanks, bubbles = unitig_spans(haps.shape[1], pos, k)
    a, b = haps[0].tobytes(), haps[1].tobytes()
    seqs = [a[s:e] for s, e in flanks.tolist()]
    for s, e in bubbles.tolist():
        seqs += [a[s:e], b[s:e]]
    flip = rng.random(len(seqs)) < 0.5
    perm = rng.permutation(len(seqs))
    comp = _COMP.tobytes()
    parts = []
    for i, j in enumerate(perm.tolist()):
        u = seqs[j]
        if flip[j]:
            u = u.translate(comp)[::-1]
        parts.append(b">u%d\n%s\n" % (i, u))
    return b"".join(parts)


def compact(seqs: list, k: int) -> set:
    """Canonical unitigs (the smaller of a unitig and its reverse
    complement) of the k-mers of `seqs` (bytes), k-mer by k-mer: the
    slow restatement the tests hold `unitig_fasta` to."""
    comp = _COMP.tobytes()

    def rc(s):
        return s.translate(comp)[::-1]

    nodes = set()
    for s in seqs:
        for i in range(len(s) - k + 1):
            x = s[i : i + k]
            nodes.add(min(x, rc(x)))

    def has(x):
        return min(x, rc(x)) in nodes

    def succ(x):
        return [x[1:] + c for c in (b"A", b"C", b"G", b"T") if has(x[1:] + c)]

    def pred(x):
        return [c + x[:-1] for c in (b"A", b"C", b"G", b"T") if has(c + x[:-1])]

    def joins(x, y):    # x's only successor is y, and y's only predecessor x
        return succ(x) == [y] and pred(y) == [x] and y != x

    out, seen = set(), set()
    for node in nodes:
        if node in seen:
            continue
        x = node            # walk back to the unitig's first k-mer
        while True:
            p = pred(x)
            if len(p) != 1 or not joins(p[0], x) or min(p[0], rc(p[0])) == node:
                break
            x = p[0]
        u = x
        seen.add(min(x, rc(x)))
        while True:
            s = succ(x)
            if len(s) != 1 or not joins(x, s[0]) or min(s[0], rc(s[0])) in seen:
                break
            x = s[0]
            u += x[-1:]
            seen.add(min(x, rc(x)))
        out.add(min(u, rc(u)))
    return out


def sample_reads(haps: np.ndarray, rng: np.random.Generator, n: int,
                 read_len: int = 100, sub_rate: float = 0.001) -> np.ndarray:
    """uint8 ASCII reads [n, read_len]."""
    hap = rng.integers(0, 2, size=n)
    starts = rng.integers(0, haps.shape[1] - read_len + 1, size=n)
    reads = np.empty((n, read_len), np.uint8)
    for h in (0, 1):
        windows = np.lib.stride_tricks.sliding_window_view(haps[h], read_len)
        reads[hap == h] = windows[starts[hap == h]]
    n_sub = rng.binomial(read_len, sub_rate, size=n)
    rows = np.repeat(np.arange(n), n_sub)
    cols = rng.integers(0, read_len, size=len(rows))
    reads[rows, cols] = _other_base(rng, reads[rows, cols])
    flip = rng.random(n) < 0.5
    reads[flip] = _COMP[reads[flip, ::-1]]
    return reads


def reads_fasta(reads: np.ndarray) -> bytes:
    """FASTA of `reads` [n, L] with headers ">r<i>"."""
    n, L = reads.shape
    blocks = []
    d, lo = 1, 0
    while lo < n:
        # the records whose index has d digits: one fixed-width block
        hi = min(n, 10 ** d)
        ids = np.arange(lo, hi, dtype=np.int64)
        block = np.empty((hi - lo, 3 + d + L + 1), np.uint8)
        block[:, 0], block[:, 1] = ord(">"), ord("r")
        for j in range(d):
            block[:, 2 + j] = ord("0") + (ids // 10 ** (d - 1 - j)) % 10
        block[:, 2 + d] = ord("\n")
        block[:, 3 + d : 3 + d + L] = reads[lo:hi]
        block[:, -1] = ord("\n")
        blocks.append(block.tobytes())
        d, lo = d + 1, hi
    return b"".join(blocks)
