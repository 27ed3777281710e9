"""A small seeded workload where the kernels' geometry has edges.

K2 answers Lk = L - k + 2 positions per read with one probe per window
of W = 3 or 4 positions, lane groups of 8 windows or positions; K5 scans
a read from both ends in chunks of 2, 4, 4, ... positions per direction
(twice that when one direction is left; scan anchors) or 16 (32; MPHF
anchors) and stops a direction at the chunk that completes E hits or
where the other direction found no hit ahead of it.  The cases below
put reads across those edges: Lk of 31, 32, 33 and 65 (k = 32 twice),
Lk not a multiple of W, reads of length k-1, k and k+1, reads with 0,
1, E and more than 32 anchor hits, hits only in a read's last chunk or
only at position len-k, efforts 1, 2 and 5, and planted N (which sends
K2 down its per-position branch).  A batch holds 45 reads, so warps and
lane groups end ragged.

K3 (greedy_walk, walk_inits) and K6 (exhaustive_dfs) give each read a
lane group that runs its own walk or DFS, probe a junction's <= 4
candidates side by side and pick the best by shuffle.  Two more cases
put reads across their edges: a graph with branches (junctions with 3
and 4 right or left candidates that tie on misses where a read ends
inside them, so the earliest must win; dead ends with 0 candidates
where reads run past the genome's ends) and a graph of unitigs of k
bases (each DFS level consumes one base, so a read's search runs to
L-k+1 levels, two below the depth bound D = L-k+3; planted N).  In every
case reads end at different steps within one warp, and the 45 reads
leave the last warp ragged (4 reads per warp).  The cases of CASE_NAMES
serve K2 and K5's CPU tests, those of WALK_CASE_NAMES (all) K3 and K6's.

K4 (pack_paths) and K8 (compact_result) take no graph: `pack_walks`
and `fused_rows` make their inputs at the batch sizes of
RESULT_BATCHES (one row, K8's 256-row tile +- 1, and more tiles than
the card holds blocks at once) and the pmax of RESULT_PMAX (rows
narrower and wider than a warp).

K11 and K12 take the edges of their plan (`gather_edges`), K10 those
of its one-launch schedule (`rowsum_edges`: chunk sizes around a warp's
index window, chunk counts around the grid's warp count, warp ranges
that cross chunk boundaries or end on them, row widths on both load
paths, stray indices, sums that wrap), and K7's check mode tables of
0, 1, 31 and 33 keys and one whose keys reach the final table
(`mphf_check_tables`).

`edge_cases()`, `pack_walks`, `fused_rows` and the gather and MPHF
edges are numpy alone (no torch, no test helper): chip_smoke.py holds
the kernels against their plain versions on them, and the CPU tests
hold the plain versions against the JAX package on the same cases.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

EDGE_SEED = 20261016
GENOME_LEN = 4000
_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


@dataclass(frozen=True)
class EdgeCase:
    name: str
    k: int
    L: int          # the batch's padded read length
    effort: int     # E of K5 (anchors tried per direction)
    unitigs: tuple[bytes, ...]
    reads: tuple[bytes, ...]

    @property
    def Lk(self) -> int:
        """K2's scan positions per read: (k-1)-mers of an L-base row."""
        return self.L - self.k + 2


# name, k, L, effort, plant N, graph ("linear": a cover of the genome by
# unitigs of k+1 to 2k+8 bases, "branch": that plus branch unitigs,
# "stride1": unitigs of k, then k and k+1 bases over the first
# STRIDE1_LEN)
_CASES = (
    ("k32_Lk33_E1", 32, 63, 1, False, "linear"),
    ("k32_Lk65_E5_N", 32, 95, 5, True, "linear"),
    ("k31_Lk32_E2", 31, 61, 2, False, "linear"),
    ("k21_Lk31_E2_N", 21, 50, 2, True, "linear"),
    ("k21_branch_E2", 21, 80, 2, False, "branch"),
    ("k15_stride1_E2_N", 15, 64, 2, True, "stride1"),
)
STRIDE1_LEN = 1500
BRANCH_SITES = 8     # junctions given branch unitigs, per side

CASE_NAMES = tuple(c[0] for c in _CASES[:4])
WALK_CASE_NAMES = tuple(c[0] for c in _CASES)


def _revcomp(s: bytes) -> bytes:
    return s.translate(_COMP)[::-1]


def _cover(genome: bytes, k: int, rng, lo: int, hi: int):
    """A linear cover of the genome by unitigs of lo to hi bases that
    overlap by k-1, some stored reverse-complemented: (unitigs, their
    start positions in the genome)."""
    out, starts, pos = [], [], 0
    while pos + k <= len(genome):
        n = min(int(rng.integers(lo, hi + 1)), len(genome) - pos)
        if n < k:
            break
        u = genome[pos : pos + n]
        out.append(_revcomp(u) if rng.random() < 0.3 else u)
        starts.append(pos)
        pos += n - (k - 1)
    return out, starts


def _unitigs(genome: bytes, k: int, rng) -> list[bytes]:
    """Unitigs of k+1 to 2k+8 bases (short, so reads cross many
    junctions)."""
    return _cover(genome, k, rng, k + 1, 2 * k + 8)[0]


def _branches(genome: bytes, k: int, starts, rng):
    """Branch unitigs at BRANCH_SITES junctions of the cover per side:
    at a right site, 2 or 3 unitigs that begin with the junction
    (k-1)-mer and follow the genome for `ly` bases, then leave it by one
    base (with the cover's unitig: 3 or 4 right candidates); at a left
    site the mirror image.  Returns (unitigs, right sites, left sites),
    a site being (junction position, ly)."""
    k1 = k - 1
    bases = b"ACGT"
    out, right, left = [], [], []
    picks = rng.choice(np.arange(2, len(starts) - 2), 2 * BRANCH_SITES,
                       replace=False)
    for i, s in enumerate(picks):
        p, ly = starts[int(s)], int(rng.integers(3, 13))
        n_var = 2 + i % 2
        if i < BRANCH_SITES:          # right: J + genome + a wrong base
            body = genome[p : p + k1 + ly]
            true = genome[p + k1 + ly]
            ends = [b for b in bases if b != true][:n_var]
            seqs = [body + bytes([b]) for b in ends]
            right.append((p, ly))
        else:                         # left: a wrong base + genome + J
            body = genome[p - ly : p + k1]
            true = genome[p - ly - 1]
            ends = [b for b in bases if b != true][:n_var]
            seqs = [bytes([b]) + body for b in ends]
            left.append((p, ly))
        out += [_revcomp(u) if rng.random() < 0.3 else u for u in seqs]
    return out, right, left


def _branch_reads(genome: bytes, k: int, L: int, right, left,
                  rng) -> list[bytes]:
    """Reads that end inside a right site's branch (or start inside a
    left site's), where the candidates tie, some with an error there;
    and reads that run past the genome's ends into random bases, where
    the walks meet 0 candidates."""
    k1 = k - 1

    def rand(n):
        return _BASES[rng.integers(0, 4, n)].tobytes()

    def err(r: bytes, at: int) -> bytes:
        r = bytearray(r)
        r[at] = _BASES[(int(np.nonzero(_BASES == r[at])[0][0]) + 1) % 4]
        return bytes(r)

    def orient(r):
        return _revcomp(r) if rng.random() < 0.5 else r

    reads = []
    for p, ly in right:
        e = p + k1 + int(rng.integers(1, ly + 1))   # ends inside the branch
        n = int(rng.integers(k1 + 2 + k, L + 1))
        r = genome[max(e - n, 0) : e]
        reads.append(orient(err(r, len(r) - 1) if rng.random() < 0.5 else r))
    for p, ly in left:
        s = p - int(rng.integers(1, ly + 1))        # starts inside it
        n = int(rng.integers(k1 + 2 + k, L + 1))
        r = genome[s : s + n]
        reads.append(orient(err(r, 0) if rng.random() < 0.5 else r))
    for _ in range(3):
        n = int(rng.integers(k + 5, L - 5))
        reads.append(orient(genome[-n:] + rand(int(rng.integers(3, L - n)))))
        reads.append(orient(rand(int(rng.integers(3, L - n))) + genome[:n]))
    return reads


def _reads(genome: bytes, k: int, L: int, E: int, plant_n: bool,
           rng) -> list[bytes]:
    def rand(n):
        return _BASES[rng.integers(0, 4, n)].tobytes()

    def piece(n, errors=0):
        s = int(rng.integers(0, len(genome) - n + 1))
        r = bytearray(genome[s : s + n])
        for _ in range(errors):
            i = int(rng.integers(0, n))
            r[i] = _BASES[(int(np.nonzero(_BASES == r[i])[0][0])
                           + int(rng.integers(1, 4))) % 4]
        r = bytes(r)
        return _revcomp(r) if rng.random() < 0.5 else r

    def planted(seg, at):
        """A random L-base read with `seg` at `at` (None: random place)."""
        at = int(rng.integers(0, L - len(seg) + 1)) if at is None else at
        return rand(at) + seg + rand(L - at - len(seg))

    reads = [piece(n) for n in (k - 1, k - 1, k, k, k + 1, k + 1)]
    reads += [piece(L) for _ in range(4)]                 # every k-mer hits
    reads += [piece(L, int(rng.integers(1, 3))) for _ in range(4)]
    reads += [rand(L) for _ in range(2)]                  # no hit
    reads += [planted(piece(k), None) for _ in range(2)]  # one hit
    reads += [planted(piece(k + E - 1), None) for _ in range(2)]   # E hits
    reads += [planted(piece(k), L - k) for _ in range(2)]  # at len-k only
    reads += [planted(piece(k + 3), L - k - 3) for _ in range(2)]  # last chunk
    reads += [planted(piece(k + 2), 0) for _ in range(2)]  # first chunk only
    reads += [piece(int(rng.integers(k - 1, L + 1)), int(rng.integers(0, 2)))
              for _ in range(45 - len(reads))]
    if plant_n:
        for i in range(0, len(reads), 3):
            r = bytearray(reads[i])
            for _ in range(int(rng.integers(1, 3))):
                r[int(rng.integers(0, len(r)))] = ord("N")
            reads[i] = bytes(r)
    return reads


def edge_cases(seed: int = EDGE_SEED) -> list[EdgeCase]:
    """The cases of WALK_CASE_NAMES, in that order, from one seeded
    genome."""
    rng = np.random.default_rng(seed)
    genome = _BASES[rng.integers(0, 4, GENOME_LEN)].tobytes()
    out = []
    for name, k, L, E, plant_n, shape in _CASES:
        if shape == "stride1":
            # unitigs of k bases over the first two thirds (one base per
            # DFS level: a read of L bases goes L-k+1 = D-2 levels deep,
            # the most it can), of k and k+1 over the rest (their first
            # k-mer is a dog anchor)
            g = genome[:STRIDE1_LEN]
            cut = 2 * STRIDE1_LEN // 3
            unitigs = (_cover(g[:cut], k, rng, k, k)[0]
                       + _cover(g[cut - (k - 1):], k, rng, k, k + 1)[0])
            reads = _reads(g, k, L, E, plant_n, rng)
        elif shape == "branch":
            unitigs, starts = _cover(genome, k, rng, k + 1, 2 * k + 8)
            extra, right, left = _branches(genome, k, starts, rng)
            unitigs += extra
            reads = _branch_reads(genome, k, L, right, left, rng)
            reads += _reads(genome, k, L, E, plant_n, rng)[: 45 - len(reads)]
        else:
            unitigs = _unitigs(genome, k, rng)
            reads = _reads(genome, k, L, E, plant_n, rng)
        out.append(EdgeCase(name, k, L, E, tuple(unitigs), tuple(reads)))
    return out


# K4 pack_paths and K8 compact_result: rows narrower and wider than a
# warp, batches of one row, of a tile +- 1 and of more tiles than a grid
# holds at once.  The CPU tests take small B of these; chip_smoke.py all.
RESULT_BATCHES = (1, 255, 256, 257, 32_768, 262_144)
RESULT_PMAX = (3, 30, 31, 62, 120)
RESULT_CASES = ("mixed", "unaligned", "over_pmax", "equal_counts", "full")
WALK_PACK_CASES = ("mixed", "empty", "short", "long")
PACK_P = 112            # walk buffer width: the survey's L (pmax 120 > P)


def fused_rows(seed: int, B: int, pmax: int, dtype, case: str) -> np.ndarray:
    """K8's input: result rows [B, 2 + pmax] of `dtype` as pack_paths
    writes them (status, true plen, then plen path slots, nonzero, and a
    zero tail).  Cases: "mixed" (every status, counts 1..pmax),
    "unaligned" (no row holds a slot), "over_pmax" (a third of the rows
    longer than pmax: full rows), "equal_counts" (every count 3: the
    stable order decides), "full" (every row aligned, count pmax)."""
    rng = np.random.default_rng(seed)
    status = rng.choice([1, 2, 3, 4, 5], size=B, p=[.4, .3, .1, .1, .1])
    plen = rng.integers(1, pmax + 1, size=B)
    if case == "unaligned":
        status = rng.choice([3, 4, 5], size=B)
    elif case == "over_pmax":
        # the true length exceeds the slots of the row: the row is full
        plen[rng.random(B) < 0.3] = pmax + rng.integers(1, 40)
    elif case == "equal_counts":
        plen[:] = 3                      # ties everywhere: stability decides
    elif case == "full":
        status = rng.choice([1, 2], size=B)
        plen[:] = pmax
    elif case != "mixed":
        raise ValueError(case)
    hi = 30000 if dtype == np.int16 else 2_000_000
    slots = rng.integers(1, hi, size=(B, pmax)) * rng.choice([-1, 1],
                                                             size=(B, pmax))
    aligned = (status == 1) | (status == 2)
    live = aligned[:, None] & (np.arange(pmax)[None, :] < plen[:, None])
    fused = np.zeros((B, 2 + pmax), dtype)
    fused[:, 0] = status
    fused[:, 1] = np.where(aligned, plen, 0)
    fused[:, 2:] = np.where(live, slots, 0)
    return fused


def pack_walks(seed: int, B: int, case: str, P: int = PACK_P) -> dict:
    """K4's input: the seven int32 walk outputs (engine/walk.py Walks
    fields) of B reads, buffers [B, P] filled with nonzero ids past llen /
    rlen too (only [:llen] and [:rlen] may reach a row).  Cases: "mixed"
    (every status, llen and rlen in [0, P], a quarter of each 0),
    "empty" (llen = rlen = 0: the offset alone), "short" (llen, rlen <=
    2), "long" (llen, rlen near P: plen beyond any pmax of the set)."""
    rng = np.random.default_rng(seed)
    status = rng.integers(0, 6, size=B)
    if case == "mixed":
        llen = np.where(rng.random(B) < 0.25, 0, rng.integers(0, P + 1, B))
        rlen = np.where(rng.random(B) < 0.25, 0, rng.integers(0, P + 1, B))
    elif case == "empty":
        llen = rlen = np.zeros(B, np.int64)
    elif case == "short":
        llen, rlen = rng.integers(0, 3, B), rng.integers(0, 3, B)
    elif case == "long":
        llen, rlen = rng.integers(P - 8, P + 1, B), rng.integers(P - 8, P + 1, B)
    else:
        raise ValueError(case)

    def ids():
        return (rng.integers(1, 30000, size=(B, P))
                * rng.choice([-1, 1], size=(B, P))).astype(np.int32)

    i32 = np.int32
    return dict(status=status.astype(i32),
                orient=rng.integers(0, 2, B).astype(i32),
                offset=rng.integers(0, P, B).astype(i32),
                llen=llen.astype(i32), rlen=rlen.astype(i32),
                lbuf=ids(), rbuf=ids())


# K11 gather_rows_sum and K12 gather_take_sum: the edges of their plan
# (engine/gather.py gather_plan) for rows of W words, where tables of up
# to `direct_max` rows take the direct path and larger ones slices of S
# rows.  Each case runs at every reps of GATHER_REPS.
GATHER_REPS = (0, 1, 8)


@dataclass(frozen=True)
class GatherEdge:
    name: str
    NB: int             # table rows (K12: words)
    B: int
    J: int
    pattern: str = "uniform"   # "one_slice": every index in slice 2;
    #                            "ends": only rows 0 and NB - 1;
    #                            "out_of_range": a quarter of them outside
    #                            [0, NB) (taken as NB - 1)
    offset: int = 0     # the table starts this many words into its buffer


def gather_edges(direct_max: int, S: int) -> list[GatherEdge]:
    """B = 1 and J = 1, 31, 33, 128 on both paths; NB = 1; NB one above
    and one below a multiple of the slice and on both sides of the direct
    / bucketed switch; one bucket taking every entry; indices 0 and NB - 1
    only; B too large for a shared-memory copy of out; entries of 64 bits
    (B * S > 2^32); tables off a 16-byte boundary on both paths; indices
    outside the table (NB, NB + 1, -1, the int32 extremes) on both
    paths."""
    m = direct_max // S + 2             # m * S rows: bucketed, m + 1 slices
    sizes = (("direct", direct_max // 2), ("bucketed", m * S + 1))
    return [
        *(GatherEdge(f"B1_{path}", nb, 1, 128) for path, nb in sizes),
        *(GatherEdge(f"J{J}_{path}", nb, 257, J)
          for path, nb in sizes for J in (1, 31, 33, 128)),
        GatherEdge("NB1", 1, 64, 33),
        GatherEdge(f"NB{m}S-1", m * S - 1, 300, 128),
        GatherEdge(f"NB{m}S+1", m * S + 1, 300, 128),
        GatherEdge("direct_max", direct_max, 300, 128),
        GatherEdge("direct_max+1", direct_max + 1, 300, 128),
        GatherEdge("one_slice", m * S, 500, 128, "one_slice"),
        GatherEdge("ends", m * S + 5, 300, 128, "ends"),
        GatherEdge("out_beyond_shared", m * S + 1, 50_000, 3),
        GatherEdge("entries64", m * S + 1, (1 << 32) // S + 1, 1),
        *(GatherEdge(f"unaligned_{path}", nb, 300, 33, offset=1 + 2 * i)
          for i, (path, nb) in enumerate(sizes)),
        *(GatherEdge(f"out_of_range_{path}", nb, 300, 33, "out_of_range")
          for path, nb in sizes),
    ]


def gather_edge_inputs(seed: int, case: GatherEdge, W: int, S: int):
    """(buffer, idx): uint32 words [offset + NB * W] whose table is
    buffer[offset:] viewed as [NB, W] (K12: W = 1, [NB]), and int32
    indices [B, J] of the case's pattern."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 1 << 32, size=case.offset + case.NB * W,
                       dtype=np.uint64).astype(np.uint32)
    shape = (case.B, case.J)
    if case.pattern == "one_slice":
        idx = rng.integers(2 * S, 3 * S, size=shape)
    elif case.pattern == "ends":
        idx = np.where(rng.random(shape) < 0.5, 0, case.NB - 1)
    elif case.pattern == "uniform":
        idx = rng.integers(0, case.NB, size=shape)
    elif case.pattern == "out_of_range":
        stray = np.array([case.NB, case.NB + 1, -1, (1 << 31) - 1, -1 << 31])
        idx = np.where(rng.random(shape) < 0.25,
                       stray[rng.integers(0, stray.size, size=shape)],
                       rng.integers(0, case.NB, size=shape))
    else:
        raise ValueError(case.pattern)
    return buf, idx.astype(np.int32)


# K10 gather_rowsum: the edges of its one-launch schedule
# (engine/gather.py rowsum_plan) on a card whose full grid has `warps`
# warps: rows [N w / warps, N (w + 1) / warps) per warp, tiles of 32 rows
# cut at chunk boundaries, 16-byte vectors where W % 4 == 0 and the
# table is 16-byte aligned, else words.
@dataclass(frozen=True)
class RowsumEdge:
    name: str
    NB: int             # table rows
    W: int              # words per row
    CH: int
    n_chunks: int
    pattern: str = "uniform"   # "ends": only rows 0 and NB - 1;
    #                            "out_of_range": a quarter of the indices
    #                            outside [0, NB) (taken as NB - 1);
    #                            "ones": every table word 0xFFFFFFFF
    offset: int = 0     # the table starts this many words into its buffer


def rowsum_edges(warps: int) -> list[RowsumEdge]:
    """CH = 1, 31, 32, 33, 4,095 and 4,097; one and two chunks; chunk
    counts one below and one above the grid's warp count (CH = 33: every
    warp's range crosses a boundary), ranges that end exactly on chunk
    boundaries (CH = 64, as many chunks as warps) and ranges that cross
    one (CH = 100, 7 chunks more); W = 1, 3, 4, 24 and 25; a table off
    a 16-byte boundary; one row; indices 0 and NB - 1 only; indices
    outside the table; all-ones rows, so that every sum wraps."""
    return [
        *(RowsumEdge(f"CH{ch}", 1000, 24, ch, 3) for ch in
          (1, 31, 32, 33, 4095, 4097)),
        RowsumEdge("one_chunk", 1000, 24, 4096, 1),
        RowsumEdge("two_chunks", 1000, 24, 4096, 2),
        RowsumEdge("chunks_warps-1", 1000, 24, 33, warps - 1),
        RowsumEdge("chunks_warps+1", 1000, 24, 33, warps + 1),
        RowsumEdge("ranges_on_boundaries", 1000, 24, 64, warps),
        RowsumEdge("ranges_across_boundaries", 1000, 24, 100, warps + 7),
        *(RowsumEdge(f"W{w}", 777, w, 33, 40) for w in (1, 3, 4, 24, 25)),
        RowsumEdge("unaligned", 1000, 24, 4095, 3, offset=1),
        RowsumEdge("NB1", 1, 24, 31, 5),
        RowsumEdge("ends", 1000, 24, 33, 70, "ends"),
        RowsumEdge("out_of_range", 1000, 24, 33, 70, "out_of_range"),
        RowsumEdge("out_of_range_words", 1000, 25, 33, 70, "out_of_range"),
        RowsumEdge("ones", 50, 24, 4097, 3, "ones"),
    ]


def rowsum_edge_inputs(seed: int, case: RowsumEdge):
    """(buffer, idx): uint32 words [offset + NB * W] whose table is
    buffer[offset:] viewed as [NB, W], and int32 indices [n_chunks * CH]
    of the case's pattern."""
    rng = np.random.default_rng(seed)
    n_words = case.offset + case.NB * case.W
    buf = (np.full(n_words, 0xFFFFFFFF, np.uint32) if case.pattern == "ones"
           else rng.integers(0, 1 << 32, size=n_words,
                             dtype=np.uint64).astype(np.uint32))
    n = case.n_chunks * case.CH
    if case.pattern == "ends":
        idx = np.where(rng.random(n) < 0.5, 0, case.NB - 1)
    elif case.pattern == "out_of_range":
        stray = np.array([case.NB, case.NB + 1, -1, (1 << 31) - 1, -1 << 31])
        idx = np.where(rng.random(n) < 0.25,
                       stray[rng.integers(0, stray.size, size=n)],
                       rng.integers(0, case.NB, size=n))
    elif case.pattern in ("uniform", "ones"):
        idx = rng.integers(0, case.NB, size=n)
    else:
        raise ValueError(case.pattern)
    return buf, idx.astype(np.int32)


# K7's check mode: stored keys of MPHF-backed tables, each row's first two
# words the key's hi and lo words at the slot the MPHF gives it
MPHF_CHECK_SIZES = (0, 1, 31, 33)
MPHF_CHECK_COLS = 5


def mphf_check_tables(seed: int = EDGE_SEED):
    """[(name, mphf, vrows uint32 [n, MPHF_CHECK_COLS])]: tables of
    MPHF_CHECK_SIZES keys (gamma 2) and one of 2,000 keys at gamma 1 with
    two levels, whose keys reach the final table; every stored key at
    its own slot."""
    from ..index.mphf import build_mphf

    rng = np.random.default_rng(seed)
    out = []
    for name, n, kw in (
            *((f"{n} keys", n, dict(gamma=2.0)) for n in MPHF_CHECK_SIZES),
            ("tight gamma (final table)", 2000,
             dict(gamma=1.0, max_levels=2))):
        keys = np.unique(rng.integers(0, 1 << 62, size=n, dtype=np.uint64))
        while keys.size < n:
            keys = np.unique(np.concatenate([keys, rng.integers(
                0, 1 << 62, size=n - keys.size, dtype=np.uint64)]))
        m = build_mphf(keys, **kw)
        vrows = rng.integers(0, 1 << 32, size=(n, MPHF_CHECK_COLS),
                             dtype=np.uint64).astype(np.uint32)
        slots = m.lookup(keys).astype(np.int64)
        vrows[slots, 0] = (keys >> np.uint64(32)).astype(np.uint32)
        vrows[slots, 1] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        out.append((name, m, vrows))
    return out
