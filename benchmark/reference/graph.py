"""The plain reference's unitig graph, built from the unitig FASTA.

Frozen copy of the parts of the mapper's python spec that the greedy
mode needs (`index/build.py`: parse_unitig_lines,
build_graph_from_seqs without the anchor mode, and UnitigGraph's
junction views, here read from the sorted key table by bisection in
place of dictionaries).  Unitig ids are 1-based; a canonical (k-1)-mer key
holds up to 4 ids per side, the fourth overwritten by every later
insert (bgreat's aligner.cpp:479-531).
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass

import numpy as np

from .seq import encode, rcb


@dataclass
class Graph:
    k: int
    pool: np.ndarray        # uint8 codes, unitigs back to back
    offsets: np.ndarray     # int64 [n+1], offsets[0] == 0 (sentinel)
    lengths: np.ndarray     # int32 [n+1], lengths[0] == 0
    ubeg: np.ndarray        # uint64 [n+1] first (k-1)-mer
    uend: np.ndarray        # uint64 [n+1] last (k-1)-mer
    jkeys: np.ndarray       # uint64 [nj] sorted canonical junction keys
    jvals: np.ndarray       # int32 [nj, 8]: left slots 0:4, right 4:8
    keys: list | None = None

    def __post_init__(self):
        self.keys = self.jkeys.tolist()

    def slots(self, key: int, side: int) -> list:
        """The ids of `key`'s left (side 0) or right (side 1) slots, in
        slot order; [] for a key that is no junction."""
        i = bisect_left(self.keys, key)
        if i == len(self.keys) or self.keys[i] != key:
            return []
        return [x for x in self.jvals[i, 4 * side : 4 * side + 4].tolist()
                if x]

    def unitig_codes(self, sid: int) -> np.ndarray:
        i = abs(sid)
        off = int(self.offsets[i])
        u = self.pool[off : off + int(self.lengths[i])]
        return (3 - u)[::-1] if sid < 0 else u

    def get_end(self, num: int) -> list:
        """Signed ids of the unitigs whose oriented sequence ends with
        the (k-1)-mer `num`."""
        rc = int(rcb(np.uint64(num), self.k - 1))
        ids = self.slots(num, 1) if num <= rc else self.slots(rc, 0)
        return [i if int(self.uend[i]) == num else -i for i in ids]

    def get_begin(self, num: int) -> list:
        rc = int(rcb(np.uint64(num), self.k - 1))
        ids = self.slots(num, 0) if num <= rc else self.slots(rc, 1)
        return [i if int(self.ubeg[i]) == num else -i for i in ids]

    def has_junction(self, rep: int) -> bool:
        """A canonical key with an id on either side: every key of the
        table has one."""
        i = bisect_left(self.keys, rep)
        return i < len(self.keys) and self.keys[i] == rep


def parse_unitig_lines(path: str, k: int) -> list:
    """Sequence lines of header/sequence pairs, up to the first sequence
    line shorter than k."""
    seqs = []
    with open(path, "rb") as f:
        while True:
            header = f.readline()
            line = f.readline().rstrip(b"\n")
            if not header or len(line) < k:
                break
            seqs.append(line)
    return seqs


def build_graph(path: str, k: int) -> Graph:
    seqs = parse_unitig_lines(path, k)
    k1 = k - 1
    n = len(seqs)
    lengths = np.zeros(n + 1, dtype=np.int32)
    lengths[1:] = np.fromiter((len(s) for s in seqs), np.int32, count=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    if n > 1:
        offsets[2:] = np.cumsum(lengths[1:n], dtype=np.int64)
    raw = b"".join(seqs)
    if not np.isin(np.frombuffer(raw, np.uint8),
                   np.frombuffer(b"ACGT", np.uint8)).all():
        raise ValueError("unitigs must hold A, C, G and T only")
    pool = encode(raw)
    # first and last (k-1)-mer of each unitig
    jj = np.arange(k1, dtype=np.int64)[None, :]
    st = offsets[1:, None]
    en = (offsets[1:] + lengths[1:].astype(np.int64) - k1)[:, None]
    wts = (2 * (k1 - 1 - jj)).astype(np.uint64)
    beg = (pool[st + jj].astype(np.uint64) << wts).sum(axis=1, dtype=np.uint64)
    end = (pool[en + jj].astype(np.uint64) << wts).sum(axis=1, dtype=np.uint64)
    ubeg = np.zeros(n + 1, np.uint64)
    uend = np.zeros(n + 1, np.uint64)
    ubeg[1:], uend[1:] = beg, end
    rc_beg, rc_end = rcb(beg, k1), rcb(end, k1)
    beg_left = beg <= rc_beg
    end_right = end <= rc_end
    # inserts in bgreat's order (unitigs ascending, begin before end);
    # the r-th insert of a (key, side) fills slot min(r, 3), and of two
    # writes to one slot the later stays
    keys_all = np.empty(2 * n, np.uint64)
    keys_all[0::2] = np.where(beg_left, beg, rc_beg)
    keys_all[1::2] = np.where(end_right, end, rc_end)
    side_all = np.empty(2 * n, np.int64)     # 0 = left, 1 = right
    side_all[0::2] = np.where(beg_left, 0, 1)
    side_all[1::2] = np.where(end_right, 1, 0)
    uid_all = np.repeat(np.arange(1, n + 1, dtype=np.int32), 2)
    jkeys, inv = np.unique(keys_all, return_inverse=True)
    gid = inv.astype(np.int64) * 2 + side_all
    order = np.argsort(gid, kind="stable")
    gs = gid[order]
    newg = np.r_[True, gs[1:] != gs[:-1]]
    gstart = np.maximum.accumulate(np.where(newg, np.arange(2 * n), 0))
    rank = np.empty(2 * n, np.int64)
    rank[order] = np.arange(2 * n) - gstart
    jvals = np.zeros((len(jkeys), 8), np.int32)
    jvals[inv, side_all * 4 + np.minimum(rank, 3)] = uid_all
    return Graph(k, pool, offsets, lengths, ubeg, uend, jkeys, jvals)

