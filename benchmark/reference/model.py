"""The plain reference's greedy mapper: one read at a time, in Python.

Frozen copy of the mapper's executable spec of the greedy mode
(`model.py`), whose semantics are bgreat's (alignerGreedy.cpp):
  - anchors: the first `effort` read positions whose canonical
    (k-1)-mer is a junction key (aligner.cpp:345-378), with bgreat's
    N-encoding quirk in the forward register;
  - per anchor: extend left to the read start, then right to the read
    end with the rest of the mismatch budget; at each junction the
    candidate with the fewest mismatches on its window wins, the first
    on a tie; one candidate is followed, no backtracking;
  - if every anchor fails, the reverse-complemented read is tried once;
  - the path is the start offset in the first unitig, then signed
    unitig ids, printed "v." joined with a newline.
"""

from __future__ import annotations

import numpy as np

from .graph import Graph
from .seq import hamming, kmers_of, rc_codes, rcb

STATUS_ALIGNED_FWD = 1
STATUS_ALIGNED_RC = 2
STATUS_NO_OVERLAP_FWD = 3
STATUS_RC_NO_OVERLAP = 4
STATUS_FAILED = 5
ALIGNED = (STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC)


def scan_kmers(codes: np.ndarray, nm: np.ndarray, k1: int):
    """(forward, reverse-complement) (k-1)-mers per read position: the
    forward register takes an N as 3 in its first window and as 0 after
    it; the reverse one is rcb of the plain encoding."""
    bcodes = np.asarray(codes, dtype=np.uint8).copy()
    nm = np.asarray(nm, dtype=bool)
    if nm.any():
        roll_n = nm.copy()
        roll_n[:k1] = False
        bcodes[roll_n] = 0
    return kmers_of(bcodes, k1), rcb(kmers_of(codes, k1), k1)


def get_n_overlap(g: Graph, codes, nm, n: int) -> list:
    k1 = g.k - 1
    if len(codes) < k1:
        return []
    fwd, rc = scan_kmers(codes, nm, k1)
    out = []
    for i in range(len(fwd)):
        if g.has_junction(int(min(fwd[i], rc[i]))):
            out.append((int(fwd[i]), i))
            if len(out) >= n:
                break
    return out


def _rcb64(v: int, n: int) -> int:
    res = 0
    for _ in range(n):
        res = (res << 2) | (3 - (v & 3))
        v >>= 2
    return res


def _walk_left(g: Graph, codes, nm, num: int, pos: int, budget: int,
               path: list) -> int:
    """Extend left from the junction `num` at read position `pos` to the
    read start; appends signed ids in walk order, then the start offset.
    Returns the mismatches used, or budget + 1 on failure."""
    k1 = g.k - 1
    if pos == 0:
        path.append(0)
        return 0
    cands = g.get_end(num)
    best, best_j, best_ended, best_off = budget + 1, -1, False, 0
    for j, sid in enumerate(cands):
        u = g.unitig_codes(sid)
        ul = len(u)
        if ul - k1 >= pos:
            off = ul - pos - k1
            miss = hamming(codes[0:pos], u[off : off + pos], nm[0:pos])
            if miss < best:
                best, best_j, best_ended, best_off = miss, j, True, off
                if miss == 0:
                    break
        else:
            w = ul - k1
            miss = hamming(codes[pos - w : pos], u[0:w], nm[pos - w : pos])
            if miss < best:
                best, best_j, best_ended = miss, j, False
                if miss == 0:
                    break
    if best > budget:
        return best
    sid = cands[best_j]
    path.append(sid)
    if best_ended:
        path.append(best_off)
        return best
    ul = int(g.lengths[abs(sid)])
    nxt = int(g.ubeg[sid]) if sid > 0 else _rcb64(int(g.uend[-sid]), k1)
    return best + _walk_left(g, codes, nm, nxt, pos - (ul - k1),
                             budget - best, path)


def _walk_right(g: Graph, codes, nm, num: int, pos: int, budget: int,
                path: list, first: bool) -> int:
    """Extend right.  first: the anchor step (the junction's bases are
    trusted, the rest of the read begins at pos + k - 1); else the
    compare windows include the junction's bases."""
    k1 = g.k - 1
    L = len(codes)
    if first:
        start = pos + k1
        rem = L - start
        if rem == 0:
            return 0
        uskip = k1
    else:
        start = pos
        rem = L - start
        if rem < g.k:
            return 0
        uskip = 0
    cands = g.get_begin(num)
    best, best_j, best_ended = budget + 1, -1, False
    for j, sid in enumerate(cands):
        u = g.unitig_codes(sid)
        ul = len(u)
        if ul - k1 >= rem:
            miss = hamming(codes[start:L], u[uskip : uskip + rem],
                           nm[start:L])
            if miss < best:
                best, best_j, best_ended = miss, j, True
                if miss == 0:
                    break
        else:
            w = min(ul - uskip, L - start)
            miss = hamming(codes[start : start + w], u[uskip : uskip + w],
                           nm[start : start + w])
            if miss < best:
                best, best_j, best_ended = miss, j, False
                if miss == 0:
                    break
    if best > budget:
        return best
    sid = cands[best_j]
    path.append(sid)
    if best_ended:
        return best
    ul = int(g.lengths[abs(sid)])
    nxt = int(g.uend[sid]) if sid > 0 else _rcb64(int(g.ubeg[-sid]), k1)
    return best + _walk_right(g, codes, nm, nxt, pos + (ul - k1),
                              budget - best, path, False)


def _align_oriented(g: Graph, codes, nm, m: int, effort: int):
    anchors = get_n_overlap(g, codes, nm, effort)
    if not anchors:
        return "no_overlap", None
    for num, i in anchors:
        path_begin: list = []
        err_begin = _walk_left(g, codes, nm, num, i, m, path_begin)
        if err_begin <= m:
            path_end: list = []
            err_end = _walk_right(g, codes, nm, num, i, m - err_begin,
                                  path_end, True)
            if err_begin + err_end <= m:
                return "aligned", list(reversed(path_begin)) + path_end
    return "failed", None


def align_read_greedy(g: Graph, codes, nm, m: int, effort: int):
    """(status, path or None) of one read."""
    status, path = _align_oriented(g, codes, nm, m, effort)
    if status == "aligned":
        return STATUS_ALIGNED_FWD, path
    if status == "no_overlap":
        return STATUS_NO_OVERLAP_FWD, None
    rcc = rc_codes(codes)
    status, path = _align_oriented(g, rcc, np.zeros(len(codes), bool), m,
                                   effort)
    if status == "aligned":
        return STATUS_ALIGNED_RC, path
    if status == "no_overlap":
        return STATUS_RC_NO_OVERLAP, None
    return STATUS_FAILED, None


def format_path(path: list) -> bytes:
    return ("".join(f"{v}." for v in path) + "\n").encode()
