"""Executable specification of the greedy mapper.

Pure-python, one read at a time, defining the EXACT alignment semantics
the batched device engine must reproduce (copy of dbgtpu/model.py, which
is byte-parity-tested against the compiled reference binary).  The
runner recomputes rows over pmax with it, and chip_smoke.py holds the
kernels' output against it on the card.

Semantics captured from the reference (behavioral study, not a code
translation; citations are into the reference bgreat sources):
  - anchor scan: first `effort` read positions whose canonical
    (k-1)-mer is a unitig extremity (getNOverlap, aligner.cpp:345-378),
  - per anchor: extend LEFT to the read start, then RIGHT to the read
    end with the remaining mismatch budget (alignReadGreedy,
    alignerGreedy.cpp:35-57),
  - at each junction, up to 4 candidate unitigs are scored by Hamming
    distance on the overlapping window; the chosen candidate is the
    argmin with earliest-index tie-break (equivalent to the reference's
    first-exact-match short-circuit at alignerGreedy.cpp:183/233/281/333
    plus strict `miss < miniMiss` update),
  - greedy: exactly one candidate is followed per junction; failure
    deeper in the walk fails the whole anchor (no backtracking),
  - on failure of every anchor the reverse-complemented read is retried
    once (alignerGreedy.cpp:54); its path is emitted with no RC marker,
  - path = [start offset in first unitig] + signed unitig IDs
    (negative = reverse complement), printed "v." joined + newline.

Counter semantics (alignAll stats, aligner.cpp:588-596):
  - no anchors on the forward read: noOverlap++, NO RC retry,
  - anchors failed, RC read has no anchors: noOverlap++ (not notAligned),
  - anchors failed on both orientations: notAligned++,
  - success: aligned++.
All non-aligned reads are written to notAligned.fa (the reference's
noOverlap.fa is dead code behind `if(false)`, alignerGreedy.cpp:414).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .constants import (
    STATUS_ALIGNED_FWD,
    STATUS_ALIGNED_RC,
    STATUS_FAILED,
    STATUS_NO_OVERLAP_FWD,
    STATUS_RC_NO_OVERLAP,
)
from .index.build import UnitigGraph
from .seq import hamming, kmers_of, rc_codes, rcb


def scan_kmers(codes: np.ndarray, nm: np.ndarray, k1: int):
    """(fwd_kmers, rc_kmers) per read position, with the reference's
    N-encoding quirk.

    The reference's rolling anchor scan encodes N inconsistently: the
    initial window is built with str2num (N -> 3, utils.cpp:125) but
    rolled-in bases use nuc2int (N -> 0, utils.cpp:132-140), while the
    RC register's nuc2intrc treats N exactly like T (utils.cpp:143-151)
    so it remains the true RC of the N->3 encoding.  Net effect: the
    forward register sees N as 0 at positions >= k-1 and as 3 before;
    the RC register is rcb() of the plain N->3 encoding throughout.
    """
    bcodes = np.asarray(codes, dtype=np.uint8).copy()
    nm = np.asarray(nm, dtype=bool)
    if nm.any():
        roll_n = nm.copy()
        roll_n[: k1] = False  # initial-window bases keep N -> 3
        bcodes[roll_n] = 0
    fwd = kmers_of(bcodes, k1)
    rc = rcb(kmers_of(codes, k1), k1)
    return fwd, rc


def get_n_overlap(
    g: UnitigGraph, codes: np.ndarray, nm: np.ndarray, n: int
) -> List[Tuple[int, int]]:
    """First n read positions whose canonical (k-1)-mer is a junction.

    Returns [(forward_kmer_value, position), ...] where the forward
    value carries the reference's rolling N-encoding (see scan_kmers).
    """
    k1 = g.k - 1
    if len(codes) < k1:
        return []
    fwd, rc = scan_kmers(codes, nm, k1)
    out: List[Tuple[int, int]] = []
    for i in range(len(fwd)):
        rep = int(min(fwd[i], rc[i]))
        if g.has_junction(rep):
            out.append((int(fwd[i]), i))
            if len(out) >= n:
                break
    return out


def _walk_left(
    g: UnitigGraph,
    codes: np.ndarray,
    nm: np.ndarray,
    num: int,
    pos: int,
    budget: int,
    path: List[int],
) -> int:
    """Extend leftward from the junction (k-1)-mer `num` starting at read
    position `pos` down to the read start.  Appends signed unitig IDs in
    walk order and finally the start offset.  Returns mismatches used,
    or budget+1 on failure.  (checkBeginGreedy == mapOnLeftEndGreedy.)
    """
    k1 = g.k - 1
    if pos == 0:
        path.append(0)
        return 0
    cands = g.get_end(num)
    best = budget + 1
    best_j = -1
    best_ended = False
    best_off = 0
    for j, sid in enumerate(cands):
        u = g.unitig_codes(sid)
        ul = len(u)
        if ul - k1 >= pos:
            # unitig covers the rest of the read-left; compare its tail
            # window (excluding the trailing junction (k-1)-mer)
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
    return best + _walk_left(g, codes, nm, nxt, pos - (ul - k1), budget - best, path)


def _rcb64(v: int, n: int) -> int:
    res = 0
    for _ in range(n):
        res = (res << 2) | (3 - (v & 3))
        v >>= 2
    return res


def _walk_right(
    g: UnitigGraph,
    codes: np.ndarray,
    nm: np.ndarray,
    num: int,
    pos: int,
    budget: int,
    path: List[int],
    first: bool,
) -> int:
    """Extend rightward.  `first=True` is the anchor step (checkEndGreedy):
    `pos` is the junction start and the remaining read begins at
    pos+k-1, the junction chars are trusted.  `first=False`
    (mapOnRightEndGreedy): the remaining read begins at `pos` and the
    compare windows INCLUDE the junction chars.
    Returns mismatches used, or budget+1 on failure.
    """
    k1 = g.k - 1
    L = len(codes)
    if first:
        start = pos + k1  # where the un-trusted remaining read begins
        rem = L - start
        if rem == 0:
            return 0
        uskip = k1  # unitig chars to skip in compares
    else:
        start = pos
        rem = L - start
        if rem < g.k:
            return 0
        uskip = 0
    cands = g.get_begin(num)
    best = budget + 1
    best_j = -1
    best_ended = False
    for j, sid in enumerate(cands):
        u = g.unitig_codes(sid)
        ul = len(u)
        if ul - k1 >= rem:
            # unitig covers the rest of the read
            miss = hamming(
                codes[start:L], u[uskip : uskip + rem], nm[start:L]
            )
            if miss < best:
                best, best_j, best_ended = miss, j, True
                if miss == 0:
                    break
        else:
            # follow-through: compare up to the unitig end (window is
            # clamped by the read end in the non-first mode, mirroring
            # the reference's substr clamp at alignerGreedy.cpp:243)
            w = min(ul - uskip, L - start)
            miss = hamming(
                codes[start : start + w], u[uskip : uskip + w],
                nm[start : start + w],
            )
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
    return best + _walk_right(
        g, codes, nm, nxt, pos + (ul - k1), budget - best, path, False
    )


def _align_oriented(
    g: UnitigGraph,
    codes: np.ndarray,
    nm: np.ndarray,
    m: int,
    effort: int,
) -> Tuple[str, Optional[List[int]]]:
    anchors = get_n_overlap(g, codes, nm, effort)
    if not anchors:
        return "no_overlap", None
    for num, i in anchors:
        path_begin: List[int] = []
        err_begin = _walk_left(g, codes, nm, num, i, m, path_begin)
        if err_begin <= m:
            path_end: List[int] = []
            err_end = _walk_right(
                g, codes, nm, num, i, m - err_begin, path_end, True
            )
            if err_begin + err_end <= m:
                return "aligned", list(reversed(path_begin)) + path_end
    return "failed", None


def align_read_greedy(
    g: UnitigGraph,
    codes: np.ndarray,
    nm: np.ndarray,
    m: int,
    effort: int,
) -> Tuple[int, Optional[List[int]]]:
    """Align one read.  Returns (STATUS_*, path or None).

    A path returned for STATUS_ALIGNED_RC refers to the RC'd read (the
    reference emits it with no RC marker).
    """
    status, path = _align_oriented(g, codes, nm, m, effort)
    if status == "aligned":
        return STATUS_ALIGNED_FWD, path
    if status == "no_overlap":
        return STATUS_NO_OVERLAP_FWD, None
    rcc = rc_codes(codes)
    rcn = np.zeros(len(codes), dtype=bool)  # RC('N') == literal 'A'
    status, path = _align_oriented(g, rcc, rcn, m, effort)
    if status == "aligned":
        return STATUS_ALIGNED_RC, path
    if status == "no_overlap":
        return STATUS_RC_NO_OVERLAP, None
    return STATUS_FAILED, None


def format_path(path: List[int]) -> bytes:
    """'offset.' + signed IDs each '.'-terminated + newline
    (reference printPath, aligner.cpp:600-609)."""
    return ("".join(f"{v}." for v in path) + "\n").encode()


def recover_path(g: UnitigGraph, path: List[int], read_len: int) -> np.ndarray:
    """Correction mode: splice the unitigs along the path and slice the
    [offset, offset+read_len) window (recoverPath, aligner.cpp:270-290)."""
    k1 = g.k - 1
    offset = path[0]
    seq = g.unitig_codes(path[1])
    for sid in path[2:]:
        u = g.unitig_codes(sid)
        if np.array_equal(seq[-k1:], u[:k1]):
            seq = np.concatenate([seq, u[k1:]])
        else:
            ru = rc_codes(u)
            if np.array_equal(seq[-k1:], ru[:k1]):
                seq = np.concatenate([seq, ru[k1:]])
            else:
                raise RuntimeError("path splice inconsistency")
    return seq[offset : offset + read_len]
