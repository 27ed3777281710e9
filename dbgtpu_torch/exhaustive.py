"""Exhaustive (branch-and-bound) aligner — executable specification.

Mirrors the reference's `-b` mode search semantics (alignerExhaustive.cpp)
while producing *useful* output: the reference's exhaustive thread body
computes paths and then discards them (string printPath result unused at
alignerExhaustive.cpp:283-287, failure streams never opened, aligner.h:84-88
— verified empirically: `-b` writes empty files).  dbgtpu instead emits
the found path in the same `offset.` + signed-ID format as greedy mode.

Search semantics kept from the reference:
  - anchors: EVERY read position, in order (getListOverlap's `if(true)`
    placeholder, aligner.cpp:318-342 — the MPHF result is ignored, and
    non-junction anchors simply yield zero candidates downstream),
  - at each junction every candidate (<=4) is explored: candidates whose
    unitig covers the remaining read are scored directly; others are
    scored on their span and the walk RECURSES with the reduced budget,
    keeping the strict minimum (`miss < miniMiss`, earliest candidate on
    ties; no exact-match short-circuit, unlike greedy),
  - NO reverse-complement retry (alignReadExhaustive has none),
  - `partial=True` (-i): a right-extension junction with zero candidates
    is accepted as a (partial) alignment (alignerExhaustive.cpp:217-221).

Deviations (documented, deliberate):
  - output is written (see above); path format normalized to greedy's
    [offset, ids...] — the reference's dead write path would have emitted
    stray trailing values (readLeft.size()+k-1 pushes at
    alignerExhaustive.cpp:99,231) and a missing leading offset when the
    left walk lands exactly on the read start (alignerExhaustive.cpp:112),
  - a successful LEFT walk that lands exactly on read start records
    offset 0 explicitly.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .constants import (
    STATUS_ALIGNED_FWD,
    STATUS_FAILED,
    STATUS_NO_OVERLAP_FWD,
)
from .index.build import UnitigGraph
from .model import scan_kmers, _rcb64
from .seq import hamming


def get_list_overlap(
    g: UnitigGraph, codes: np.ndarray, nm: np.ndarray
) -> List[Tuple[int, int]]:
    """Every read position with its forward (k-1)-mer value (the
    reference's rolling N-quirk included via scan_kmers)."""
    k1 = g.k - 1
    if len(codes) < k1:
        return []
    fwd, _ = scan_kmers(codes, nm, k1)
    return [(int(fwd[i]), i) for i in range(len(fwd))]


def _walk_left_exh(
    g: UnitigGraph,
    codes: np.ndarray,
    nm: np.ndarray,
    num: int,
    pos: int,
    budget: int,
    used: frozenset | None = None,
) -> Tuple[int, List[int]]:
    """Exhaustive left extension from junction (k-1)-mer `num` at read
    position `pos`.  Returns (mismatches, path_prefix) where path_prefix
    is [offset, deepest_id, ..., nearest_id]; mismatches > budget on
    failure.  (checkBeginExhaustive/mapOnLeftEndExhaustive semantics.)

    `used` (path mode): signed unitig IDs already on the walk are
    skipped — the simple-path constraint of alignerPaths.cpp:370-371.
    """
    k1 = g.k - 1
    if pos == 0:
        return 0, [0]
    cands = g.get_end(num)
    best = budget + 1
    best_path: List[int] = []
    for sid in cands:
        if used is not None and sid in used:
            continue
        u = g.unitig_codes(sid)
        ul = len(u)
        if ul - k1 >= pos:
            off = ul - pos - k1
            miss = hamming(codes[0:pos], u[off : off + pos], nm[0:pos])
            if miss < best:
                best = miss
                best_path = [off, sid]
        else:
            w = ul - k1
            miss = hamming(codes[pos - w : pos], u[0:w], nm[pos - w : pos])
            if miss < best:
                nxt = (
                    int(g.ubeg[sid]) if sid > 0
                    else _rcb64(int(g.uend[-sid]), k1)
                )
                sub, sub_path = _walk_left_exh(
                    g, codes, nm, nxt, pos - w, budget - miss,
                    used | {sid} if used is not None else None,
                )
                miss += sub
                if miss < best:
                    best = miss
                    best_path = sub_path + [sid]
    return best, best_path


def _walk_right_exh(
    g: UnitigGraph,
    codes: np.ndarray,
    nm: np.ndarray,
    num: int,
    pos: int,
    budget: int,
    partial: bool,
    first: bool,
    used: frozenset | None = None,
) -> Tuple[int, List[int]]:
    """Exhaustive right extension; `pos` is the junction start (the
    remaining read begins at pos+k-1).  Returns (mismatches, id_list).
    (checkEndExhaustive/mapOnRightEndExhaustive semantics; both compare
    from unitig.substr(k-1), so `first` only gates the partial check.)

    `used`: simple-path filter (path mode), as in _walk_left_exh.
    """
    k1 = g.k - 1
    L = len(codes)
    start = pos + k1
    rem = L - start
    if rem == 0:
        return 0, []
    cands = g.get_begin(num)
    if partial and first and not cands:
        # reference: partial & rangeUnitigs.empty() -> accept as-is
        return 0, []
    best = budget + 1
    best_path: List[int] = []
    for sid in cands:
        if used is not None and sid in used:
            continue
        u = g.unitig_codes(sid)
        ul = len(u)
        if ul - k1 >= rem:
            miss = hamming(
                codes[start:L], u[k1 : k1 + rem], nm[start:L]
            )
            if miss < best:
                best = miss
                best_path = [sid]
        else:
            w = ul - k1
            miss = hamming(
                codes[start : start + w], u[k1:ul], nm[start : start + w]
            )
            if miss < best:
                nxt = (
                    int(g.uend[sid]) if sid > 0
                    else _rcb64(int(g.ubeg[-sid]), k1)
                )
                sub, sub_path = _walk_right_exh(
                    g, codes, nm, nxt, pos + w, budget - miss,
                    partial, False,
                    used | {sid} if used is not None else None,
                )
                miss += sub
                if miss < best:
                    best = miss
                    best_path = [sid] + sub_path
    return best, best_path


def align_read_exhaustive(
    g: UnitigGraph,
    codes: np.ndarray,
    nm: np.ndarray,
    m: int,
    partial: bool = False,
) -> Tuple[int, Optional[List[int]]]:
    """Align one read exhaustively.  Returns (STATUS_*, path or None).
    No RC retry (matching alignReadExhaustive, alignerExhaustive.cpp:35-58).
    """
    anchors = get_list_overlap(g, codes, nm)
    if not anchors:
        return STATUS_NO_OVERLAP_FWD, None
    for num, i in anchors:
        err_b, path_begin = _walk_left_exh(g, codes, nm, num, i, m)
        if err_b <= m:
            err_e, path_end = _walk_right_exh(
                g, codes, nm, num, i, m - err_b, partial, True
            )
            if err_b + err_e <= m:
                return STATUS_ALIGNED_FWD, path_begin + path_end
    return STATUS_FAILED, None
