"""Path mode (-p): simple-path alignment — executable specification
(copy of dbgtpu/paths_mode.py; the mode has no device engine in either
package and runs on the host through spec.run_pipeline).

The reference ships a 460-line path-mode aligner (alignerPaths.cpp)
that is UNREACHABLE from its CLI: `p` sits in the getopt string but has
no case handler (bgreat.cpp:67-109), so `pathOption` is always false.
dbgtpu implements the mode and wires a working `-p` flag.

Semantics (behavioral study of alignerPaths.cpp):
  - the constraint: a signed unitig ID may appear at most once on the
    path — walks are simple paths, not arbitrary walks (the candidate
    filter at alignerPaths.cpp:136-137, 187-188, 307-308, 370-371).
    A unitig CAN appear twice in opposite orientations (membership is
    on the signed ID), which we preserve.
  - `exhaustive_path` (alignReadExhaustivePath, :66-88): the exhaustive
    search of exhaustive.py with the no-revisit filter threaded
    through both walks; anchors = every read position; no RC retry.
  - `greedy_path` (alignReadGreedyPath, :35-63): anchor-pair stitching
    — align the read START via the left walk from one of the first
    `effort` anchors, the read END via the right walk from one of the
    last `effort` anchors, then COVER the middle by hopping anchor to
    anchor: consecutive anchor junctions either share one unitig whose
    interior exactly spans the gap (checkPairPaths, :237-286) or are
    bridged by a bounded greedy walk (mapOnRightPath, :178-234).

Documented deviations from the (dead) reference code:
  - the reference's membership check scans the mixed path vector, so
    previously-pushed OFFSET integers can shadow unitig IDs
    (find() over a vector holding both, alignerPaths.cpp:247 vs :402);
    we track a proper visited-ID set,
  - its dead write path would emit the same stray trailing values as
    exhaustive mode; our output is the normalized [offset, ids...],
  - the middle-cover bookkeeping is reimplemented as a clean
    anchor-index loop with identical candidate preference order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .constants import (
    STATUS_ALIGNED_FWD,
    STATUS_FAILED,
    STATUS_NO_OVERLAP_FWD,
)
from .exhaustive import (
    _walk_left_exh,
    _walk_right_exh,
    get_list_overlap,
)
from .index.build import UnitigGraph
from .seq import hamming


def align_read_exhaustive_path(
    g: UnitigGraph,
    codes: np.ndarray,
    nm: np.ndarray,
    m: int,
    partial: bool = False,
) -> Tuple[int, Optional[List[int]]]:
    """Simple-path exhaustive alignment (alignReadExhaustivePath)."""
    anchors = get_list_overlap(g, codes, nm)
    if not anchors:
        return STATUS_NO_OVERLAP_FWD, None
    empty: frozenset = frozenset()
    for num, i in anchors:
        err_b, path_begin = _walk_left_exh(
            g, codes, nm, num, i, m, used=empty
        )
        if err_b <= m:
            used = frozenset(v for v in path_begin[1:])
            err_e, path_end = _walk_right_exh(
                g, codes, nm, num, i, m - err_b, partial, True, used=used
            )
            if err_b + err_e <= m:
                return STATUS_ALIGNED_FWD, path_begin + path_end
    return STATUS_FAILED, None


def _check_pair(
    g: UnitigGraph,
    codes: np.ndarray,
    nm: np.ndarray,
    a1: Tuple[int, int],
    a2: Tuple[int, int],
    budget: int,
    used: frozenset,
) -> Tuple[int, Optional[int]]:
    """Can anchors a1 -> a2 be joined by ONE unitig?  (checkPairPaths.)

    Returns (mismatches, signed_id or None).  Close anchors (< k apart)
    join for free when the junction sets share a unitig; wider gaps
    require a shared unitig whose interior exactly spans the gap and is
    Hamming-checked against the read.
    """
    k = g.k
    k1 = k - 1
    (num1, p1), (num2, p2) = a1, a2
    succ = g.get_begin(num1)
    pred = g.get_end(num2)
    gap = p2 - p1
    if gap < k:
        for sid in succ:
            if sid in pred:
                return 0, (sid if sid not in used else None)
        return budget + 1, None
    best = budget + 1
    best_id: Optional[int] = None
    for sid in succ:
        if sid in pred and sid not in used:
            u = g.unitig_codes(sid)
            span = gap - k1
            if len(u) - 2 * k1 == span:
                miss = hamming(
                    codes[p1 + k1 : p2], u[k1 : k1 + span],
                    nm[p1 + k1 : p2],
                )
                if miss < best:
                    best = miss
                    best_id = sid
    return best, best_id


def _cover_middle(
    g: UnitigGraph,
    codes: np.ndarray,
    nm: np.ndarray,
    anchors: List[Tuple[int, int]],
    start: int,
    end: int,
    budget: int,
    effort: int,
    used: frozenset,
    path: List[int],
) -> int:
    """Stitch anchors[start] .. anchors[end] (coverGreedyPath).
    Returns mismatches used (> budget on failure); appends IDs."""
    from .model import _rcb64

    k1 = g.k - 1
    while start < end:
        # 1) try to hop to one of the next `effort` anchors directly
        best = budget + 1
        best_i = 0
        best_id: Optional[int] = None
        for i in range(1, effort + 1):
            if start + i > end:
                break
            miss, sid = _check_pair(
                g, codes, nm, anchors[start], anchors[start + i],
                budget, used,
            )
            if miss < best:
                best, best_i, best_id = miss, i, sid
        if best <= budget:
            if best_id is not None:
                path.append(best_id)
                used = used | {best_id}
            budget -= best
            start += best_i
            continue
        # 2) bounded greedy walk right (mapOnRightPath): follow the
        # min-mismatch unvisited successor one unitig, resync if we
        # land exactly on a later anchor
        num, pos = anchors[start]
        cands = [s for s in g.get_begin(num) if s not in used]
        L = len(codes)
        rem_start = pos + k1
        best = budget + 1
        best_sid = None
        best_end = False
        for sid in cands:
            u = g.unitig_codes(sid)
            ul = len(u)
            w = ul - k1
            if L - rem_start <= w:
                miss = hamming(
                    codes[rem_start:L], u[k1 : k1 + L - rem_start],
                    nm[rem_start:L],
                )
                if miss < best:
                    best, best_sid, best_end = miss, sid, True
            else:
                miss = hamming(
                    codes[rem_start : rem_start + w], u[k1:ul],
                    nm[rem_start : rem_start + w],
                )
                if miss < best:
                    best, best_sid, best_end = miss, sid, False
        if best > budget or best_sid is None:
            return budget + 1
        path.append(best_sid)
        used = used | {best_sid}
        budget -= best
        if best_end:
            return 0  # reached the read end inside the cover
        ul = int(g.lengths[abs(best_sid)])
        nxt = (
            int(g.uend[best_sid]) if best_sid > 0
            else _rcb64(int(g.ubeg[-best_sid]), k1)
        )
        pos += ul - k1
        # resync: does this junction coincide with a later anchor?
        moved = False
        for j in range(start + 1, len(anchors)):
            if anchors[j] == (nxt, pos):
                start = j
                moved = True
                break
        if not moved:
            # continue from a synthetic anchor at the new junction
            anchors = (
                anchors[: start + 1] + [(nxt, pos)] + anchors[start + 1 :]
            )
            start += 1
            end += 1
    return 0


def align_read_greedy_path(
    g: UnitigGraph,
    codes: np.ndarray,
    nm: np.ndarray,
    m: int,
    effort: int,
    partial: bool = False,
) -> Tuple[int, Optional[List[int]]]:
    """Anchor-pair stitched simple-path alignment (alignReadGreedyPath).
    No RC retry (the reference's is commented out, alignerPaths.cpp:59).

    Deviation (documented): anchors are filtered to *verified junction*
    positions (the getNOverlap scan, uncapped) instead of the
    reference's every-position unverified list — with unverified
    anchors the middle cover almost always dead-ends on empty
    neighbor sets (the code is unreachable in the reference and was
    clearly never exercised); junction-filtered anchors make the
    stitching heuristic actually work.
    """
    from .model import get_n_overlap

    anchors = get_n_overlap(g, codes, nm, len(codes))
    if not anchors:
        return STATUS_NO_OVERLAP_FWD, None
    n = len(anchors)
    for start in range(min(effort, n)):
        err_b, path_begin = _walk_left_exh(
            g, codes, nm, anchors[start][0], anchors[start][1], m,
            used=frozenset(),
        )
        if err_b > m:
            continue
        for end in range(n - 1, max(start, n - effort) - 1, -1):
            used = frozenset(path_begin[1:])
            err_e, path_end = _walk_right_exh(
                g, codes, nm, anchors[end][0], anchors[end][1],
                m - err_b, partial, True, used=used,
            )
            if err_b + err_e > m:
                continue
            used = used | frozenset(path_end)
            mid: List[int] = []
            err_c = _cover_middle(
                g, codes, nm, anchors, start, end,
                m - err_b - err_e, effort, used, mid,
            )
            if err_b + err_e + err_c <= m:
                return (
                    STATUS_ALIGNED_FWD,
                    path_begin + mid + path_end,
                )
    return STATUS_FAILED, None
