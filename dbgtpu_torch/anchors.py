"""Dog/anchor mode (-G) — executable specification.

Anchors are whole k-mers looked up in a table over (almost) every k-mer
of every unitig, instead of extremity (k-1)-mers; a hit pins the read to
a (unitig, offset) placement which is verified by direct Hamming
comparison and finished with the greedy end-extension machinery
(alignReadGreedyAnchors, alignerGreedy.cpp:60-164).

Behavioral contract kept from the reference:
  - the anchor table indexes canonical k-mers at unitig offsets
    j in [0, len-k-1] (the `j+k < len` bound EXCLUDES the final k-mer,
    aligner.cpp:434-443); last writer wins per canonical k-mer
    (aligner.cpp:466-476),
  - the first `effort` read positions whose canonical k-mer is in the
    table become anchors, in read order,
  - anchor orientation fix: if the unitig k-mer at the anchored offset
    does not equal the read k-mer, the unitig is reverse-complemented
    and the offset mirrored (alignerGreedy.cpp:75-82),
  - four placement cases (alignerGreedy.cpp:83-158):
      1. unitig contained in read: verify whole unitig, extend both ends,
      2. unitig overhangs the read end: verify prefix, extend left only,
      3. read overhangs the unitig end: verify suffix, extend right only,
      4. read contained in unitig: single Hamming check,
  - on failure of every anchor: one retry on the reverse-complemented
    read (alignerGreedy.cpp:161); statuses as in greedy mode.

Deviation (documented): the reference's rolling k-mer scan in
getNAnchors reuses (k-1)-mer-sized update registers (offsetUpdate =
4^(k-1), RC shift 2k-4; aligner.cpp:305-315, 381-405), so every scanned
value past read position 0 is wrong — anchors effectively exist only at
position 0 plus accidental MPHF false positives.  dbgtpu computes the
roll correctly at every position (strictly more reads align); there is
no bug-compat switch because replicating the false-positive pattern
would require bit-exact BooPHF internals for no user value.
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
from .model import _walk_left, _walk_right
from .seq import canonical, codes_to_kmer, hamming, kmers_of, rc_codes


def get_n_anchors(
    g: UnitigGraph, codes: np.ndarray, n: int
) -> List[Tuple[int, int, int]]:
    """First n (unitig_id, unitig_offset, read_pos) anchors whose
    canonical k-mer is indexed.  Correct rolling scan (see module
    docstring); N encodes as 3 throughout (str2num semantics)."""
    k = g.k
    if len(codes) < k:
        return []
    kms = kmers_of(codes, k)
    out: List[Tuple[int, int, int]] = []
    for i in range(len(kms)):
        hit = g.anchors.get(int(canonical(kms[i], k)))
        if hit is not None:
            out.append((hit[0], hit[1], i))
            if len(out) >= n:
                break
    return out


def _align_anchors_oriented(
    g: UnitigGraph,
    codes: np.ndarray,
    nm: np.ndarray,
    m: int,
    effort: int,
) -> Tuple[str, Optional[List[int]]]:
    k = g.k
    k1 = k - 1
    L = len(codes)
    anchors = get_n_anchors(g, codes, effort)
    if not anchors:
        return "no_overlap", None
    for uid, upos, rpos in anchors:
        u = g.unitig_codes(uid)
        if len(u) < k:
            continue  # reference guard, alignerGreedy.cpp:71-74
        if not np.array_equal(u[upos : upos + k], codes[rpos : rpos + k]):
            u = rc_codes(u)
            upos = len(u) - k - upos
            sid = -uid
        else:
            sid = uid
        ul = len(u)
        if rpos >= upos:
            rstart = rpos - upos  # unitig start within the read
            if L - rpos >= ul - upos:
                # CASE 1: unitig contained in the read
                errors = hamming(
                    codes[rstart : rstart + ul], u, nm[rstart : rstart + ul]
                )
                if errors <= m:
                    path_begin: List[int] = []
                    err_b = _walk_left(
                        g, codes, nm, int(codes_to_kmer(u[:k1])),
                        rstart, m - errors, path_begin,
                    )
                    if err_b + errors <= m:
                        path_end = [sid]
                        err_e = _walk_right(
                            g, codes, nm, int(codes_to_kmer(u[-k1:])),
                            rstart + ul - k1, m - errors - err_b,
                            path_end, True,
                        )
                        if err_b + errors + err_e <= m:
                            return "aligned", (
                                list(reversed(path_begin)) + path_end
                            )
            else:
                # CASE 2: unitig overhangs the read end
                w = L - rstart
                errors = hamming(codes[rstart:L], u[:w], nm[rstart:L])
                if errors <= m:
                    path_begin = []
                    err_b = _walk_left(
                        g, codes, nm, int(codes_to_kmer(u[:k1])),
                        rstart, m - errors, path_begin,
                    )
                    if err_b + errors <= m:
                        return "aligned", (
                            list(reversed(path_begin)) + [sid]
                        )
        else:
            offset = upos - rpos  # read start within the unitig
            if L - rpos >= ul - upos:
                # CASE 3: read overhangs the unitig end
                w = ul - offset
                errors = hamming(codes[0:w], u[offset:ul], nm[0:w])
                if errors <= m:
                    path_end = [offset, sid]
                    err_e = _walk_right(
                        g, codes, nm, int(codes_to_kmer(u[-k1:])),
                        rpos - upos + ul - k1, m - errors,
                        path_end, True,
                    )
                    if errors + err_e <= m:
                        return "aligned", path_end
            else:
                # CASE 4: read contained in the unitig
                errors = hamming(
                    codes, u[offset : offset + L], nm
                )
                if errors <= m:
                    return "aligned", [offset, sid]
    return "failed", None


def align_read_greedy_anchors(
    g: UnitigGraph,
    codes: np.ndarray,
    nm: np.ndarray,
    m: int,
    effort: int,
) -> Tuple[int, Optional[List[int]]]:
    """Align one read in anchor mode.  Returns (STATUS_*, path or None)."""
    status, path = _align_anchors_oriented(g, codes, nm, m, effort)
    if status == "aligned":
        return STATUS_ALIGNED_FWD, path
    if status == "no_overlap":
        return STATUS_NO_OVERLAP_FWD, None
    rcc = rc_codes(codes)
    rcn = np.zeros(len(codes), dtype=bool)
    status, path = _align_anchors_oriented(g, rcc, rcn, m, effort)
    if status == "aligned":
        return STATUS_ALIGNED_RC, path
    if status == "no_overlap":
        return STATUS_RC_NO_OVERLAP, None
    return STATUS_FAILED, None
