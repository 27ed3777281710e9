"""K3 greedy_walk: the greedy junction walk from per-anchor inits.

Counterpart of dbgtpu/engine/core.py _run_walks in its general form
(bookkeep, junction, final flush), with _junction_probe, _junction_vals
(either index layout) and _window_miss.  A walk starts from one
initial state per anchor (`Inits`, core.py:1112-1128): greedy mode is
the special case (LEFT at the anchor, budget m, nothing preloaded) whose
anchors are the first / last E junction hits of the scan
(_first_k_hits / _last_k_hits_rc); dog mode (-G) precomputes the inits
in K5 (engine/dog.py).  The kernel is csrc/walk.cu (one thread per read,
walking to completion) with two entry points, one per way the inits
arrive; `walk_inits_ref` is its plain torch version, a vectorized
lockstep loop over the batch without the JAX engine's tail compaction.

On an index cut over cards (`--shard-index`) the greedy entry reads the
junction table by one of two paths that a host plan (`walk_plan`) picks
for the batch: direct (each remote row read over NVLink where it lies,
once per evaluation of it) or staged (`walk_stage`: as the batch starts,
every row of the table's remote ranges crosses NVLink once into a stage
on the reading card, on a side stream beside K1 and K2, and K3 walks from
there on its own copy of the index struct).  On the CPU `walk_ref` is the
plain version of both.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..constants import (
    STATUS_ALIGNED_FWD,
    STATUS_ALIGNED_RC,
    STATUS_FAILED,
    STATUS_NO_OVERLAP_FWD,
    STATUS_RC_NO_OVERLAP,
)
from ..kernels import build
from ..kernels.measure import HBM_BYTES_PER_S, NVLINK_BYTES_PER_S
from .index import (
    C_BEG_HI, C_BEG_LO, C_END_HI, C_END_LO, C_RCB_HI, C_RCB_LO, C_RCE_HI,
    C_RCE_LO, C_ULEN, C_UOFF, META_COLS, IndexTensors, c_index_arg,
)
from .kmer import M32, rcb_ref
from .member import junction_vals_ref
from .read_scan import Scan, unpack_fields
from .shard import ShardPlan, shard_plan, stage_ranges_launch

# K3's greedy wrapper calls on CUDA by its path ("direct": the junction
# table read where it lies, "staged": from the batch's stage); a run's
# check that it took the plan's path
calls = {"direct": 0, "staged": 0}

# walk phases (core.py _FETCH .. _DONE)
FETCH, LEFT, RFIRST, RCONT, DONE = 0, 1, 2, 3, 4
BIG = 1 << 30
CHUNK_SHIFT = 7            # log2(index.device.CHUNK_BASES)


class Walks(NamedTuple):
    status: torch.Tensor   # int32 [B]
    orient: torch.Tensor   # int32 [B] 0 forward, 1 reverse complement
    offset: torch.Tensor   # int32 [B] start offset in the first unitig
    llen: torch.Tensor     # int32 [B] entries of lbuf in use
    rlen: torch.Tensor     # int32 [B] entries of rbuf in use
    lbuf: torch.Tensor     # int32 [B, P] left-walk ids in walk order;
    #                        only [:llen] is meaningful
    rbuf: torch.Tensor     # int32 [B, P] right-walk ids; only [:rlen]


def max_iters_for(effort: int, L: int) -> int:
    """Junction-step cap of a read (core.align_batch :937-938)."""
    return 2 * effort * 2 * L + 64


def _anchors(member: torch.Tensor, vals: torch.Tensor, E: int,
             from_end: bool):
    """First (or last) E hits per row: (hit column [B, E], value [B, E],
    count [B]) — core._first_k_hits / _last_k_hits_rc."""
    memi = member.to(torch.int64)
    cum = memi.cumsum(dim=1)
    total = cum[:, -1:]
    rank = total - cum + memi if from_end else cum
    col = torch.arange(member.shape[1], device=member.device)[None, :]
    pos, val = [], []
    for e in range(E):
        sel = (rank == e + 1) & member.bool()
        pos.append(torch.where(sel, col, 0).sum(dim=1))
        val.append(torch.where(sel, vals, 0).sum(dim=1))
    if E:
        return torch.stack(pos, 1), torch.stack(val, 1), total[:, 0].clamp(max=E)
    z = torch.zeros((member.shape[0], 0), dtype=torch.int64,
                    device=member.device)
    return z, z, torch.zeros_like(total[:, 0])


def _window_miss_ref(ix: IndexTensors, meta, is_fwd, ustart, rstart, w,
                     rcodes, ncodes, L: int):
    """Hamming distance over each candidate's window [B, C], base by
    base (core._window_miss): unitig bases [ustart, ustart+w) against
    read bases [rstart, rstart+w), plus the positions set in ncodes (the
    N-mask on forward walks, zeros on RC walks)."""
    SW = ix.seq_words
    if SW > 0:
        fwd = unpack_fields(
            meta[..., META_COLS : META_COLS + SW].reshape(-1, SW), 2, 16 * SW)
        rc = unpack_fields(
            meta[..., META_COLS + SW : META_COLS + 2 * SW].reshape(-1, SW), 2,
            16 * SW)
        useq = torch.where(is_fwd.reshape(-1, 1), fwd, rc)
        ustart_ = ustart.reshape(-1)
    else:
        RW = ix.pool_rows.shape[1]
        g = meta[..., C_UOFF].to(torch.int64) + ustart
        r = (g >> CHUNK_SHIFT) + torch.where(is_fwd, 0, ix.n_chunks)
        useq = unpack_fields(ix.pool_rows[r.clamp(min=0)].reshape(-1, RW), 2,
                             16 * RW)
        ustart_ = (g & ((1 << CHUNK_SHIFT) - 1)).reshape(-1)
    B, C = is_fwd.shape
    t = torch.arange(L, device=rcodes.device)[None, :]
    ui = (ustart_[:, None] + t).clamp(0, useq.shape[1] - 1)
    ub = useq.gather(1, ui).reshape(B, C, L)
    ri = (rstart[..., None] + t[None]).clamp(0, rcodes.shape[1] - 1)
    rb = rcodes[:, None, :].expand(B, C, -1).gather(2, ri)
    bad = (ub != rb) | ncodes[:, None, :].expand(B, C, -1).gather(2, ri).bool()
    inwin = t[None] < w[..., None]
    return (bad & inwin).sum(dim=2)


INIT_FIELDS = ("ph0", "cur0", "pos0", "ra", "ra_pos", "bud0", "off0", "r0",
               "st0")


class Inits(NamedTuple):
    """Per-anchor initial walk states (core._run_walks `env`).  planes is
    int64 [9, 2, B, E]: INIT_FIELDS in order, [.., 0, ..] the forward
    anchors, [.., 1, ..] the RC anchors.  ph0 initial phase (LEFT,
    RFIRST or DONE); cur0 / pos0 initial (k-1)-mer and read position;
    ra / ra_pos the right-walk restart point; bud0 initial budget
    (negative: the anchor already failed); off0 preset offset; r0 signed
    id preloaded into rbuf[0] (0: none); st0 status recorded when ph0 is
    DONE.  Rows e >= n_f (n_r) are never read."""
    planes: torch.Tensor
    n_f: torch.Tensor      # int32 [B] forward anchors, <= E
    n_r: torch.Tensor      # int32 [B] RC anchors, <= E

    def field(self, name: str) -> torch.Tensor:
        return self.planes[INIT_FIELDS.index(name)]


def greedy_inits_ref(scan: Scan, member1, member2, lens, *, k: int, m: int,
                     effort: int, counts: dict | None = None) -> Inits:
    """Greedy inits (core.align_batch :1059-1091): the first E member1
    hits with their bug values, the last E member2 hits mapped to RC
    positions with their rc values; LEFT at the anchor, budget m.
    `counts`, when given, gets the sectors of bug and rcs read at those
    anchors (count_read_sectors)."""
    E = effort
    lens = lens.to(torch.int64)
    apos_f, aval_f, n_f = _anchors(member1, scan.bug, E, from_end=False)
    col_r, aval_r, n_r = _anchors(member2, scan.rcs, E, from_end=True)
    if counts is not None:
        B = member1.shape[0]
        rows = torch.arange(B, device=member1.device)[:, None].expand(B, E)
        for plane, col, n in ((scan.bug, apos_f, n_f), (scan.rcs, col_r, n_r)):
            used = torch.arange(E, device=col.device)[None, :] < n[:, None]
            read = torch.zeros(plane.shape, dtype=torch.bool,
                               device=plane.device)
            read[rows[used], col[used]] = True
            count_read_sectors(plane, read, counts)
    apos_r = lens[:, None] - (k - 1) - col_r
    cur = torch.stack([aval_f, aval_r])
    pos = torch.stack([apos_f, apos_r])
    const = torch.zeros_like(pos)
    planes = torch.stack([const + LEFT, cur, pos, cur, pos, const + m, const,
                          const, const])
    return Inits(planes, n_f.to(torch.int32), n_r.to(torch.int32))


def junction_probe_ref(ix: IndexTensors, mL, mRF, cur, pos, lens, rcodes,
                       ncodes, *, k1: int, L: int) -> dict:
    """core._junction_probe for the phases in (mL, mRF) (RCONT where
    neither): candidate lookup of the (k-1)-mer `cur` plus the windowed
    Hamming of its <= 4 candidates against the read codes `rcodes` [B, L]
    (N-mask `ncodes`).  Returns int64/bool [B, 4] arrays: valid, sid,
    miss (BIG where invalid), ended, ul, ust, nxt_l, nxt_r, and for
    counting what the probe reads (`count_probe`) found [B], cand (the
    candidate ids), win (window lengths), is_fwd and uoff."""
    B = cur.shape[0]
    rc = rcb_ref(cur, k1)
    is_canon = cur <= rc
    found, vals8 = junction_vals_ref(ix, torch.where(is_canon, cur, rc))
    use_right = torch.where(mL, is_canon, ~is_canon)
    cands = torch.where(use_right[:, None], vals8[:, 4:8], vals8[:, :4])
    cands = torch.where(found[:, None], cands, 0)
    valid = cands > 0
    meta = ix.umeta[cands.clamp(min=0)].to(torch.int64)   # [B, 4, C]

    def kmer(c_hi, c_lo):
        return ((meta[..., c_hi] & M32) << 32) | (meta[..., c_lo] & M32)

    ul = meta[..., C_ULEN]
    beg, end = kmer(C_BEG_HI, C_BEG_LO), kmer(C_END_HI, C_END_LO)
    is_fwd = torch.where(mL[:, None], end, beg) == cur[:, None]
    rem = torch.where(mL, pos, torch.where(mRF, lens - pos - k1,
                                           lens - pos))[:, None]
    mLc, mRFc = mL[:, None], mRF[:, None]
    ended = (ul - k1) >= rem
    ustart = torch.where(mLc & ended, ul - rem - k1,
                         torch.where(mRFc, k1, 0))
    rstart = torch.where(
        mLc, torch.where(ended, 0, pos[:, None] - (ul - k1)),
        torch.where(mRFc, (pos + k1)[:, None], pos[:, None]))
    w = torch.where(ended, rem, torch.where(mLc | mRFc, ul - k1,
                                            torch.minimum(ul, rem)))
    miss = _window_miss_ref(ix, meta, is_fwd, ustart, rstart, w, rcodes,
                            ncodes, L)
    return dict(
        valid=valid,
        sid=torch.where(is_fwd, cands, -cands),
        miss=torch.where(valid, miss, BIG),
        ended=ended,
        ul=ul,
        ust=ustart,
        nxt_l=torch.where(is_fwd, beg, kmer(C_RCE_HI, C_RCE_LO)),
        nxt_r=torch.where(is_fwd, end, kmer(C_RCB_HI, C_RCB_LO)),
        found=found, cand=cands, win=w, is_fwd=is_fwd, uoff=meta[..., C_UOFF],
    )


SECTOR = 32       # bytes of one device memory sector
HEADER_WORDS = 10  # umeta words a candidate reads: C_UOFF .. C_RCE_LO
MPHF_LOOKUP_BYTES = 20 + 40   # an MPHF lookup: its level row, its jrows row


def _sectors(byte_lo, byte_hi):
    """32-byte sectors spanned by the byte ranges [lo, hi) (hi > lo)."""
    return (byte_hi - 1) // SECTOR - byte_lo // SECTOR + 1


def count_probe(ix: IndexTensors, p: dict, evaluated, counts: dict) -> None:
    """Add to `counts` what the junction evaluations of the reads in
    `evaluated` [B] read (p: junction_probe_ref's result for them):
    evals, the lookups that found their key, the valid candidates, their
    16-base window words, and the 32-byte sectors of each valid
    candidate's umeta header and window words (the unitig's embedded
    words, or its pool chunk row's).  Sector addresses count from the
    start of each table."""
    ok = evaluated[:, None] & p["valid"]
    cand, win, ust = p["cand"], p["win"], p["ust"]
    nw = torch.where(win > 0, (win + 15) // 16, 0)
    ucols = ix.umeta.shape[1]
    row0 = 4 * cand * ucols
    head = _sectors(row0, row0 + 4 * HEADER_WORDS)
    SW = ix.seq_words
    if SW > 0:
        base = cand * ucols + META_COLS + torch.where(p["is_fwd"], 0, SW)
        s0, nsrc = ust, SW
    else:
        RW = ix.pool_rows.shape[1]
        g = p["uoff"] + ust
        r = ((g >> CHUNK_SHIFT) + torch.where(p["is_fwd"], 0, ix.n_chunks)
             ).clamp(min=0)
        base = r * RW
        s0, nsrc = g & ((1 << CHUNK_SHIFT) - 1), RW
    # window_miss reads word i = s >> 4 of each 16-base step, and i + 1
    # where the step is not word-aligned, inside [0, nsrc)
    w_lo = (s0 >> 4).clamp(0, nsrc - 1)
    w_hi = (((s0 + 16 * (nw - 1)) >> 4) + ((s0 & 15) != 0).to(torch.int64)
            ).clamp(0, nsrc - 1)
    b_lo, b_hi = 4 * (base + w_lo), 4 * (base + w_hi + 1)
    wsec = torch.where(nw > 0, _sectors(b_lo, b_hi), 0)
    if SW > 0:   # header and window share a sector where they meet
        wsec = wsec - ((nw > 0) & ((row0 + 4 * HEADER_WORDS - 1) // SECTOR
                                   == b_lo // SECTOR)).to(torch.int64)
    for key, v in (("evals", evaluated), ("found", evaluated & p["found"]),
                   ("cands", ok), ("words", torch.where(ok, nw, 0)),
                   ("sectors", torch.where(ok, head + wsec, 0))):
        counts[key] = counts.get(key, 0) + int(v.sum())


def probe_bytes(ix: IndexTensors, counts: dict) -> tuple[int, int]:
    """(junction, other): the bytes that the junction evaluations counted
    in `counts` (count_probe's keys) must read, of the junction table and
    of the rest.  Per evaluation the junction row's S key-hi words and,
    where the key was found, a key-lo sector and a values sector (MPHF
    layout: the level row and the jrows row); per valid candidate the
    sectors of its umeta header and window words (umeta or the pool).
    Only the junction table is cut over cards under `--shard-index`
    (engine/index.py sharded_index_tensors): umeta and the pool are
    replicated, so `other` never crosses NVLink."""
    n = counts.get("evals", 0)
    if ix.mph_meta is not None:
        junction = n * MPHF_LOOKUP_BYTES
    else:
        junction = n * ix.st_slots * 4 + counts.get("found", 0) * 2 * SECTOR
    return junction, counts.get("sectors", 0) * SECTOR


def count_read_sectors(plane, read, counts: dict) -> None:
    """Add to counts["anchor_sectors"] the 32-byte sectors of `plane`
    [B, Lk] that reading its elements where `read` (bool [B, Lk]) is set
    takes, each sector once: what a function that reads an input once
    must move for those elements."""
    flat = torch.nonzero(read.reshape(-1))[:, 0]
    sectors = torch.unique(flat * plane.element_size() // SECTOR)
    counts["anchor_sectors"] = (counts.get("anchor_sectors", 0)
                                + int(sectors.numel()))


def walk_inits_ref(ix: IndexTensors, rows, lens, inits: Inits, *, k: int,
                   L: int, counts: dict | None = None) -> Walks:
    """Plain torch version of K3: the JAX engine's lockstep loop
    (bookkeep, junction) over the whole batch, int64 lanes.  rows is the
    scan's packed [3, B, RWr] forward / RC / N-mask rows.  `counts`, when
    given, gets what the walk's junction evaluations (successful and
    failed steps) read: count_probe's keys."""
    k1 = k - 1
    _, _, B, E = inits.planes.shape
    dev = rows.device
    Lw = (L + 15) // 16
    P = 16 * Lw
    max_iters = max_iters_for(E, L)
    lens = lens.to(torch.int64)
    ar = torch.arange(B, device=dev)
    n_f = inits.n_f.to(torch.int64)
    n_r = inits.n_r.to(torch.int64)
    planes = inits.planes
    if E == 0:     # no anchor is ever loaded; keep the gathers in range
        planes = torch.zeros((9, 2, B, 1), dtype=torch.int64, device=dev)
    codes_f = unpack_fields(rows[0], 2, 16 * rows.shape[2])
    codes_r = unpack_fields(rows[1], 2, 16 * rows.shape[2])
    nmask = unpack_fields(rows[2], 2, 16 * rows.shape[2])

    def z():
        return torch.zeros(B, dtype=torch.int64, device=dev)

    s = dict(phase=z() + FETCH, status=z(), orient=z(), aidx=z(), a=z(),
             a_pos=z(), cur=z(), pos=z(), budget=z(), offset=z(), llen=z(),
             rlen=z())
    lbuf = torch.zeros((B, P), dtype=torch.int64, device=dev)
    rbuf = torch.zeros((B, P), dtype=torch.int64, device=dev)

    def aligned_status():
        return torch.where(s["orient"] == 0, STATUS_ALIGNED_FWD,
                           STATUS_ALIGNED_RC)

    def bookkeep():
        is_f = s["phase"] == FETCH
        o0 = s["orient"] == 0
        n_cur = torch.where(o0, n_f, n_r)
        have = s["aidx"] < n_cur
        fwd_exh = is_f & ~have & o0
        rc_exh = is_f & ~have & ~o0
        st_noov = fwd_exh & (n_f == 0)
        to_rc = fwd_exh & (n_f > 0)
        st_rcno = rc_exh & (n_r == 0)
        st_fail = rc_exh & (n_r > 0)
        ai = s["aidx"].clamp(0, planes.shape[3] - 1)
        both = planes[:, :, ar, ai]                      # [9, 2, B]
        init = dict(zip(INIT_FIELDS, torch.where(o0, both[:, 0], both[:, 1])))
        bad = is_f & have & (init["bud0"] < 0)
        load = is_f & have & ~bad
        s["status"] = torch.where(
            st_noov, STATUS_NO_OVERLAP_FWD,
            torch.where(st_rcno, STATUS_RC_NO_OVERLAP,
                        torch.where(st_fail, STATUS_FAILED, s["status"])))
        s["status"] = torch.where(load & (init["ph0"] == DONE), init["st0"],
                                  s["status"])
        s["phase"] = torch.where(st_noov | st_rcno | st_fail, DONE,
                                 torch.where(load, init["ph0"], s["phase"]))
        s["orient"] = torch.where(to_rc, 1, s["orient"])
        s["aidx"] = torch.where(to_rc, 0,
                                torch.where(bad, s["aidx"] + 1, s["aidx"]))
        r0 = init["r0"]
        for key, v in (("a", init["ra"]), ("a_pos", init["ra_pos"]),
                       ("cur", init["cur0"]), ("pos", init["pos0"]),
                       ("budget", init["bud0"]), ("llen", z()),
                       ("rlen", (r0 != 0).to(torch.int64)),
                       ("offset", init["off0"])):
            s[key] = torch.where(load, v, s[key])
        rbuf[:, 0] = torch.where(load & (r0 != 0), r0, rbuf[:, 0])
        l0 = (s["phase"] == LEFT) & (s["pos"] == 0)
        s["offset"] = torch.where(l0, 0, s["offset"])
        s["phase"] = torch.where(l0, RFIRST, s["phase"])
        s["cur"] = torch.where(l0, s["a"], s["cur"])
        s["pos"] = torch.where(l0, s["a_pos"], s["pos"])
        fin = ((s["phase"] == RFIRST) & (lens - s["pos"] - k1 == 0)) | (
            (s["phase"] == RCONT) & (lens - s["pos"] < k))
        s["status"] = torch.where(fin, aligned_status(), s["status"])
        s["phase"] = torch.where(fin, DONE, s["phase"])

    def junction():
        phase, pos = s["phase"], s["pos"]
        mL = phase == LEFT
        mRF = phase == RFIRST
        active = mL | mRF | (phase == RCONT)
        o0 = (s["orient"] == 0)[:, None]
        p = junction_probe_ref(
            ix, mL, mRF, s["cur"], pos, lens, torch.where(o0, codes_f, codes_r),
            torch.where(o0, nmask, 0), k1=k1, L=L)
        if counts is not None:
            count_probe(ix, p, active, counts)
        bestj = p["miss"].argmin(dim=1, keepdim=True)     # first minimum

        def sel(x):
            return x.gather(1, bestj)[:, 0]

        best = sel(p["miss"])
        end_s, ul_s, ust_s, sid_s = (sel(p[n]) for n in
                                     ("ended", "ul", "ust", "sid"))
        ok_ = active & (best <= s["budget"])
        fail = active & (best > s["budget"])
        push_l = ok_ & mL
        push_r = ok_ & ~mL
        li = s["llen"].clamp(0, P - 1)
        ri = s["rlen"].clamp(0, P - 1)
        lbuf[ar[push_l], li[push_l]] = sid_s[push_l]
        rbuf[ar[push_r], ri[push_r]] = sid_s[push_r]
        s["llen"] = s["llen"] + push_l.to(torch.int64)
        s["rlen"] = s["rlen"] + push_r.to(torch.int64)
        s["budget"] = torch.where(ok_, s["budget"] - best, s["budget"])
        le = ok_ & mL & end_s
        s["offset"] = torch.where(le, ust_s, s["offset"])
        s["cur"] = torch.where(le, s["a"], s["cur"])
        s["pos"] = torch.where(le, s["a_pos"], s["pos"])
        lc = ok_ & mL & ~end_s
        s["pos"] = torch.where(lc, pos - (ul_s - k1), s["pos"])
        s["cur"] = torch.where(lc, sel(p["nxt_l"]), s["cur"])
        re_ = ok_ & ~mL & end_s
        s["status"] = torch.where(re_, aligned_status(), s["status"])
        rc_ = ok_ & ~mL & ~end_s
        s["pos"] = torch.where(rc_, pos + (ul_s - k1), s["pos"])
        s["cur"] = torch.where(rc_, sel(p["nxt_r"]), s["cur"])
        s["phase"] = torch.where(
            fail, FETCH,
            torch.where(le, RFIRST, torch.where(re_, DONE, s["phase"])))
        s["phase"] = torch.where(rc_, RCONT, s["phase"])
        s["aidx"] = torch.where(fail, s["aidx"] + 1, s["aidx"])

    it = 0
    while it < max_iters and bool((s["phase"] != DONE).any()):
        bookkeep()
        junction()
        it += 1
    bookkeep()
    bookkeep()
    i32 = torch.int32
    return Walks(s["status"].to(i32), s["orient"].to(i32),
                 s["offset"].to(i32), s["llen"].to(i32), s["rlen"].to(i32),
                 lbuf.to(i32), rbuf.to(i32))


def walk_ref(ix: IndexTensors, scan: Scan, member1, member2, lens, *,
             k: int, m: int, effort: int, L: int,
             counts: dict | None = None) -> Walks:
    """Plain torch version of K3's greedy entry (`counts`: as
    walk_inits_ref's, and the anchors' reads of bug and rcs)."""
    inits = greedy_inits_ref(scan, member1, member2, lens, k=k, m=m,
                             effort=effort, counts=counts)
    return walk_inits_ref(ix, scan.rows, lens, inits, k=k, L=L,
                          counts=counts)


def pull_pays(Q: int, nb: int, cols: int, remote_share: float) -> bool:
    """Whether Q junction evaluations in a table of nb rows of `cols`
    words (S = cols / 10 slots), a `remote_share` of its rows on other
    cards, take less time with the remote ranges staged than read where
    they lie.  Direct: each remote evaluation reads its row's 2S key
    words (K3 compares key-hi and key-lo together) and a 32-byte values
    sector over NVLink, remote_share * Q * (2S * 4 + 32) bytes.  Staged:
    the remote rows, remote_share * nb * cols * 4 bytes, cross NVLink
    once and are written to the stage and read from it at the memory
    rate.  Both at the card's published rates.  The pull runs on a side
    stream beside K1 and K2, but the rule charges it in full: launched
    from Python, as the runner launches, the overlap shortened no chain
    (PERF.md, B15)."""
    if remote_share <= 0 or Q < 1 or nb < 1:
        return False
    pulled = remote_share * nb * cols * 4
    t_staged = pulled / NVLINK_BYTES_PER_S + 2 * pulled / HBM_BYTES_PER_S
    t_direct = (remote_share * Q * (2 * (cols // 10) * 4 + SECTOR)
                / NVLINK_BYTES_PER_S)
    return t_staged < t_direct


# junction evaluations per read the plan counts: a lower bound, one per
# read (a read without an anchor makes none; the survey batch makes 1.7)
EVALS_PER_READ = 1


def walk_plan(B: int, nb_local: int, cols: int, local: Sequence[bool],
              staged: bool | None = None) -> ShardPlan:
    """K3's plan for a batch of B reads on a junction table cut into
    D = len(local) ranges of nb_local rows of `cols` words, `local[s]`
    saying whether range s lies on the reading card: staged, every range
    not on the card in engine/shard.py shard_plan's layout (range s at
    stage row stage_base[s]), where `pull_pays` for B * EVALS_PER_READ
    evaluations (the survey's full batch over 2-4 cards; not a card's
    quarter of it, nor scale1M's table); else direct.  Whole ranges, with no
    mark pass: K3's keys are known only as it walks.  `staged` True or
    False takes that path whatever the rule says (a measurement); with
    every range on the card nothing is staged."""
    D = len(local)
    share = sum(not x for x in local) / D
    if staged is None:
        staged = pull_pays(B * EVALS_PER_READ, nb_local * D, cols, share)
    return shard_plan(B, nb_local, cols, local,
                      staged=bool(staged) and nb_local > 0 and share > 0)


def plan_for(ix: IndexTensors, B: int, dev: torch.device,
             staged: bool | None = None,
             local: Sequence[bool] | None = None) -> ShardPlan:
    """`walk_plan` for K3 on a batch of B reads on `dev` (or, `local`
    given, as if the ranges it names False lay on other cards); an index
    that is not cut into ranges is read directly."""
    if not ix.st_shards or ix.mph_meta is not None:
        local = [True]
    elif local is None:
        local = [x.device == dev for x in ix.st_shards]
    return walk_plan(B, *ix.st_fused.shape, local, staged)


@dataclass
class WalkStage:
    """One batch's stage of the junction table for K3: `rows`, the rows
    of the ranges `plan` stages, in stage order; `index`, K3's copy of
    the index struct whose staged st_shards point into rows; `ready`, an
    event after the pull where it ran on another stream (None: on the
    stream K3 runs on)."""
    plan: ShardPlan
    rows: torch.Tensor
    index: build.IndexC
    ready: torch.cuda.Event | None = None


def staged_index(ix: IndexTensors, plan: ShardPlan,
                 rows: torch.Tensor) -> build.IndexC:
    """A copy of ix's index struct whose ranges that `plan` stages read
    from `rows` (int32 [plan.remote_rows, cols], stage order)."""
    c = build.IndexC.from_buffer_copy(ix.c_index)
    row_bytes = ix.st_fused.shape[1] * 4
    for s, base in enumerate(plan.stage_base):
        if base >= 0:
            c.st_shards[s] = rows.data_ptr() + base * row_bytes
    return c


_pull_streams: dict[int, torch.cuda.Stream] = {}


def pull_stream(dev: torch.device) -> torch.cuda.Stream:
    """The side stream that card `dev`'s stage pulls run on (one a card,
    made at first use)."""
    if dev.index not in _pull_streams:
        _pull_streams[dev.index] = torch.cuda.Stream(dev)
    return _pull_streams[dev.index]


def walk_stage(ix: IndexTensors, B: int, dev: torch.device, *,
               plan: ShardPlan | None = None) -> WalkStage | None:
    """Start K3's stage for a batch of B reads on card `dev`, with `dev`
    current, by `plan` (default `plan_for(ix, B, dev)`): None where the
    plan reads in place (every range on the card, the rule's choice, an
    unsharded index, the CPU).  Else the range pull (csrc/shard.cu
    dbg_walk_stage, counted as `walk_stage`) launches on the card's side
    stream (`pull_stream`) behind the work already queued on the current
    one, so that the batch's K1 and K2 run beside it, and K3 waits for
    its event (`greedy_walk_launch`).  The stage comes from PyTorch's
    caching allocator on the current stream, K3's, so that a later batch
    reuses its memory only behind this batch's K3; it is recorded on the
    side stream too, whose pull writes it.  It is scratch of this batch
    (at most IN_FLIGHT stages a card at once), not held across batches,
    so a card keeps holding only its own ranges between them."""
    if dev.type != "cuda":
        return None
    plan = plan_for(ix, B, dev) if plan is None else plan
    if plan.direct:
        return None
    stream = pull_stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    launch, rows = stage_ranges_launch(ix.st_shards, plan, dev, stream)
    launch()
    build.count("walk_stage")
    rows.record_stream(stream)
    ready = torch.cuda.Event()
    ready.record(stream)
    return WalkStage(plan, rows, staged_index(ix, plan, rows), ready)


def greedy_walk(ix: IndexTensors, scan: Scan, member1, member2, lens, *,
                k: int, m: int, effort: int, L: int,
                stage: WalkStage | None = None) -> Walks:
    """K3's greedy entry on the scan's device: the kernel on CUDA, the
    plain version on the CPU, an error anywhere else.  The kernel picks
    the anchors from the member masks itself.  On a sharded index it
    reads the junction table from the batch's `stage` (`walk_stage`,
    started as the batch began) where one is given, else where it
    lies."""
    dev = scan.bug.device
    if dev.type == "cpu":
        return walk_ref(ix, scan, member1, member2, lens, k=k, m=m,
                        effort=effort, L=L)
    if dev.type != "cuda":
        raise ValueError(f"no greedy_walk kernel for device {dev}")
    if lens.device != dev:
        raise ValueError("index, scan and lens must share a device")
    if lens.dtype != torch.int32 or member1.dtype != torch.uint8:
        raise TypeError("lens must be int32 and members uint8")
    B, Lk = scan.bug.shape
    if member1.shape != (B, Lk) or member2.shape != (B, Lk):
        raise ValueError("member shapes differ from the scan's")
    launch, walks = greedy_walk_launch(ix, scan, member1, member2, lens,
                                       k=k, m=m, effort=effort, L=L,
                                       stage=stage)
    if B:
        launch()
        build.count("greedy_walk")
        calls["direct" if stage is None else "staged"] += 1
    return walks


def greedy_walk_launch(ix: IndexTensors, scan: Scan, member1, member2, lens,
                       *, k: int, m: int, effort: int, L: int,
                       stage: WalkStage | None = None):
    """K3's greedy entry, allocation on checked CUDA tensors:
    (build.Launch into the outputs, the Walks it fills).  It reads the
    junction table from `stage` (whose pull the current stream waits for
    here) where one is given, else where it lies.  The launch keeps the
    stage."""
    dev = scan.bug.device
    B, Lk = scan.bug.shape
    index = c_index_arg(ix, dev)
    if stage is not None:
        if stage.ready is not None:
            torch.cuda.current_stream(dev).wait_event(stage.ready)
        index = ctypes.addressof(stage.index)
    P = 16 * ((L + 15) // 16)
    scan = Scan(*(t.contiguous() for t in scan))
    member1, member2, lens = (t.contiguous()
                              for t in (member1, member2, lens))
    out = torch.empty((5, B), dtype=torch.int32, device=dev)
    lbuf = torch.empty((B, P), dtype=torch.int32, device=dev)
    rbuf = torch.empty((B, P), dtype=torch.int32, device=dev)
    launch = build.Launch("greedy_walk", "dbg_greedy_walk", (
        member1.data_ptr(), member2.data_ptr(), scan.bug.data_ptr(),
        scan.rcs.data_ptr(), lens.data_ptr(), scan.rows.data_ptr(), B,
        Lk, scan.rows.shape[2], index, k, m, effort,
        max_iters_for(effort, L), P,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        out[3].data_ptr(), out[4].data_ptr(), lbuf.data_ptr(),
        rbuf.data_ptr(), build.stream_ptr(dev),
    ), (ix, scan, member1, member2, lens, out, lbuf, rbuf, stage))
    return launch, Walks(out[0], out[1], out[2], out[3], out[4], lbuf, rbuf)


def walk_inits(ix: IndexTensors, rows, lens, inits: Inits, *, k: int,
               L: int) -> Walks:
    """K3's entry from precomputed inits (dog mode) on the rows' device:
    the kernel on CUDA, the plain version on the CPU, an error anywhere
    else."""
    dev = rows.device
    if dev.type == "cpu":
        return walk_inits_ref(ix, rows, lens, inits, k=k, L=L)
    if dev.type != "cuda":
        raise ValueError(f"no walk_inits kernel for device {dev}")
    if lens.device != dev:
        raise ValueError("index, rows and lens must share a device")
    if lens.dtype != torch.int32 or inits.planes.dtype != torch.int64:
        raise TypeError("lens must be int32 and the init planes int64")
    B = rows.shape[1]
    if inits.planes.shape[:3] != (len(INIT_FIELDS), 2, B):
        raise ValueError(f"init planes {tuple(inits.planes.shape)} for B={B}")
    launch, walks = walk_inits_launch(ix, rows, lens, inits, k=k, L=L)
    if B:
        launch()
        build.count("walk_inits")
    return walks


def walk_inits_launch(ix: IndexTensors, rows, lens, inits: Inits, *, k: int,
                      L: int):
    """K3's entry from inits, allocation on checked CUDA tensors:
    (build.Launch into the outputs, the Walks it fills)."""
    dev = rows.device
    _, B, RWr = rows.shape
    E = inits.planes.shape[3]
    P = 16 * ((L + 15) // 16)
    rows, lens = rows.contiguous(), lens.contiguous()
    planes = inits.planes.contiguous()
    n = torch.stack([inits.n_f, inits.n_r]).to(torch.int32).contiguous()
    out = torch.empty((5, B), dtype=torch.int32, device=dev)
    lbuf = torch.empty((B, P), dtype=torch.int32, device=dev)
    rbuf = torch.empty((B, P), dtype=torch.int32, device=dev)
    launch = build.Launch("walk_inits", "dbg_walk_inits", (
        planes.data_ptr(), n.data_ptr(), lens.data_ptr(), rows.data_ptr(),
        B, RWr, c_index_arg(ix, dev), k, E, max_iters_for(E, L), P,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        out[3].data_ptr(), out[4].data_ptr(), lbuf.data_ptr(),
        rbuf.data_ptr(), build.stream_ptr(dev),
    ), (ix, rows, lens, planes, n, out, lbuf, rbuf))
    return launch, Walks(out[0], out[1], out[2], out[3], out[4], lbuf, rbuf)
