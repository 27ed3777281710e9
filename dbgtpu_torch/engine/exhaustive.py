"""K6 exhaustive_dfs: the branch-and-bound DFS of exhaustive mode (-b).

Counterpart of dbgtpu/engine/exhaustive.py align_batch_exhaustive
(:83-475: bookkeepX :195, dfs_step :261).  Anchors are the positions
set in K2's exhaustive mask `inter`, in read order, with the bug-scan
(k-1)-mer as the anchor value; at each anchor a left DFS, then a right
DFS, each over all <= 4 candidates of every junction (the junction
probe of core._junction_probe, shared with K3), pruned against the
phase's best so far (`total < best`), first achiever winning ties.
`partial` (-i) accepts a right ROOT junction with no candidate.  There
is no RC retry: orient is always 0.  The result uses the Walks layout
with buffers of width D = L - k + 3 (the stack depth bound), so K4 packs
it unchanged.

The kernel is csrc/exhaustive.cu (one thread per read, the DFS run to
completion on an explicit stack); `exhaustive_ref` is its plain torch
version, a lockstep port of bookkeepX / dfs_step over the batch without
the JAX engine's staged tail compaction.
"""

from __future__ import annotations

import torch

from ..constants import (
    STATUS_ALIGNED_FWD,
    STATUS_FAILED,
    STATUS_NO_OVERLAP_FWD,
)
from ..kernels import build
from .index import IndexTensors, c_index_arg
from .read_scan import Scan, unpack_fields
from .walk import (
    BIG, Walks, count_probe, count_read_sectors, junction_probe_ref,
)

# phases (exhaustive.py _FETCHX .. _DONEX)
FETCHX, LDFS, RDFS, LDONE, RDONE, LRDY, DONEX = 0, 1, 2, 3, 4, 5, 6
# one spilled stack frame: tci, tn, tacc, the chosen sid, then 7 fields
# x 4 candidates (sid, miss, end, ust, npos, next k-mer hi, lo)
FRAME_WORDS = 32


def depth_for(L: int, k: int) -> int:
    """D: stack depth bound and path buffer width (each level consumes
    at least one base)."""
    return L - k + 3


def exhaustive_ref(ix: IndexTensors, scan: Scan, inter, lens, *, k: int,
                   m: int, partial: bool, L: int,
                   counts: dict | None = None) -> Walks:
    """Plain torch version of K6 (int64 lanes).  `counts`, when given,
    gets what the DFS's junction evaluations (one per populated frame)
    read, walk.count_probe's keys, and the sectors of bug that FETCHX
    reads at its anchors (walk.count_read_sectors)."""
    k1 = k - 1
    B, Lk = scan.bug.shape
    dev = scan.bug.device
    D = depth_for(L, k)
    lens = lens.to(torch.int64)
    ar = torch.arange(B, device=dev)
    col = torch.arange(Lk, device=dev)[None, :]
    pos_or_big = torch.where(inter.bool(), col, BIG)
    nxt_int = torch.flip(torch.cummin(torch.flip(pos_or_big, [1]), 1).values,
                         [1])                   # next interesting >= i
    n_pos = lens - k1 + 1
    codes = unpack_fields(scan.rows[0], 2, 16 * scan.rows.shape[2])
    nmask = unpack_fields(scan.rows[2], 2, 16 * scan.rows.shape[2])

    def z(*shape):
        return torch.zeros((B,) + shape, dtype=torch.int64, device=dev)

    s = dict(phase=torch.where(n_pos <= 0, DONEX, FETCHX),
             status=torch.where(n_pos <= 0, STATUS_NO_OVERLAP_FWD, 0),
             a=z(), ak=z(), best=z(), bl=z(), bloff=z(), bllen=z(),
             brlen=z(), sp=z(), tk=z(), tpos=z(), tacc=z(), tci=z(), tn=z(),
             tpop=torch.zeros(B, dtype=torch.bool, device=dev))
    cand = ("sid", "miss", "end", "ust", "npos", "nk")
    for c in cand:
        s["tc_" + c] = z(4)
    bl_buf, br_buf, csid = z(D), z(D), z(D)
    fetched = torch.zeros((B, Lk), dtype=torch.bool, device=dev)  # counts
    stack = {c: z(D) for c in ("ci", "n", "acc")}
    stack.update({c: z(D, 4) for c in cand})

    def upd(key, mask, v):
        s[key] = torch.where(mask.reshape(mask.shape + (1,) * (s[key].dim()
                                                            - 1)), v, s[key])

    def start_dfs(go, phase):
        upd("sp", go, 0)
        upd("tk", go, s["ak"])
        upd("tpos", go, s["a"])
        upd("tacc", go, 0)
        upd("tpop", go, True)
        upd("phase", go, phase)

    def bookkeep():
        ld = s["phase"] == LDONE                 # left stack exhausted
        l_ok = ld & (s["best"] <= m)
        upd("bl", l_ok, s["best"])
        upd("phase", l_ok, LRDY)
        upd("a", ld & ~l_ok, s["a"] + 1)
        upd("phase", ld & ~l_ok, FETCHX)
        rd = s["phase"] == RDONE                 # right stack exhausted
        r_ok = rd & (s["best"] <= m - s["bl"])
        upd("status", r_ok, STATUS_ALIGNED_FWD)
        upd("phase", r_ok, DONEX)
        upd("a", rd & ~r_ok, s["a"] + 1)
        upd("phase", rd & ~r_ok, FETCHX)
        fx = s["phase"] == FETCHX                # next interesting anchor
        nxt = nxt_int.gather(1, s["a"].clamp(0, Lk - 1)[:, None])[:, 0]
        none = fx & ((nxt >= n_pos) | (s["a"] > lens - k1))
        upd("status", none, STATUS_FAILED)
        upd("phase", none, DONEX)
        go = fx & ~none
        upd("a", go, nxt)
        upd("ak", go, scan.bug.gather(1, nxt.clamp(0, Lk - 1)[:, None])[:, 0])
        if counts is not None:
            fetched[ar[go], nxt[go]] = True
        upd("best", go, m + 1)
        upd("bllen", go, 0)
        upd("bloff", go, 0)
        start_dfs(go, LDFS)
        triv = go & (s["a"] == 0)     # anchor at the read start: left done
        upd("bl", triv, 0)
        upd("phase", triv, LRDY)
        lr = s["phase"] == LRDY                  # start the right DFS
        win = lr & (lens - s["a"] - k1 == 0)
        upd("brlen", lr, 0)
        upd("status", win, STATUS_ALIGNED_FWD)
        upd("phase", win, DONEX)
        rgo = lr & ~win
        upd("best", rgo, m - s["bl"] + 1)
        start_dfs(rgo, RDFS)

    def dfs_step():
        mL = s["phase"] == LDFS
        mR = s["phase"] == RDFS
        active = mL | mR
        need_pop = active & s["tpop"]
        # populate the top frame: the valid candidates, compacted in order
        p = junction_probe_ref(ix, mL, mR, s["tk"], s["tpos"], lens, codes,
                               nmask, k1=k1, L=L)
        if counts is not None:
            count_probe(ix, p, need_pop, counts)
        pv = p["valid"]
        vidx = pv.to(torch.int64).cumsum(1) - 1
        step_ = torch.where(mL[:, None], -(p["ul"] - k1), p["ul"] - k1)
        fields = dict(sid=p["sid"], miss=p["miss"],
                      end=p["ended"].to(torch.int64), ust=p["ust"],
                      npos=s["tpos"][:, None] + step_,
                      nk=torch.where(mL[:, None], p["nxt_l"], p["nxt_r"]))
        for c, x in fields.items():
            comp = torch.stack([torch.where(pv & (vidx == t), x, 0).sum(1)
                                for t in range(4)], 1)
            upd("tc_" + c, need_pop, comp)
        c_n = pv.sum(1)
        upd("tn", need_pop, c_n)
        upd("tci", need_pop, 0)
        upd("tpop", need_pop, False)
        if partial:     # right ROOT junction without candidates: accept
            upd("best", need_pop & mR & (s["sp"] == 0) & (c_n == 0), 0)

        # one candidate trial, or a pop, of the top frame
        step = active & ~need_pop
        popm = step & (s["tci"] >= s["tn"])
        spm = s["sp"] - 1
        under = popm & (spm < 0)
        upd("phase", under, torch.where(mL, LDONE, RDONE))
        restore = popm & ~under
        trial = step & ~popm
        ci = s["tci"].clamp(0, 3)[:, None]
        t = {c: s["tc_" + c].gather(1, ci)[:, 0] for c in cand}
        total = s["tacc"] + t["miss"]
        t_end = t["end"] != 0
        impr = trial & t_end & (total < s["best"])      # terminal: snapshot
        upd("best", impr, total)
        dcol = torch.arange(D, device=dev)[None, :]
        spn = s["sp"][:, None]
        snap = torch.where(dcol < spn, csid,
                           torch.where(dcol == spn, t["sid"][:, None], 0))
        iml, imr = impr & mL, impr & mR
        bl_buf[iml] = snap[iml]
        br_buf[imr] = snap[imr]
        upd("bllen", iml, s["sp"] + 1)
        upd("bloff", iml, t["ust"])
        upd("brlen", imr, s["sp"] + 1)
        upd("tci", trial, s["tci"] + 1)
        push = trial & ~t_end & (total < s["best"])    # descend
        spc = s["sp"].clamp(0, D - 1)
        for c in ("ci", "n", "acc"):
            stack[c][ar[push], spc[push]] = s["t" + c][push]
        for c in cand:
            stack[c][ar[push], spc[push]] = s["tc_" + c][push]
        csid[ar[push], spc[push]] = t["sid"][push]
        upd("sp", push, s["sp"] + 1)
        upd("tk", push, t["nk"])
        upd("tpos", push, t["npos"])
        upd("tacc", push, total)
        upd("tpop", push, True)
        spr = spm.clamp(0, D - 1)                      # pop: restore parent
        for c in ("ci", "n", "acc"):
            upd("t" + c, restore, stack[c][ar, spr])
        for c in cand:
            upd("tc_" + c, restore, stack[c][ar, spr])
        upd("sp", restore | under, spm)

    while bool((s["phase"] != DONEX).any()):
        bookkeep()
        dfs_step()
    bookkeep()
    if counts is not None:
        count_read_sectors(scan.bug, fetched, counts)
    i32 = torch.int32
    return Walks(s["status"].to(i32), torch.zeros(B, dtype=i32, device=dev),
                 s["bloff"].to(i32), s["bllen"].to(i32), s["brlen"].to(i32),
                 bl_buf.to(i32), br_buf.to(i32))


def exhaustive_dfs(ix: IndexTensors, scan: Scan, inter, lens, *, k: int,
                   m: int, partial: bool, L: int) -> Walks:
    """K6 on the scan's device: the kernel on CUDA, the plain version on
    the CPU, an error anywhere else.  The kernel's stack lives in a
    scratch tensor of D x FRAME_WORDS x B int32 allocated here, per
    batch."""
    dev = scan.bug.device
    if dev.type == "cpu":
        return exhaustive_ref(ix, scan, inter, lens, k=k, m=m,
                              partial=partial, L=L)
    if dev.type != "cuda":
        raise ValueError(f"no exhaustive_dfs kernel for device {dev}")
    if lens.device != dev or inter.device != dev:
        raise ValueError("index, scan, inter and lens must share a device")
    if lens.dtype != torch.int32 or inter.dtype != torch.uint8:
        raise TypeError("lens must be int32 and inter uint8")
    B, Lk = scan.bug.shape
    if inter.shape != (B, Lk):
        raise ValueError("inter's shape differs from the scan's")
    launch, walks = exhaustive_dfs_launch(ix, scan, inter, lens, k=k, m=m,
                                          partial=partial, L=L)
    if B:
        launch()
        build.count("exhaustive_dfs")
    return walks


def exhaustive_dfs_launch(ix: IndexTensors, scan: Scan, inter, lens, *,
                          k: int, m: int, partial: bool, L: int):
    """K6's allocation on checked CUDA tensors, its stack included:
    (build.Launch into the outputs, the Walks it fills)."""
    dev = scan.bug.device
    B, Lk = scan.bug.shape
    D = depth_for(L, k)
    scan = Scan(*(t.contiguous() for t in scan))
    inter, lens = inter.contiguous(), lens.contiguous()
    out = torch.empty((4, B), dtype=torch.int32, device=dev)
    lbuf = torch.zeros((B, D), dtype=torch.int32, device=dev)
    rbuf = torch.zeros((B, D), dtype=torch.int32, device=dev)
    stack = torch.empty((D, FRAME_WORDS, B), dtype=torch.int32, device=dev)
    launch = build.Launch("exhaustive_dfs", "dbg_exhaustive_dfs", (
        inter.data_ptr(), scan.bug.data_ptr(), lens.data_ptr(),
        scan.rows.data_ptr(), B, Lk, scan.rows.shape[2], c_index_arg(ix, dev),
        k, m, int(partial), D,
        stack.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), out[3].data_ptr(), lbuf.data_ptr(),
        rbuf.data_ptr(), build.stream_ptr(dev),
    ), (ix, scan, inter, lens, out, lbuf, rbuf, stack))
    return launch, Walks(out[0], torch.zeros(B, dtype=torch.int32, device=dev),
                         out[1], out[2], out[3], lbuf, rbuf)
