"""K5 dog_anchors: the anchor stage of dog mode (-G).

Counterpart of dbgtpu/engine/dog.py: the k-mer scan and canonical
lookup of align_batch_anchors (:195-231, _anchor_lookup :59 under
either anchor layout: the fused scan table, or the MPHF slot and the
stored-key verify in `amph_arows`), the anchor pick (core._first_k_hits /
_last_k_hits_rc with n_mer = k) and _dog_inits (:101), whose placement
verify is one core._window_miss.  Its output is the per-anchor walk
inits that K3 walks from (walk.Inits).  Anchors are whole k-mers of
length k, so at k = 32 a k-mer fills 64 bits (see engine/kmer.py).
The kernel is csrc/dog.cu; `dog_anchors_ref` is its plain torch
version.
"""

from __future__ import annotations

import torch

from ..constants import STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC
from ..kernels import build
from .index import (
    C_BEG_HI, C_BEG_LO, C_END_HI, C_END_LO, C_RCB_HI, C_RCB_LO, C_RCE_HI,
    C_RCE_LO, C_ULEN, LOOKUP_CHUNK, IndexTensors, c_index_arg,
)
from .kmer import M32, as_i32, le_ref, mix32_ref, rcb_ref, split_ref
from .mphf import _signed32, mphf_rows_ref
from .read_scan import _scan, unpack_fields
from .walk import (
    DONE, INIT_FIELDS, LEFT, RFIRST, Inits, _anchors, _window_miss_ref,
)


def anchor_lookup_ref(ix: IndexTensors, keys: torch.Tensor):
    """Canonical k-mers [B, n] -> (member bool, uid, upos, ucanon int64)
    (dog._anchor_lookup): from the MPHF anchor rows when the index holds
    them, else from at_fused, LOOKUP_CHUNK positions at a time."""
    if ix.amph_meta is not None:
        member, row = mphf_rows_ref(ix.amph_rows, ix.amph_f, ix.amph_arows,
                                    ix.amph_meta, keys)
        vals = _signed32(row[..., 2:5])
        return member, vals[..., 0], vals[..., 1], vals[..., 2]
    S = ix.at_slots
    nbm = ix.at_fused.shape[0] - 1
    member = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    vals = torch.zeros(keys.shape + (3,), dtype=torch.int64,
                       device=keys.device)
    chunk = LOOKUP_CHUNK
    for c0 in range(0, keys.shape[1], chunk):
        hi, lo = split_ref(keys[:, c0 : c0 + chunk])
        row = ix.at_fused[mix32_ref(hi ^ ix.at_seed, lo) & nbm]
        ok = (row[..., :S] == as_i32(hi)[..., None]) & (
            row[..., S : 2 * S] == as_i32(lo)[..., None])
        v = row[..., 2 * S :].reshape(ok.shape + (3,)).to(torch.int64) & M32
        member[:, c0 : c0 + chunk] = ok.any(dim=-1)
        vals[:, c0 : c0 + chunk] = torch.where(ok[..., None], v, 0).sum(-2)
    vals = _signed32(vals)
    return member, vals[..., 0], vals[..., 1], vals[..., 2]


def dog_inits_ref(ix: IndexTensors, uid, upos, ucan, le, rpos, lens, rcodes,
                  ncodes, *, k: int, m: int, st_aligned: int, L: int) -> dict:
    """dog._dog_inits: the placement case of each anchor [B, E] and its
    initial walk state.  le: the read k-mer at the anchor is the
    canonical key; rcodes / ncodes: codes [B, L] and N-mask of the
    oriented read (zeros for the RC read)."""
    k1 = k - 1
    meta = ix.umeta[uid.clamp(min=0)].to(torch.int64)        # [B, E, C]

    def kmer(c_hi, c_lo):
        return ((meta[..., c_hi] & M32) << 32) | (meta[..., c_lo] & M32)

    ul = meta[..., C_ULEN]
    fwd = le.to(torch.int64) == ucan
    upos_o = torch.where(fwd, upos, ul - k - upos)
    beg = torch.where(fwd, kmer(C_BEG_HI, C_BEG_LO), kmer(C_RCE_HI, C_RCE_LO))
    end = torch.where(fwd, kmer(C_END_HI, C_END_LO), kmer(C_RCB_HI, C_RCB_LO))
    lensc = lens.to(torch.int64)[:, None]
    rge = rpos >= upos_o                  # unitig start lies inside the read
    vu = torch.where(rge, 0, upos_o - rpos)      # unitig-side verify start
    vr = torch.where(rge, rpos - upos_o, 0)      # read-side verify start
    w = torch.minimum(ul - vu, lensc - vr)       # all four cases unified
    errors = _window_miss_ref(ix, meta, fwd, vu, vr, w, rcodes, ncodes, L)
    covers = (lensc - rpos) >= (ul - upos_o)     # read reaches unitig end
    case3 = ~rge & covers
    case4 = ~rge & ~covers
    return dict(
        ph0=torch.where(case4, DONE, torch.where(case3, RFIRST, LEFT)),
        cur0=torch.where(case3, end, beg),
        pos0=torch.where(rge, vr, torch.where(case3, ul - vu - k1, 0)),
        ra=end,
        # case 2 parks the right restart at lens-k+1, where the RIGHT-FIRST
        # phase ends at once
        ra_pos=torch.where(rge & covers, vr + ul - k1, lensc - k1),
        bud0=m - errors,
        off0=torch.where(rge, 0, vu),
        r0=torch.where(fwd, uid, -uid),
        st0=torch.full_like(ul, st_aligned),
    )


def dog_anchors_ref(ix: IndexTensors, rows, lens, *, k: int, m: int,
                    effort: int, L: int) -> Inits:
    """Plain torch version of K5: scan every k-mer of the packed forward
    rows [3, B, RWr], look its canonical form up, take the first E hits
    (forward anchors) and the last E (RC anchors), and place each."""
    E = effort
    lens = lens.to(torch.int64)
    codes_f = unpack_fields(rows[0], 2, L)
    f = _scan(codes_f, k)                                 # [B, L-k+1]
    r = rcb_ref(f, k)
    le_f = le_ref(f, r)
    member, uid, upos, ucan = anchor_lookup_ref(ix, torch.where(le_f, f, r))
    col = torch.arange(f.shape[1], device=f.device)[None, :]
    member &= col <= (lens - k)[:, None]
    le_r = le_ref(r, f)
    out = []
    for o, from_end in ((0, False), (1, True)):
        cols, _, n = _anchors(member, uid, E, from_end=from_end)

        def at(x):
            return x.gather(1, cols)

        le = at(le_f if o == 0 else le_r)
        rpos = cols if o == 0 else lens[:, None] - k - cols
        rcodes = unpack_fields(rows[o], 2, 16 * rows.shape[2])
        ncodes = (unpack_fields(rows[2], 2, 16 * rows.shape[2]) if o == 0
                  else torch.zeros_like(rcodes))
        ini = dog_inits_ref(
            ix, at(uid), at(upos), at(ucan), le, rpos, lens, rcodes, ncodes,
            k=k, m=m, st_aligned=(STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC)[o],
            L=L)
        out.append((torch.stack([ini[f_] for f_ in INIT_FIELDS]), n))
    planes = torch.stack([out[0][0], out[1][0]], dim=1)   # [9, 2, B, E]
    return Inits(planes, out[0][1].to(torch.int32),
                 out[1][1].to(torch.int32))


def dog_anchors(ix: IndexTensors, rows, lens, *, k: int, m: int,
                effort: int, L: int) -> Inits:
    """K5 on the rows' device: the kernel on CUDA, the plain version on
    the CPU, an error anywhere else."""
    if not ix.has_anchors:
        raise ValueError("index was not built in dog mode "
                         "(anchor table is empty)")
    dev = rows.device
    if dev.type == "cpu":
        return dog_anchors_ref(ix, rows, lens, k=k, m=m, effort=effort, L=L)
    if dev.type != "cuda":
        raise ValueError(f"no dog_anchors kernel for device {dev}")
    if lens.device != dev:
        raise ValueError("index, rows and lens must share a device")
    if lens.dtype != torch.int32 or rows.dtype != torch.int32:
        raise TypeError("rows and lens must be int32")
    if not 2 <= k <= 32 or L < k:
        raise ValueError(f"unsupported k={k} for L={L}")
    launch, inits = dog_anchors_launch(ix, rows, lens, k=k, m=m,
                                       effort=effort)
    if rows.shape[1]:
        launch()
        build.count("dog_anchors")
    return inits


def dog_anchors_launch(ix: IndexTensors, rows, lens, *, k: int, m: int,
                       effort: int):
    """K5's allocation on checked CUDA tensors: (build.Launch into the
    outputs, the Inits it fills; rows e >= n stay zero)."""
    dev = rows.device
    _, B, RWr = rows.shape
    rows, lens = rows.contiguous(), lens.contiguous()
    planes = torch.zeros((len(INIT_FIELDS), 2, B, effort), dtype=torch.int64,
                         device=dev)
    n = torch.zeros((2, B), dtype=torch.int32, device=dev)
    launch = build.Launch("dog_anchors", "dbg_dog_anchors", (
        rows.data_ptr(), B, RWr, lens.data_ptr(), c_index_arg(ix, dev), k, m,
        effort, planes.data_ptr(), n.data_ptr(), build.stream_ptr(dev),
    ), (ix, rows, lens, planes, n))
    return launch, Inits(planes, n[0], n[1])
