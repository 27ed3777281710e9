"""The device index as torch tensors (counterpart of
dbgtpu/engine/core.py IndexArrays / index_to_device).

This module carries the state from the numpy `DeviceIndex` built by
index/device.py onto a torch device.  Tables whose JAX dtype is
uint32 are held as int32 tensors with the same bits (torch has little
uint32 support); the kernels read them as uint32 and the plain
versions mask them back to 32-bit values in int64 lanes.

Both layouts of both tables are carried: the junction table as the
fused scan table (`st_fused`) or as an MPHF over rank-group rows plus
the dense `mph_jrows` (`--index-layout mphf`); the dog-mode (-G) anchor
table as `at_fused` or as an MPHF plus `amph_arows` (keysets of
ANCHOR_MPHF_MIN keys or more, or the mphf layout).  The two choices are
independent.  `mph_meta` / `amph_meta` hold an MPHF's static structure
(core.py's `jl_meta` / `al_meta`) and are None under the scan layout.

Under `--shard-index` over D > 1 devices (`sharded_index_tensors`) the
scan table `st_fused` and the probe table `pt_rows` are cut into D
contiguous bucket ranges, one on each device, as dbgtpu shards them
(dbgtpu/dist/mesh.py:152-159); every other table is replicated.  Each
device's IndexTensors holds its own range as `st_fused` / `pt_rows` and
every device's in `st_shards` / `pt_shards` (engine/shard.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..index.device import PT_SLOTS, DeviceIndex
from ..index.mphf import _SEEDS_HI, _SEEDS_LO
from ..kernels.build import (
    MAX_SHARDS, MPHF_MAX_LEVELS, IndexC, MphfC, MphfMetaC,
)
from .mphf import check_mphf_table
from .shard import check_sharded_table, enable_peer_access

# umeta column layout (dbgtpu.index.device.build_device_index)
C_UOFF, C_ULEN = 0, 1
C_BEG_HI, C_BEG_LO, C_END_HI, C_END_LO = 2, 3, 4, 5
C_RCB_HI, C_RCB_LO, C_RCE_HI, C_RCE_LO = 6, 7, 8, 9
META_COLS = 16          # metadata columns before the embedded sequence
# read positions per gather in the plain fused-table lookups, so the
# gathered rows stay [B, LOOKUP_CHUNK, row width]
LOOKUP_CHUNK = 8


@dataclass(frozen=True)
class MphfMeta:
    """Static structure of one MPHF (core._mphf_meta): per level the
    hash seeds (taken from the host table index/mphf.py builds with,
    never recomputed), the bit mask of the level's size and the offset
    of its first rank-group row (= the host MPHF's sample_off); then the
    final table's bucket count (0: none) and the key count."""

    seeds_hi: tuple[int, ...]
    seeds_lo: tuple[int, ...]
    masks: tuple[int, ...]
    row_offs: tuple[int, ...]
    final_nb: int
    n_keys: int

    @property
    def n_levels(self) -> int:
        return len(self.masks)

    @functools.cached_property
    def c_struct(self) -> MphfMetaC:
        """The meta as the struct the kernels take (csrc/common.cuh
        dbg::MphfMeta), built once."""
        c = MphfMetaC(n_levels=self.n_levels,
                      has_final=int(self.final_nb > 0),
                      final_mask=max(self.final_nb - 1, 0),
                      n_keys=self.n_keys)
        for lvl in range(self.n_levels):
            c.seed_hi[lvl] = self.seeds_hi[lvl]
            c.seed_lo[lvl] = self.seeds_lo[lvl]
            c.mask[lvl] = self.masks[lvl]
            c.row_off[lvl] = self.row_offs[lvl]
        return c


def mphf_meta_of(m) -> MphfMeta:
    """index.mphf.MPHF -> MphfMeta."""
    n = int(m.n_levels)
    if n > MPHF_MAX_LEVELS:
        raise ValueError(f"MPHF has {n} levels; the kernels take at most "
                         f"{MPHF_MAX_LEVELS}")
    return MphfMeta(
        seeds_hi=tuple(int(x) for x in _SEEDS_HI[:n]),
        seeds_lo=tuple(int(x) for x in _SEEDS_LO[:n]),
        masks=tuple(int(x) for x in m.mask[:n]),
        row_offs=tuple(int(x) for x in m.sample_off[:n]),
        final_nb=(int(m.final_tbl.n_buckets) if m.final_tbl is not None
                  else 0),
        n_keys=int(m.n_keys),
    )


def fuse_mphf(m) -> tuple[np.ndarray, np.ndarray]:
    """index.mphf.MPHF -> (fused rank-group rows uint32 [ng, 5], final
    table uint32 [nbf, 12]) (core._fuse_mphf).  Each 128-bit rank group
    is one row: rank_base + sample, then its 4 level words, so a level
    lookup is one row read; the row of word w of level lvl is
    sample_off[lvl] + (w >> 2).  A final-table row is 4 key-hi, 4 key-lo
    and 4 values."""
    ft = m.final_tbl
    if ft is not None:
        nbf = ft.n_buckets
        frows = np.concatenate(
            [ft.khi, ft.klo, ft.vals.reshape(nbf, 4).view(np.uint32)], axis=1)
    else:
        frows = np.zeros((0, 12), np.uint32)
    parts = []
    for lvl in range(m.n_levels):
        w = m.words[m.word_off[lvl] : m.word_off[lvl + 1]]
        smp = m.samples[m.sample_off[lvl] : m.sample_off[lvl + 1]]
        ng = len(smp)
        wp = np.zeros(ng * 4, np.uint32)
        wp[: len(w)] = w
        r = np.zeros((ng, 5), np.uint32)
        r[:, 0] = (smp.astype(np.int64)
                   + int(m.rank_base[lvl])).astype(np.uint32)
        r[:, 1:5] = wp.reshape(ng, 4)
        parts.append(r)
    rows = np.concatenate(parts) if parts else np.zeros((0, 5), np.uint32)
    return rows, frows


@dataclass
class IndexTensors:
    st_fused: torch.Tensor   # int32 [nb, 10*S]: S slot key-hi | S key-lo |
    #                          S slots x 8 junction ids (uint32 bits)
    st_seed: int             # bucket-hash seed of st_fused
    umeta: torch.Tensor      # int32 [U+1, 16 + 2*SW]: metadata columns,
    #                          then SW fwd and SW rc packed-sequence words
    pool_rows: torch.Tensor  # int32 [2*n_chunks, RW] fwd then rc chunk
    #                          rows (uint32 bits; 1 placeholder row when
    #                          the sequence is embedded in umeta)
    n_chunks: int            # forward chunk-row count
    pt_rows: torch.Tensor    # int32 [nbp, W*PT_SLOTS] closure-probe rows
    #                          (W = 4 or 3); [0, 32] when absent
    pt_seed: int             # bucket-hash seed of pt_rows
    at_fused: torch.Tensor   # int32 [nba, 5*S] dog anchor table: S slot
    #                          key-hi | S key-lo | S slots x (uid, upos,
    #                          ucanon); [0, 160] when absent
    at_seed: int             # bucket-hash seed of at_fused
    # MPHF junction layout (placeholders of 0 rows and a None meta under
    # the scan layout; st_fused is then [0, 320])
    mph_rows: torch.Tensor   # int32 [ng, 5] fused rank-group rows
    mph_jrows: torch.Tensor  # int32 [n, 10]: key-hi, key-lo, 8 junction ids
    mph_f: torch.Tensor      # int32 [nbf, 12] final table
    mph_meta: MphfMeta | None
    # MPHF dog anchor layout (at_fused is then [0, 160])
    amph_rows: torch.Tensor  # int32 [ng, 5]
    amph_arows: torch.Tensor  # int32 [n, 5]: key-hi, key-lo, uid, upos, ucanon
    amph_f: torch.Tensor     # int32 [nbf, 12]
    amph_meta: MphfMeta | None
    # a sharded index (--shard-index over D > 1 devices): every device's
    # range of st_fused and of pt_rows, in device order (this device's is
    # st_fused / pt_rows itself, the others lie on their devices); () for
    # whole tables.  The other devices' shards are kept alive here, since
    # c_index points into them.
    st_shards: tuple = field(default=(), repr=False, compare=False)
    pt_shards: tuple = field(default=(), repr=False, compare=False)
    # the tables as the struct the kernels take (csrc/common.cuh
    # dbg::Index), built once from the fields above.  It holds raw
    # pointers into them: keep this IndexTensors alive while a kernel that
    # was given the struct may run.
    c_index: IndexC = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        dev = self.umeta.device
        for t in self.tensors():
            if (t.device != dev or not t.is_contiguous()
                    or t.dtype != torch.int32):
                raise ValueError("index tables must be contiguous int32 "
                                 "tensors on one device")
        n_shards = len(self.st_shards) or 1
        for own, shards in ((self.st_fused, self.st_shards),
                            (self.pt_rows, self.pt_shards)):
            if shards and (
                    len(shards) != n_shards or n_shards > MAX_SHARDS
                    or not any(t is own for t in shards)
                    or any(t.shape != own.shape or t.dtype != torch.int32
                           or not t.is_contiguous() for t in shards)):
                raise ValueError("a sharded table needs 1 to "
                                 f"{MAX_SHARDS} contiguous int32 shards of "
                                 "one shape, this device's among them")

        def mphf(rows, frows, vrows, meta):
            if meta is None:
                return MphfC()
            return MphfC(rows=rows.data_ptr(), frows=frows.data_ptr(),
                         vrows=vrows.data_ptr(), meta=meta.c_struct)

        self.c_index = IndexC(
            st=self.st_fused.data_ptr(), umeta=self.umeta.data_ptr(),
            pool=self.pool_rows.data_ptr(), pt=self.pt_rows.data_ptr(),
            at=self.at_fused.data_ptr(),
            st_nb=self.st_fused.shape[0], st_cols=self.st_fused.shape[1],
            st_seed=self.st_seed, ucols=self.umeta.shape[1],
            pool_cols=self.pool_rows.shape[1], n_chunks=self.n_chunks,
            pt_nb=self.pt_rows.shape[0], pt_cols=self.pt_rows.shape[1],
            pt_seed=self.pt_seed, pt_slots=PT_SLOTS,
            at_nb=self.at_fused.shape[0], at_cols=self.at_fused.shape[1],
            at_seed=self.at_seed,
            jl_mphf=int(self.mph_meta is not None),
            al_mphf=int(self.amph_meta is not None),
            jm=mphf(self.mph_rows, self.mph_f, self.mph_jrows, self.mph_meta),
            am=mphf(self.amph_rows, self.amph_f, self.amph_arows,
                    self.amph_meta),
            n_shards=n_shards,
        )
        for i, t in enumerate(self.st_shards):
            self.c_index.st_shards[i] = t.data_ptr()
        for i, t in enumerate(self.pt_shards):
            self.c_index.pt_shards[i] = t.data_ptr()

    @property
    def device(self) -> torch.device:
        return self.umeta.device

    @property
    def st_slots(self) -> int:
        return self.st_fused.shape[1] // 10

    @property
    def at_slots(self) -> int:
        return self.at_fused.shape[1] // 5

    @property
    def seq_words(self) -> int:
        """SW: packed-sequence words per orientation embedded in umeta
        (0 = windows come from pool_rows)."""
        return (self.umeta.shape[1] - META_COLS) // 2

    @property
    def pt_window(self) -> int:
        """Positions answered per closure probe (derived from the row
        width, as in core._closure_member)."""
        return 4 if self.pt_rows.shape[1] == 4 * PT_SLOTS else 3

    @property
    def has_anchors(self) -> bool:
        """The index was built in dog mode (either anchor layout)."""
        return self.at_fused.shape[0] > 0 or self.amph_meta is not None

    def tensors(self) -> list[torch.Tensor]:
        """The tables this device holds (its own shards of a sharded
        index)."""
        return [v for v in vars(self).values() if isinstance(v, torch.Tensor)]

    def held_bytes(self) -> int:
        """Bytes of the tables this device holds."""
        return sum(t.numel() * t.element_size() for t in self.tensors())


def c_index_arg(ix: IndexTensors, dev) -> int:
    """Address of the index struct for a kernel launch on `dev` (the C
    entry point copies the struct into the kernel's parameters)."""
    if ix.device != dev:
        raise ValueError(f"the index lies on {ix.device}, the batch on {dev}")
    return ctypes.addressof(ix.c_index)


def fuse_scan_table(t) -> np.ndarray:
    """ScanTable -> fused [nb, 2*S + V*S] uint32 rows: slot keys, then
    each slot's V values (V = 8 junction ids, or 3 anchor values)
    (core._fuse_scan_table, which lives in a module that imports JAX)."""
    nb = t.keys.shape[0]
    return np.concatenate(
        [t.keys, t.vals.reshape(nb, -1).view(np.uint32)], axis=1
    )


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """numpy array -> tensor on `device`; uint32 arrays become int32
    tensors with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def on_device(device: torch.device):
    """The context in which `device`'s kernels launch: on a card, that
    card made current, so its current stream is the one launched on (a
    card's default stream is the null stream of whichever card is
    current)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _device(device) -> torch.device:
    """`cuda` as the current card, so that `cuda` and `cuda:<current>`
    name one card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _memo(di: DeviceIndex) -> dict:
    memo = getattr(di, "_torch_ix", None)
    if memo is None:
        memo = {}
        di._torch_ix = memo
    return memo


def index_tensors(di: DeviceIndex, device) -> IndexTensors:
    """DeviceIndex (numpy) -> IndexTensors on `device`, memoized on `di`
    per device: the index upload is the largest transfer of a run.
    `cuda` and `cuda:<current>` name one card and share one entry."""
    device = _device(device)
    memo = _memo(di)
    key = str(device)
    if key not in memo:
        memo[key] = _upload(di, device)
    return memo[key]


def sharded_index_tensors(di: DeviceIndex, devices) -> list[IndexTensors]:
    """DeviceIndex (numpy, scan layout) -> one IndexTensors per device of
    `devices` (1 to MAX_SHARDS of them), with `st_fused` and `pt_rows`
    cut into len(devices) contiguous bucket ranges, range d on device d,
    and every other table replicated; memoized on `di` per device list.
    A mesh of one device holds the tables whole, as one range each, as
    dbgtpu's mesh of one does.
    On cards each reads the others' ranges through peer pointers
    (enable_peer_access: a pair of cards without peer access raises).
    Each card waits for every upload, then K13 reads the first and last
    row of every range through its pointers against the host's rows
    (engine/shard.py check_sharded_table).  On the CPU the ranges are
    row ranges of the one CPU device, as a mesh there is N shards."""
    devices = [_device(d) for d in devices]
    D = len(devices)
    memo = _memo(di)
    key = "shards:" + ",".join(map(str, devices))
    if key in memo:
        return memo[key]
    if di.scan_tbl is None:
        raise ValueError("a sharded index needs the scan layout")
    st = fuse_scan_table(di.scan_tbl)
    pt = di.probe_tbl.rows if di.probe_tbl is not None else None
    if not 1 <= D <= MAX_SHARDS or any(
            a is not None and a.shape[0] % D for a in (st, pt)):
        raise ValueError(f"cannot cut tables of {st.shape[0]} and "
                         f"{0 if pt is None else pt.shape[0]} rows into {D} "
                         f"equal ranges (1 to {MAX_SHARDS})")
    cards = [d for d in devices if d.type == "cuda"]
    if cards:
        enable_peer_access(cards)

    def cut(a):
        n = a.shape[0] // D
        return tuple(to_device(np.asarray(a[i * n : (i + 1) * n], np.uint32),
                               d) for i, d in enumerate(devices))

    st_shards = cut(st)
    pt_shards = cut(pt) if pt is not None else ()
    # every shard must have arrived before any card's kernel reads it
    for d in cards:
        torch.cuda.synchronize(d)
    ixs = []
    for i, d in enumerate(devices):
        with on_device(d):
            ixs.append(_upload(di, d, st_shards, pt_shards, i))
            check_sharded_table(st_shards, st, d, "junction")
            if pt is not None:
                check_sharded_table(pt_shards, pt, d, "probe")
    memo[key] = ixs
    return ixs


def _upload(di: DeviceIndex, device: torch.device, st_shards=(),
            pt_shards=(), shard=0) -> IndexTensors:
    """The IndexTensors of `di` on `device`: every table uploaded, or, of
    a sharded index, range `shard` of `st_shards` and `pt_shards` (already
    on their devices) in place of st_fused and pt_rows."""
    t = di.scan_tbl
    pt = di.probe_tbl
    at = di.anchor_scan
    if t is None and di.mphf_junction is None:
        raise ValueError("the DeviceIndex holds no junction table")

    def u32(a):
        return to_device(np.asarray(a, np.uint32), device)

    def empty(cols):
        return torch.zeros((0, cols), dtype=torch.int32, device=device)

    def mphf(holder, vrows, vcols):
        """(rows, vrows, frows, meta) of an MphfJunction / MphfAnchors."""
        if holder is None:
            return empty(5), empty(vcols), empty(12), None
        rows, frows = fuse_mphf(holder.mphf)
        return u32(rows), u32(vrows), u32(frows), mphf_meta_of(holder.mphf)

    mj, ma = di.mphf_junction, di.anchor_mphf
    mph_rows, mph_jrows, mph_f, mph_meta = mphf(
        mj, None if mj is None else mj.jrows, 10)
    amph_rows, amph_arows, amph_f, amph_meta = mphf(
        ma, None if ma is None else ma.arows, 5)
    if st_shards:
        st_fused = st_shards[shard]
    else:
        st_fused = u32(fuse_scan_table(t)) if t is not None else empty(320)
    if pt_shards:
        pt_rows = pt_shards[shard]
    else:
        pt_rows = u32(pt.rows) if pt is not None else empty(32)
    ix = IndexTensors(
        st_fused=st_fused,
        st_seed=int(t.seed) if t is not None else 0,
        umeta=to_device(np.asarray(di.umeta, np.int32), device),
        pool_rows=u32(di.pool_rows),
        n_chunks=int(di.n_chunks),
        pt_rows=pt_rows,
        pt_seed=int(pt.seed) if pt is not None else 0,
        at_fused=u32(fuse_scan_table(at)) if at is not None else empty(160),
        at_seed=int(at.seed) if at is not None else 0,
        mph_rows=mph_rows, mph_jrows=mph_jrows, mph_f=mph_f,
        mph_meta=mph_meta,
        amph_rows=amph_rows, amph_arows=amph_arows, amph_f=amph_f,
        amph_meta=amph_meta, st_shards=st_shards, pt_shards=pt_shards,
    )
    # every stored key must come back at its own row (K7, once per table
    # and upload): a table that disagrees with the lookup would show only
    # as reads that fail to align
    if mph_meta is not None:
        check_mphf_table(mph_rows, mph_f, mph_jrows, mph_meta, "junction")
    if amph_meta is not None:
        check_mphf_table(amph_rows, amph_f, amph_arows, amph_meta, "anchor")
    return ix
