"""Index persistence: save and load the built graph and its device
layout (copy of the numpy part of dbgtpu/index/persist.py; the file
format is dbgtpu's, member for member, so a file either package wrote
loads in the other).

The reference ships BooPHF save/load (BooPHF.h:927-1005) but never
calls it: every run rebuilds the index (SURVEY.md §5).  Here
persistence is `--save-index` / `--load-index` on the command line.

v2 format (this module's writer): the UnitigGraph flat arrays
(pool/offsets/lengths/extremities/jkeys+jvals slot table) plus the
device-ready artifacts (ScanTable, ProbeTable, umeta, pool rows, the
MPHF tables of either layout), so a load gives a device-ready index with
no rebuild.  Uncompressed npz: inflating would cost more than the read
it saves on multi-GB tables.

v1 files (dict-derived arrays) still load; their device index is rebuilt
at first use.

The loaded DeviceIndex is kept on the graph in the port's memo,
`graph._torch_device_index[layout]` (engine/runner.py get_device_index);
engine/index.py index_tensors uploads it at first use.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from .build import AnchorView, UnitigGraph
from .device import (
    PT_SLOTS, DeviceIndex, HashTable, MphfAnchors, MphfJunction, ProbeTable,
    ScanTable, build_device_index,
)
from .mphf import MPHF

_MAGIC_V1 = "dbgtpu-index-v1"
_MAGIC_V2 = "dbgtpu-index-v2"


def _anchor_arrays(g: UnitigGraph) -> dict:
    if not (g.dog_mode and g.anchors):
        return {}
    # the AnchorView is sorted arrays; persist them verbatim
    d = dict(anchor_keys=g.anchors.keys, anchor_vals=g.anchors.vals)
    if g.anchors.ucanon is not None:
        d["anchor_ucanon"] = np.asarray(g.anchors.ucanon, bool)
    return d


def _mphf_arrays(pfx: str, m: MPHF) -> dict:
    d = {
        f"{pfx}_n_keys": m.n_keys, f"{pfx}_gamma": m.gamma,
        f"{pfx}_n_levels": m.n_levels, f"{pfx}_words": m.words,
        f"{pfx}_word_off": m.word_off, f"{pfx}_mask": m.mask,
        f"{pfx}_rank_base": m.rank_base, f"{pfx}_samples": m.samples,
        f"{pfx}_sample_off": m.sample_off,
    }
    if m.final_tbl is not None:
        t = m.final_tbl
        d.update({f"{pfx}_f_khi": t.khi, f"{pfx}_f_klo": t.klo,
                  f"{pfx}_f_vals": t.vals})
    return d


def device_index_memo(g: UnitigGraph) -> dict:
    """The graph's {layout: DeviceIndex} memo (shared with
    engine/runner.py get_device_index)."""
    return g.__dict__.setdefault("_torch_device_index", {})


def save_index(g: UnitigGraph, path: str, di: DeviceIndex | None = None,
               layout: str = "scan") -> None:
    """Persist graph + device layout (v2).  `di` defaults to the graph's
    device index for `layout`, built (and kept on the graph) if absent.

    layout="mphf" persists the compact MPHF junction artifacts (level
    bitvectors + jrows + final table), so a `--load-index --index-layout
    mphf` start needs no rebuild.  Whatever junction layouts the
    DeviceIndex carries are saved; a load under the other layout still
    works, it rebuilds that layout's junction table from the slot
    table."""
    if di is None:
        memo = device_index_memo(g)
        if layout not in memo:
            memo[layout] = build_device_index(g, layout=layout)
        di = memo[layout]
    d = dict(
        magic=_MAGIC_V2, k=g.k, n_unitigs=g.n_unitigs,
        pool=g.pool, offsets=g.offsets, lengths=g.lengths,
        ubeg=g.ubeg, uend=g.uend, dog_mode=g.dog_mode,
        jkeys=(g.jkeys if g.jkeys is not None else np.zeros(0, np.uint64)),
        jvals=(g.jvals if g.jvals is not None else np.zeros((0, 8), np.int32)),
        # device layout
        d_umeta=di.umeta, d_pool_rows=di.pool_rows,
        d_n_chunks=di.n_chunks, d_halo=di.halo_bases,
        d_max_ulen=di.max_ulen, d_pool_words=di.pool_words,
        d_uoff=di.uoff, d_ulen=di.ulen,
        d_ubeg_hi=di.ubeg_hi, d_ubeg_lo=di.ubeg_lo,
        d_uend_hi=di.uend_hi, d_uend_lo=di.uend_lo,
        d_rcbeg_hi=di.rcbeg_hi, d_rcbeg_lo=di.rcbeg_lo,
        d_rcend_hi=di.rcend_hi, d_rcend_lo=di.rcend_lo,
        **_anchor_arrays(g),
    )
    if di.id_inv is not None:
        # graph-order renumbered tables: the new->file-order id map must
        # travel with them (the runner translates on drain)
        d["d_id_inv"] = di.id_inv
    st = di.scan_tbl
    if st is not None:
        d.update(st_keys=st.keys, st_vals=st.vals,
                 st_nb=st.n_buckets, st_seed=st.seed)
    pt = di.probe_tbl
    if pt is not None:
        d.update(pt_rows=pt.rows, pt_nb=pt.n_buckets,
                 pt_seed=pt.seed, pt_window=pt.window)
    at = di.anchor_scan
    if at is not None:
        d.update(at_keys=at.keys, at_vals=at.vals,
                 at_nb=at.n_buckets, at_seed=at.seed)
    if di.anchor_mphf is not None:
        d.update(_mphf_arrays("amph", di.anchor_mphf.mphf),
                 amph_arows=di.anchor_mphf.arows)
    if di.mphf_junction is not None:
        d.update(_mphf_arrays("mph", di.mphf_junction.mphf),
                 mph_jrows=di.mphf_junction.jrows)
    np.savez(path, **d)


def _member_shape(z, name: str) -> tuple:
    """Shape of an npz member from its header alone (the data stays on
    disk)."""
    with z.zip.open(name + ".npy") as f:
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0
                       if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        return read_header(f)[0]


def _load_mphf(z, pfx: str) -> MPHF:
    final = None
    if f"{pfx}_f_khi" in z:
        khi = z[f"{pfx}_f_khi"]
        final = HashTable(khi, z[f"{pfx}_f_klo"], z[f"{pfx}_f_vals"],
                          khi.shape[0])
    return MPHF(
        n_keys=int(z[f"{pfx}_n_keys"]), gamma=float(z[f"{pfx}_gamma"]),
        n_levels=int(z[f"{pfx}_n_levels"]), words=z[f"{pfx}_words"],
        word_off=z[f"{pfx}_word_off"], mask=z[f"{pfx}_mask"],
        rank_base=z[f"{pfx}_rank_base"], samples=z[f"{pfx}_samples"],
        sample_off=z[f"{pfx}_sample_off"], final_tbl=final,
    )


class _Members:
    """An npz file's members by name, each read from the file (and
    inflated, in a compressed file) in an `index.read` span of `spans`,
    with counters `file_bytes` (its stored size) and `array_bytes`."""

    def __init__(self, z, spans):
        self.z, self.spans = z, spans

    def __contains__(self, name) -> bool:
        return name in self.z

    def __getitem__(self, name):
        with self.spans.span("index.read"):
            a = self.z[name]
            self.spans.count("file_bytes",
                             self.z.zip.getinfo(name + ".npy").compress_size)
            self.spans.count("array_bytes", a.nbytes)
        return a

    @property
    def zip(self):
        return self.z.zip


def load_index(path: str, spans=None) -> UnitigGraph:
    """Load a persisted index; returns the graph with its device index
    kept in `graph._torch_device_index` when the file carries one (v2).
    The members' reads are spans of `spans` (`index.read`, spans.py)."""
    from ..spans import Recorder

    z = _Members(np.load(path, allow_pickle=False),
                 Recorder() if spans is None else spans)
    magic = str(z["magic"])
    if magic == _MAGIC_V1:
        return _load_v1(z)
    if magic != _MAGIC_V2:
        raise ValueError(f"{path}: not a dbgtpu index file")
    g = UnitigGraph(
        k=int(z["k"]), n_unitigs=int(z["n_unitigs"]),
        pool=z["pool"], offsets=z["offsets"], lengths=z["lengths"],
        ubeg=z["ubeg"], uend=z["uend"],
        dog_mode=bool(z["dog_mode"]),
        jkeys=z["jkeys"], jvals=z["jvals"],
    )
    _load_anchors(g, z)

    # probe-layout guard: a file written under another probe bucket
    # geometry must not feed mis-shaped rows to the device; drop the
    # device tables and let the first use rebuild them from the (always
    # valid) slot table: right in every mode, only a slower first start.
    # Scan and anchor tables need no guard: the engine derives their
    # slot geometry from the stored row width.
    if "pt_rows" in z and _member_shape(z, "pt_rows")[1] != (
            4 if int(z["pt_window"]) == 4 else 3) * PT_SLOTS:
        return g

    st = None
    if "st_keys" in z:
        st = ScanTable(z["st_keys"], z["st_vals"], int(z["st_nb"]),
                       int(z["st_seed"]))
    at = None
    if "at_keys" in z:
        at = ScanTable(z["at_keys"], z["at_vals"], int(z["at_nb"]),
                       int(z["at_seed"]))
    ma = None
    if "amph_words" in z:
        ma = MphfAnchors(_load_mphf(z, "amph"), z["amph_arows"])
    mj = None
    if "mph_words" in z:
        mj = MphfJunction(_load_mphf(z, "mph"), z["mph_jrows"])
    pt = None
    if "pt_rows" in z:
        pt = ProbeTable(z["pt_rows"], int(z["pt_nb"]), int(z["pt_seed"]),
                        int(z["pt_window"]))
    di = DeviceIndex(
        k=g.k, pool=g.pool, pool_words=z["d_pool_words"],
        uoff=z["d_uoff"], ulen=z["d_ulen"],
        ubeg_hi=z["d_ubeg_hi"], ubeg_lo=z["d_ubeg_lo"],
        uend_hi=z["d_uend_hi"], uend_lo=z["d_uend_lo"],
        rcbeg_hi=z["d_rcbeg_hi"], rcbeg_lo=z["d_rcbeg_lo"],
        rcend_hi=z["d_rcend_hi"], rcend_lo=z["d_rcend_lo"],
        max_ulen=int(z["d_max_ulen"]),
        anchor_scan=at, scan_tbl=st,
        umeta=z["d_umeta"], pool_rows=z["d_pool_rows"],
        n_chunks=int(z["d_n_chunks"]), halo_bases=int(z["d_halo"]),
        probe_tbl=pt, mphf_junction=mj, anchor_mphf=ma,
        id_inv=(z["d_id_inv"] if "d_id_inv" in z else None),
    )
    # one view per junction layout the file carries; a layout it lacks
    # is rebuilt from the slot table at first use (get_device_index)
    memo = device_index_memo(g)
    both = st is not None and mj is not None
    if mj is not None:
        memo["mphf"] = replace(di, scan_tbl=None) if both else di
    if st is not None:
        memo["scan"] = replace(di, mphf_junction=None) if both else di
    return g


def _load_anchors(g: UnitigGraph, z) -> None:
    if "anchor_keys" in z:
        # stored sorted; older files carried int64 vals (and no ucanon
        # column: the device build recomputes it for those)
        g.anchors = AnchorView(
            z["anchor_keys"], z["anchor_vals"].astype(np.int32),
            ucanon=(np.asarray(z["anchor_ucanon"], bool)
                    if "anchor_ucanon" in z else None),
        )


def _load_v1(z) -> UnitigGraph:
    """Legacy loader: dict-derived arrays only; the device index is
    rebuilt from the reconstructed slot table on first use."""
    g = UnitigGraph(
        k=int(z["k"]), n_unitigs=int(z["n_unitigs"]),
        pool=z["pool"], offsets=z["offsets"], lengths=z["lengths"],
        ubeg=z["ubeg"], uend=z["uend"],
        dog_mode=bool(z["dog_mode"]),
    )
    g.left = _arrays_to_dict(z["left_keys"], z["left_flat"], z["left_off"])
    g.right = _arrays_to_dict(z["right_keys"], z["right_flat"], z["right_off"])
    _load_anchors(g, z)
    # reconstruct the slot table so build_device_index takes the
    # vectorized path rather than the per-key python loop
    keys = np.union1d(
        np.fromiter(g.left.keys(), np.uint64, count=len(g.left)),
        np.fromiter(g.right.keys(), np.uint64, count=len(g.right)),
    )
    vals = np.zeros((len(keys), 8), np.int32)
    for i, key in enumerate(keys.tolist()):
        for j, uid in enumerate(g.left.get(key, [])[:4]):
            vals[i, j] = uid
        for j, uid in enumerate(g.right.get(key, [])[:4]):
            vals[i, 4 + j] = uid
    g.jkeys, g.jvals = keys, vals
    return g


# ---- legacy v1 writer kept for tests/back-compat tooling ----

def _dict_to_arrays(d: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """{key -> [ids]} -> (keys u64 [N], flat int32, off int64 [N+1])."""
    keys = np.fromiter(d.keys(), dtype=np.uint64, count=len(d))
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    lists = list(d.values())
    flat = []
    off = [0]
    for i in order:
        ids = lists[i]
        flat.extend(ids)
        off.append(off[-1] + len(ids))
    return keys, np.array(flat, np.int32), np.array(off, np.int64)


def _arrays_to_dict(keys, flat, off) -> dict:
    return {
        int(k): [int(v) for v in flat[off[i] : off[i + 1]]]
        for i, k in enumerate(keys)
    }


def save_graph(g: UnitigGraph, path: str) -> None:
    """Legacy v1 writer (graph only, dict-derived arrays)."""
    lk, lf, lo = _dict_to_arrays(g.left)
    rk, rf, ro = _dict_to_arrays(g.right)
    d = dict(
        magic=_MAGIC_V1, k=g.k, n_unitigs=g.n_unitigs,
        pool=g.pool, offsets=g.offsets, lengths=g.lengths,
        ubeg=g.ubeg, uend=g.uend,
        left_keys=lk, left_flat=lf, left_off=lo,
        right_keys=rk, right_flat=rf, right_off=ro,
        dog_mode=g.dog_mode,
        **_anchor_arrays(g),
    )
    np.savez_compressed(path, **d)


def load_graph(path: str) -> UnitigGraph:
    """Load either format (alias of load_index, kept for callers)."""
    return load_index(path)
