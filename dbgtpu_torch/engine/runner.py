"""Host-side batching around the torch engine (counterpart of
dbgtpu/engine/runner.py align_bulk, one device, greedy, anchor and
exhaustive modes).

Parsed reads are packed into batches (2-bit words + N bits, native C
packer when available), each batch is mapped by
core.align_batch_packed_compact on the device, the host fetches the
result's meta columns and the populated prefix of its path slots
(engine/compact.py) and unpacks them in input order.  Rows whose true
path length exceeds the batch's pmax are recomputed exactly on the host
by the executable spec of the mode (model.py, anchors.py,
exhaustive.py) — part of the output contract, as in dbgtpu.  There is
no other host fallback: a device failure raises.

dbgtpu's runner quantises the fetched prefix, fetches speculatively and
groups dispatches, against recompiles and a slow link; none of that is
needed here, and the prefix is sliced exactly.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..constants import STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC
from ..index.build import UnitigGraph
from ..index.device import DeviceIndex, build_device_index
from ..index.persist import device_index_memo
from ..spec import spec_for
from .compact import compact_counts, expand_compact
from .core import align_batch_packed_compact
from .index import index_tensors, to_device

# device-side path-slot bound (offset + signed ids) before the host
# recompute takes over; scales with the read length (runner._pmax_cap)
PMAX_CAP = 30


def _pmax_cap(L: int) -> int:
    return max(PMAX_CAP, L // 4)


def get_device_index(graph: UnitigGraph, layout: str = "scan") -> DeviceIndex:
    """The graph's DeviceIndex in `layout` ("scan" or "mphf"), built once
    per layout and kept on the graph; a graph built in dog mode also
    gets its anchor table."""
    memo = device_index_memo(graph)
    if layout not in memo:
        memo[layout] = build_device_index(graph, layout=layout)
    return memo[layout]


def _bucket_len(n: int, k: int) -> int:
    """Read length rounded up: multiples of 16 up to 256, then of 256."""
    n = max(n, k + 1, 64)
    if n <= 256:
        return ((n + 15) // 16) * 16
    return ((n + 255) // 256) * 256


def _pmax_for(di: DeviceIndex, L: int) -> int:
    """Static packed-path bound: offset slot + signed-id slots (every
    non-final junction push advances the walk by >= the shortest
    unitig's stride)."""
    ul = di.ulen[1:]
    stride = max(1, int(ul.min(initial=1)) - (di.k - 1))
    span = L - (di.k - 1)
    return int(1 + (span + stride - 1) // stride + 4)


def pack_words_batch(codes: np.ndarray, nmask: np.ndarray):
    """[B, L] uint8 codes + bool N-mask -> (words uint32 [B, ceil(L/16)],
    nmbits uint32 [B, ceil(L/32)])."""
    B, L = codes.shape
    Lw = (L + 15) // 16
    c = np.pad(codes, ((0, 0), (0, Lw * 16 - L)))
    words = (
        c.reshape(B, Lw, 16).astype(np.uint32)
        << (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    ).sum(axis=2, dtype=np.uint32)
    Lb = (L + 31) // 32
    nmp = np.pad(nmask, ((0, 0), (0, Lb * 32 - L)))
    nmbits = (
        nmp.reshape(B, Lb, 32).astype(np.uint32)
        << np.arange(32, dtype=np.uint32)[None, None, :]
    ).sum(axis=2, dtype=np.uint32)
    return words, nmbits


def pack_records(parsed, lens_all, s0: int, nb: int, L: int):
    """Records [s0, s0+nb) -> (words, nmbits, lens) numpy arrays; nmbits
    is [nb, 0] when the batch holds no N."""
    if native.available():
        words, nmbits, blens = native.pack_batch_native(parsed, s0, nb, nb, L)
    else:
        lens = lens_all[s0 : s0 + nb]
        starts = parsed.seq_off[s0 : s0 + nb]
        col = np.arange(L, dtype=np.int64)[None, :]
        gidx = starts[:, None] + np.minimum(col, (lens - 1)[:, None])
        valid = col < lens[:, None]
        codes = np.where(valid, parsed.codes[gidx], 0).astype(np.uint8)
        nmask = parsed.nmask[gidx] & valid
        words, nmbits = pack_words_batch(codes, nmask)
        blens = lens.astype(np.int32)
    if not nmbits.any():
        nmbits = np.zeros((nb, 0), np.uint32)
    return words, nmbits, blens.astype(np.int32)


def align_bulk(graph: UnitigGraph, parsed, m: int, effort: int, *,
               batch_size: int, device, mode: str = "greedy",
               partial: bool = False, index_layout: str = "scan",
               on_batch=None, xfer=None, progress=None):
    """Mapping of every parsed record in `mode`, input order preserved.

    Returns (status int32 [N], path_off int64 [N+1], paths_flat int32):
    aligned reads' spans hold [offset, signed ids...], other reads have
    empty spans.  `on_batch(slot, s0, nb, status, counts, flat)` is
    called after each batch (the caller formats output there); `xfer`
    collects the batch payload bytes (h2d_bytes, d2h_bytes);
    `progress(done, total, aligned)` is called after each batch with the
    records done and aligned so far in this call."""
    spec = spec_for(mode, m, effort, partial)
    di = get_device_index(graph, index_layout)
    ix = index_tensors(di, device)
    k = graph.k
    N = parsed.n
    lens_all = np.diff(parsed.seq_off).astype(np.int32)
    status_all = np.zeros(N, np.int32)
    counts_all = np.zeros(N, np.int64)
    flat_parts: list[np.ndarray] = []
    n_aligned = 0
    if xfer is None:
        xfer = {}
    xfer.setdefault("h2d_bytes", 0)
    xfer.setdefault("d2h_bytes", 0)

    for slot, s0 in enumerate(range(0, N, batch_size)):
        nb = min(batch_size, N - s0)
        L = _bucket_len(int(lens_all[s0 : s0 + nb].max(initial=k + 1)), k)
        pmax = min(_pmax_for(di, L), _pmax_cap(L))
        words, nmbits, blens = pack_records(parsed, lens_all, s0, nb, L)
        xfer["h2d_bytes"] += words.nbytes + nmbits.nbytes + blens.nbytes
        meta_d, flat_d = align_batch_packed_compact(
            ix, to_device(words, device), to_device(nmbits, device),
            to_device(blens, device), mode=mode, k=k, m=m, effort=effort,
            L=L, pmax=pmax, partial=partial,
        )
        meta = meta_d.cpu().numpy()
        counts = compact_counts(meta, pmax)
        prefix = flat_d[: int(counts.sum())].cpu().numpy()
        xfer["d2h_bytes"] += meta.nbytes + prefix.nbytes

        status = meta[:, 0].astype(np.int32)
        plen = meta[:, 1].astype(np.int32)
        aligned = (status == STATUS_ALIGNED_FWD) | (status == STATUS_ALIGNED_RC)
        over = aligned & (plen > pmax)
        paths = expand_compact(meta, prefix, pmax).astype(np.int32)
        if di.id_inv is not None:
            # renumbered device ids -> file-order ids (slot 0 is the
            # offset; overflow rows are recomputed with file-order ids)
            cols = np.arange(paths.shape[1])[None, :]
            sel = ((aligned & ~over)[:, None] & (cols >= 1)
                   & (cols < counts[:, None]))
            v = paths[sel]
            paths[sel] = np.sign(v) * di.id_inv[np.abs(v)]
        if over.any():
            # the device rows hold only pmax path slots: recompute these
            # reads exactly with the executable spec
            full = {}
            for i in np.nonzero(over)[0]:
                _, codes, nm = parsed.record(s0 + int(i))
                st, path = spec(graph, codes, nm)
                status[i] = st
                full[int(i)] = path or []
            aligned = (status == STATUS_ALIGNED_FWD) | (
                status == STATUS_ALIGNED_RC)
            wide = max([pmax] + [len(p) for p in full.values()])
            if wide > paths.shape[1]:
                paths = np.pad(paths, ((0, 0), (0, wide - paths.shape[1])))
            for i, path in full.items():
                paths[i, : len(path)] = path
                paths[i, len(path):] = 0
                counts[i] = len(path)
            counts = np.where(aligned, counts, 0)
        status_all[s0 : s0 + nb] = status
        counts_all[s0 : s0 + nb] = counts
        cols = np.arange(paths.shape[1])[None, :]
        flat = paths[aligned[:, None] & (cols < counts[:, None])]
        flat_parts.append(flat)
        if on_batch is not None:
            on_batch(slot, s0, nb, status, counts, flat)
        if progress is not None:
            n_aligned += int(aligned.sum())
            progress(s0 + nb, N, n_aligned)

    path_off = np.zeros(N + 1, np.int64)
    np.cumsum(counts_all, out=path_off[1:])
    paths_flat = (np.concatenate(flat_parts) if flat_parts
                  else np.zeros(0, np.int32))
    return status_all, path_off, paths_flat
