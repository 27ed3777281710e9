"""Host-side batching around the torch engine (counterpart of
dbgtpu/engine/runner.py align_bulk: greedy, anchor and exhaustive
modes, one device or a mesh of local devices).

Parsed reads are packed into batches (2-bit words + N bits, native C
packer when available), each batch is mapped by
core.align_batch_packed_compact on the device, the host fetches the
result's meta columns and the populated prefix of its path slots
(engine/compact.py) and unpacks them in input order.  Rows whose true
path length exceeds the batch's pmax are recomputed exactly on the host
by the executable spec of the mode (model.py, anchors.py,
exhaustive.py) — part of the output contract, as in dbgtpu.  There is
no other host fallback: a device failure raises.

The batches run as a pipeline, as dbgtpu's do (runner.py:552-694).
The calling thread packs a batch, uploads it through pinned memory
without blocking, launches its kernels and queues the copy of `meta`
into a pinned buffer behind them, then goes on to the next batch.  One
drain thread takes the batches in slot order: it waits for `meta` (an
event), fetches the populated prefix of `flat` on a side stream,
rebuilds the rows, recomputes the rows over pmax and calls `on_batch`
and `progress`.  The native pack and format release the
GIL, so a batch's pack and an earlier batch's format run side by side.
Every kernel launches from the calling thread (the launch counts and
K8's scratch per stream are not shared with the drain), and at most
IN_FLIGHT batches are launched and not yet drained.

With a mesh (dist/mesh.py make_mesh) each batch is cut into contiguous
equal shards, one per device; every shard is launched on its own device
before any is drained, and the drain joins the shards' rows in read
order.  The index is replicated (index_tensors memoizes it per device),
or with `shard_index` its two large tables are cut over the mesh's
devices (engine/index.py sharded_index_tensors), after dbgtpu's guards
(`check_shard_index`).

dbgtpu's runner quantises the fetched prefix and ratchets pmax, against
XLA recompiles and a slow link; neither is needed here, and the prefix
is sliced exactly.  Nor does it queue a prefix guessed from the running
maximum at launch, as dbgtpu does (runner.py:608-621): on the H100 that
guess timed level with the drain's fetch and added 7% to D2H.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..constants import STATUS_ALIGNED_FWD, STATUS_ALIGNED_RC
from ..index.build import UnitigGraph
from ..index.device import DeviceIndex, build_device_index
from ..index.persist import device_index_memo
from ..spans import Recorder
from ..spec import spec_for
from .compact import compact_counts, expand_compact
from .core import align_batch_packed_compact
from .index import (
    IndexTensors, index_tensors, on_device, sharded_index_tensors,
)

# device-side path-slot bound (offset + signed ids) before the host
# recompute takes over; scales with the read length (runner._pmax_cap)
PMAX_CAP = 30

# batches launched and not yet drained, at most (dbgtpu's bound,
# runner.py:684): bounds the device and pinned buffers held at once
IN_FLIGHT = 3


def _pmax_cap(L: int) -> int:
    return max(PMAX_CAP, L // 4)


def get_device_index(graph: UnitigGraph, layout: str = "scan",
                     spans: Recorder | None = None) -> DeviceIndex:
    """The graph's DeviceIndex in `layout` ("scan" or "mphf"), built once
    per layout and kept on the graph (its phases in `spans`); a graph
    built in dog mode also gets its anchor table."""
    memo = device_index_memo(graph)
    if layout not in memo:
        memo[layout] = build_device_index(graph, layout=layout, spans=spans)
    return memo[layout]


def check_shard_index(di: DeviceIndex, mode: str, n_devices: int) -> None:
    """dbgtpu's guards of `--shard-index` on a mesh of `n_devices`
    (dbgtpu/engine/runner.py:287-307, whatever the mesh's size): greedy
    mode, a scan table (an MPHF index has none: 0 rows) and a probe table
    of at least one row per device or none, and row counts that the
    device count divides.  Raises ValueError with dbgtpu's text."""
    nb_st = di.scan_tbl.keys.shape[0] if di.scan_tbl else 0
    nb_pt = di.probe_tbl.rows.shape[0] if di.probe_tbl else 0
    if mode != "greedy" or nb_st < n_devices or 0 < nb_pt < n_devices:
        raise ValueError(
            "--shard-index requires greedy mode and index "
            "tables with at least one bucket row per device"
        )
    if nb_st % n_devices or nb_pt % n_devices:
        raise ValueError(
            "--shard-index requires the bucket counts to "
            f"divide the mesh evenly (junction {nb_st} rows, "
            f"probe {nb_pt} rows, mesh {n_devices}); bucket counts "
            "are powers of two, so use a power-of-two mesh size"
        )


def mesh_index(graph: UnitigGraph, layout: str, devices, mode: str,
               mesh: bool = False, shard_index: bool = False
               ) -> list[IndexTensors]:
    """The graph's index tensors on each of `devices`: replicated, or with
    `shard_index` on a mesh (`mesh`) cut over them, after dbgtpu's guards
    (a mesh of one device holds the tables as one range, checked at
    upload as every sharded table is)."""
    di = get_device_index(graph, layout)
    if mesh and shard_index:
        check_shard_index(di, mode, len(devices))
        return sharded_index_tensors(di, devices)
    ixs = []
    for d in devices:
        with on_device(d):
            ixs.append(index_tensors(di, d))
    return ixs


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


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy array -> tensor on `device` (uint32 as int32 with the same
    bits).  To a card it goes through pinned memory without blocking the
    host: the caching host allocator keeps the pinned block until its
    copy has run."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _Shard:
    """One device's rows of a batch, launched: the device result and the
    host copy of `meta` (queued behind the kernels on a card, the result
    itself on the CPU)."""

    def __init__(self, meta_d, flat_d, fetch_stream):
        self.flat_d, self.fetch_stream = flat_d, fetch_stream
        self.event = None
        if meta_d.device.type != "cuda":
            self.meta_h = meta_d
            return
        self.meta_h = torch.empty(meta_d.shape, dtype=meta_d.dtype,
                                  pin_memory=True)
        self.meta_h.copy_(meta_d, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def fetch(self, pmax: int):
        """(meta, counts, prefix) on the host, from the drain thread: waits
        for `meta`, then copies the populated prefix of `flat` on the
        device's fetch stream (a copy, no kernel)."""
        if self.event is None:
            meta = self.meta_h.numpy()
            counts = compact_counts(meta, pmax)
            return meta, counts, self.flat_d[: int(counts.sum())].numpy()
        self.event.synchronize()
        meta = self.meta_h.numpy()
        counts = compact_counts(meta, pmax)
        with torch.cuda.stream(self.fetch_stream):
            self.fetch_stream.wait_event(self.event)
            prefix = self.flat_d[: int(counts.sum())].cpu()
        return meta, counts, prefix.numpy()


def align_bulk(graph: UnitigGraph, parsed, m: int, effort: int, *,
               batch_size: int, device, mode: str = "greedy",
               partial: bool = False, index_layout: str = "scan",
               mesh=None, shard_index: bool = False, on_batch=None,
               xfer=None, progress=None, spans: Recorder | None = None):
    """Mapping of every parsed record in `mode`, input order preserved.

    Returns (status int32 [N], path_off int64 [N+1], paths_flat int32):
    aligned reads' spans hold [offset, signed ids...], other reads have
    empty spans.  `mesh` (a list of devices, dist.mesh.make_mesh) splits
    every batch over its devices, `batch_size` rounded up to a multiple
    of their count (dbgtpu's rule, runner.py:285-286); without one the
    batches run on `device`.  `shard_index` (dbgtpu's `--shard-index`)
    cuts the index's two large tables over the mesh's devices
    (`mesh_index`); without a mesh it changes nothing.
    `on_batch(slot, s0, nb, status, counts, flat)` is called after each
    batch, in slot order, on the drain thread (the caller formats output
    there, in spans that take the batch's id from its `format` span);
    `xfer` collects the batch payload bytes (h2d_bytes; d2h_bytes, meta
    and the populated prefix); `progress(done, total, aligned)` is
    called after each batch with the records done and aligned so far in
    this call.  A failure in the drain raises here.

    `spans` (spans.py) gets the pipeline's legs, each batch's spans
    carrying its id, unique within the run: on this thread `launch`
    (children `launch.pack` and `launch.card` per card: upload, kernels
    and queued copies) and `stall` (waiting for the drain of the batch);
    on the drain thread one `fetch` per card (the wait for `meta`, the
    prefix's copy, and `fetch.expand`, its rows rebuilt), then `drain`
    (children `drain.rebuild`, `drain.recompute` over pmax with counter
    `reads`, and `format` around `on_batch`)."""
    devices = list(mesh) if mesh else [torch.device(device)]
    if len(devices) > 1:
        batch_size = -(-batch_size // len(devices)) * len(devices)
    spec = spec_for(mode, m, effort, partial)
    di = get_device_index(graph, index_layout)
    ixs = mesh_index(graph, index_layout, devices, mode, bool(mesh),
                     shard_index)
    fetch_streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                     for d in devices]
    k = graph.k
    N = parsed.n
    lens_all = np.diff(parsed.seq_off).astype(np.int32)
    status_all = np.zeros(N, np.int32)
    counts_all = np.zeros(N, np.int64)
    flat_parts: list = []
    if xfer is None:
        xfer = {}
    for key in ("h2d_bytes", "d2h_bytes"):
        xfer.setdefault(key, 0)
    if spans is None:
        spans = Recorder()
    batch0 = spans.batches(-(-N // batch_size))
    seen = {"aligned": 0}

    def launch(s0, nb, L, pmax) -> list:
        """Pack records [s0, s0+nb), launch each shard's kernels on its
        device and queue its copies: the batch's shards."""
        with spans.span("launch.pack"):
            words, nmbits, blens = pack_records(parsed, lens_all, s0, nb, L)
        xfer["h2d_bytes"] += words.nbytes + nmbits.nbytes + blens.nbytes
        step = -(-nb // len(devices))
        shards = []
        for card, (dev, ix, fs, a) in enumerate(zip(
                devices, ixs, fetch_streams, range(0, nb, step))):
            b = min(a + step, nb)
            with spans.span("launch.card", card=card), on_device(dev):
                meta_d, flat_d = align_batch_packed_compact(
                    ix, upload(words[a:b], dev), upload(nmbits[a:b], dev),
                    upload(blens[a:b], dev), mode=mode, k=k, m=m,
                    effort=effort, L=L, pmax=pmax, partial=partial,
                )
                shards.append(_Shard(meta_d, flat_d, fs))
        return shards

    def drain(slot, batch, s0, nb, pmax, shards):
        metas, rows = [], []
        for card, sh in enumerate(shards):
            with spans.span("fetch", batch, card):
                meta, counts, prefix = sh.fetch(pmax)
                xfer["d2h_bytes"] += meta.nbytes + prefix.nbytes
                metas.append(meta)
                with spans.span("fetch.expand"):
                    rows.append(expand_compact(meta, prefix, pmax))
        with spans.span("drain", batch):
            with spans.span("drain.rebuild"):
                meta = np.concatenate(metas)
                paths = np.concatenate(rows).astype(np.int32)
                counts = compact_counts(meta, pmax)
                status = meta[:, 0].astype(np.int32)
                plen = meta[:, 1].astype(np.int32)
                aligned = ((status == STATUS_ALIGNED_FWD)
                           | (status == STATUS_ALIGNED_RC))
                over = aligned & (plen > pmax)
                if di.id_inv is not None:
                    # renumbered device ids -> file-order ids (slot 0 is
                    # the offset; overflow rows are recomputed with
                    # file-order ids)
                    cols = np.arange(paths.shape[1])[None, :]
                    sel = ((aligned & ~over)[:, None] & (cols >= 1)
                           & (cols < counts[:, None]))
                    v = paths[sel]
                    paths[sel] = np.sign(v) * di.id_inv[np.abs(v)]
            if over.any():
                with spans.span("drain.recompute"):
                    spans.count("reads", int(over.sum()))
                    paths, counts, aligned = _recompute(
                        s0, paths, counts, status, over, pmax)
            status_all[s0 : s0 + nb] = status
            counts_all[s0 : s0 + nb] = counts
            cols = np.arange(paths.shape[1])[None, :]
            flat = paths[aligned[:, None] & (cols < counts[:, None])]
            flat_parts[slot] = flat
            if on_batch is not None:
                with spans.span("format"):
                    on_batch(slot, s0, nb, status, counts, flat)
            if progress is not None:
                seen["aligned"] += int(aligned.sum())
                progress(s0 + nb, N, seen["aligned"])

    def _recompute(s0, paths, counts, status, over, pmax):
        """The device rows hold only pmax path slots: the reads of `over`
        recomputed exactly with the executable spec (status in place)."""
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
        return paths, np.where(aligned, counts, 0), aligned

    pending: deque = deque()

    def stall():
        """Wait for the oldest batch's drain (its failure raises)."""
        slot, fut = pending.popleft()
        with spans.span("stall", batch0 + slot):
            fut.result()

    with ThreadPoolExecutor(max_workers=1) as pool:
        try:
            for slot, s0 in enumerate(range(0, N, batch_size)):
                batch = batch0 + slot
                with spans.span("launch", batch):
                    nb = min(batch_size, N - s0)
                    L = _bucket_len(
                        int(lens_all[s0 : s0 + nb].max(initial=k + 1)), k)
                    pmax = min(_pmax_for(di, L), _pmax_cap(L))
                    shards = launch(s0, nb, L, pmax)
                    flat_parts.append(None)
                    pending.append((slot, pool.submit(
                        drain, slot, batch, s0, nb, pmax, shards)))
                if len(pending) >= IN_FLIGHT:
                    stall()
            while pending:
                stall()
        except BaseException:
            for _, f in pending:
                f.cancel()
            raise

    path_off = np.zeros(N + 1, np.int64)
    np.cumsum(counts_all, out=path_off[1:])
    paths_flat = (np.concatenate(flat_parts) if flat_parts
                  else np.zeros(0, np.int32))
    return status_all, path_off, paths_flat
