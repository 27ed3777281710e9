"""The pipelined runner of dbgtpu_torch (engine/runner.py align_bulk) on
the CPU (the kernels' plain versions): output bytes against dbgtpu's
python spec at several batch sizes, with N, with rows over pmax, in
greedy, -G and -b -i under both index layouts; on_batch and progress in
slot order; a failure in the drain thread raises out of align_bulk;
the payload bytes equal the serial runner's arithmetic.  Tolerance 0."""

import concurrent.futures
import sys
import threading

import numpy as np
import pytest

from dbgtpu.pipeline import run_pipeline as dbgtpu_pipeline
from dbgtpu_torch import native
from dbgtpu_torch.engine import runner
from dbgtpu_torch.engine.core import align_batch_packed_compact
from dbgtpu_torch.engine.index import index_tensors, to_device
from dbgtpu_torch.index.build import build_graph
from dbgtpu_torch.pipeline import run_pipeline
from dbgtpu_torch.spans import Recorder

from . import synth

_COUNTS = ("read_number", "aligned", "not_aligned", "no_overlap")
# (k, make_dataset arguments): reads with N; stride-1 unitigs, whose
# paths run past the 30-slot device cap and are recomputed on the host
_DATASETS = {
    "with_n": (21, dict(genome_len=8000, n_reads=60, n_frac=0.2)),
    "over_pmax": (15, dict(genome_len=6000, n_reads=40, min_unitig=15,
                           max_unitig=18, decoy_frac=0.0)),
}
_MODES = {"greedy": ("greedy", False), "anchors": ("anchors", False),
          "exhaustive_i": ("exhaustive", True)}
_WANT: dict = {}


def _files(tmp_path_factory, name):
    k, kw = _DATASETS[name]
    d = tmp_path_factory.getbasetemp() / f"runner_{name}"
    rf, uf = d / "reads.fa", d / "unitigs.fa"
    if not rf.exists():
        d.mkdir(exist_ok=True)
        reads_fa, unitigs_fa = synth.make_dataset(seed=1010, k=k, **kw)
        rf.write_bytes(reads_fa)
        uf.write_bytes(unitigs_fa)
    return k, str(rf), str(uf)


def _want(name, k, rf, uf, mode, partial):
    """dbgtpu's python spec, once per dataset and mode."""
    key = (name, mode, partial)
    if key not in _WANT:
        _WANT[key] = dbgtpu_pipeline([rf], uf, k=k, m=2, impl="python",
                                     mode=mode, partial=partial)
    return _WANT[key]


def _same(got, want):
    assert got[0] == want[0]
    assert got[1] == want[1]
    for f in _COUNTS:
        assert getattr(got[2], f) == getattr(want[2], f), f


@pytest.mark.parametrize("layout", ["scan", "mphf"])
@pytest.mark.parametrize("mode_name", list(_MODES))
@pytest.mark.parametrize("name", list(_DATASETS))
def test_runner_bytes_equal_spec(tmp_path_factory, name, mode_name, layout):
    k, rf, uf = _files(tmp_path_factory, name)
    mode, partial = _MODES[mode_name]
    want = _want(name, k, rf, uf, mode, partial)
    got = run_pipeline([rf], uf, k=k, m=2, batch_size=7, device="cpu",
                       mode=mode, partial=partial, index_layout=layout)
    _same(got, want)
    assert got[2].aligned > 0
    if name == "over_pmax" and mode == "greedy":
        longest = max(ln.count(b".") for ln in got[0].split(b"\n")[1::2])
        assert longest > runner.PMAX_CAP


@pytest.mark.parametrize("batch_size", [1, 7, 64, 61])
def test_runner_batch_sizes(tmp_path_factory, batch_size):
    """One read a batch, a ragged last batch, one batch larger than the
    file (61 > its 60 reads)."""
    k, rf, uf = _files(tmp_path_factory, "with_n")
    got = run_pipeline([rf], uf, k=k, m=2, batch_size=batch_size,
                       device="cpu")
    _same(got, _want("with_n", k, rf, uf, "greedy", False))


def _parsed(tmp_path_factory, name="with_n"):
    k, rf, uf = _files(tmp_path_factory, name)
    return build_graph(uf, k), native.parse_reads(rf, k, False)


def test_runner_calls_back_in_slot_order(tmp_path_factory):
    """on_batch and progress run on the drain thread, once per batch, in
    slot order, with the records done so far."""
    graph, parsed = _parsed(tmp_path_factory)
    calls, threads = [], set()

    def on_batch(slot, s0, nb, status, counts, flat):
        threads.add(threading.get_ident())
        calls.append(("batch", slot, s0, nb, int(counts.sum()), len(flat)))

    def progress(done, total, aligned):
        calls.append(("progress", done, total, aligned))

    status, path_off, flat = runner.align_bulk(
        graph, parsed, 2, 2, batch_size=8, device="cpu", on_batch=on_batch,
        progress=progress)
    n = parsed.n
    starts = list(range(0, n, 8))
    assert [c[1] for c in calls if c[0] == "batch"] == list(range(len(starts)))
    assert [c[2] for c in calls if c[0] == "batch"] == starts
    assert [c[1] for c in calls if c[0] == "progress"] == [
        min(s + 8, n) for s in starts]
    assert calls[-1][1:3] == (n, n)
    assert calls[-1][3] == int(((status == 1) | (status == 2)).sum())
    # each batch's callbacks: on_batch, then progress
    assert [c[0] for c in calls] == ["batch", "progress"] * len(starts)
    assert threads and threading.get_ident() not in threads
    assert sum(c[4] for c in calls if c[0] == "batch") == path_off[-1]


def test_runner_drain_failure_raises(tmp_path_factory, monkeypatch):
    """An exception in the drain thread (here in the rebuild of the third
    batch) raises out of align_bulk, within a timeout; the batches after
    it stop (a drain already running ends, the queued ones are
    cancelled)."""
    graph, parsed = _parsed(tmp_path_factory)
    real, seen = runner.expand_compact, []

    def failing(*a, **kw):
        seen.append(threading.get_ident())
        if len(seen) == 3:
            raise RuntimeError("injected drain failure")
        return real(*a, **kw)

    monkeypatch.setattr(runner, "expand_compact", failing)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(runner.align_bulk, graph, parsed, 2, 2,
                          batch_size=4, device="cpu")
        with pytest.raises(RuntimeError, match="injected drain failure"):
            fut.result(timeout=120)
    assert 3 <= len(seen) <= 3 + runner.IN_FLIGHT < -(-parsed.n // 4)


def test_runner_in_flight_bound(tmp_path_factory, monkeypatch):
    """At most IN_FLIGHT batches are launched and not yet drained: the
    launch of batch i waits for the drain of batch i - IN_FLIGHT."""
    graph, parsed = _parsed(tmp_path_factory)
    real_launch = runner.align_batch_packed_compact
    real_expand = runner.expand_compact
    state = {"launched": 0, "drained": 0, "most": 0}
    lock = threading.Lock()

    def launch(*a, **kw):
        with lock:
            state["launched"] += 1
            state["most"] = max(state["most"],
                                state["launched"] - state["drained"])
        return real_launch(*a, **kw)

    def expand(*a, **kw):
        out = real_expand(*a, **kw)
        with lock:
            state["drained"] += 1
        return out

    monkeypatch.setattr(runner, "align_batch_packed_compact", launch)
    monkeypatch.setattr(runner, "expand_compact", expand)
    runner.align_bulk(graph, parsed, 2, 2, batch_size=4, device="cpu")
    assert state["launched"] == state["drained"] == -(-parsed.n // 4)
    assert state["most"] <= runner.IN_FLIGHT


def test_runner_under_frequent_thread_switches(tmp_path_factory):
    """The launching thread and the drain share the result arrays and
    the byte and leg counts; with the interpreter switching
    threads every microsecond the rows, the callbacks' order and the
    byte counts stay those of an undisturbed run (a lost update would
    break one)."""
    graph, parsed = _parsed(tmp_path_factory)
    want_xfer: dict = {}
    want = runner.align_bulk(graph, parsed, 2, 2, batch_size=2, device="cpu",
                             xfer=want_xfer)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            xfer, slots = {}, []
            got = runner.align_bulk(
                graph, parsed, 2, 2, batch_size=2, device="cpu", xfer=xfer,
                on_batch=lambda slot, *rest: slots.append(slot))
            for a, b in zip(got, want):
                assert (a == b).all()
            assert slots == list(range(-(-parsed.n // 2)))
            assert [xfer[key] for key in ("h2d_bytes", "d2h_bytes")] == [
                want_xfer[key] for key in ("h2d_bytes", "d2h_bytes")]
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("mode", ["greedy", "anchors"])
def test_runner_payload_bytes_equal_serial_arithmetic(tmp_path_factory, mode):
    """xfer's H2D bytes are each batch's packed words, N bits and
    lengths, its D2H bytes each batch's meta and populated prefix: what
    a serial runner (pack, launch, fetch, one batch at a time) counts."""
    k, rf, uf = _files(tmp_path_factory, "with_n")
    graph = build_graph(uf, k, dog_mode=mode == "anchors")
    parsed = native.parse_reads(rf, k, False)
    xfer: dict = {}
    spans = Recorder()
    runner.align_bulk(graph, parsed, 2, 2, batch_size=16, device="cpu",
                      mode=mode, xfer=xfer, spans=spans)
    di = runner.get_device_index(graph, "scan")
    ix = index_tensors(di, "cpu")
    lens_all = np.diff(parsed.seq_off).astype(np.int32)
    h2d = d2h = 0
    for s0 in range(0, parsed.n, 16):
        nb = min(16, parsed.n - s0)
        L = runner._bucket_len(int(lens_all[s0 : s0 + nb].max()), k)
        pmax = min(runner._pmax_for(di, L), runner._pmax_cap(L))
        words, nmbits, blens = runner.pack_records(parsed, lens_all, s0, nb,
                                                   L)
        h2d += words.nbytes + nmbits.nbytes + blens.nbytes
        meta, flat = align_batch_packed_compact(
            ix, to_device(words, "cpu"), to_device(nmbits, "cpu"),
            to_device(blens, "cpu"), mode=mode, k=k, m=2, effort=2, L=L,
            pmax=pmax)
        meta = meta.numpy()
        n = int(runner.compact_counts(meta, pmax).sum())
        d2h += meta.nbytes + flat[:n].numpy().nbytes
    assert (xfer["h2d_bytes"], xfer["d2h_bytes"]) == (h2d, d2h)
    for leg in ("launch", "drain", "fetch", "stall"):
        assert spans.total(leg) > 0.0
