"""How a kernel is timed and bounded: the timers and one bound convention
for chip_smoke.py, torch_profile.py and tools/exp_gather.py.

Two timers.  `cuda_ms` puts CUDA events around a run of back-to-back
calls from Python: what a kernel costs in a run of launches through its
C entry point, which for a kernel shorter than a Python and ctypes
launch is the host's launch rate.  `graph_ms` captures the launches once
into a CUDA graph and replays it between the events, so the device
alone sets the pace: a short kernel's own time plus the graph's per
launch cost, which `launch_floor_ms` measures on a kernel that does
nothing.

Against another tree's kernels (`--baseline-csrc`, build.load_from):
`in_turns` times both in turns, and `on` launches this tree's
`build.Launch` on the older library, through `OLDER_ENTRIES` where the
older entry point takes other arguments.

`device_busy` reads a torch.profiler run: the device-side events'
summed time over the run's host wall."""

from __future__ import annotations

import ctypes
import statistics

HBM_BYTES_PER_S = 3.35e12       # the H100's published memory rate
# 32-bit integer operations: a quarter of the published 67 TFLOP/s of
# float32, which counts a fused multiply-add as two on twice as many lanes
INT_OPS_PER_S = 67e12 / 4
# NVLink into one H100 from the other cards of its host: 450 GB/s each
# way of the published 900 GB/s
NVLINK_BYTES_PER_S = 450e9


def bound_ms(stream_bytes: int, touched: int, table: int,
             ops: int, remote_share: float = 0.0) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for a
    function that streams `stream_bytes` (each tensor once), touches
    `touched` bytes of rows in tables of `table` bytes (never more than
    the table) and needs `ops` integer operations: the larger of the
    bytes over the memory rate and the operations over the integer
    rate.  `remote_share` of the touched bytes lie on other cards of a
    sharded index: those bytes also cross NVLink, at NVLINK_BYTES_PER_S
    into this card, and the byte time is the larger of the two."""
    rows = min(touched, table)
    t_bytes = max((stream_bytes + rows) / HBM_BYTES_PER_S,
                  remote_share * rows / NVLINK_BYTES_PER_S)
    t_ops = ops / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_busy(prof, wall_s: float):
    """(summed device-event ms, busy share, per-name (device ms, event
    count)).  The counts show a trace that lost events: every kernel of
    a mode's path runs once per batch."""
    from torch.autograd import DeviceType

    total_us, by_name = 0.0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        total_us += us
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + us / 1e3, n + 1)
    by_name = dict(sorted(by_name.items(), key=lambda x: -x[1][0]))
    return total_us / 1e3, total_us / 1e3 / (wall_s * 1e3), by_name


def cuda_ms(fn, reps: int, launches: int = 1) -> float:
    """Median milliseconds per call of `fn` over `reps` timed runs (CUDA
    events, after one warm-up call).  A run is one call, or `launches`
    back-to-back calls between the two events: a kernel's own time where
    one call's host work would outlast it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def graph_ms(bind, reps: int, launches: int = 1):
    """(median ms per launch, outputs): `launches` launches captured once
    into a torch.cuda.CUDAGraph, replayed between two CUDA events, over
    `reps` timed replays (after one warm-up call and one replay).

    bind() -> (launch, outputs) is called once before the capture (the
    warm-up) and once inside it, and what it binds (a build.Launch's
    stream pointer above all) must be bound in that call: the capture
    runs on a stream of its own, and a launch bound to another stream
    would run at capture time instead of in the graph.  The captured
    outputs are overwritten with 0x5A bytes before the first replay, so
    outputs equal to the wrapper's after it come from the graph's
    launches."""
    import torch

    launch, _ = bind()
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch, outputs = bind()
        for _ in range(launches):
            launch()
    for t in outputs:
        t.view(torch.uint8).fill_(0x5A)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times), outputs


def launch_floor_ms(reps: int = 5, launches: int = 200) -> tuple[float, float]:
    """(cuda_ms, graph_ms) of a kernel that does nothing (one block of one
    warp, csrc/mphf.cu dbg_empty), `launches` launches per run: the least
    either timer can read."""
    import torch

    from . import build

    lib = build.load()

    def bind():
        stream = torch.cuda.current_stream().cuda_stream
        return (lambda: build.check(lib.dbg_empty(stream), "empty")), ()

    return (cuda_ms(bind()[0], reps, launches=launches),
            graph_ms(bind, reps, launches)[0])


def turns(first, second) -> tuple[float, float, list[float]]:
    """first() and second() -> ms, timed in turns (first, second, second,
    first): (first's mean, second's mean, the four times)."""
    t = [first(), second(), second(), first()]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def in_turns(timer, baseline=None, key: str = "",
             entry: str | None = None) -> dict:
    """timer(lib) -> ms of this tree's kernel (lib None) or of the
    `baseline` library's: {key}ms, and with a baseline that has the C
    entry point `entry` (any, when None) also, in turns (baseline, this,
    this, baseline), baseline_{key}ms and {key}turns_ms."""
    if baseline is None or (entry is not None
                            and not hasattr(baseline, entry)):
        return {f"{key}ms": timer(None)}
    base, ours, times = turns(lambda: timer(baseline), lambda: timer(None))
    return {f"{key}ms": ours, f"baseline_{key}ms": base,
            f"{key}turns_ms": times}


def _older_k10(launch):
    """K10 before its one-launch plan: (tbl, idx, n_chunks, CH, W, split,
    part, out, stream), `split` blocks per chunk (8 blocks per SM aimed
    at, at least 64 rows a block), then a pass over the partial sums."""
    import torch

    from ..engine.gather import _card_of

    tbl_p, _, idx_p, n_chunks, CH, W, _, _, out_p, stream = launch.args
    dev = launch.tensors[1].device
    split = max(1, min(CH // 64, -(-8 * _card_of(dev)[0] // n_chunks)))
    part = torch.empty(n_chunks * split if split > 1 else 0,
                       dtype=torch.int32, device=dev)
    return (tbl_p, idx_p, n_chunks, CH, W, split, part.data_ptr(), out_p,
            stream), (part,)


def _older_k12(launch):
    """K12 before the slice plan: (tbl1, NB, idx, B, J, reps, blocks,
    shared memory limit, out, stream)."""
    from ..engine.gather import _card_of

    a = launch.args
    return a[:6] + _card_of(launch.tensors[1].device) + a[-2:], ()


def _older_k13(launch):
    """K13 before its plan: (table, ids, Q, out, stream) from this tree's
    one ShardArgs (the first tensor its launch keeps)."""
    a = launch.tensors[0]
    return (ctypes.addressof(a.table), a.ids, a.Q, a.out, a.stream), ()


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# this tree's C entry points whose arguments differ in older trees:
# entry -> (an entry point that only the newer trees have, the older
# argument types, older(launch) -> (the older arguments from this
# tree's build.Launch, tensors they point into))
OLDER_ENTRIES = {
    # K7 before its plan: one key a thread, blocks of 256
    "dbg_mphf_slots": ("dbg_mphf_check", [_P, _P, _P, _P, _LL, _P, _P],
                       lambda launch: (launch.args[:5] + launch.args[7:], ())),
    "dbg_gather_rowsum": ("dbg_gather_rowsum_occupancy",
                          [_P, _P, _I, _I, _I, _I, _P, _P, _P], _older_k10),
    # K11 before the slice plan: (tbl, idx, B, J, W, reps, out, stream)
    "dbg_gather_rows_sum": (
        "dbg_sizeof_gather_plan", [_P, _P, _I, _I, _I, _I, _P, _P],
        lambda launch: ((launch.args[0],) + launch.args[2:7]
                        + launch.args[-2:], ())),
    "dbg_gather_take_sum": ("dbg_sizeof_gather_plan",
                            [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
                            _older_k12),
    # K13 before its plan: (table, ids, Q, out, stream), the direct path
    "dbg_sharded_rows": ("dbg_sizeof_shard_args", [_P, _P, _LL, _P, _P],
                         _older_k13),
}


def on(lib, launch):
    """() -> None: this tree's `launch` (a build.Launch, its arguments
    bound) on kernel library `lib` (None: this tree's), its arguments
    mapped once through OLDER_ENTRIES where `lib` is an older tree's whose
    entry point takes other ones.  Either way the entry point is bound
    once and called the same way, so that timing launches in turns
    charges both libraries the same host work."""
    from . import build

    newer, argtypes, older = OLDER_ENTRIES.get(launch.entry,
                                               (None, None, None))
    if lib is None or newer is None or hasattr(lib, newer):
        fn = getattr(build.load() if lib is None else lib, launch.entry)
        args, keep = launch.args, launch.tensors
    else:
        fn = lib[launch.entry]       # a fresh binding: its own argtypes
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        args, keep = older(launch)

    def go(keep=keep):
        build.check(fn(*args), launch.name)

    return go
