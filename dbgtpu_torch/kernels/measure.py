"""How a kernel is timed and bounded: one timer and one bound convention
for chip_smoke.py, torch_profile.py and tools/exp_gather.py."""

from __future__ import annotations

import statistics

HBM_BYTES_PER_S = 3.35e12       # the H100's published memory rate
# 32-bit integer operations: a quarter of the published 67 TFLOP/s of
# float32, which counts a fused multiply-add as two on twice as many lanes
INT_OPS_PER_S = 67e12 / 4


def bound_ms(stream_bytes: int, touched: int, table: int,
             ops: int) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for a
    function that streams `stream_bytes` (each tensor once), touches
    `touched` bytes of rows in tables of `table` bytes (never more than
    the table) and needs `ops` integer operations: the larger of the
    bytes over the memory rate and the operations over the integer
    rate."""
    t_bytes = (stream_bytes + min(touched, table)) / HBM_BYTES_PER_S
    t_ops = ops / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
