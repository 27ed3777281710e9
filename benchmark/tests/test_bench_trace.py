"""The idle share's interval union: overlapping streams of one card
count once, and each card is counted on its own."""

import json

import pytest

from benchmark import trace


def _x(name, cat, ts_us, dur_us, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts_us, "dur": dur_us,
            "args": args}


@pytest.fixture
def chrome(tmp_path):
    events = [
        _x("bench.window", "user_annotation", 1_000_000, 10_000_000),
        _x("bench.window", "gpu_user_annotation", 0, 99_000_000, device=0),
        _x("bench.job", "user_annotation", 1_000_000, 4_000_000),
        _x("bench.job", "user_annotation", 5_000_000, 6_000_000),
        # card 0: a kernel and a copy on two streams, overlapping by 1 s
        _x("read_scan_kernel", "kernel", 2_000_000, 2_000_000, device=0),
        _x("Memcpy HtoD", "gpu_memcpy", 3_000_000, 2_000_000, device=0),
        # card 0: a kernel reaching past the window's end
        _x("compact_kernel<short>", "kernel", 10_000_000, 3_000_000,
           device=0),
        # card 1: one memset, inside the first
        _x("Memset", "gpu_memset", 2_500_000, 500_000, device=1),
        _x("cudaLaunchKernel", "cuda_runtime", 2_000_000, 100),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return trace.from_chrome(p)


def test_union_counts_overlap_once(chrome):
    assert chrome.window == (1.0, 11.0)
    assert chrome.jobs == [(1.0, 5.0), (5.0, 11.0)]
    assert chrome.busy_s(0) == pytest.approx(3.0 + 1.0)   # 2-5 s, 10-11 s
    assert chrome.busy_s(1) == pytest.approx(0.5)


def test_idle_gaps_and_names(chrome):
    assert chrome.idle_gaps(0) == [(1.0, 2.0), (5.0, 10.0)]
    assert chrome.idle_gaps(1) == [(1.0, 2.5), (3.0, 11.0)]
    t = chrome.time_by_name()
    assert t["compact_kernel<short>"] == pytest.approx(1.0)
    assert "cudaLaunchKernel" not in t


def test_merged_and_union():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 12)]
    assert trace.merged(iv, 0, 10) == [(0, 3), (5, 6), (8, 10)]
    assert trace.union_length(iv, 0, 10) == pytest.approx(6.0)
    assert trace.union_length([], 0, 10) == 0
