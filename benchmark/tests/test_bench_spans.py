"""The program's spans on the trace's clock (spans.py): the one offset a
job, the innermost span of each thread, the drain's spans over the main
thread's stall, the idle gaps split by span with the time between jobs
unspanned, and each reader of the spans on a synthetic run."""

import json

import pytest

from benchmark import harness, spans, trace
from benchmark.spans import Span
from benchmark.tests.tiny import REPO

FIELDS = ["name", "thread", "batch", "card", "start", "end", "cpu",
          "parent", "counters"]


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts * 1e6,
            "dur": dur * 1e6, "args": args}


def _row(name, thread, start, end, parent=-1, batch=-1, cpu=None,
         **counters):
    return [name, thread, batch, 0 if name in ("fetch", "launch.card")
            else -1, start, end, (end - start) if cpu is None else cpu,
            parent, counters]


# job 0 on the host clock (offset -100 s onto the trace's): parse, then
# batch 0's launch and a stall, during which the drain thread fetches
# and formats; then the write
JOB0 = [
    _row("job", "main", 101.0, 105.0),
    _row("parse", "main", 101.0, 102.0, 0),
    _row("align", "main", 102.0, 104.5, 0),
    _row("launch", "main", 102.0, 102.8, 2, batch=0),
    _row("stall", "main", 102.8, 104.4, 2, batch=0),
    _row("fetch", "drain", 102.5, 103.0, batch=0),
    _row("drain", "drain", 103.0, 104.0, batch=0, cpu=0.5),
    _row("format", "drain", 103.2, 103.9, 6, batch=0),
    _row("format.paths", "drain", 103.2, 103.25, 7, batch=0),
    _row("format.na_image", "drain", 103.3, 103.5, 7, batch=0),
    _row("format.na_text", "drain", 103.5, 103.8, 7, batch=0),
    _row("write", "main", 104.5, 104.9, 0),
]
# job 1 (offset -199 s): parse, then an index load with one member read
JOB1 = [
    _row("job", "main", 205.0, 209.5),
    _row("parse", "main", 205.0, 207.0, 0),
    _row("index.load", "main", 207.5, 208.5, 0),
    _row("index.read", "main", 207.6, 207.9, 2, file_bytes=10,
         array_bytes=20),
]


def _summary(rows, reads=64):
    return {"reads": reads, "trace": {"clock": "CLOCK_MONOTONIC",
                                      "fields": FIELDS, "spans": rows}}


@pytest.fixture
def run(tmp_path):
    events = [
        _x("bench.window", "user_annotation", 1.0, 10.0),
        _x("bench.job", "user_annotation", 1.0, 4.0),
        _x("bench.job", "user_annotation", 6.0, 4.5),
        _x("read_scan_kernel", "kernel", 2.0, 0.5, device=0),
        _x("member_kernel", "kernel", 7.0, 0.2, device=0),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    r = harness.Run({"batch_size": 32, "mesh": 0}, {}, 1, None, 64)
    r.trace = trace.from_chrome(p)
    r.jobs = [harness.Job(101.0, 105.0, 0, None, (), _summary(JOB0)),
              harness.Job(205.0, 209.5, 0, None, (), _summary(JOB1))]
    return r


def _span(name, thread, start, end):
    return Span(name, thread, -1, -1, start, end, 0.0, -1, {})


def test_one_offset_a_job(run):
    got = {(s.name, round(s.start, 9), round(s.end, 9))
           for s in spans.on_trace(run)}
    assert ("parse", 1.0, 2.0) in got and ("stall", 2.8, 4.4) in got
    assert ("parse", 6.0, 8.0) in got and ("index.read", 8.6, 8.9) in got


def test_innermost_of_nested_spans():
    segs = spans.innermost([
        _span("a", "main", 0, 10), _span("b", "main", 0, 4),
        _span("c", "main", 1, 2), _span("d", "main", 4, 6),
        _span("e", "main", 12, 13)])
    assert segs == [(0, 1, "b"), (1, 2, "c"), (2, 4, "b"), (4, 6, "d"),
                    (6, 10, "a"), (12, 13, "e")]


def test_the_drain_wins_over_the_stall_only():
    segs = spans.labels([
        _span("job", "main", 0, 20), _span("launch", "main", 0, 5),
        _span("stall", "main", 5, 10), _span("write", "main", 12, 14),
        _span("format", "drain", 3, 6), _span("drain", "drain", 7, 8)])
    assert segs == [(0, 5, "launch"), (5, 6, "format"), (6, 7, "stall"),
                    (7, 8, "drain"), (8, 10, "stall"), (12, 14, "write")]


def test_idle_split_by_span(run):
    assert run.trace.idle_gaps(0) == [(1.0, 2.0), (2.5, 7.0), (7.2, 11.0)]
    got = spans.idle_by_span(run)
    want = {"parse": 2.8, "launch": 0.3, "fetch": 0.2, "drain": 0.3,
            "format": 0.15, "format.paths": 0.05, "format.na_image": 0.2,
            "format.na_text": 0.3, "stall": 0.4, "align": 0.1,
            "write": 0.4, "index.load": 0.7, "index.read": 0.3,
            # job 0's last 0.1 s, the 1 s between the jobs, job 1's
            # stretches outside its spans and the window after it
            spans.UNSPANNED: 0.1 + 1.0 + 0.5 + 1.5}
    assert set(got) == set(want)
    for name, s in want.items():
        assert got[name] == pytest.approx(s, abs=1e-9), name
    assert sum(got.values()) == pytest.approx(10.0 - 0.5 - 0.2)


@pytest.mark.parametrize("metric,want", [
    ("na_image_ms_per_batch", 0.2 / 4 * 1e3),
    ("na_text_ms_per_batch", 0.3 / 4 * 1e3),
    ("paths_text_ms_per_batch", 0.05 / 4 * 1e3),
    ("drain_cpu_pct", 50.0),
    ("index_read_s", 0.3 / 2),
    ("write_s_per_mreads", 0.4 / 128 * 1e6),
    ("device_idle_unspanned_pct", 100 * 3.1 / 9.3),
])
def test_reader_on_a_synthetic_run(run, metric, want):
    assert harness.reader(metric, REPO)(run) == pytest.approx(want)


@pytest.mark.parametrize("metric", [
    "na_image_ms_per_batch", "na_text_ms_per_batch",
    "paths_text_ms_per_batch", "drain_cpu_pct", "index_read_s",
    "write_s_per_mreads", "device_idle_unspanned_pct"])
def test_reader_finds_nothing_without_spans(run, metric):
    """A program without the recorder writes no trace block: each reader
    returns None, and raises nothing; so without the trace."""
    read = harness.reader(metric, REPO)
    for job in run.jobs:
        job.summary = {"reads": 64}
    assert read(run) is None
    run.trace = None
    assert read(run) is None


def test_breakdown_idle_gaps_by_span(run):
    """breakdown()'s idle gaps are the ten longest of idle_by_span, the
    unspanned time named as such; its device operations by time."""
    got = harness.breakdown(run)
    idle = spans.idle_by_span(run)
    assert len(idle) > 10
    want = sorted(idle.items(), key=lambda x: -x[1])[:10]
    assert got["idle_gaps"] == [[n, s] for n, s in want]
    assert got["idle_gaps"][0] == [spans.UNSPANNED, pytest.approx(3.1)]
    assert got["idle_gaps"][1] == ["parse", pytest.approx(2.8)]
    assert got["device_ops"] == [["read_scan_kernel", pytest.approx(0.5)],
                                 ["member_kernel", pytest.approx(0.2)]]
