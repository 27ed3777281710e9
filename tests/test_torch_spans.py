"""The span recorder of dbgtpu_torch (spans.py) and the spans the
program records through it, on the CPU: the `trace` block of
--json-summary under a torch.profiler, the legs as the spans' sums,
the spans added to a --profile-dir trace, and the same bytes with
tracing on and off."""

import json
import sys
import threading

import pytest
import torch

from dbgtpu_torch import cli
from dbgtpu_torch.spans import FIELDS, Recorder

from . import synth

BATCH = 16
# --json-summary key -> the spans whose wall seconds it sums
LEGS = {"launch_seconds": ("launch",), "drain_seconds": ("drain",),
        "format_seconds": ("format",), "wait_seconds": ("fetch",),
        "stall_seconds": ("stall",), "parse_seconds": ("parse",),
        "align_seconds": ("align",), "upload_seconds": ("index.upload",),
        "device_index_seconds": ("index.device",),
        "index_seconds": ("index.load", "graph.build", "index.save")}
PER_BATCH = ("launch", "launch.pack", "launch.card", "fetch", "drain",
             "drain.rebuild", "format", "format.paths", "format.na_image",
             "format.na_text", "stall")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    reads, unitigs = synth.make_dataset(seed=1818, genome_len=8000, k=21,
                                        n_reads=100, n_frac=0.05)
    (d / "reads.fa").write_bytes(reads)
    (d / "unitigs.fa").write_bytes(unitigs)
    return d


def _argv(d, tag, *extra):
    return ["-r", str(d / "reads.fa"), "-k", "21", "-g",
            str(d / "unitigs.fa"), "--device", "cpu", "--batch-size",
            str(BATCH), "-f", str(d / f"paths.{tag}"), "-a",
            str(d / f"na.{tag}"), "--json-summary",
            str(d / f"summary.{tag}.json"), *extra]


def _profiled_run(d, tag, *extra):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert cli.main(_argv(d, tag, *extra)) == 0
    return json.loads((d / f"summary.{tag}.json").read_text())


def _rows(summary):
    t = summary["trace"]
    assert t["clock"] == "CLOCK_MONOTONIC" and t["fields"] == list(FIELDS)
    return [dict(zip(FIELDS, r)) for r in t["spans"]]


@pytest.fixture(scope="module")
def traced(data):
    """A run under a CPU torch.profiler: its summary and span rows."""
    s = _profiled_run(data, "on")
    return s, _rows(s)


def test_every_batch_has_its_spans(traced, capsys):
    s, rows = traced
    n = -(-s["reads"] // BATCH)
    assert n > 2
    for name in PER_BATCH:
        got = sorted(r["batch"] for r in rows if r["name"] == name)
        assert got == list(range(n)), name
    for r in rows:
        if r["name"] in ("launch", "launch.pack", "launch.card", "stall"):
            assert r["thread"] == "main", r
        if r["name"].startswith(("fetch", "drain", "format")):
            assert r["thread"] == "drain", r
        if r["name"] in ("launch.card", "fetch"):
            assert r["card"] == 0
    by_name = {r["name"]: r for r in rows}
    for name in ("job", "map", "parse", "align", "write", "graph.build",
                 "index.device", "index.build.junction", "index.build.probe",
                 "index.build.rows", "index.upload"):
        assert name in by_name, name
    assert by_name["parse"]["counters"]["reads"] == s["reads"]
    assert by_name["parse"]["counters"]["bytes"] > 0
    assert by_name["index.upload"]["counters"]["bytes"] == sum(
        s["index_card_bytes"])


def test_children_lie_inside_their_parents(traced):
    _, rows = traced
    roots = [r for r in rows if r["parent"] < 0]
    assert {r["name"] for r in roots} == {"job", "fetch", "drain"}
    for r in rows:
        assert r["start"] <= r["end"] and r["cpu"] >= 0
        if r["parent"] < 0:
            continue
        p = rows[r["parent"]]
        assert p["thread"] == r["thread"]
        assert p["start"] <= r["start"] and r["end"] <= p["end"], (p, r)
        if r["batch"] >= 0 and p["batch"] >= 0:
            assert r["batch"] == p["batch"]
    parents = {r["name"]: rows[r["parent"]]["name"] for r in rows
               if r["parent"] >= 0}
    assert parents["format.paths"] == parents["format.na_image"] == \
        parents["format.na_text"] == "format"
    assert parents["format"] == parents["drain.rebuild"] == "drain"
    assert parents["launch.pack"] == parents["launch.card"] == "launch"
    assert parents["launch"] == parents["stall"] == "align"
    assert parents["fetch.expand"] == "fetch"
    assert parents["align"] == parents["parse"] == "map"


def test_legs_equal_their_spans_sums(traced):
    s, rows = traced
    for key, names in LEGS.items():
        want = sum(r["end"] - r["start"] for r in rows if r["name"] in names)
        assert abs(s[key] - want) <= 0.0005 + 1e-9, key
    (mp,) = [r for r in rows if r["name"] == "map"]
    assert abs(s["map_seconds"] - (mp["end"] - mp["start"])) <= 0.0005


def test_a_loaded_index_reads_its_members_in_spans(data):
    assert cli.main(_argv(data, "save", "--save-index",
                          str(data / "ix.npz"))) == 0
    s = _profiled_run(data, "load", "--load-index", str(data / "ix.npz"))
    rows = _rows(s)
    (load,) = [r for r in rows if r["name"] == "index.load"]
    reads = [r for r in rows if r["name"] == "index.read"]
    assert reads and all(rows[r["parent"]] is load for r in reads)
    assert sum(r["counters"]["array_bytes"] for r in reads) > 0
    assert sum(r["counters"]["file_bytes"] for r in reads) <= (
        data / "ix.npz").stat().st_size
    assert abs(s["index_seconds"] - (load["end"] - load["start"])) <= 0.0005
    assert not [r for r in rows if r["name"] == "graph.build"]
    assert (data / "paths.load").read_bytes() == \
        (data / "paths.save").read_bytes()


def test_no_trace_block_without_a_profiler(data):
    assert cli.main(_argv(data, "off")) == 0
    s = json.loads((data / "summary.off.json").read_text())
    assert "trace" not in s
    for key in LEGS:
        assert s[key] >= 0.0, key
    assert s["launch_seconds"] > 0 and s["drain_seconds"] > 0


def test_tracing_leaves_the_bytes_as_they_are(data, traced):
    assert cli.main(_argv(data, "plain")) == 0
    for out in ("paths", "na"):
        assert (data / f"{out}.on").read_bytes() == \
            (data / f"{out}.plain").read_bytes()


def test_profile_dir_holds_both_threads_spans(data):
    prof = data / "prof"
    assert cli.main(_argv(data, "prof", "--profile-dir", str(prof))) == 0
    (path,) = prof.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    (job,) = [e for e in events if e.get("name") == "dbgtpu.job"
              and e.get("ph") == "X"]
    ours = [e for e in events if e.get("cat") == "dbgtpu"]
    assert {e["name"] for e in ours} >= set(PER_BATCH) | {"job", "parse"}
    assert len({e["tid"] for e in ours}) == 2
    assert {e["tid"] for e in ours if e["name"] == "drain"} != \
        {e["tid"] for e in ours if e["name"] == "launch"}
    lo, hi = job["ts"], job["ts"] + job["dur"]
    slack = 1000.0      # microseconds between the range and the job span
    for e in ours:
        assert lo - slack <= e["ts"] and e["ts"] + e["dur"] <= hi + slack
    assert any(e["args"]["batch"] == 1 for e in ours)
    s = json.loads((data / "summary.prof.json").read_text())
    assert len(s["trace"]["spans"]) == len(ours)
    # the spans' counters ride in the events' arguments
    (parse,) = [e for e in ours if e["name"] == "parse"]
    assert parse["args"]["reads"] == s["reads"]
    assert parse["args"]["bytes"] > 0
    (upload,) = [e for e in ours if e["name"] == "index.upload"]
    assert upload["args"]["bytes"] == sum(s["index_card_bytes"])


def test_an_off_recorder_keeps_only_sums():
    rec = Recorder()
    for _ in range(3):
        with rec.span("a", batch=1):
            rec.count("n", 2)
            with rec.span("b") as b:
                pass
    assert b.seconds >= 0 and rec.total("a") >= rec.total("b") >= 0
    assert rec.rows == [] and rec.trace() is None
    assert rec.total("a", "b") == rec.total("a") + rec.total("b")
    rec.add("c", 1.5)
    assert rec.total("c") == 1.5
    assert rec.batches(4) == 0 and rec.batches(2) == 4


def test_an_on_recorder_keeps_spans_counters_and_threads():
    rec = Recorder(on=True)
    with rec.span("a", batch=3, card=1):
        rec.count("n", 2)
        rec.count("n", 5)
        with rec.span("b"):
            pass

        def work():
            with rec.span("c", batch=7):
                with rec.span("d"):
                    pass

        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    rows = [dict(zip(FIELDS, r)) for r in rec.trace()["spans"]]
    by = {r["name"]: r for r in rows}
    assert by["a"]["counters"] == {"n": 7} and by["a"]["parent"] == -1
    assert rows[by["b"]["parent"]]["name"] == "a"
    assert (by["b"]["batch"], by["b"]["card"]) == (3, 1)
    assert by["c"]["thread"] == by["d"]["thread"] == "drain"
    assert by["a"]["thread"] == "main" and by["c"]["parent"] == -1
    assert (by["d"]["batch"], by["d"]["card"]) == (7, -1)
    assert set(rec.tids) == {"main", "drain"}


def test_two_threads_lose_no_span_time():
    """Both threads add to the one table of sums; with the interpreter
    switching threads every microsecond, each name's sum still equals
    the sum of its rows (a lost update would break it)."""
    rec = Recorder(on=True)

    def work(name):
        for _ in range(2000):
            with rec.span(name):
                pass
            with rec.span("shared"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(f"t{i}",))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    rows = [dict(zip(FIELDS, r)) for r in rec.trace()["spans"]]
    assert len(rows) == 4 * 2 * 2000
    for name in ("t0", "t3", "shared"):
        want = sum(r["end"] - r["start"] for r in rows if r["name"] == name)
        assert rec.total(name) == pytest.approx(want, rel=1e-9, abs=1e-12)


def test_for_run_is_on_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    assert not Recorder.for_run().on
    assert Recorder.for_run("some/dir").on
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch._C._autograd._profiler_enabled()
        assert Recorder.for_run().on
