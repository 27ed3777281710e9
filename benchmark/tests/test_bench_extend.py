"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric to the repository's BENCHMARK.json as new files and
appended entries: the harness runs them, the cell reports the
throughput, and no file or entry that was there is changed."""

import hashlib
import json

from benchmark import harness
from benchmark.tests.tiny import add_cell, copy_tree

GROUPS = ("configs", "workloads", "end_to_end", "per_layer")


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_by_files_alone(tmp_path):
    root = copy_tree(tmp_path / "tree")
    before = _digests(root)
    spec_before = json.loads((root / "BENCHMARK.json").read_text())
    cell = add_cell(root, "tiny.extra", "load", reads=700)
    (root / "benchmark" / "metrics" / "jobs_per_window.py").write_text(
        '"""Jobs that ran to their end in the window."""\n\n\n'
        "def read(run):\n    return float(len(run.done))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "jobs_per_window", "unit": "jobs", "better": "higher",
        "source": "host_clock", "layer": "runner, launch leg",
        "moves": "reads_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))

    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        root.joinpath(p).relative_to(root) for p in (
            "benchmark/configs/tiny_extra.json",
            "benchmark/traffic/tiny_extra.json",
            "benchmark/metrics/jobs_per_window.py")}
    for group in GROUPS:
        old = spec_before[group]
        assert spec[group][:len(old)] == old, group
    assert {k: v for k, v in spec.items() if k not in GROUPS} == {
        k: v for k, v in spec_before.items() if k not in GROUPS}

    assert {m["name"] for m in harness.metrics_of(spec, cell, False)} == {
        "reads_per_s", "setup_s"}
    assert [m["name"] for m in harness.metrics_of(spec, cell, True)] == [
        "jobs_per_window"]
    r = harness.run_cell(cell, 3, 1.0, False, device="cpu", root=root,
                         cache=root / "cache", sample=10 ** 6)
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}
    assert harness.reader("jobs_per_window", root)(
        type("R", (), {"done": [1, 2]})()) == 2.0
