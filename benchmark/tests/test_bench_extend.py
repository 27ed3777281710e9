"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and entries: the harness runs them, and no file that
was there is edited."""

import hashlib
import json

from benchmark import harness
from benchmark.tests.tiny import add_cell, copy_tree


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_by_files_alone(tmp_path):
    root = copy_tree(tmp_path / "tree")
    before = _digests(root)
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

    r = harness.run_cell(cell, 3, 1.0, False, device="cpu", root=root,
                         cache=root / "cache", sample=10 ** 6)
    assert r["correct"], r["compared"]
    assert "reads_per_s" in r["metrics"]
    layer = [m["name"] for m in harness.metrics_of(spec, cell, True)]
    assert "jobs_per_window" in layer
    assert harness.reader("jobs_per_window", root)(
        type("R", (), {"done": [1, 2]})()) == 2.0
