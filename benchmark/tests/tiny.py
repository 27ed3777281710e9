"""A copy of the benchmark with a tiny cell, for runs on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "source": "a tiny copy of ecoli_k31_scan for the CPU tests",
    "genome_len": 30000, "genome_seed": 5, "snp_rate": 0.01, "k": 31,
    "m": 2, "e": 2, "mode": "greedy", "index_layout": "scan", "mesh": 0,
    "batch_size": 256, "chips": 1, "reduced": ["genome_len"],
    "assumed": {},
}

# the metrics of a cell whose jobs build the graph (traffic cold131k),
# which no cell of BENCHMARK.json reports yet: a later change adds them
# as these entries, their readers being in benchmark/metrics/
COLD_METRICS = {
    "end_to_end": [{"name": "cold_run_s", "unit": "s", "better": "lower",
                    "bound": 0.25, "source": "host_clock"}],
    "per_layer": [
        {"name": "index_build_s", "unit": "s", "better": "lower",
         "source": "program_span", "layer": "graph and device-index build",
         "moves": "cold_run_s"},
        {"name": "device_idle_pct.cold", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "cold_run_s"}],
}


def copy_tree(dest: Path) -> Path:
    """BENCHMARK.json and benchmark/ copied under `dest`."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", dest)
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def add_cell(root: Path, name: str = "tiny.warm", index: str = "load",
             reads: int = 1200, like: str = "ecoli.warm",
             **config) -> str:
    """Adds a tiny configuration, traffic mix and cell to the copy at
    `root`, as a later change would: new files, and entries appended to
    BENCHMARK.json; the cell reports what `like` reports, or, where its
    jobs build the graph, COLD_METRICS."""
    cfg_name = name.replace(".", "_")
    (root / "benchmark" / "configs" / f"{cfg_name}.json").write_text(
        json.dumps(dict(TINY_CONFIG, **config)))
    (root / "benchmark" / "traffic" / f"{cfg_name}.json").write_text(
        json.dumps({"reads": reads, "read_len": 100, "sub_rate": 0.01,
                    "index": index}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": cfg_name, "source": "tiny",
        "file": f"benchmark/configs/{cfg_name}.json", "reduced": [],
        "why": "tiny"})
    spec["workloads"].append({"name": name, "config": cfg_name,
                              "traffic": cfg_name, "chips": 1,
                              "why": "tiny"})
    if index == "build":
        for group, entries in COLD_METRICS.items():
            new = {e["name"] for e in entries}
            spec[group] = [m for m in spec[group] if m["name"] not in new]
            spec[group] += [dict(e, workloads=[name]) for e in entries]
        like = None
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    return name
