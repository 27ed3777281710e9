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


def copy_tree(dest: Path) -> Path:
    """BENCHMARK.json and benchmark/ copied under `dest`."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", dest)
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def add_cell(root: Path, name: str = "tiny.warm", index: str = "load",
             reads: int = 1200, **config) -> str:
    """Adds a tiny configuration, traffic mix and cell to the copy at
    `root`, as a later change would: new files, and entries appended to
    BENCHMARK.json, no entry that was there changed; the cell reports
    every end-to-end metric that lists no cells."""
    cfg_name = name.replace(".", "_")
    cfg = dict(TINY_CONFIG, **config)
    (root / "benchmark" / "configs" / f"{cfg_name}.json").write_text(
        json.dumps(cfg))
    (root / "benchmark" / "traffic" / f"{cfg_name}.json").write_text(
        json.dumps({"reads": reads, "read_len": 100, "sub_rate": 0.01,
                    "index": index}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": cfg_name, "source": "tiny",
        "file": f"benchmark/configs/{cfg_name}.json", "reduced": [],
        "why": "tiny"})
    spec["workloads"].append({"name": name, "config": cfg_name,
                              "traffic": cfg_name, "chips": cfg["chips"],
                              "why": "tiny"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    return name


STUB_COMPARE = """
def _records(blob):
    return len(blob.splitlines()) // 2


def compare(g, reads, paths, na, summaries, m, e, sample, seed, device):
    n = _records(reads)
    return {"records_misplaced": (abs(n - _records(paths) - _records(na)),
                                  0),
            "counters_differ": (sum(s.get("reads") != n
                                    for s in summaries), 0)}
"""
STUB_COMPARES = ("records_misplaced", "counters_differ")


def add_reference(root: Path, name: str, modes: tuple, check: str = "",
                  compares: tuple | None = STUB_COMPARES,
                  compare: str = STUB_COMPARE) -> Path:
    """A stub reference package `benchmark/<name>/` declaring `modes`
    and, unless None, `compares`; its comparison (`compare`, by default
    one that counts the reads in the two files and in each summary) is
    put in check.py below `check`."""
    pkg = root / "benchmark" / name
    pkg.mkdir()
    (pkg / "__init__.py").write_text(
        f"MODES = {tuple(modes)!r}\n" + ("" if compares is None else
                                         f"COMPARES = {tuple(compares)!r}\n"))
    (pkg / "graph.py").write_text(
        "def build_graph(path, k):\n    return (path, k)\n")
    (pkg / "check.py").write_text(check + "\n" + compare)
    return pkg
