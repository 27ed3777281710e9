"""Every file the benchmark names loads, and BENCHMARK.json keeps to
the shape its harness reads."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests.tiny import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_parts_load(cell):
    c, config, traffic = harness.cell_parts(SPEC, cell, REPO)
    assert config["chips"] == c["chips"]
    for key in ("genome_len", "genome_seed", "snp_rate",
                "k", "m", "e", "mode", "index_layout", "mesh",
                "batch_size", "reduced", "assumed", "source"):
        assert key in config, key
    assert traffic["index"] in ("load", "build")
    assert traffic["reads"] > 0 and traffic["read_len"] > config["k"]


@pytest.mark.parametrize(
    "metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_metric_reader_loads(metric):
    assert callable(harness.reader(metric, REPO))


def test_names_units_and_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic",
                                       "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        for e in SPEC[group]:
            assert set(e) <= keys, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            names.add((group, e["name"]))
    assert len(names) == sum(len(SPEC[g]) for g in
                             ("configs", "workloads", "end_to_end",
                              "per_layer"))
    assert {m["name"] for m in SPEC["end_to_end"]} == {
        "reads_per_s", "setup_s"}
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= 1


def test_every_cell_reports_what_its_layers_move():
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in cells:
        e2e = {m["name"] for m in harness.metrics_of(SPEC, w, False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w
        layer = harness.metrics_of(SPEC, w, True)
        assert layer, w
        for m in layer:
            assert m["moves"] in e2e, (w, m["name"])
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= cells
