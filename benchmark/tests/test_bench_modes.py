"""A configuration's mode becomes the program's flag through the
harness's table, and its reference package, named in the configuration,
judges the jobs: a mode that the package does not declare, or that the
program lacks, is refused before any job runs, and a comparison that
leaves out a number the package declares is not correct."""

import pytest

from benchmark import data, harness
from benchmark.tests.tiny import TINY_CONFIG, add_cell, add_reference, \
    copy_tree

GRAPH = data.GraphFiles("u.fa", "ix.npz", 31, 10)
LOAD = {"index": "load"}


@pytest.mark.parametrize("config,flags", [
    ({}, []),
    ({"mode": "dog"}, ["-G"]),
    ({"mode": "exhaustive"}, ["-b"]),
    ({"shard_index": True, "mesh": 4}, ["--mesh", "4", "--shard-index"]),
    ({"mode": "dog", "shard_index": True}, ["-G", "--shard-index"]),
])
def test_mode_table(config, flags):
    def argv_of(cfg):
        return harness.job_argv(cfg, LOAD, GRAPH, "r.fa", ("p", "n"), 2)

    head = argv_of(TINY_CONFIG)[:-2]        # up to --batch-size N
    argv = argv_of(dict(TINY_CONFIG, **config))
    assert argv[:len(head)] == head
    rest = argv[len(head):]
    at = rest.index("--load-index")
    assert rest[at + 1] == "ix.npz"
    assert rest[:at] + rest[at + 2:] == flags


def _record_jobs(monkeypatch):
    from dbgtpu_torch import cli

    seen, orig = [], cli.main

    def recorded(argv):
        seen.append(list(argv))
        return orig(argv)
    monkeypatch.setattr(cli, "main", recorded)
    return seen


def test_stub_reference_declaring_dog_gets_G(tmp_path, monkeypatch):
    root = copy_tree(tmp_path / "tree")
    add_reference(root, "reference_dog", ("dog",))
    cell = add_cell(root, "tiny.dog", "load", reads=600, mode="dog",
                    reference="reference_dog")
    seen = _record_jobs(monkeypatch)
    r = harness.run_cell(cell, 11, 0.5, False, device="cpu", root=root,
                         cache=root / "cache")
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and "reads_per_s" in r["metrics"]
    assert seen and all("-G" in argv and "-b" not in argv for argv in seen)
    assert set(r["compared"]) == {
        "records_misplaced", "counters_differ", "comparisons_missing",
        "jobs_differ", "failed_jobs"}
    assert r["compared"]["comparisons_missing"]["value"] == 0


@pytest.mark.parametrize("compares,missing", [
    (None, 3),          # declares nothing: the greedy package's three
    (("records_misplaced", "counters_differ"), 2),
])
def test_comparison_leaving_out_a_number_is_not_correct(
        tmp_path, compares, missing):
    root = copy_tree(tmp_path / "tree")
    add_reference(root, "reference_empty", ("dog",), compares=compares,
                  compare="def compare(*args):\n    return {}\n")
    cell = add_cell(root, "tiny.empty", "load", reads=600, mode="dog",
                    reference="reference_empty")
    r = harness.run_cell(cell, 11, 0.5, False, device="cpu", root=root,
                         cache=root / "cache")
    assert not r["correct"]
    assert r["compared"]["comparisons_missing"] == {"value": missing,
                                                    "limit": 0}
    assert r["compared"]["jobs_differ"]["value"] == 0
    assert r["compared"]["failed_jobs"]["value"] == 0


@pytest.mark.parametrize("config", [
    {"mode": "dog"},                            # reference: greedy only
    {"mode": "exhaustive"},
    {"mode": "greedy", "reference": "reference_dog"},
    {"mode": "fancy", "reference": "reference_dog"},    # no such mode
    {"reference": "no_such_reference"},
    {"reference": "../reference"},
    {"mode": "dog", "reference": "reference_blind"},    # compares nothing
])
def test_unjudged_mode_refused_at_set_up(tmp_path, monkeypatch, config):
    root = copy_tree(tmp_path / "tree")
    add_reference(root, "reference_dog", ("dog", "fancy"))
    add_reference(root, "reference_blind", ("dog",), compares=())
    cell = add_cell(root, "tiny.refused", "load", **config)
    seen = _record_jobs(monkeypatch)
    with pytest.raises(harness.Refused):
        harness.run_cell(cell, 11, 0.5, False, device="cpu", root=root,
                         cache=root / "cache")
    assert seen == []
    assert not (root / "cache").exists()
