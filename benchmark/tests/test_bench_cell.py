"""A tiny cell's window end to end on the CPU (the program's plain
kernels), judged by the plain reference; the control and the planted
faults that the comparison has to refuse; device metrics refused off the
card; and a cell on the card (skipped without one)."""

import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.tiny import REPO, add_cell, copy_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = copy_tree(tmp_path_factory.mktemp("bench") / "tree")
    add_cell(root, "tiny.warm", "load")
    add_cell(root, "tiny.cold", "build")
    add_cell(root, "tiny.mesh2", "load", mesh=2, batch_size=512)
    return root


def _run(tree, cell, seconds=1.0, **kw):
    kw.setdefault("sample", 10 ** 6)        # every read of the tiny cell
    return harness.run_cell(cell, 2 ** 33 + 7, seconds, False, device="cpu",
                            root=tree, cache=tree / "cache", **kw)


@pytest.mark.parametrize("cell", ["tiny.warm", "tiny.cold", "tiny.mesh2"])
def test_tiny_cell_correct(tree, cell):
    r = _run(tree, cell)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    names = set(r["metrics"])
    assert "setup_s" in names
    assert "reads_per_s" in names
    assert r["device"]["platform"] == "cpu"
    assert list(r["compared"]) == (
        ["sample_reads_differ", "records_misplaced", "counters_differ",
         "comparisons_missing", "jobs_differ", "failed_jobs"]
        + (["jobs_not_cold"] if cell == "tiny.cold" else []))


def test_device_metrics_refused_off_the_card(tree):
    with pytest.raises(harness.OffCard):
        harness.run_cell("tiny.warm", 1, 1.0, True, device="cpu",
                         root=tree, cache=tree / "cache")


def test_control_is_not_correct(tree):
    """The program's own lower setting, one mismatch fewer (-m 1)."""
    r = _run(tree, "tiny.warm", control=True)
    assert not r["correct"]
    assert r["compared"]["sample_reads_differ"]["value"] > 0


def _alter_one_answer(monkeypatch):
    from dbgtpu_torch.engine import runner

    orig = runner.expand_compact

    def altered(meta, prefix, pmax):
        rows = orig(meta, prefix, pmax)
        hit = np.nonzero(rows[:, 1])[0]
        if len(hit):
            rows[hit[0], 1] += 1
        return rows
    monkeypatch.setattr(runner, "expand_compact", altered)


def _drop_half_the_batch(monkeypatch):
    from dbgtpu_torch.engine import runner

    orig = runner.pack_records

    def half(parsed, lens_all, s0, nb, L):
        words, nmbits, blens = orig(parsed, lens_all, s0, nb, L)
        blens = blens.copy()
        blens[nb // 2 :] = 0
        return words, nmbits, blens
    monkeypatch.setattr(runner, "pack_records", half)


def _stale_state(monkeypatch):
    """Each batch gets the first batch's device result back."""
    from dbgtpu_torch.engine import runner

    orig = runner.align_batch_packed_compact
    first = {}

    def stale(ix, words, nmbits, lens, **kw):
        out = orig(ix, words, nmbits, lens, **kw)
        first.setdefault("out", out)
        meta, flat = first["out"]
        n = lens.shape[0]
        return (meta[:n].clone(), flat.clone()) if n <= meta.shape[0] else out
    monkeypatch.setattr(runner, "align_batch_packed_compact", stale)


def _drop_a_card(monkeypatch):
    """The second device's share of each batch never comes back."""
    from dbgtpu_torch.engine import runner

    orig = runner.align_batch_packed_compact
    calls = {"n": 0}

    def dropped(ix, words, nmbits, lens, **kw):
        meta, flat = orig(ix, words, nmbits, lens, **kw)
        calls["n"] += 1
        if calls["n"] % 2 == 0:
            meta = meta.clone()
            meta[:] = 0
        return meta, flat
    monkeypatch.setattr(runner, "align_batch_packed_compact", dropped)


@pytest.mark.parametrize("fault,cell", [
    (_alter_one_answer, "tiny.warm"),
    (_drop_half_the_batch, "tiny.warm"),
    (_stale_state, "tiny.warm"),
    (_drop_a_card, "tiny.mesh2"),
])
def test_planted_fault_is_not_correct(tree, monkeypatch, fault, cell):
    fault(monkeypatch)
    r = _run(tree, cell)
    assert not r["correct"], r["compared"]


def test_one_earlier_job_altered_is_not_correct(tree, monkeypatch):
    """A path id altered in the window's first job, the file's size kept:
    the last job's files agree with the reference, the first job's
    digest does not agree with the last's."""
    from dbgtpu_torch import cli

    orig = cli.main

    def first_job_altered(argv):
        rc = orig(argv)
        out = argv[argv.index("-f") + 1]
        if out.endswith("paths.0"):
            with open(out, "rb") as f:
                blob = bytearray(f.read())
            at = blob.index(b"\n", blob.index(b">")) + 1  # a path's first id
            blob[at] = ord("1") if blob[at] != ord("1") else ord("2")
            with open(out, "wb") as f:
                f.write(blob)
        return rc
    monkeypatch.setattr(cli, "main", first_job_altered)
    r = _run(tree, "tiny.warm", seconds=20.0)  # two jobs on a loaded host
    assert r["attempted"] >= 2
    assert r["compared"]["jobs_differ"]["value"] == 1
    assert r["compared"]["sample_reads_differ"]["value"] == 0
    assert not r["correct"]


def test_run_exits_without_a_card():
    """run.py prints no result and exits non-zero without a card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(REPO / "benchmark" / "run.py"), "--workload",
         "ecoli.warm", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 1 and out.stdout == ""


def test_run_exits_with_fewer_cards_than_the_cell(tmp_path):
    """run.py prints no result and exits 1 where the machine has one card
    and the cell asks for four (torch's card count stubbed)."""
    root = copy_tree(tmp_path / "tree")
    add_cell(root, "tiny.four", "load", mesh=4, chips=4)
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "sys.argv = ['run.py', '--workload', 'tiny.four', '--seed', "
            "'1', '--seconds', '1', '--trace', '0']\n"
            "runpy.run_path(%r, run_name='__main__')\n"
            % str(root / "benchmark" / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 1 and out.stdout == "", out.stderr
    assert "needs 4 CUDA card(s); found 1" in out.stderr


def test_run_exits_without_the_program(tmp_path):
    """A tree of BENCHMARK.json and benchmark/ alone prints no result."""
    root = copy_tree(tmp_path / "alone")
    out = subprocess.run(
        [sys.executable, str(root / "benchmark" / "run.py"), "--workload",
         "ecoli.warm", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_cell_on_the_card(card, tmp_path):
    """ecoli.warm for a few seconds through run.py, traced: correct, with
    its per-layer metrics."""
    out = subprocess.run(
        [sys.executable, str(REPO / "benchmark" / "run.py"), "--workload",
         "ecoli.warm", "--seed", "5", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=1200, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert 0 < r["metrics"]["kernel_roofline_pct"]["value"] <= 100
