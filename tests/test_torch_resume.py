"""Journaled, resumable runs of the port (dbgtpu_torch/pipeline.py
run_pipeline_resumable) and its progress line: the port's counterparts
of tests/test_resume.py, on the CPU, bytes also equal to dbgtpu's
`run_pipeline`.  Tolerance 0."""

import json

import pytest

import dbgtpu_torch.pipeline as pipeline_mod
from dbgtpu.pipeline import (
    _journal_fingerprint as dbgtpu_fingerprint,
    run_pipeline as dbgtpu_pipeline,
)
from dbgtpu_torch import cli
from dbgtpu_torch.pipeline import (
    _journal_fingerprint, make_progress_printer, run_pipeline,
    run_pipeline_resumable,
)

from .synth import make_dataset

_COUNTS = ("read_number", "aligned", "not_aligned", "no_overlap")


def _dataset(tmp_path):
    reads_fa, unitigs_fa = make_dataset(
        seed=1307, genome_len=15000, k=21, n_reads=400, err_frac=0.5,
    )
    rf = tmp_path / "r.fa"
    uf = tmp_path / "u.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    return str(rf), str(uf)


def _fresh(rf, uf, **kw):
    got = run_pipeline([rf], uf, k=21, m=2, effort=2, batch_size=32,
                       device="cpu", **kw)
    want = dbgtpu_pipeline([rf], uf, k=21, m=2, effort=2, impl="python", **kw)
    assert got[:2] == want[:2]
    return got


def _resumable(rf, uf, pf, naf, **kw):
    return run_pipeline_resumable(
        [rf], uf, k=21, paths_file=pf, na_file=naf, m=2, effort=2,
        batch_size=32, segment_records=64, device="cpu", **kw)


@pytest.mark.parametrize("mode,layout", [("greedy", "scan"),
                                         ("anchors", "mphf"),
                                         ("exhaustive", "scan")])
def test_resume_uninterrupted_matches_buffered(tmp_path, mode, layout):
    rf, uf = _dataset(tmp_path)
    want_p, want_n, want_s = _fresh(rf, uf, mode=mode)
    pf, naf = str(tmp_path / "paths"), str(tmp_path / "na.fa")
    stats = _resumable(rf, uf, pf, naf, mode=mode, index_layout=layout)
    assert open(pf, "rb").read() == want_p
    assert open(naf, "rb").read() == want_n
    for f in _COUNTS:
        assert getattr(stats, f) == getattr(want_s, f), f
    assert stats.payload_d2h_bytes > 0 and stats.leg("align_seconds") > 0
    assert not (tmp_path / "paths.resume.json").exists()


def test_resume_after_kill_byte_identical(tmp_path, monkeypatch):
    rf, uf = _dataset(tmp_path)
    want_p, want_n, want_s = _fresh(rf, uf)
    pf, naf = str(tmp_path / "paths"), str(tmp_path / "na.fa")

    real = pipeline_mod.align_bulk
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:       # "kill -9" during the third segment
            raise KeyboardInterrupt("simulated kill")
        return real(*a, **kw)

    monkeypatch.setattr(pipeline_mod, "align_bulk", dying)
    with pytest.raises(KeyboardInterrupt):
        _resumable(rf, uf, pf, naf)
    monkeypatch.setattr(pipeline_mod, "align_bulk", real)

    journal = json.load(open(tmp_path / "paths.resume.json"))
    assert 0 < journal["record_off"] < 400   # genuinely mid-file
    assert journal["version"] == 1
    assert set(journal) == {"version", "fingerprint", "file_idx",
                            "record_off", "paths_bytes", "na_bytes", "stats"}
    assert journal["paths_bytes"] == len(open(pf, "rb").read())

    # torn tail: bytes appended after the last journaled fsync must be
    # discarded on resume
    with open(pf, "ab") as f:
        f.write(b">torn\n999.\n")

    stats = _resumable(rf, uf, pf, naf)
    assert open(pf, "rb").read() == want_p
    assert open(naf, "rb").read() == want_n
    assert stats.aligned == want_s.aligned
    assert stats.read_number == want_s.read_number
    assert not (tmp_path / "paths.resume.json").exists()


def test_resume_rejects_mismatched_journal(tmp_path):
    rf, uf = _dataset(tmp_path)
    pf, naf = str(tmp_path / "paths"), str(tmp_path / "na.fa")
    (tmp_path / "paths.resume.json").write_text(json.dumps(
        {"version": 1, "fingerprint": "deadbeefdeadbeef",
         "file_idx": 0, "record_off": 100, "paths_bytes": 0,
         "na_bytes": 0,
         "stats": {"read_number": 0, "aligned": 0, "not_aligned": 0,
                   "no_overlap": 0}}
    ))
    with pytest.raises(ValueError, match="different inputs"):
        _resumable(rf, uf, pf, naf)
    # the fingerprint is dbgtpu's: either package resumes the other's run
    args = (["a.fa", "b.fa"], "u.fa", 21, 2, 2, "exhaustive", False, True,
            True)
    assert _journal_fingerprint(*args) == dbgtpu_fingerprint(*args)
    assert _journal_fingerprint(*args) != _journal_fingerprint(
        *args[:-1], False)
    # a journal that expects output which is gone is refused too
    (tmp_path / "paths.resume.json").write_text(json.dumps(
        {"version": 1,
         "fingerprint": _journal_fingerprint([rf], uf, 21, 2, 2, "greedy",
                                             False, False, False),
         "file_idx": 0, "record_off": 64, "paths_bytes": 10, "na_bytes": 0,
         "stats": {"read_number": 64, "aligned": 1, "not_aligned": 0,
                   "no_overlap": 0}}))
    with pytest.raises(ValueError, match="is missing"):
        _resumable(rf, uf, pf, naf)


def test_progress_callback_fires(tmp_path, capsys):
    rf, uf = _dataset(tmp_path)
    run_pipeline([rf], uf, k=21, m=2, effort=2, batch_size=64,
                 device="cpu", progress_every=1)
    err = capsys.readouterr().err
    assert "[progress]" in err
    assert "400/400" in err
    assert err.count("[progress]") == 7       # ceil(400 / 64) batches
    assert make_progress_printer(0) is None


def test_progress_counts_span_segments(tmp_path, capsys):
    """Over the segments of a resumable run the line reports cumulative
    counts; the last one holds the run's totals."""
    rf, uf = _dataset(tmp_path)
    pf, naf = str(tmp_path / "paths"), str(tmp_path / "na.fa")
    stats = _resumable(rf, uf, pf, naf, progress_every=2)
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("[progress]")]
    assert len(lines) == 7          # 6 segments of 2 batches, 1 of 1
    assert lines[-1].startswith(
        f"[progress] reads 400/400 | aligned {stats.aligned} ")


def test_cli_resume_continues_a_killed_run(tmp_path, monkeypatch, capsys):
    """`--resume` through cli.main: a run killed in its second segment,
    then the same command again; with --num-processes it is refused."""
    rf, uf = _dataset(tmp_path)
    monkeypatch.chdir(tmp_path)
    want_p, want_n, want_s = _fresh(rf, uf)
    argv = ["-r", rf, "-k", "21", "-g", uf, "-m", "2", "--device", "cpu",
            "--batch-size", "50", "--resume", "--json-summary", "s.json"]
    real = pipeline_mod.align_bulk
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("simulated kill")
        return real(*a, **kw)

    monkeypatch.setattr(pipeline_mod, "align_bulk", dying)
    with pytest.raises(KeyboardInterrupt):
        cli.main(argv)
    monkeypatch.setattr(pipeline_mod, "align_bulk", real)
    assert json.load(open("paths.resume.json"))["record_off"] == 200
    assert cli.main(argv) == 0
    assert (tmp_path / "paths").read_bytes() == want_p
    assert (tmp_path / "notAligned.fa").read_bytes() == want_n
    assert json.load(open("s.json"))["aligned"] == want_s.aligned
    assert f"Reads : {want_s.read_number}" in capsys.readouterr().out
    assert cli.main(argv + ["--num-processes", "2"]) == 2
    assert "--resume" in capsys.readouterr().err
