"""The dbgtpu_torch slice end to end on the CPU (the kernels' plain
versions): output bytes against dbgtpu's python spec and JAX engine,
the CLI, the refused flags, and that the port runs without JAX."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dbgtpu.pipeline import run_pipeline as dbgtpu_pipeline
from dbgtpu_torch import cli
from dbgtpu_torch.pipeline import run_pipeline

from . import synth

ROOT = Path(__file__).resolve().parents[1]
_COUNTS = ("read_number", "aligned", "not_aligned", "no_overlap")


def _files(tmp_path, seed, k, n_reads, fastq=False, **kw):
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=seed, genome_len=kw.pop("genome_len", 10000), k=k,
        n_reads=n_reads, **kw)
    rf, uf = tmp_path / "reads.fa", tmp_path / "unitigs.fa"
    if fastq:
        reads_fa = synth.to_fastq(
            [ln for ln in reads_fa.split(b"\n")[1::2] if ln])
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    return str(rf), str(uf)


def _same(got, want):
    assert got[0] == want[0]
    assert got[1] == want[1]
    for f in _COUNTS:
        assert getattr(got[2], f) == getattr(want[2], f), f


def test_slice_bytes_equal_spec_and_jax_engine(tmp_path):
    rf, uf = _files(tmp_path, 71, 21, 128, n_frac=0.2)
    got = run_pipeline([rf], uf, k=21, m=2, batch_size=48, device="cpu")
    assert got[2].aligned > 0 and got[2].not_aligned + got[2].no_overlap > 0
    _same(got, dbgtpu_pipeline([rf], uf, k=21, m=2, impl="python"))
    _same(got, dbgtpu_pipeline([rf], uf, k=21, m=2, impl="jax",
                               batch_size=128))


@pytest.mark.parametrize("case,k,m,kw", [
    ("k31_m0", 31, 0, {}),
    ("fastq", 31, 2, {}),
    ("correction", 31, 2, dict(n_frac=0.2)),
    ("renumbered", 21, 2, {}),
    # stride-1 unitigs: paths longer than the 30-slot device cap are
    # recomputed on the host spec
    ("pmax_overflow", 15, 2, dict(min_unitig=15, max_unitig=18,
                                  decoy_frac=0.0)),
    # k-1 = 31 (62-bit k-mers) and reads in the L=512 bucket
    ("k32_long_reads", 32, 2, dict(n_frac=0.1, read_len=300,
                                   genome_len=20000)),
    # tiny k and unitigs: many junctions per read
    ("k4", 4, 1, dict(min_unitig=4, max_unitig=10, genome_len=400,
                      read_len=30)),
    ("k9_short_reads", 9, 1, dict(n_frac=0.1, min_unitig=9, max_unitig=30,
                                  read_len=40, genome_len=3000)),
])
def test_slice_bytes_equal_spec(tmp_path, monkeypatch, case, k, m, kw):
    fastq = case == "fastq"
    correction = case == "correction"
    if case == "renumbered":
        monkeypatch.setenv("DBGTPU_RENUMBER", "1")
    rf, uf = _files(tmp_path, 72, k, 96, fastq=fastq, **kw)
    args = dict(k=k, m=m, fastq=fastq, correction=correction)
    got = run_pipeline([rf], uf, batch_size=40, device="cpu", **args)
    _same(got, dbgtpu_pipeline([rf], uf, impl="python", **args))
    assert got[2].aligned > 0
    if case == "pmax_overflow":
        longest = max(ln.count(b".") for ln in got[0].split(b"\n")[1::2])
        assert longest > 30


def test_cli_writes_dbgtpu_outputs(tmp_path, monkeypatch, capsys):
    from dbgtpu import cli as dbgtpu_cli

    rf, uf = _files(tmp_path, 73, 21, 64, n_frac=0.1)
    common = ["-r", rf, "-k", "21", "-g", uf, "-m", "1", "-e", "3"]
    monkeypatch.chdir(tmp_path)
    assert dbgtpu_cli.main(common + ["--impl", "python",
                                     "-f", "p_ref", "-a", "n_ref"]) == 0
    want_out = capsys.readouterr().out
    assert cli.main(common + ["--device", "cpu", "-f", "p", "-a", "n",
                              "--json-summary", "s.json"]) == 0
    got_out = capsys.readouterr().out
    assert (tmp_path / "p").read_bytes() == (tmp_path / "p_ref").read_bytes()
    assert (tmp_path / "n").read_bytes() == (tmp_path / "n_ref").read_bytes()

    def counts(out):  # the stats block without its timing lines
        return [ln for ln in out.splitlines()
                if "seconds" not in ln.lower()]

    assert counts(got_out) == counts(want_out)
    assert "Overlap and aligned" in got_out
    assert '"device": "cpu"' in (tmp_path / "s.json").read_text()


@pytest.mark.parametrize("flags,mode,partial", [
    (["-G"], "anchors", False),
    (["-b"], "exhaustive", False),
    (["-b", "-i"], "exhaustive", True),
    # dbgtpu's precedence: -b wins over -G, -i affects only -b
    (["-G", "-b", "-i"], "exhaustive", True),
    (["-i"], "greedy", False),
])
def test_cli_runs_anchor_and_exhaustive_modes(tmp_path, monkeypatch, flags,
                                              mode, partial):
    """-G, -b and -b -i through cli.main on the CPU: bytes equal to
    dbgtpu's spec in the same mode."""
    rf, uf = _files(tmp_path, 76, 21, 64, n_frac=0.1)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-r", rf, "-k", "21", "-g", uf, "-m", "2",
                     "--device", "cpu"] + flags) == 0
    want = dbgtpu_pipeline([rf], uf, k=21, m=2, impl="python", mode=mode,
                           partial=partial)
    assert (tmp_path / "paths").read_bytes() == want[0]
    assert (tmp_path / "notAligned.fa").read_bytes() == want[1]
    assert want[2].aligned > 0


def test_cli_refuses_an_mphf_anchor_index(tmp_path, monkeypatch, capsys):
    """-G on a dog keyset that takes the MPHF anchor layout exits 2 and
    names the layout and the anchor count."""
    from dbgtpu.index import device as device_mod

    rf, uf = _files(tmp_path, 77, 21, 8)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(device_mod, "ANCHOR_MPHF_MIN", 0)
    assert cli.main(["-r", rf, "-k", "21", "-g", uf, "-G",
                     "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "MPHF anchor layout" in err and "anchors" in err and "B12" in err
    assert not (tmp_path / "paths").exists()


@pytest.mark.parametrize("flags", [
    ["-p"], ["-b", "-p"], ["--index-layout", "mphf"],
    ["--mesh", "2"], ["--shard-index"], ["--num-processes", "2"],
    ["--coordinator", "localhost:1"], ["--merge-shards", "2"],
    ["--save-index", "x.npz"], ["--load-index", "x.npz"], ["--resume"],
    ["--profile-dir", "prof"],
])
def test_cli_refuses_flags_outside_the_slice(flags, capsys):
    assert cli.main(["-r", "reads.fa", "-k", "21", "--device", "cpu"]
                    + flags) == 2
    refused = "-p" if "-p" in flags else flags[0]
    assert refused in capsys.readouterr().err


def test_cli_without_gpu_stops(tmp_path, monkeypatch, capsys):
    rf, uf = _files(tmp_path, 74, 21, 8)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-r", rf, "-k", "21", "-g", uf]) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "paths").exists()


def test_port_runs_without_jax(tmp_path):
    """In a process where `import jax` fails, the port imports and maps
    a small file on the CPU; `python -m dbgtpu_torch` without a GPU
    exits non-zero."""
    rf, uf = _files(tmp_path, 75, 21, 16)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import dbgtpu_torch, dbgtpu_torch.cli, dbgtpu_torch.pipeline\n"
        "import dbgtpu_torch.engine.core, dbgtpu_torch.kernels.build\n"
        "from dbgtpu_torch.pipeline import run_pipeline\n"
        f"p, n, s = run_pipeline([{rf!r}], {uf!r}, k=21, device='cpu')\n"
        "assert s.read_number == 16 and len(p) > 0\n"
        "print('NO-JAX-OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "NO-JAX-OK" in res.stdout
    res = subprocess.run(
        [sys.executable, "-m", "dbgtpu_torch", "-r", rf, "-k", "21", "-g",
         uf], env=env, cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert not (tmp_path / "paths").exists()


def test_port_sources_never_import_jax():
    paths = [*(ROOT / "dbgtpu_torch").rglob("*.py"), ROOT / "chip_smoke.py",
             ROOT / "torch_profile.py"]
    for path in paths:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path


def test_kernel_build_recipe(monkeypatch):
    """The kernels build from the package's own sources into
    build/dbgtpu_torch/ with nvcc for sm_90a; nothing is built at
    import, and a machine without nvcc gets a clear error."""
    from dbgtpu_torch.kernels import build

    names = {p.name for p in build.sources()}
    assert {"read_scan.cu", "member.cu", "walk.cu", "pack.cu", "dog.cu",
            "exhaustive.cu", "common.cuh", "junction.cuh"} <= names
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    so = build.library_path()
    assert so.parent == ROOT / "build" / "dbgtpu_torch"
    assert build.source_hash() in so.name
    assert set(build.launches) == set(build.KERNELS)
    if so.exists():
        pytest.skip("a kernel library is already built here")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_kernel_build_dir_outside_a_checkout(monkeypatch, tmp_path):
    """An installed copy builds into $DBGTPU_TORCH_CACHE, not beside
    site-packages."""
    from dbgtpu_torch.kernels import build

    monkeypatch.setattr(build, "_ROOT", tmp_path / "site-packages")
    monkeypatch.setenv("DBGTPU_TORCH_CACHE", str(tmp_path / "cache"))
    assert build._build_dir() == tmp_path / "cache" / "dbgtpu_torch"
