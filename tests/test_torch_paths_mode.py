"""Path modes (-p, -p -b) and process sharding of the port, on the CPU:
bytes equal to `dbgtpu.cli` with `--impl python`, path modes launch no
kernel and say so, and N `--process-id` runs merged with
`--merge-shards` equal one run.  Tolerance 0."""

import json

import pytest

import dbgtpu.paths_mode
import dbgtpu_torch.paths_mode
from dbgtpu import cli as dbgtpu_cli
from dbgtpu.index.build import build_graph as dbgtpu_build_graph
from dbgtpu.io.fasta import iter_reads
from dbgtpu.pipeline import run_pipeline as dbgtpu_pipeline
from dbgtpu.seq import encode, n_mask
from dbgtpu_torch import cli
from dbgtpu_torch.index.build import build_graph
from dbgtpu_torch.kernels import build as kernel_build
from dbgtpu_torch.pipeline import run_pipeline
from dbgtpu_torch.spec import spec_for

from . import synth


def _files(tmp_path, seed=41, n_reads=150, **kw):
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=seed, genome_len=15000, k=21, n_reads=n_reads, **kw)
    rf, uf = tmp_path / "reads.fa", tmp_path / "unitigs.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    return str(rf), str(uf)


@pytest.mark.parametrize("partial", [False, True])
def test_path_aligners_equal_dbgtpu(tmp_path, partial):
    """paths_mode.py is a copy: the same (status, path) per read, also
    through spec_for."""
    rf, uf = _files(tmp_path, n_frac=0.1)
    g_ref, g_own = dbgtpu_build_graph(uf, 21), build_graph(uf, 21)
    greedy = spec_for("paths", 2, 2, partial)
    exhaustive = spec_for("paths-exhaustive", 2, 2, partial)
    aligned = 0
    for _, seq in iter_reads(rf, 21, False):
        codes, nm = encode(seq), n_mask(seq)
        want = dbgtpu.paths_mode.align_read_greedy_path(
            g_ref, codes, nm, 2, 2, partial)
        assert dbgtpu_torch.paths_mode.align_read_greedy_path(
            g_own, codes, nm, 2, 2, partial) == want
        assert greedy(g_own, codes, nm) == want
        want = dbgtpu.paths_mode.align_read_exhaustive_path(
            g_ref, codes, nm, 2, partial)
        assert dbgtpu_torch.paths_mode.align_read_exhaustive_path(
            g_own, codes, nm, 2, partial) == want
        assert exhaustive(g_own, codes, nm) == want
        aligned += want[0] == 1
    assert aligned > 20
    with pytest.raises(ValueError):
        spec_for("walks", 2, 2, False)


@pytest.mark.parametrize("flags", [["-p"], ["-p", "-b"], ["-p", "-i"],
                                   ["-p", "-b", "-i"], ["-p", "-G"],
                                   ["-p", "-c"]])
def test_cli_path_modes_write_dbgtpu_bytes(tmp_path, monkeypatch, flags):
    """-p wins over -b and -G as in dbgtpu; no kernel is launched, and
    the summary names the host spec as the device, on any --device."""
    rf, uf = _files(tmp_path, n_frac=0.1)
    monkeypatch.chdir(tmp_path)
    common = ["-r", rf, "-k", "21", "-g", uf, "-m", "2"] + flags
    assert dbgtpu_cli.main(common + ["--impl", "python", "-f", "p_ref", "-a",
                                     "n_ref"]) == 0
    kernel_build.reset_launches()
    assert cli.main(common + ["--json-summary", "s.json"]) == 0
    assert (tmp_path / "paths").read_bytes() == (
        tmp_path / "p_ref").read_bytes()
    assert (tmp_path / "notAligned.fa").read_bytes() == (
        tmp_path / "n_ref").read_bytes()
    summ = json.loads((tmp_path / "s.json").read_text())
    assert summ["device"] == "host-spec" and summ["aligned"] > 0
    assert not any(kernel_build.launches.values())
    # dbgtpu turns --impl jax into the python spec for these modes
    want = dbgtpu_pipeline(
        [rf], uf, k=21, m=2, impl="jax", correction="-c" in flags,
        mode="paths-exhaustive" if "-b" in flags else "paths",
        partial="-i" in flags)
    assert (tmp_path / "paths").read_bytes() == want[0]


@pytest.mark.parametrize("device,noted", [("cuda", True), ("cpu", False)])
def test_path_mode_says_that_it_runs_on_the_host(tmp_path, monkeypatch,
                                                 capsys, device, noted):
    """-p under a CUDA --device (the default) runs all the same, without a
    card, and one stderr line says that the device is not used."""
    rf, uf = _files(tmp_path, n_reads=20)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-r", rf, "-k", "21", "-g", uf, "-p", "--device",
                     device]) == 0
    err = capsys.readouterr().err
    assert ("path modes (-p) run on the host spec" in err) == noted
    assert (tmp_path / "paths").stat().st_size > 0


def test_path_mode_from_a_loaded_index_and_sharded(tmp_path, monkeypatch):
    rf, uf = _files(tmp_path)
    monkeypatch.chdir(tmp_path)
    want = dbgtpu_pipeline([rf], uf, k=21, impl="python", mode="paths")
    assert cli.main(["-r", rf, "-k", "21", "-g", uf, "-p", "--save-index",
                     "ix.npz", "-f", "p0", "-a", "n0"]) == 0
    for pid in (0, 1):
        assert cli.main(["-r", rf, "-p", "--load-index", "ix.npz",
                         "--num-processes", "2", "--process-id",
                         str(pid)]) == 0
    assert cli.main(["-r", rf, "--merge-shards", "2"]) == 0
    for got in ((tmp_path / "p0", tmp_path / "n0"),
                (tmp_path / "paths", tmp_path / "notAligned.fa")):
        assert got[0].read_bytes() == want[0]
        assert got[1].read_bytes() == want[1]


@pytest.mark.parametrize("n,flags,mode", [(2, [], "greedy"),
                                          (3, [], "greedy"),
                                          (3, ["-G"], "anchors"),
                                          (2, ["-b", "-i"], "exhaustive")])
def test_sharded_runs_merge_to_one_run(tmp_path, monkeypatch, n, flags, mode):
    """N processes, each mapping its record range of both input files
    into <out>.shard<id>; merged in process order they are the single
    run's bytes, which are dbgtpu's."""
    rf, uf = _files(tmp_path, seed=43, n_reads=101, n_frac=0.1)
    rf2 = str(tmp_path / "more.fa")
    open(rf2, "wb").write(open(rf, "rb").read()[:2000].rsplit(b">", 1)[0])
    monkeypatch.chdir(tmp_path)
    reads = f"{rf},{rf2}"
    common = ["-r", reads, "-k", "21", "-g", uf, "--device", "cpu",
              "--batch-size", "16"] + flags
    assert cli.main(common + ["-f", "p1", "-a", "n1"]) == 0
    for pid in range(n):
        assert cli.main(common + ["--num-processes", str(n), "--process-id",
                                  str(pid), "--json-summary",
                                  f"s{pid}.json"]) == 0
        assert (tmp_path / f"paths.shard{pid}").exists()
    assert not (tmp_path / "paths").exists()
    assert cli.main(["-r", reads, "--merge-shards", str(n)]) == 0
    assert not (tmp_path / "paths.shard0").exists()
    # per file the shards interleave, so the merged order is per process:
    # compare as multisets of records with the single run, and exactly
    # with dbgtpu's sharded run merged the same way
    for pid in range(n):
        assert dbgtpu_cli.main(
            ["-r", reads, "-k", "21", "-g", uf, "--impl", "python",
             "--num-processes", str(n), "--process-id", str(pid), "-f",
             "p_ref", "-a", "n_ref"] + flags) == 0
    assert dbgtpu_cli.main(["-r", reads, "--merge-shards", str(n), "-f",
                            "p_ref", "-a", "n_ref"]) == 0
    assert (tmp_path / "paths").read_bytes() == (
        tmp_path / "p_ref").read_bytes()
    assert (tmp_path / "notAligned.fa").read_bytes() == (
        tmp_path / "n_ref").read_bytes()

    def records(b):
        parts = b.split(b"\n>")
        return sorted(parts)

    assert records((tmp_path / "paths").read_bytes()) == records(
        (tmp_path / "p1").read_bytes())
    total = sum(json.loads((tmp_path / f"s{pid}.json").read_text())["reads"]
                for pid in range(n))
    want = dbgtpu_pipeline(reads.split(","), uf, k=21, impl="python",
                           mode=mode, partial="-i" in flags)
    assert total == want[2].read_number
    assert (tmp_path / "p1").read_bytes() == want[0]


def test_one_file_sharded_equals_the_single_run_exactly(tmp_path, monkeypatch):
    rf, uf = _files(tmp_path, seed=44, n_reads=77)
    monkeypatch.chdir(tmp_path)
    want = run_pipeline([rf], uf, k=21, device="cpu")
    for pid in range(3):
        got = run_pipeline([rf], uf, k=21, device="cpu", num_processes=3,
                           process_id=pid)
        (tmp_path / f"paths.shard{pid}").write_bytes(got[0])
        (tmp_path / f"notAligned.fa.shard{pid}").write_bytes(got[1])
    assert cli.main(["-r", rf, "--merge-shards", "3"]) == 0
    assert (tmp_path / "paths").read_bytes() == want[0]
    assert (tmp_path / "notAligned.fa").read_bytes() == want[1]
    with pytest.raises(FileNotFoundError):
        cli.main(["-r", rf, "--merge-shards", "2"])
