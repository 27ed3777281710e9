"""dbgtpu_torch's run modes beyond one device on the CPU: `--mesh N` (N
shards of each batch, dist/mesh.py), `--coordinator` with two gloo
processes on a free localhost port (dist/multihost.py init_distributed
and global_stats_sum) and `--profile-dir` (a torch.profiler trace).
Output bytes against dbgtpu's python spec; tolerance 0."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dbgtpu.pipeline import run_pipeline as dbgtpu_pipeline
from dbgtpu_torch import cli, native
from dbgtpu_torch.dist import mesh as mesh_mod
from dbgtpu_torch.dist import multihost
from dbgtpu_torch.engine import runner
from dbgtpu_torch.index.build import build_graph

from . import synth

ROOT = Path(__file__).resolve().parents[1]


def _files(tmp_path, seed=81, n_reads=50):
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=seed, genome_len=8000, k=21, n_reads=n_reads, n_frac=0.1)
    rf, uf = tmp_path / "reads.fa", tmp_path / "unitigs.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    return str(rf), str(uf)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_make_mesh_takes_local_devices(monkeypatch):
    """The first N local CUDA devices, all of them for None, what there
    is where fewer are present; on the CPU, N shards of the one device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert mesh_mod.make_mesh(2) == cuda[:2]
    assert mesh_mod.make_mesh(None) == cuda
    assert mesh_mod.make_mesh(8, "cuda:1") == cuda
    assert mesh_mod.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert mesh_mod.make_mesh(None, "cpu") == [torch.device("cpu")]
    assert mesh_mod.mesh_of(0, "cuda") is None
    assert mesh_mod.mesh_of(-1, "cuda") == cuda
    assert mesh_mod.mesh_of(-1, "cpu") == [torch.device("cpu")]
    assert mesh_mod.mesh_of(2, "cpu") == [torch.device("cpu")] * 2


@pytest.mark.parametrize("n", [2, 3, 8])
def test_mesh_rounds_batches_as_dbgtpu(tmp_path, n):
    """The batch size is rounded up to a multiple of the mesh's device
    count (dbgtpu/engine/runner.py:285-286), each batch cut into
    contiguous equal shards, one launch per shard holding rows."""
    rf, uf = _files(tmp_path)
    graph, parsed = build_graph(uf, 21), native.parse_reads(rf, 21, False)
    plain = runner.align_bulk(graph, parsed, 2, 2, batch_size=7,
                              device="cpu")
    for batch_size in (1, 7, 16):
        rounded = ((batch_size + n - 1) // n) * n    # dbgtpu's rule
        starts, shard_rows = [], []
        real = runner.align_batch_packed_compact

        def launch(ix, words, *a, **kw):
            shard_rows.append(words.shape[0])
            return real(ix, words, *a, **kw)

        runner.align_batch_packed_compact = launch
        try:
            got = runner.align_bulk(
                graph, parsed, 2, 2, batch_size=batch_size, device="cpu",
                mesh=mesh_mod.make_mesh(n, "cpu"),
                on_batch=lambda slot, s0, nb, *r: starts.append((s0, nb)))
        finally:
            runner.align_batch_packed_compact = real
        assert [s for s, _ in starts] == list(range(0, parsed.n, rounded))
        assert all(nb == rounded for _, nb in starts[:-1])
        step = -(-rounded // n)
        assert max(shard_rows) == step and sum(shard_rows) == parsed.n
        for a, b in zip(got, plain):
            assert (a == b).all()


@pytest.mark.parametrize("mesh", ["2", "8", "-1"])
def test_cli_mesh_bytes_equal_spec(tmp_path, monkeypatch, mesh):
    rf, uf = _files(tmp_path)
    monkeypatch.chdir(tmp_path)
    for flags, mode, layout in (([], "greedy", "scan"),
                                (["-b", "-i"], "exhaustive", "mphf")):
        want = dbgtpu_pipeline([rf], uf, k=21, impl="python", mode=mode,
                               partial="-i" in flags)
        assert cli.main(["-r", rf, "-k", "21", "-g", uf, "--device", "cpu",
                         "--batch-size", "12", "--mesh", mesh,
                         "--index-layout", layout] + flags) == 0
        assert (tmp_path / "paths").read_bytes() == want[0]
        assert (tmp_path / "notAligned.fa").read_bytes() == want[1]


def test_cli_shard_index_runs_only_on_one_device(tmp_path, monkeypatch,
                                                 capsys):
    """--shard-index changes nothing on a mesh of one device and runs;
    on more than one it exits 2 before reading input, naming B15."""
    rf, uf = _files(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-r", "missing.fa", "-k", "21", "--device", "cpu",
                     "--shard-index", "--mesh", "2"]) == 2
    err = capsys.readouterr().err
    assert "--shard-index" in err and "B15" in err
    want = dbgtpu_pipeline([rf], uf, k=21, impl="python")
    assert cli.main(["-r", rf, "-k", "21", "-g", uf, "--device", "cpu",
                     "--shard-index", "--mesh", "1"]) == 0
    assert (tmp_path / "paths").read_bytes() == want[0]


def test_resume_on_a_mesh(tmp_path, monkeypatch):
    """A journaled run on a mesh of 3 shards writes the spec's bytes."""
    rf, uf = _files(tmp_path)
    monkeypatch.chdir(tmp_path)
    want = dbgtpu_pipeline([rf], uf, k=21, impl="python", mode="anchors")
    assert cli.main(["-r", rf, "-k", "21", "-g", uf, "--device", "cpu",
                     "-G", "--resume", "--batch-size", "8",
                     "--mesh", "3"]) == 0
    assert (tmp_path / "paths").read_bytes() == want[0]
    assert (tmp_path / "notAligned.fa").read_bytes() == want[1]
    assert not (tmp_path / "paths.resume.json").exists()


def _coordinated(tmp_path, rf, uf):
    """Two `python -m dbgtpu_torch` processes joined by --coordinator on a
    free localhost port: their stdout."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dbgtpu_torch", "-r", rf, "-k", "21", "-g", uf,
         "--device", "cpu", "--batch-size", "16", "-f", "paths", "-a",
         "notAligned.fa", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(pid),
         "--json-summary", f"s{pid}.json"],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_coordinator_two_gloo_processes(tmp_path):
    """Process 0 prints the stats block summed over both processes and
    writes it to --json-summary; process 1 prints none; the merged
    shards are the single run's bytes."""
    rf, uf = _files(tmp_path, n_reads=70)
    want = dbgtpu_pipeline([rf], uf, k=21, impl="python")
    outs = _coordinated(tmp_path, rf, uf)
    n = want[2].read_number
    assert f"Reads : {n}\n" in outs[0]
    assert f"Overlap and aligned : {want[2].aligned} " in outs[0]
    assert "Reads :" not in outs[1]
    summ = json.loads((tmp_path / "s0.json").read_text())
    assert [summ[f] for f in ("reads", "aligned", "not_aligned",
                              "no_overlap")] == [
        want[2].read_number, want[2].aligned, want[2].not_aligned,
        want[2].no_overlap]
    assert not (tmp_path / "s1.json").exists()
    for base in ("paths", "notAligned.fa"):
        multihost.merge_shards(str(tmp_path / base), 2)
    assert (tmp_path / "paths").read_bytes() == want[0]
    assert (tmp_path / "notAligned.fa").read_bytes() == want[1]


def test_init_distributed_and_stats_sum_in_one_process(monkeypatch):
    """Without a coordinator nothing starts and the sum is the identity;
    dbgtpu's environment names give the coordinator, the process count
    and id; a group of one sums to the identity."""
    import numpy as np
    import torch.distributed as dist

    for name in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.init_distributed() is False
    v = np.array([5, 3, 1, 1], np.int64)
    assert (multihost.global_stats_sum(v) == v).all()
    monkeypatch.setenv("JAX_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    try:
        assert multihost.init_distributed() is True
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        assert dist.get_backend() == "gloo"
        assert multihost.init_distributed() is True      # already up
        got = multihost.global_stats_sum(v)
        assert got.dtype == np.int64 and (got == v).all()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("extra", [[], ["--resume", "--batch-size", "8"]])
def test_profile_dir_writes_a_trace(tmp_path, monkeypatch, extra):
    """--profile-dir writes a Chrome trace of the mapping call into DIR,
    of a journaled run too; the bytes do not change."""
    rf, uf = _files(tmp_path)
    monkeypatch.chdir(tmp_path)
    want = dbgtpu_pipeline([rf], uf, k=21, impl="python")
    assert cli.main(["-r", rf, "-k", "21", "-g", uf, "--device", "cpu",
                     "--profile-dir", "prof", *extra]) == 0
    assert (tmp_path / "paths").read_bytes() == want[0]
    assert (tmp_path / "notAligned.fa").read_bytes() == want[1]
    traces = list((tmp_path / "prof").glob("*.json"))
    assert len(traces) == 1
    trace = json.loads(traces[0].read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("run_pipeline" in n or n.startswith("aten::") for n in names)
