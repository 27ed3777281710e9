"""dbgtpu_torch's run modes beyond one device on the CPU: `--mesh N` (N
shards of each batch, dist/mesh.py), `--coordinator` with two gloo
processes on a free localhost port (dist/multihost.py init_distributed
and global_stats_sum) and `--profile-dir` (a torch.profiler trace).
Output bytes against dbgtpu's python spec; tolerance 0."""

import dataclasses
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


# dbgtpu's --shard-index guards (dbgtpu/engine/runner.py:287-307), each
# on a mesh of one device and of more: (flags, mesh size, the dataset's
# genome length, probe rows kept (None: all))
_GUARDS = {
    "anchors-mesh1": (["-G"], 1, 8000, None),
    "anchors-mesh2": (["-G"], 2, 8000, None),
    "exhaustive-mesh1": (["-b"], 1, 8000, None),
    "exhaustive-mesh2": (["-b"], 2, 8000, None),
    "mphf-mesh1": (["--index-layout", "mphf"], 1, 8000, None),
    "mphf-mesh4": (["--index-layout", "mphf"], 4, 8000, None),
    "junction-rows-below-mesh": ([], 8, 2000, None),
    "probe-rows-below-mesh": ([], 8, 8000, 4),
    "uneven-mesh3": ([], 3, 8000, None),
}


@pytest.mark.parametrize("case", list(_GUARDS) + ["no-mesh"])
def test_cli_shard_index_guards_as_dbgtpu(tmp_path, monkeypatch, case):
    """--shard-index on a mesh of any size takes dbgtpu's guards: -G, -b,
    the mphf layout (no scan table: 0 rows), fewer junction or probe rows
    than devices and a mesh size that does not divide the row counts each
    raise dbgtpu's ValueError, word for word (the CLI too, for the cases
    that flags make; the probe table is cut on both packages' built index
    for its case).  Without a mesh the flag changes nothing and the run
    writes the spec's bytes."""
    from dbgtpu import native as jax_native
    from dbgtpu.dist.mesh import make_mesh as jax_mesh
    from dbgtpu.engine import runner as jax_runner
    from dbgtpu.index.build import build_graph as jax_build_graph

    monkeypatch.chdir(tmp_path)
    if case == "no-mesh":
        rf, uf = _files(tmp_path)
        want = dbgtpu_pipeline([rf], uf, k=21, impl="python")
        assert cli.main(["-r", rf, "-k", "21", "-g", uf, "--device", "cpu",
                         "--shard-index"]) == 0
        assert (tmp_path / "paths").read_bytes() == want[0]
        assert (tmp_path / "notAligned.fa").read_bytes() == want[1]
        return
    flags, n, genome_len, probe_rows = _GUARDS[case]
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=81, genome_len=genome_len, k=21, n_reads=20, n_frac=0.1)
    rf, uf = str(tmp_path / "reads.fa"), str(tmp_path / "unitigs.fa")
    Path(rf).write_bytes(reads_fa)
    Path(uf).write_bytes(unitigs_fa)
    mode = ("anchors" if "-G" in flags else "exhaustive" if "-b" in flags
            else "greedy")
    layout = "mphf" if "mphf" in flags else "scan"
    graphs = []
    for build, get in ((jax_build_graph, jax_runner.get_device_index),
                       (build_graph, runner.get_device_index)):
        g = build(uf, 21, dog_mode=mode == "anchors")
        di = get(g, layout)
        if probe_rows is not None:
            di.probe_tbl = dataclasses.replace(
                di.probe_tbl, rows=di.probe_tbl.rows[:probe_rows])
        graphs.append(g)
    with pytest.raises(ValueError) as want:
        jax_runner.align_bulk(graphs[0], jax_native.parse_reads(rf, 21, False),
                              2, 2, mode=mode, index_layout=layout,
                              mesh=jax_mesh(n), shard_index=True)
    assert "--shard-index requires" in str(want.value)
    with pytest.raises(ValueError) as got:
        runner.align_bulk(graphs[1], native.parse_reads(rf, 21, False), 2, 2,
                          batch_size=16, device="cpu", mode=mode,
                          index_layout=layout,
                          mesh=mesh_mod.make_mesh(n, "cpu"), shard_index=True)
    assert str(got.value) == str(want.value)
    if probe_rows is None:
        with pytest.raises(ValueError) as got:
            cli.main(["-r", rf, "-k", "21", "-g", uf, "--device", "cpu",
                      "--shard-index", "--mesh", str(n)] + flags)
        assert str(got.value) == str(want.value)
        assert not (tmp_path / "paths").exists()


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
    writes it to --json-summary; process 1 prints none and writes its
    own counters there; the merged shards are the single run's bytes."""
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
    # every process writes its --json-summary (dbgtpu/cli.py:291-295):
    # process 1's holds its own record range's counters
    own = dbgtpu_pipeline([rf], uf, k=21, impl="python", num_processes=2,
                          process_id=1)[2]
    summ1 = json.loads((tmp_path / "s1.json").read_text())
    assert [summ1[f] for f in ("reads", "aligned", "not_aligned",
                               "no_overlap")] == [
        own.read_number, own.aligned, own.not_aligned, own.no_overlap]
    assert 0 < own.read_number < n
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
    """--profile-dir writes a Chrome trace of the whole run into DIR,
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
