"""The dbgtpu_torch slice end to end on the CPU (the kernels' plain
versions): output bytes against dbgtpu's python spec and JAX engine
under both index layouts, the CLI, the refused flags and the flags that
were refused once, and that the port runs without JAX and without
dbgtpu."""

import json
import os
import re
import shutil
import socket
import subprocess
import sys
import types
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
    (["--index-layout", "mphf"], "greedy", False),
    (["-G", "--index-layout", "mphf"], "anchors", False),
    (["-b", "--index-layout", "mphf"], "exhaustive", False),
    (["-b", "-i", "--index-layout", "mphf"], "exhaustive", True),
])
def test_cli_runs_anchor_and_exhaustive_modes(tmp_path, monkeypatch, flags,
                                              mode, partial):
    """-G, -b and -b -i through cli.main on the CPU, under the scan and
    the mphf index layout: bytes equal to dbgtpu's spec in the same
    mode."""
    rf, uf = _files(tmp_path, 76, 21, 64, n_frac=0.1)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-r", rf, "-k", "21", "-g", uf, "-m", "2",
                     "--device", "cpu"] + flags) == 0
    want = dbgtpu_pipeline([rf], uf, k=21, m=2, impl="python", mode=mode,
                           partial=partial)
    assert (tmp_path / "paths").read_bytes() == want[0]
    assert (tmp_path / "notAligned.fa").read_bytes() == want[1]
    assert want[2].aligned > 0


def test_cli_runs_an_mphf_anchor_index(tmp_path, monkeypatch):
    """-G on a dog keyset that takes the MPHF anchor layout beside a scan
    junction table (the input the port used to refuse with exit 2) runs
    and writes dbgtpu's spec bytes."""
    from dbgtpu_torch.engine.runner import get_device_index
    from dbgtpu_torch.index import device as device_mod
    from dbgtpu_torch.index.build import build_graph

    rf, uf = _files(tmp_path, 77, 21, 64, n_frac=0.1)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(device_mod, "ANCHOR_MPHF_MIN", 0)
    assert cli.main(["-r", rf, "-k", "21", "-g", uf, "-G",
                     "--device", "cpu"]) == 0
    want = dbgtpu_pipeline([rf], uf, k=21, impl="python", mode="anchors")
    assert (tmp_path / "paths").read_bytes() == want[0]
    assert (tmp_path / "notAligned.fa").read_bytes() == want[1]
    assert want[2].aligned > 0
    di = get_device_index(build_graph(uf, 21, dog_mode=True))
    assert di.anchor_mphf is not None and di.anchor_scan is None
    assert di.scan_tbl is not None and di.mphf_junction is None


@pytest.mark.parametrize("flags,mode,env_extra", [
    (["--index-layout", "mphf"], "greedy", {}),
    (["-G", "--index-layout", "mphf"], "anchors", {}),
    (["-b", "--index-layout", "mphf"], "exhaustive", {}),
    # scan junction table, MPHF anchors
    (["-G"], "anchors", {"DBGTPU_ANCHOR_MPHF_MIN": "1"}),
])
def test_cli_mphf_layouts_equal_spec_and_jax_engine(tmp_path, flags, mode,
                                                    env_extra):
    """`python -m dbgtpu_torch --device cpu` and `python -m dbgtpu --impl
    jax` with the same flags and environment, each in a process of its
    own (the JAX programs of the MPHF layouts are compiled outside the
    suite's process, as tests/test_modes.py does): both write the bytes
    of dbgtpu's python spec."""
    rf, uf = _files(tmp_path, 78, 21, 96, n_frac=0.1)
    want = dbgtpu_pipeline([rf], uf, k=21, m=2, impl="python", mode=mode)
    assert want[2].aligned > 0 and want[2].aligned < want[2].read_number
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               CUDA_VISIBLE_DEVICES="", **env_extra)
    common = ["-r", rf, "-k", "21", "-g", uf, "-m", "2"] + flags
    for tag, cmd in (
        ("port", ["-m", "dbgtpu_torch", "--device", "cpu", "--json-summary",
                  "port.json"]),
        ("jax", ["-m", "dbgtpu", "--impl", "jax"]),
    ):
        res = subprocess.run(
            [sys.executable, *cmd, *common, "-f", f"p_{tag}", "-a",
             f"n_{tag}"], env=env, cwd=tmp_path, capture_output=True,
            text=True, timeout=600)
        assert res.returncode == 0, (tag, res.stderr[-2000:])
        assert (tmp_path / f"p_{tag}").read_bytes() == want[0], tag
        assert (tmp_path / f"n_{tag}").read_bytes() == want[1], tag
    hbm = json.loads((tmp_path / "port.json").read_text())["index_hbm_bytes"]
    if mode == "anchors":
        # MPHF anchors are several times smaller than the scan table's
        assert 0 < hbm["anchor_table"] < 60 * want[2].read_number * 100


_REFUSED = (["--resume", "--impl", "python"],)
# a coordinated run's address: a free localhost port at run time
_FREE_PORT = "127.0.0.1:{port}"


@pytest.mark.parametrize("flags", [
    ["-p"], ["-b", "-p"],
    ["--mesh", "2"], ["--shard-index"], ["--num-processes", "2"],
    ["--coordinator", "localhost:1"], ["--merge-shards", "2"],
    ["--save-index", "x.npz"], ["--load-index", "x.npz"], ["--resume"],
    ["--profile-dir", "prof"],
    ["--mesh", "0"], ["--shard-index", "--mesh", "2"],
    ["--coordinator", _FREE_PORT, "--num-processes", "2"],
    ["--impl", "python"], ["--impl", "jax"], ["--impl", "auto"],
    ["--resume", "--impl", "python"], ["--impl", "python", "-b"],
])
def test_cli_refuses_flags_outside_the_slice(tmp_path, monkeypatch, flags,
                                             capsys):
    """--resume refuses --impl python as dbgtpu does: it exits 2 naming
    the flag, before reading input.  Everything else runs and gives
    dbgtpu's bytes on the same inputs: the flags the port used to refuse
    (path modes, persistence, --resume, process sharding, --mesh 0 and
    2, --shard-index without a mesh and with --mesh 2 (the index cut
    into two row ranges on the CPU), --coordinator with one process and
    with two, --profile-dir) and
    --impl python|jax|auto.  --impl python runs on the host spec.  The
    coordinated case runs process 1 as a subprocess beside process 0 in
    this one, on a free localhost port."""
    if flags in _REFUSED:
        assert cli.main(["-r", "reads.fa", "-k", "21", "--device", "cpu"]
                        + flags) == 2
        assert flags[0] in capsys.readouterr().err
        return
    rf, uf = _files(tmp_path, 79, 21, 48, n_frac=0.1)
    monkeypatch.chdir(tmp_path)
    base = ["-r", rf, "-k", "21", "-g", uf, "--device", "cpu",
            "--json-summary", "s.json"]
    mode = ("paths-exhaustive" if flags == ["-b", "-p"]
            else "paths" if flags == ["-p"]
            else "exhaustive" if "-b" in flags else "greedy")
    want = dbgtpu_pipeline([rf], uf, k=21, impl="python", mode=mode)
    if flags[0] == "--load-index":
        assert cli.main(base + ["--save-index", "x.npz"]) == 0
    if flags[0] in ("--num-processes", "--merge-shards"):
        for pid in (0, 1):
            assert cli.main(base + ["--num-processes", "2", "--process-id",
                                    str(pid)]) == 0
        assert not (tmp_path / "paths").exists()
        assert cli.main(["-r", rf, "--merge-shards", "2"]) == 0
    elif flags[1:2] == [_FREE_PORT]:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        flags = [flags[0], _FREE_PORT.format(port=port), *flags[2:]]
        env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
        peer = subprocess.Popen(
            [sys.executable, "-m", "dbgtpu_torch", *base[:-2], *flags,
             "--process-id", "1"], env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            assert cli.main(base + flags) == 0
            out, err = peer.communicate(timeout=300)
        finally:
            if peer.poll() is None:
                peer.kill()
        assert peer.returncode == 0, err[-2000:]
        assert "Reads :" not in out
        assert f"Reads : {want[2].read_number}\n" in capsys.readouterr().out
        assert cli.main(["-r", rf, "--merge-shards", "2"]) == 0
    else:
        assert cli.main(base + flags) == 0
    assert (tmp_path / "paths").read_bytes() == want[0]
    assert (tmp_path / "notAligned.fa").read_bytes() == want[1]
    assert want[2].aligned > 0
    if flags[0] == "--save-index":
        assert (tmp_path / "x.npz").exists()
    if flags[0] == "--profile-dir":
        assert len(list((tmp_path / "prof").glob("*.json"))) == 1
    device = json.loads((tmp_path / "s.json").read_text())["device"]
    on_host = "-p" in flags or "python" in flags
    assert (device == "host-spec") == on_host, device


def test_cli_without_gpu_stops(tmp_path, monkeypatch, capsys):
    rf, uf = _files(tmp_path, 74, 21, 8)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-r", rf, "-k", "21", "-g", uf]) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "paths").exists()


def test_port_runs_without_jax_and_without_dbgtpu(tmp_path):
    """In a process where `import jax` and `import dbgtpu` fail, the port
    imports and maps a small file on the CPU under both layouts, and
    `python -m dbgtpu_torch --device cpu` writes its outputs from a copy
    of the package alone (no dbgtpu/ directory beside it); without a GPU
    and without --device cpu it exits non-zero."""
    rf, uf = _files(tmp_path, 75, 21, 16)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dbgtpu'] = None\n"
        "import dbgtpu_torch, dbgtpu_torch.cli, dbgtpu_torch.pipeline\n"
        "import dbgtpu_torch.engine.core, dbgtpu_torch.kernels.build\n"
        "import dbgtpu_torch.kernels.measure\n"
        "import dbgtpu_torch.spec, dbgtpu_torch.native\n"
        "import dbgtpu_torch.index.persist, dbgtpu_torch.paths_mode\n"
        "import dbgtpu_torch.dist.multihost, dbgtpu_torch.engine.gather\n"
        "import dbgtpu_torch.dist.mesh\n"
        "import dbgtpu_torch.tools.exp_gather, dbgtpu_torch.tools.ggmap\n"
        "import dbgtpu_torch.tools.convert_one_line, dbgtpu_torch.tools.no_n\n"
        "import dbgtpu_torch.tools.get_large_unitigs\n"
        "import dbgtpu_torch.tools.dbg_construction\n"
        "from dbgtpu_torch.pipeline import run_pipeline\n"
        "for layout in ('scan', 'mphf'):\n"
        f"    p, n, s = run_pipeline([{rf!r}], {uf!r}, k=21, device='cpu',\n"
        "                           index_layout=layout)\n"
        "    assert s.read_number == 16 and len(p) > 0\n"
        f"p, n, s = run_pipeline([{rf!r}], {uf!r}, k=21, mode='paths',\n"
        "                       save_index='alone.npz')\n"
        "assert s.device == 'host-spec' and len(p) > 0\n"
        "from dbgtpu_torch.index.persist import load_index\n"
        "g = load_index('alone.npz')\n"
        f"assert run_pipeline([{rf!r}], '', k=21, graph=g, device='cpu',\n"
        "                    mode='paths')[0] == p\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'dbgtpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ALONE-OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "ALONE-OK" in res.stdout
    # the package alone, copied out of the repository
    alone = tmp_path / "alone"
    shutil.copytree(ROOT / "dbgtpu_torch", alone / "dbgtpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(env, PYTHONPATH=str(alone),
               DBGTPU_NATIVE_CACHE=str(tmp_path / "native"))
    for extra, ok in (([], False),
                      (["--device", "cpu", "--index-layout", "mphf", "-G"],
                       True)):
        res = subprocess.run(
            [sys.executable, "-m", "dbgtpu_torch", "-r", rf, "-k", "21", "-g",
             uf] + extra, env=env, cwd=alone, capture_output=True, text=True,
            timeout=300)
        assert (res.returncode == 0) == ok, res.stderr
        assert (alone / "paths").exists() == ok
    want = dbgtpu_pipeline([rf], uf, k=21, impl="python", mode="anchors")
    assert (alone / "paths").read_bytes() == want[0]
    # the gather experiment from the copy alone: plain versions on the CPU
    res = subprocess.run(
        [sys.executable, "-m", "dbgtpu_torch.tools.exp_gather", "--device",
         "cpu"], env=env, cwd=alone, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("== plain version (exact)") == 5


_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|dbgtpu)(?:[.\s]|$)", re.M)


def test_port_sources_never_import_jax_or_dbgtpu():
    paths = [*(ROOT / "dbgtpu_torch").rglob("*.py"), ROOT / "chip_smoke.py",
             ROOT / "torch_profile.py"]
    assert len(paths) > 40
    names = {str(p.relative_to(ROOT)) for p in paths}
    assert {"dbgtpu_torch/index/persist.py", "dbgtpu_torch/paths_mode.py",
            "dbgtpu_torch/dist/multihost.py", "dbgtpu_torch/dist/mesh.py",
            "dbgtpu_torch/engine/gather.py",
            "dbgtpu_torch/tools/exp_gather.py",
            "dbgtpu_torch/tools/ggmap.py"} <= names
    for path in paths:
        found = _IMPORT.search(path.read_text())
        assert found is None, (path, found.group(0))
    assert _IMPORT.search("    from dbgtpu.seq import encode")
    assert _IMPORT.search("import jax")
    assert not _IMPORT.search("from dbgtpu_torch.seq import encode")


def test_kernel_build_recipe(monkeypatch):
    """The kernels build from the package's own sources into
    build/dbgtpu_torch/ with nvcc for sm_90a; nothing is built at
    import, and a machine without nvcc gets a clear error."""
    from dbgtpu_torch.kernels import build

    names = {p.name for p in build.sources()}
    assert {"read_scan.cu", "member.cu", "walk.cu", "pack.cu", "dog.cu",
            "exhaustive.cu", "mphf.cu", "compact.cu", "gather.cu",
            "common.cuh", "junction.cuh", "mphf.cuh"} <= names
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


def test_kernel_resources_from_ptxas_report(monkeypatch, tmp_path):
    """The build keeps ptxas's report (-Xptxas -v) beside the library,
    each source's part after a line naming it; kernel_resources reads the
    source, registers and spills per kernel entry from it, and
    chip_smoke.py prints them with the warps per SM that the block size
    the source's library reports (dbg_<source>_threads) allows."""
    import chip_smoke
    from dbgtpu_torch.kernels import build

    assert build.NVCC_FLAGS[-2:] == ["-Xptxas", "-v"]
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    assert build.ptxas_path().parent == tmp_path
    assert build.kernel_resources() == {}
    build.ptxas_path().write_text(
        "== walk.cu\n"
        "ptxas info    : Compiling entry function '_Z18greedy_walk_kernelv'"
        " for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z18greedy_walk_kernelv\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
        "loads\n"
        "ptxas info    : Used 64 registers, used 0 barriers, 472 bytes "
        "cmem[0]\n"
        "== gather.cu\n"
        "ptxas info    : Compiling entry function '_Z6gatherv' for 'sm_90a'\n"
        "ptxas info    : Used 30 registers, used 0 barriers\n")
    got = build.kernel_resources()
    assert got == {
        "_Z18greedy_walk_kernelv": dict(source="walk", registers=64,
                                        spill_stores=8, spill_loads=4),
        "_Z6gatherv": dict(source="gather", registers=30)}

    def dbg_walk_threads():
        return 128

    lines = []
    monkeypatch.setattr(chip_smoke, "log", lines.append)
    chip_smoke.log_resources("t", got, types.SimpleNamespace(
        dbg_walk_threads=dbg_walk_threads))
    assert lines == [
        "[ptxas] t: gather.cu _Z6gatherv: 30 registers, spill stores 0 B, "
        "loads 0 B; block size not reported",
        "[ptxas] t: walk.cu _Z18greedy_walk_kernelv: 64 registers, spill "
        "stores 8 B, loads 4 B; 32 warps per SM in blocks of 128 threads"]
    # 65,536 registers per SM, allocated per warp in units of 256
    assert chip_smoke.occupancy_warps(64, 128) == 32
    assert chip_smoke.occupancy_warps(84, 128) == 20
    assert chip_smoke.occupancy_warps(32, 256) == 64


def test_kernel_build_dir_outside_a_checkout(monkeypatch, tmp_path):
    """An installed copy builds into $DBGTPU_TORCH_CACHE, not beside
    site-packages."""
    from dbgtpu_torch.kernels import build

    monkeypatch.setattr(build, "_ROOT", tmp_path / "site-packages")
    monkeypatch.setenv("DBGTPU_TORCH_CACHE", str(tmp_path / "cache"))
    assert build._build_dir() == tmp_path / "cache" / "dbgtpu_torch"
