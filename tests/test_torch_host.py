"""The host modules dbgtpu_torch keeps as its own copies (constants, seq,
io.fasta, index.hash32 / build / device / mphf / persist, native, the
executable spec model / anchors / exhaustive / paths_mode, spec.py's
output helpers, the dist.multihost helpers and tools/) against the
dbgtpu originals on seeded inputs: same arrays, same bytes (tolerance
0).  The port never imports dbgtpu; only these tests hold both packages
side by side."""

import ast
import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest

import dbgtpu.anchors
import dbgtpu.constants
import dbgtpu.dist.multihost
import dbgtpu.exhaustive
import dbgtpu.index.build
import dbgtpu.index.device
import dbgtpu.index.mphf
import dbgtpu.index.persist
import dbgtpu.io.fasta
import dbgtpu.model
import dbgtpu.native
import dbgtpu.paths_mode
import dbgtpu.pipeline
import dbgtpu.seq
import dbgtpu_torch.anchors
import dbgtpu_torch.constants
import dbgtpu_torch.dist.multihost
import dbgtpu_torch.exhaustive
import dbgtpu_torch.index.build
import dbgtpu_torch.index.device
import dbgtpu_torch.index.hash32
import dbgtpu_torch.index.mphf
import dbgtpu_torch.index.persist
import dbgtpu_torch.io.fasta
import dbgtpu_torch.model
import dbgtpu_torch.native
import dbgtpu_torch.paths_mode
import dbgtpu_torch.pipeline
import dbgtpu_torch.seq
import dbgtpu_torch.spec
from dbgtpu.engine import kmer32

from . import synth
from .torch_parity import fasta_seqs

REF_BUILD, OWN_BUILD = dbgtpu.index.build, dbgtpu_torch.index.build
REF_DEV, OWN_DEV = dbgtpu.index.device, dbgtpu_torch.index.device


def assert_same(a, b, where="value"):
    """Deep equality of two results built by the two packages: arrays by
    dtype, shape and content, objects of same-named classes field by
    field (memo attributes the engines attach, `_...`, aside)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for key in a:
            assert_same(a[key], b[key], f"{where}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif a is None or isinstance(a, (bool, int, float, str, bytes, np.generic)):
        assert type(a) is type(b) and a == b, (where, a, b)
    else:
        assert type(a).__name__ == type(b).__name__, where
        names = (getattr(type(a), "__slots__", None)
                 or [n for n in vars(a) if not n.startswith("_")])
        assert names, where
        for name in names:
            assert_same(getattr(a, name), getattr(b, name), f"{where}.{name}")


def _dataset(tmp_path, seed, k, n_reads=80, fastq=False, **kw):
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=seed, genome_len=kw.pop("genome_len", 8000), k=k,
        n_reads=n_reads, **kw)
    if fastq:
        reads_fa = synth.to_fastq(
            [ln for ln in reads_fa.split(b"\n")[1::2] if ln])
    rf, uf = tmp_path / "reads.fa", tmp_path / "unitigs.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    return str(rf), str(uf)


def test_constants_equal():
    names = [n for n in vars(dbgtpu.constants) if n.isupper()]
    assert len(names) >= 5
    for n in names:
        assert getattr(dbgtpu_torch.constants, n) == getattr(
            dbgtpu.constants, n), n


def test_seq_and_hash32_equal():
    rng = np.random.default_rng(101)
    seq = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=300,
                           p=[.24, .24, .24, .24, .04]))
    own, ref = dbgtpu_torch.seq, dbgtpu.seq
    codes = ref.encode(seq)
    assert_same(own.encode(seq), codes)
    assert_same(own.n_mask(seq), ref.n_mask(seq))
    assert own.decode(codes) == ref.decode(codes)
    assert_same(own.rc_codes(codes), ref.rc_codes(codes))
    for n in (4, 20, 31, 32):
        kmers = ref.kmers_of(codes, n)
        assert_same(own.kmers_of(codes, n), kmers, f"kmers_of {n}")
        assert_same(own.rcb(kmers, n), ref.rcb(kmers, n), f"rcb {n}")
        assert_same(own.canonical(kmers, n), ref.canonical(kmers, n))
        assert own.codes_to_kmer(codes[:n]) == ref.codes_to_kmer(codes[:n])
    assert own.hamming(codes[:50], codes[50:100], ref.n_mask(seq)[:50]) == \
        ref.hamming(codes[:50], codes[50:100], ref.n_mask(seq)[:50])
    keys = rng.integers(0, 2**64, size=5000, dtype=np.uint64)
    h = dbgtpu_torch.index.hash32
    hi, lo = kmer32.split64(keys)
    assert_same(h.split64(keys), (hi, lo))
    assert_same(h.join64(hi, lo), kmer32.join64(hi, lo))
    assert_same(h.mix32(hi, lo), kmer32.mix32(hi, lo))
    assert_same(h.mix32b(hi, lo), kmer32.mix32b(hi, lo))


@pytest.mark.parametrize("fastq", [False, True])
def test_fasta_readers_equal(tmp_path, fastq):
    rf, _ = _dataset(tmp_path, 102, 21, fastq=fastq, n_frac=0.2)
    got = list(dbgtpu_torch.io.fasta.iter_reads(rf, 21, fastq))
    assert got == list(dbgtpu.io.fasta.iter_reads(rf, 21, fastq))
    assert len(got) > 50


@pytest.mark.parametrize("k,dog", [(21, False), (21, True), (32, True),
                                   (5, False)])
def test_build_graph_equal(tmp_path, k, dog):
    kw = dict(min_unitig=5, max_unitig=12, genome_len=600) if k == 5 else {}
    _, uf = _dataset(tmp_path, 103 + k, k, **kw)
    ref = REF_BUILD.build_graph(uf, k, dog_mode=dog)
    own = OWN_BUILD.build_graph(uf, k, dog_mode=dog)
    assert_same(own, ref, "graph")
    assert own.n_unitigs > 10 and len(own.jkeys) > 0
    assert bool(own.anchors) == dog
    assert own.left == ref.left and own.right == ref.right
    key = int(ref.jkeys[0])
    assert own.get_begin(key) == ref.get_begin(key)
    assert own.get_end(key) == ref.get_end(key)
    assert_same(OWN_BUILD.build_graph_from_seqs(
        fasta_seqs(open(uf, "rb").read()), k, dog_mode=dog), ref, "from seqs")


@pytest.mark.parametrize("case,layout,dog,env", [
    ("scan", "scan", False, {}),
    ("mphf", "mphf", False, {}),
    ("scan_dog", "scan", True, {}),
    ("mphf_dog", "mphf", True, {}),
    ("scan_renumbered", "scan", False, {"DBGTPU_RENUMBER": "1"}),
    ("mphf_dog_renumbered", "mphf", True, {"DBGTPU_RENUMBER": "1"}),
    ("window4", "scan", False, {"DBGTPU_PROBE_WINDOW": "4"}),
])
def test_build_device_index_equal(tmp_path, monkeypatch, case, layout, dog,
                                  env):
    """Both packages read the same DBGTPU_* environment and build the
    same tables from the same graph."""
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    _, uf = _dataset(tmp_path, 110, 21, genome_len=12000)
    ref = REF_DEV.build_device_index(
        REF_BUILD.build_graph(uf, 21, dog_mode=dog), layout=layout)
    own = OWN_DEV.build_device_index(
        OWN_BUILD.build_graph(uf, 21, dog_mode=dog), layout=layout)
    assert_same(own, ref, "device index")
    assert_same(OWN_DEV.hbm_report(own), REF_DEV.hbm_report(ref), "hbm")
    assert (own.mphf_junction is not None) == (layout == "mphf")
    assert (own.scan_tbl is None) == (layout == "mphf")
    assert own.probe_tbl is not None
    if dog:
        assert (own.anchor_mphf is not None) == (layout == "mphf")
    if "DBGTPU_RENUMBER" in env:
        assert own.id_inv is not None
    if case == "window4":
        assert own.probe_tbl.window == 4


def test_anchor_mphf_floor_equal(tmp_path, monkeypatch):
    """A dog keyset of ANCHOR_MPHF_MIN keys or more takes the MPHF anchor
    layout beside a scan junction table, in both packages."""
    assert OWN_DEV.ANCHOR_MPHF_MIN == REF_DEV.ANCHOR_MPHF_MIN == 4_000_000
    monkeypatch.setattr(REF_DEV, "ANCHOR_MPHF_MIN", 1)
    monkeypatch.setattr(OWN_DEV, "ANCHOR_MPHF_MIN", 1)
    _, uf = _dataset(tmp_path, 111, 21)
    ref = REF_DEV.build_device_index(REF_BUILD.build_graph(uf, 21, True))
    own = OWN_DEV.build_device_index(OWN_BUILD.build_graph(uf, 21, True))
    assert_same(own, ref, "device index")
    assert own.anchor_mphf is not None and own.anchor_scan is None
    assert own.scan_tbl is not None


@pytest.mark.parametrize("n,gamma,max_levels", [
    (5000, 2.0, 25), (4000, 1.05, 3), (3000, 16.0, 3), (1, 2.0, 25),
    (0, 2.0, 25),
])
def test_build_mphf_equal(tmp_path, n, gamma, max_levels):
    rng = np.random.default_rng(n + 7)
    keys = np.unique(rng.integers(0, 2**63, size=2 * n + 2,
                                  dtype=np.uint64))[:n]
    ref = dbgtpu.index.mphf.build_mphf(keys, gamma=gamma,
                                       max_levels=max_levels)
    own = dbgtpu_torch.index.mphf.build_mphf(keys, gamma=gamma,
                                             max_levels=max_levels)
    assert_same(own, ref, "mphf")
    absent = rng.integers(0, 2**63, size=1000, dtype=np.uint64)
    q = np.concatenate([keys, absent])
    assert_same(own.lookup(q), ref.lookup(q), "lookup")
    assert own.total_bits() == ref.total_bits()
    assert_same(dbgtpu_torch.index.mphf._SEEDS_HI, dbgtpu.index.mphf._SEEDS_HI)
    assert_same(dbgtpu_torch.index.mphf._SEEDS_LO, dbgtpu.index.mphf._SEEDS_LO)
    # a file saved by one package loads in the other
    path = str(tmp_path / "m.npz")
    own.save(path)
    assert_same(dbgtpu.index.mphf.MPHF.load(path), ref, "saved mphf")


@pytest.mark.parametrize("fastq", [False, True])
def test_native_parse_and_pack_equal(tmp_path, fastq):
    """The port's native library is its own file; it parses and packs as
    dbgtpu's, and as both python fallbacks."""
    own, ref = dbgtpu_torch.native, dbgtpu.native
    assert own.available() and ref.available()
    assert own._LIB_CACHE != ref._LIB_CACHE
    assert "dbgtpu_torch" in own._get_lib()._name
    rf, _ = _dataset(tmp_path, 120, 21, fastq=fastq, n_frac=0.2)
    want = ref.parse_reads(rf, 21, fastq)
    assert_same(own.parse_reads(rf, 21, fastq), want, "parsed")
    assert_same(own.parse_reads_python(rf, 21, fastq), want, "python parse")
    assert want.n > 50 and want.nmask.any()
    assert_same(own.pack_batch_native(want, 8, 40, 48, 112),
                ref.pack_batch_native(want, 8, 40, 48, 112), "packed")
    assert own.parse_reads(rf, 21, fastq).seq_bytes(3) == want.seq_bytes(3)


@pytest.mark.parametrize("mode,k,m,kw", [
    ("greedy", 21, 2, dict(n_frac=0.2)),
    ("greedy", 32, 1, dict(read_len=150, genome_len=12000)),
    ("anchors", 21, 2, dict(n_frac=0.2)),
    ("anchors", 32, 2, {}),
    ("exhaustive", 21, 2, dict(n_frac=0.2)),
    ("exhaustive_partial", 21, 1, dict(n_frac=0.1)),
])
def test_spec_aligners_equal(tmp_path, mode, k, m, kw):
    """model / anchors / exhaustive: the same (status, path) per read."""
    rf, uf = _dataset(tmp_path, 130 + k, k, n_reads=60, **kw)
    dog = mode == "anchors"
    g_ref = REF_BUILD.build_graph(uf, k, dog_mode=dog)
    g_own = OWN_BUILD.build_graph(uf, k, dog_mode=dog)
    partial = mode == "exhaustive_partial"
    ref_fn, own_fn = {
        "greedy": (lambda g, c, n: dbgtpu.model.align_read_greedy(
                       g, c, n, m, 2),
                   lambda g, c, n: dbgtpu_torch.model.align_read_greedy(
                       g, c, n, m, 2)),
        "anchors": (lambda g, c, n: dbgtpu.anchors.align_read_greedy_anchors(
                        g, c, n, m, 2),
                    lambda g, c, n:
                    dbgtpu_torch.anchors.align_read_greedy_anchors(
                        g, c, n, m, 2)),
    }.get(mode, (lambda g, c, n: dbgtpu.exhaustive.align_read_exhaustive(
                     g, c, n, m, partial),
                 lambda g, c, n: dbgtpu_torch.exhaustive.align_read_exhaustive(
                     g, c, n, m, partial)))
    spec = dbgtpu_torch.spec.spec_for(mode.split("_")[0], m, 2, partial)
    statuses = set()
    for _, seq in dbgtpu.io.fasta.iter_reads(rf, k, False):
        codes, nm = dbgtpu.seq.encode(seq), dbgtpu.seq.n_mask(seq)
        want = ref_fn(g_ref, codes, nm)
        assert own_fn(g_own, codes, nm) == want
        assert spec(g_own, codes, nm) == want
        statuses.add(want[0])
        if want[1] and len(want[1]) > 1:
            rlen = len(seq)
            assert_same(dbgtpu_torch.model.recover_path(g_own, want[1], rlen),
                        dbgtpu.model.recover_path(g_ref, want[1], rlen))
            assert dbgtpu_torch.model.format_path(want[1]) == \
                dbgtpu.model.format_path(want[1])
    assert statuses & {1, 2}


@pytest.mark.parametrize("correction", [False, True])
@pytest.mark.parametrize("native_on", [True, False])
def test_format_outputs_equal(tmp_path, monkeypatch, correction, native_on):
    """_count_stats / _format_outputs / RunStats on one aligned block,
    through the native formatters and through the python fallbacks."""
    rf, uf = _dataset(tmp_path, 140, 21, n_frac=0.2)
    want = dbgtpu.pipeline.run_pipeline([rf], uf, k=21, impl="python",
                                        correction=correction)
    g_ref = REF_BUILD.build_graph(uf, 21)
    g_own = OWN_BUILD.build_graph(uf, 21)
    parsed = dbgtpu.native.parse_reads(rf, 21, False)
    status = np.zeros(parsed.n, np.int32)
    paths = []
    for i in range(parsed.n):
        _, codes, nm = parsed.record(i)
        status[i], path = dbgtpu.model.align_read_greedy(g_ref, codes, nm,
                                                         2, 2)
        paths.append(path or [])
    path_off = np.zeros(parsed.n + 1, np.int64)
    np.cumsum([len(p) for p in paths], out=path_off[1:])
    flat = np.array([v for p in paths for v in p], np.int32)
    if not native_on:
        monkeypatch.setattr(dbgtpu.native, "available", lambda: False)
        monkeypatch.setattr(dbgtpu_torch.native, "available", lambda: False)
    outs = []
    for mod, graph in ((dbgtpu.pipeline, g_ref), (dbgtpu_torch.spec, g_own)):
        stats = mod.RunStats()
        aligned = mod._count_stats(stats, status)
        outs.append((mod._format_outputs(graph, parsed, status, path_off,
                                         flat, correction, aligned),
                     stats.summary(), stats.as_dict()))
    assert outs[0] == outs[1]
    assert outs[1][0] == (want[0], want[1])
    assert outs[1][0][0] and outs[1][0][1]


@pytest.mark.parametrize("mode,partial", [("greedy", False),
                                          ("anchors", False),
                                          ("exhaustive", True)])
def test_spec_pipeline_equal(tmp_path, mode, partial):
    """spec.run_pipeline is dbgtpu's run_pipeline(impl="python")."""
    rf, uf = _dataset(tmp_path, 150, 21, n_frac=0.2)
    got = dbgtpu_torch.spec.run_pipeline([rf], uf, k=21, m=2, mode=mode,
                                         partial=partial)
    want = dbgtpu.pipeline.run_pipeline([rf], uf, k=21, m=2, impl="python",
                                        mode=mode, partial=partial)
    assert got[:2] == want[:2] and got[0]
    fields = [f.name for f in dataclasses.fields(dbgtpu_torch.spec.RunStats)
              if "seconds" not in f.name]
    for f in fields:
        assert getattr(got[2], f) == getattr(want[2], f), f


@pytest.mark.parametrize("mode,partial", [("paths", False), ("paths", True),
                                          ("paths-exhaustive", False)])
def test_spec_pipeline_path_modes_equal(tmp_path, mode, partial):
    """spec.run_pipeline in the path modes is dbgtpu's run_pipeline, whose
    path modes run on the python spec under either impl; a record range
    keeps the same reads."""
    rf, uf = _dataset(tmp_path, 151, 21, n_frac=0.1)
    got = dbgtpu_torch.spec.run_pipeline([rf], uf, k=21, m=2, mode=mode,
                                         partial=partial)
    want = dbgtpu.pipeline.run_pipeline([rf], uf, k=21, m=2, impl="jax",
                                        mode=mode, partial=partial)
    assert got[:2] == want[:2] and got[0]
    got = dbgtpu_torch.spec.run_pipeline(
        [rf], uf, k=21, m=2, mode=mode, partial=partial,
        rec_range=lambda n: dbgtpu.dist.multihost.shard_ranges(n, 3)[1])
    want = dbgtpu.pipeline.run_pipeline(
        [rf], uf, k=21, m=2, impl="python", mode=mode, partial=partial,
        process_id=1, num_processes=3)
    assert got[:2] == want[:2] and got[2].read_number == want[2].read_number


@pytest.mark.parametrize("name", ["shard_files", "shard_ranges",
                                  "shard_path", "merge_shards"])
def test_multihost_helpers_equal(tmp_path, name):
    own, ref = dbgtpu_torch.dist.multihost, dbgtpu.dist.multihost
    assert inspect.getsource(getattr(own, name)) == inspect.getsource(
        getattr(ref, name))
    # the coordinated run is the port's own, on torch.distributed
    for fn in (own.init_distributed, own.global_stats_sum):
        assert "torch.distributed" in inspect.getsource(fn)
    files = [f"f{i}" for i in range(7)]
    for n in (1, 2, 3, 8):
        for total in (0, 1, 7, 100):
            assert own.shard_ranges(total, n) == ref.shard_ranges(total, n)
        for pid in range(n):
            assert own.shard_files(files, pid, n) == ref.shard_files(
                files, pid, n)
            assert own.shard_path("out", pid) == ref.shard_path("out", pid)
    for mod, base in ((own, tmp_path / "own"), (ref, tmp_path / "ref")):
        for i in range(3):
            Path(mod.shard_path(str(base), i)).write_bytes(
                bytes([65 + i]) * (1 << 20 | i))
        mod.merge_shards(str(base), 3)
        assert not Path(mod.shard_path(str(base), 0)).exists()
        with pytest.raises(FileNotFoundError):
            mod.merge_shards(str(base), 3)
    assert (tmp_path / "own").read_bytes() == (tmp_path / "ref").read_bytes()


@pytest.mark.parametrize("name", [
    "tools/convert_one_line.py", "tools/no_n.py",
    "tools/get_large_unitigs.py", "tools/dbg_construction.py",
])
def test_tool_copies_are_verbatim(name):
    root = Path(dbgtpu.__file__).resolve().parents[1]
    assert (root / "dbgtpu_torch" / name).read_bytes() == (
        root / "dbgtpu" / name).read_bytes()


@pytest.mark.parametrize("name", [
    "align_read_exhaustive_path", "align_read_greedy_path",
])
def test_paths_mode_functions_are_verbatim(name):
    """paths_mode.py differs from its original in the module docstring
    only."""
    own, ref = dbgtpu_torch.paths_mode, dbgtpu.paths_mode
    assert inspect.getsource(getattr(own, name)) == inspect.getsource(
        getattr(ref, name))
    body = [inspect.getsource(m).split('"""', 2)[2] for m in (own, ref)]
    assert body[0] == body[1]


@pytest.mark.parametrize("name", [
    "_anchor_arrays", "_load_anchors", "_load_v1", "_dict_to_arrays",
    "_arrays_to_dict", "save_graph", "load_graph",
])
def test_persist_helpers_are_verbatim(name):
    """The v1 reader and writer and the anchor helpers of index/persist.py
    are dbgtpu's, comments aside (tests/test_torch_persist.py holds
    save_index and load_index to dbgtpu's files)."""
    def code(mod):
        """The function's syntax tree without docstrings and local
        imports (the port imports at module level)."""
        tree = ast.parse(inspect.getsource(getattr(mod, name)))
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if isinstance(body, list):
                node.body = [
                    n for n in body
                    if not isinstance(n, (ast.Import, ast.ImportFrom))
                    and not (isinstance(n, ast.Expr)
                             and isinstance(n.value, ast.Constant)
                             and isinstance(n.value.value, str))]
        return ast.dump(tree)

    assert code(dbgtpu_torch.index.persist) == code(dbgtpu.index.persist)


def test_progress_printer_is_dbgtpus(capsys):
    """make_progress_printer prints dbgtpu's line for the same calls."""
    outs = []
    for mod in (dbgtpu.pipeline, dbgtpu_torch.pipeline):
        progress = mod.make_progress_printer(2)
        progress.segment()
        for done in (10, 20, 30):
            progress(done, 30, done // 2)
        progress.segment()
        progress(5, 5, 5)
        err = capsys.readouterr().err
        outs.append([ln.rsplit("|", 1)[0] for ln in err.splitlines()])
        assert mod.make_progress_printer(0) is None
    assert outs[0] == outs[1] and len(outs[1]) == 3
    assert outs[1][-1].startswith("[progress] reads 35/35 | aligned 20 ")
