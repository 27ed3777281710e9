"""Index persistence of the port (dbgtpu_torch/index/persist.py,
`--save-index` / `--load-index`):
index files interchange with dbgtpu's in both directions member by
member, loaded tensors equal built ones, and a run from a loaded index
writes the bytes of a fresh run.  Everything on the CPU; tolerance 0."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import dbgtpu.index.build
import dbgtpu.index.device
import dbgtpu.index.persist
import dbgtpu_torch.index.build
import dbgtpu_torch.index.device
import dbgtpu_torch.index.persist
from dbgtpu.pipeline import run_pipeline as dbgtpu_pipeline
from dbgtpu_torch import cli
from dbgtpu_torch.engine import index as engine_index
from dbgtpu_torch.engine.runner import get_device_index
from dbgtpu_torch.kernels import build as kernel_build

from . import synth
from .test_torch_host import assert_same

REF, OWN = dbgtpu.index.persist, dbgtpu_torch.index.persist
REF_BUILD, OWN_BUILD = dbgtpu.index.build, dbgtpu_torch.index.build
REF_DEV, OWN_DEV = dbgtpu.index.device, dbgtpu_torch.index.device


def _files(tmp_path, seed=301, k=21, n_reads=96, **kw):
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=seed, genome_len=kw.pop("genome_len", 10000), k=k,
        n_reads=n_reads, n_frac=0.1, **kw)
    rf, uf = tmp_path / "reads.fa", tmp_path / "unitigs.fa"
    rf.write_bytes(reads_fa)
    uf.write_bytes(unitigs_fa)
    return str(rf), str(uf)


def _members(path):
    with np.load(path, allow_pickle=False) as z:
        return {name: z[name] for name in z.files}


def _ref_views(g):
    """dbgtpu's loaded graph -> {layout: DeviceIndex}."""
    views = {"scan": getattr(g, "_device_index", None),
             "mphf": getattr(g, "_device_index_mphf", None)}
    return {name: di for name, di in views.items() if di is not None}


def _tensors_equal(a, b):
    fields = [f.name for f in dataclasses.fields(a) if f.name != "c_index"]
    assert len(fields) > 15
    for name in fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


@pytest.mark.parametrize("layout,dog", [("scan", False), ("scan", True),
                                        ("mphf", False), ("mphf", True)])
def test_index_files_interchange_with_dbgtpu(tmp_path, layout, dog):
    """The same graph saved by both packages: equal members (the zip's
    time stamps differ, so no byte compare of the npz); each package
    loads the other's file into the objects it loads from its own."""
    _, uf = _files(tmp_path)
    ref_path, own_path = str(tmp_path / "ref.npz"), str(tmp_path / "own.npz")
    REF.save_index(REF_BUILD.build_graph(uf, 21, dog_mode=dog), ref_path,
                   layout=layout)
    g_own = OWN_BUILD.build_graph(uf, 21, dog_mode=dog)
    OWN.save_index(g_own, own_path, layout=layout)
    ref_m, own_m = _members(ref_path), _members(own_path)
    assert str(own_m["magic"]) == "dbgtpu-index-v2"
    assert_same(own_m, ref_m, "npz members")
    assert ("mph_jrows" in own_m) == (layout == "mphf")
    assert ("st_keys" in own_m) == (layout == "scan")
    assert ("anchor_keys" in own_m) == dog

    built = get_device_index(g_own, layout)
    for path in (ref_path, own_path):
        got = OWN.load_index(path)
        assert_same(got, g_own, "graph")
        assert set(OWN.device_index_memo(got)) == {layout}
        assert_same(OWN.device_index_memo(got)[layout], built, "device index")
        want = REF.load_index(path, stream_device=False)
        assert set(_ref_views(want)) == {layout}
        assert_same(OWN.device_index_memo(got)[layout],
                    _ref_views(want)[layout], "device index vs dbgtpu's")
        assert_same(got, want, "graph vs dbgtpu's")


def test_v1_round_trip_both_ways(tmp_path):
    _, uf = _files(tmp_path)
    g = OWN_BUILD.build_graph(uf, 21, dog_mode=True)
    own_path, ref_path = str(tmp_path / "o.npz"), str(tmp_path / "r.npz")
    OWN.save_graph(g, own_path)
    REF.save_graph(REF_BUILD.build_graph(uf, 21, dog_mode=True), ref_path)
    assert str(_members(own_path)["magic"]) == "dbgtpu-index-v1"
    assert_same(_members(own_path), _members(ref_path), "v1 members")
    for path in (own_path, ref_path):
        got = OWN.load_graph(path)
        assert not OWN.device_index_memo(got)
        assert got.left == g.left and got.right == g.right
        assert_same(got, REF.load_graph(path), "v1 graph")
        # the rebuilt slot table gives the device index of the built graph
        assert_same(get_device_index(got), get_device_index(g), "rebuilt")
    keys, flat, off = OWN._dict_to_arrays(g.left)
    assert_same((keys, flat, off), REF._dict_to_arrays(g.left))
    assert OWN._arrays_to_dict(keys, flat, off) == g.left


def test_renumbered_index_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("DBGTPU_RENUMBER", "1")
    _, uf = _files(tmp_path)
    g = OWN_BUILD.build_graph(uf, 21)
    path = str(tmp_path / "renum.npz")
    OWN.save_index(g, path)
    built = get_device_index(g)
    assert built.id_inv is not None
    monkeypatch.delenv("DBGTPU_RENUMBER")
    got = OWN.device_index_memo(OWN.load_index(path))["scan"]
    assert_same(got, built, "device index")
    assert_same(_ref_views(REF.load_index(path, stream_device=False))["scan"],
                built, "dbgtpu's load")


def test_stale_probe_geometry_rebuilds(tmp_path):
    """A file whose probe rows have another bucket geometry: the device
    tables are dropped, the first use rebuilds them from the slot table,
    in both packages."""
    _, uf = _files(tmp_path)
    g = OWN_BUILD.build_graph(uf, 21)
    di = get_device_index(g)
    stale = dataclasses.replace(di, probe_tbl=dataclasses.replace(
        di.probe_tbl, rows=di.probe_tbl.rows[:, :-8].copy()))
    path = str(tmp_path / "stale.npz")
    OWN.save_index(g, path, di=stale)
    got = OWN.load_index(path)
    assert not OWN.device_index_memo(got)
    assert not _ref_views(REF.load_index(path, stream_device=False))
    assert_same(got, g, "graph")
    assert_same(get_device_index(got), di, "rebuilt device index")


def test_file_with_both_junction_layouts_splits_into_views(tmp_path):
    _, uf = _files(tmp_path)
    g = OWN_BUILD.build_graph(uf, 21)
    scan, mphf = get_device_index(g, "scan"), get_device_index(g, "mphf")
    both = dataclasses.replace(scan, mphf_junction=mphf.mphf_junction)
    path = str(tmp_path / "both.npz")
    OWN.save_index(g, path, di=both)
    memo = OWN.device_index_memo(OWN.load_index(path))
    assert_same(memo["scan"], scan, "scan view")
    assert_same(memo["mphf"], mphf, "mphf view")
    assert_same(_ref_views(REF.load_index(path, stream_device=False)),
                dict(memo), "dbgtpu's views")


def test_old_anchor_columns_load(tmp_path):
    """Older files carry int64 anchor_vals and no anchor_ucanon: the
    device build recomputes the column."""
    _, uf = _files(tmp_path)
    g = OWN_BUILD.build_graph(uf, 21, dog_mode=True)
    path = str(tmp_path / "g.npz")
    OWN.save_graph(g, path)
    m = _members(path)
    m["anchor_vals"] = m["anchor_vals"].astype(np.int64)
    del m["anchor_ucanon"]
    np.savez(path, **m)
    got = OWN.load_graph(path)
    assert got.anchors.vals.dtype == np.int32 and got.anchors.ucanon is None
    assert_same(get_device_index(got), get_device_index(g), "device index")


@pytest.mark.parametrize("layout,dog", [("scan", True), ("mphf", True),
                                        ("scan", False)])
def test_loaded_index_tensors_equal_built(tmp_path, monkeypatch, layout, dog):
    """A load gives host arrays only; their upload at first use gives the
    tensors a plain build gives, and an MPHF table from a file still gets
    its K7 check."""
    _, uf = _files(tmp_path)
    g = OWN_BUILD.build_graph(uf, 21, dog_mode=dog)
    path = str(tmp_path / "ix.npz")
    OWN.save_index(g, path, layout=layout)
    built = engine_index.index_tensors(get_device_index(g, layout), "cpu")

    loaded = OWN.load_index(path)
    di = get_device_index(loaded, layout)
    assert getattr(di, "_torch_ix", None) is None      # nothing uploaded
    checks = []
    monkeypatch.setattr(engine_index, "check_mphf_table",
                        lambda *a: checks.append(a[-1]))
    ix = engine_index.index_tensors(di, "cpu")
    _tensors_equal(ix, built)
    assert checks == (["junction", "anchor"] if layout == "mphf" else [])
    assert engine_index.index_tensors(di, "cpu") is ix      # memoized


_MODES = {"greedy": ([], "greedy"), "-G": (["-G"], "anchors"),
          "-b": (["-b"], "exhaustive")}


@pytest.mark.parametrize("layout", ["scan", "mphf"])
@pytest.mark.parametrize("mode_name", list(_MODES))
def test_cli_save_then_load_writes_the_bytes_of_a_fresh_run(
        tmp_path, monkeypatch, mode_name, layout):
    flags, mode = _MODES[mode_name]
    rf, uf = _files(tmp_path)
    monkeypatch.chdir(tmp_path)
    want = dbgtpu_pipeline([rf], uf, k=21, m=2, impl="python", mode=mode)
    common = ["-r", rf, "-m", "2", "--device", "cpu", "--index-layout",
              layout] + flags
    assert cli.main(common + ["-k", "21", "-g", uf, "--save-index", "ix.npz",
                              "-f", "p_save", "-a", "n_save"]) == 0
    kernel_build.reset_launches()
    # -k and -g of a --load-index run are ignored (a k out of range too)
    assert cli.main(common + ["-k", "99", "-g", "absent.fa", "--load-index",
                              "ix.npz", "-f", "p_load", "-a", "n_load",
                              "--json-summary", "s.json"]) == 0
    for tag in ("save", "load"):
        assert (tmp_path / f"p_{tag}").read_bytes() == want[0], tag
        assert (tmp_path / f"n_{tag}").read_bytes() == want[1], tag
    summ = json.loads((tmp_path / "s.json").read_text())
    assert summ["aligned"] == want[2].aligned > 0
    assert summ["reads"] == want[2].read_number
    assert not any(kernel_build.launches.values())     # CPU: plain versions


def test_cli_load_under_the_other_layout_rebuilds_it(tmp_path, monkeypatch):
    rf, uf = _files(tmp_path)
    monkeypatch.chdir(tmp_path)
    want = dbgtpu_pipeline([rf], uf, k=21, m=2, impl="python")
    assert cli.main(["-r", rf, "-k", "21", "-g", uf, "--device", "cpu",
                     "--save-index", "scan.npz"]) == 0
    assert cli.main(["-r", rf, "--device", "cpu", "--load-index", "scan.npz",
                     "--index-layout", "mphf", "-f", "p", "-a", "n"]) == 0
    assert (tmp_path / "p").read_bytes() == want[0]
    assert (tmp_path / "n").read_bytes() == want[1]
    g = OWN.load_index(str(tmp_path / "scan.npz"))
    assert set(OWN.device_index_memo(g)) == {"scan"}
    assert get_device_index(g, "mphf").mphf_junction is not None


def test_cli_persists_mphf_anchors_beside_a_scan_table(tmp_path, monkeypatch):
    """DBGTPU_ANCHOR_MPHF_MIN=1: the -G index holds MPHF anchors under the
    scan layout, and so does its file, which dbgtpu loads too."""
    monkeypatch.setattr(OWN_DEV, "ANCHOR_MPHF_MIN", 1)
    rf, uf = _files(tmp_path)
    monkeypatch.chdir(tmp_path)
    want = dbgtpu_pipeline([rf], uf, k=21, m=2, impl="python", mode="anchors")
    assert cli.main(["-r", rf, "-k", "21", "-g", uf, "-G", "--device", "cpu",
                     "--save-index", "ix.npz"]) == 0
    m = _members(str(tmp_path / "ix.npz"))
    assert "amph_arows" in m and "st_keys" in m and "at_keys" not in m
    assert cli.main(["-r", rf, "-G", "--device", "cpu", "--load-index",
                     "ix.npz", "-f", "p", "-a", "n"]) == 0
    assert (tmp_path / "p").read_bytes() == want[0]
    assert (tmp_path / "n").read_bytes() == want[1]
    ref = _ref_views(REF.load_index(str(tmp_path / "ix.npz"),
                                    stream_device=False))["scan"]
    own = OWN.device_index_memo(OWN.load_index(str(tmp_path / "ix.npz")))
    assert_same(own["scan"], ref, "device index")
    assert own["scan"].anchor_mphf is not None


def test_dbgtpu_runs_from_a_file_the_port_saved(tmp_path, monkeypatch):
    """`python -m dbgtpu --load-index` on the port's file (python spec),
    and the port on dbgtpu's file."""
    from dbgtpu import cli as dbgtpu_cli

    rf, uf = _files(tmp_path)
    monkeypatch.chdir(tmp_path)
    want = dbgtpu_pipeline([rf], uf, k=21, m=2, impl="python")
    assert cli.main(["-r", rf, "-k", "21", "-g", uf, "--device", "cpu",
                     "--save-index", "own.npz"]) == 0
    assert dbgtpu_cli.main(["-r", rf, "--load-index", "own.npz", "--impl",
                            "python", "-f", "p_ref", "-a", "n_ref"]) == 0
    assert dbgtpu_cli.main(["-r", rf, "-k", "21", "-g", uf, "--impl",
                            "python", "--save-index", "ref.npz"]) == 0
    assert cli.main(["-r", rf, "--load-index", "ref.npz", "--device", "cpu",
                     "-f", "p_own", "-a", "n_own"]) == 0
    for tag in ("ref", "own"):
        assert (tmp_path / f"p_{tag}").read_bytes() == want[0], tag
        assert (tmp_path / f"n_{tag}").read_bytes() == want[1], tag
