"""dbgtpu_torch's sharded index (`--shard-index` over a mesh, B15) on the
CPU: K13's plain version `sharded_rows_ref` against dbgtpu's
core._sharded_rows under jax.shard_map on 2, 4 and 8 of conftest's
virtual CPU devices; the plain K2 and K3 on an index cut into 2, 4 and 8
row ranges against the whole index's and against dbgtpu's
sharded_packed_fn(..., shard_index=True); the upload's table check; and
the CLI with `--device cpu --shard-index --mesh 2/4/8` (and a journaled
run) against dbgtpu's `--mesh 8 --shard-index` and the python spec.
Inputs come from numpy seeds; every comparison is exact (tolerance 0:
the outputs are integers).  One shard_map per device count and test
keeps the JAX compiles of the module few (tests/conftest.py)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from dbgtpu.dist.mesh import make_mesh as jax_mesh, sharded_packed_fn
from dbgtpu.engine import core
from dbgtpu.pipeline import run_pipeline as dbgtpu_pipeline
from dbgtpu_torch import cli
from dbgtpu_torch.engine import core as tcore
from dbgtpu_torch.engine.index import index_tensors, sharded_index_tensors
from dbgtpu_torch.engine.member import member_ref
from dbgtpu_torch.engine.read_scan import read_scan_ref
from dbgtpu_torch.engine.shard import (
    check_sharded_table, scan_rows_ref, sharded_rows, sharded_rows_ref,
)
from dbgtpu_torch.engine.walk import walk_ref

from . import synth
from .torch_parity import assert_walks_equal, batch, dataset, device_index, t32

ROOT = Path(__file__).resolve().parents[1]
K, M, E, L = 21, 2, 2, 112
MESHES = [2, 4, 8]


def _ids(rng, nb: int, D: int, Q: int) -> np.ndarray:
    """Q global bucket ids (Q a multiple of D): every shard's first and
    last row, one id on each side of the table, the rest at random."""
    nbl = nb // D
    edges = np.concatenate([np.arange(D) * nbl, np.arange(1, D + 1) * nbl - 1,
                            [-1, nb]])
    ids = rng.integers(0, nb, size=Q, dtype=np.int64)
    ids[: len(edges)] = edges
    return rng.permutation(ids).astype(np.int32)


@pytest.mark.parametrize("D", MESHES)
def test_sharded_rows_ref_matches_jax_sharded_rows(D):
    """dbgtpu's _sharded_rows (all_gather, the residents answered, zeros
    elsewhere, psum_scatter) on D virtual devices, for a junction-width
    (W 320) and a probe-width (W 128) table, against the plain K13 and
    the wrapper on CPU tensors, exact."""
    rng = np.random.default_rng(700 + D)
    st = rng.integers(0, 1 << 32, size=(64, 320), dtype=np.uint64).astype(
        np.uint32)
    pt = rng.integers(0, 1 << 32, size=(32, 128), dtype=np.uint64).astype(
        np.uint32)
    b_st, b_pt = _ids(rng, 64, D, 96), _ids(rng, 32, D, 48)
    mesh = Mesh(np.array(jax.devices()[:D]), ("x",))
    fn = jax.shard_map(
        lambda s, p, bs, bp: (core._sharded_rows(s, bs, "x"),
                              core._sharded_rows(p, bp, "x")),
        mesh=mesh, in_specs=(P("x"),) * 4, out_specs=(P("x"), P("x")),
        check_vma=False)
    want = fn(jnp.asarray(st), jnp.asarray(pt), jnp.asarray(b_st),
              jnp.asarray(b_pt))
    for table, b, w in ((st, b_st, want[0]), (pt, b_pt, want[1])):
        shards = list(torch.from_numpy(table.view(np.int32)).chunk(D))
        got = sharded_rows_ref(shards, torch.from_numpy(b))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(w))
        assert torch.equal(sharded_rows(shards, torch.from_numpy(b)), got)
        inside = (b >= 0) & (b < table.shape[0])
        np.testing.assert_array_equal(got.numpy()[inside],
                                      table.view(np.int32)[b[inside]])
        assert not got.numpy()[~inside].any()


@pytest.fixture(scope="module")
def case():
    """A greedy dataset with N (batch `with_n`) and the same reads
    without N, packed with an all-zero N plane of the same shape (batch
    `no_n`), so both K2 branches run under one compiled shape."""
    graph, reads = dataset(seed=83, k=K, n_reads=64, n_frac=0.15)
    di = device_index(graph)
    assert di.scan_tbl.keys.shape[0] >= 8 and di.probe_tbl is not None
    with_n = batch(reads, L, keep_empty_nmbits=True)
    clean = [r.replace(b"N", b"A").replace(b"n", b"a") for r in reads]
    no_n = batch(clean, L, keep_empty_nmbits=True)
    assert with_n[4].any() and not no_n[4].any()
    return di, {"with_n": with_n, "no_n": no_n}


@pytest.mark.parametrize("D", MESHES)
def test_plain_member_and_walk_on_a_sharded_index(case, D):
    """The plain K2 (closure probes on the N-free batch, per-position
    lookups on the batch with N) and K3 on the index cut into D row
    ranges equal the whole index's; the fused rows equal dbgtpu's
    sharded_packed_fn with shard_index=True on D virtual devices."""
    di, batches = case
    whole = index_tensors(di, "cpu")
    ixs = sharded_index_tensors(di, ["cpu"] * D)
    assert len(ixs) == D and len(ixs[0].st_shards) == D
    assert ixs[0].st_fused.shape[0] * D == whole.st_fused.shape[0]
    assert ixs[0].pt_rows.shape[0] * D == whole.pt_rows.shape[0]
    assert ixs[0].held_bytes() < whole.held_bytes()
    pmax = 6
    fn = sharded_packed_fn(jax_mesh(D), mode="greedy", k=K, m=M, effort=E,
                           L=L, pmax=pmax, shard_index=True)
    jix = core.index_to_device(di)
    for name, (_, _, lens, words, nmbits) in batches.items():
        tl = t32(lens)
        scan = read_scan_ref(t32(words), t32(nmbits), tl, L=L, k1=K - 1)
        assert bool(scan.has_n.item()) == (name == "with_n")
        for ix in ixs:
            got_m = member_ref(ix, scan, tl, L=L, k1=K - 1)
            want_m = member_ref(whole, scan, tl, L=L, k1=K - 1)
            for g, w in zip(got_m, want_m):
                assert torch.equal(g, w), name
        got_w = walk_ref(ixs[D - 1], scan, *got_m, tl, k=K, m=M, effort=E,
                         L=L)
        want_w = walk_ref(whole, scan, *want_m, tl, k=K, m=M, effort=E, L=L)
        assert_walks_equal(got_w, {f: getattr(want_w, f).numpy() for f in (
            "status", "orient", "offset", "llen", "rlen", "lbuf", "rbuf")})
        fused, _ = fn(jix, jnp.asarray(words), jnp.asarray(nmbits),
                      jnp.asarray(lens))
        got = tcore.align_batch_packed(ixs[0], t32(words), t32(nmbits), tl,
                                       k=K, m=M, effort=E, L=L, pmax=pmax)
        np.testing.assert_array_equal(got.numpy(), np.asarray(fused),
                                      err_msg=name)


def test_upload_checks_every_shard(case):
    """The upload's check reads each shard's first and last row through
    the sharded_rows path; a shard that differs from the host table is
    named."""
    di, _ = case
    ixs = sharded_index_tensors(di, ["cpu"] * 4)
    host = np.concatenate([t.numpy() for t in ixs[0].st_shards]).view(
        np.uint32)
    check_sharded_table(ixs[0].st_shards, host, torch.device("cpu"),
                        "junction")
    bad = host.copy()
    bad[3 * host.shape[0] // 4] ^= 1
    with pytest.raises(ValueError, match="shard on cpu"):
        check_sharded_table(ixs[0].st_shards, bad, torch.device("cpu"),
                            "junction")
    # the global bucket mask: nb_local * D - 1
    hi = torch.tensor([5, 6, 7], dtype=torch.int64)
    lo = torch.tensor([1, 2, 3], dtype=torch.int64)
    whole = index_tensors(di, "cpu")
    assert torch.equal(scan_rows_ref(ixs[0].st_fused, ixs[0].st_shards,
                                     whole.st_seed, hi, lo),
                       scan_rows_ref(whole.st_fused, (), whole.st_seed, hi,
                                     lo))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_cli")
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=411, genome_len=20000, k=21, n_reads=603, err_frac=0.5,
        n_frac=0.02)
    (tmp / "reads.fa").write_bytes(reads_fa)
    (tmp / "unitig.fa").write_bytes(unitigs_fa)
    rf, uf = str(tmp / "reads.fa"), str(tmp / "unitig.fa")
    want = dbgtpu_pipeline([rf], uf, k=21, impl="python")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_force_"
                          "host_platform_device_count=8").strip())
    # dbgtpu's sharded run, as tests/test_dist_e2e.py runs it
    subprocess.run(
        [sys.executable, "-m", "dbgtpu", "-r", rf, "-k", "21", "-g", uf,
         "-m", "2", "-f", str(tmp / "p_jax"), "-a", str(tmp / "n_jax"),
         "--impl", "jax", "--batch-size", "256", "--mesh", "8",
         "--shard-index"], check=True, env=env, cwd=ROOT,
        capture_output=True, timeout=900)
    jax_out = ((tmp / "p_jax").read_bytes(), (tmp / "n_jax").read_bytes())
    assert jax_out == want[:2]
    return tmp, rf, uf, want


@pytest.mark.parametrize("flags", [["--mesh", "1"], ["--mesh", "2"],
                                   ["--mesh", "4"],
                                   ["--mesh", "8"],
                                   ["--mesh", "2", "--resume"]])
def test_cli_shard_index_bytes(files, flags, monkeypatch):
    """`--device cpu --shard-index` over 1, 2, 4 and 8 row ranges, and a
    journaled run over 2, write dbgtpu's `--mesh 8 --shard-index` bytes
    (equal to the python spec's) and its stats block; each range holds
    its share of the two large tables."""
    tmp, rf, uf, want = files
    monkeypatch.chdir(tmp)
    out = tmp / "_".join(f.strip("-") for f in flags)
    assert cli.main(["-r", rf, "-k", "21", "-g", uf, "-m", "2", "--device",
                     "cpu", "--batch-size", "256", "--shard-index", "-f",
                     f"{out}.p", "-a", f"{out}.n", "--json-summary",
                     f"{out}.json"] + flags) == 0
    assert Path(f"{out}.p").read_bytes() == want[0]
    assert Path(f"{out}.n").read_bytes() == want[1]
    summ = json.loads(Path(f"{out}.json").read_text())
    assert [summ[f] for f in ("reads", "aligned", "not_aligned",
                              "no_overlap")] == [
        want[2].read_number, want[2].aligned, want[2].not_aligned,
        want[2].no_overlap]
    held = summ["index_card_bytes"]
    D = int(flags[1])
    hbm = summ["index_hbm_bytes"]
    assert len(held) == D and len(set(held)) == 1
    shared = hbm["junction_table"] + hbm["probe_table"]
    assert held[0] < hbm["total"] - shared + shared // D + 4096
    assert not Path(f"{out}.p.resume.json").exists()
