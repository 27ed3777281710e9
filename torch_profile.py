#!/usr/bin/env python3
"""Where the time goes in dbgtpu_torch on one NVIDIA GPU.

    python3 torch_profile.py [--cells survey:scan,survey:mphf,...]
                             [--modes greedy,anchors,exhaustive] [--reps 3]

First it measures the card's memory rate with a plain device-to-device
copy of 1 GiB (bytes read plus bytes written over the copy's time).
Then, for each cell (a workload under one index layout), it builds the
graph, the device index and the index tensors (timed; a dog-mode graph
with its anchor table for -G) and, in each mode, maps the cell's 131,072
reads warm with `dbgtpu_torch.pipeline.run_pipeline` `--reps` times,
splitting the align phase into host pack, H2D, the mode's kernels
(synchronized), the host rebuild of the compact result and native
formatting (the H2D and kernel stages synchronize, so these runs hold
the pipelined runner to one batch on the device at a time; the rebuild
and format run on its drain thread); the payload bytes of the compact result fetch are printed
beside what padded rows would have taken.  One more warm run goes under
torch.profiler: the device busy share is the summed duration of the
device-side events (kernels, copies, memsets) over that run's host wall.
Each built index also goes through `--load-index`'s path (the
`--load-index` leg): it is saved (dbgtpu_torch.index.persist.save_index),
its file read alone, loaded to host arrays
(dbgtpu_torch.index.persist.load_index) and uploaded, timed until the
index tensors are on the card, beside the seconds the build took; the
loaded tensors must equal the built ones.
Then each kernel of the mode is timed against its plain version on the
first 32,768-read batch with its bound, alone (back-to-back launches of
its C entry point, rotating over the cell's 4 batches) and through its
wrapper, and with `--baseline-csrc
DIR` beside the kernels built from DIR, in turns (chip_smoke.compare_kernels: the
published memory rate; here also the bound at the measured rate; in an
mphf cell also K2's per-position branch on the index without its probe
table; K4 also replayed from a CUDA graph, beside the floor of that
timer, an empty kernel), K7 mphf_slots in its check mode on the cell's
junction MPHF table, by both timers and against the other launch plans
(the check of a table at upload; the warm runs reuse the uploaded
index, so they launch it no more), and the first
reads are checked byte for byte against the port's python spec in that
mode.

Workloads:
  survey   2 Mbp genome, ~30.7k unitigs of 40-150 bp, 131,072 reads of
           100 bp, k=31, m=2, e=2 (chip_smoke.survey_workload).
  scale1M  seed 404, 65 Mbp genome, ~1M unitigs of 40-150 bp, 131,072
           reads of 100 bp.  Its ~34M dog anchors take the MPHF anchor
           layout under either junction layout; building them is host
           work of minutes.
Cells are `workload:layout` with layout scan or mphf.

`--shard survey1M,scale1M [--meshes 1,2,4] [--turns N]
[--batch-sizes 32768,...] [--k3-paths plan,direct,staged]` measures
`--shard-index` instead (shard_runs): greedy / scan runs through
`cli.main` from a loaded index with `--mesh D`, replicated and sharded,
in turns (1,048,576 survey reads; scale1M's 131,072 reads at the largest
D; a D beyond the local cards is skipped), at each `--batch-size` of
`--batch-sizes`, the sharded runs once for each of `--k3-paths` (K3's
junction reads by its plan's rule, or forced direct or staged:
engine/walk.py plan_for), bytes equal across all, with align seconds,
end-to-end reads/s, the index bytes each card holds and K3's calls by
path; then K2 and K3 alone on the index replicated, cut into D ranges
on one card, and cut over D cards where there are D.

Prints one line per measurement and, last, one JSON object per cell.
Needs a CUDA device; imports neither JAX nor dbgtpu.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCRATCH = ROOT / "build" / "torch_profile"
K, M, EFFORT, BATCH = 31, 2, 2, 32768
MODES = ("greedy", "anchors", "exhaustive")
DEFAULT_CELLS = "survey:scan,survey:mphf,scale1M:scan,scale1M:mphf"


def survey():
    import chip_smoke as cs

    return cs.survey_workload()


def scale1m():
    import numpy as np

    from dbgtpu_torch.seq import encode
    from tests import synth

    rng = np.random.default_rng(404)
    genome = synth.make_genome(rng, 1_000_000 * 65)
    unitigs = synth.chop_unitigs(genome, K, rng, 40, 150)
    reads = synth.sample_reads(genome, rng, 131072, 100, err_frac=0.5)
    return unitigs, np.stack([encode(r) for r in reads])


# name: (workload, reads checked against the spec)
WORKLOADS = {"survey": (survey, 4096), "scale1M": (scale1m, 2048)}


class StageTimer:
    """Wraps module functions to sum their host wall per stage."""

    def __init__(self):
        self.t: dict[str, float] = {}

    def wrap(self, mod, attr, stage, sync=False):
        import torch

        fn = getattr(mod, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            self.t[stage] = self.t.get(stage, 0.0) + time.perf_counter() - t0
            return r

        setattr(mod, attr, timed)


def measure_copy_rate(device) -> float:
    """Bytes per second of a device-to-device copy of 1 GiB: bytes read
    plus bytes written over the median time of 10 copies."""
    import torch

    import chip_smoke as cs

    n = 1 << 30
    src = torch.zeros(n, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    ms = cs.cuda_ms(lambda: dst.copy_(src), 10)
    return 2 * n / (ms / 1e3)


def load_leg(tag, graph, layout, built_ix, device, td) -> dict:
    """The `--load-index` leg of one built index: seconds to save it, to
    read its file alone, to load it to host arrays and to upload them;
    the tensors that arrive must equal `built_ix`'s."""
    import torch

    import chip_smoke as cs
    from dbgtpu_torch.engine.index import index_tensors
    from dbgtpu_torch.engine.runner import get_device_index
    from dbgtpu_torch.index.persist import load_index, save_index

    path = td / f"index_{layout}_{int(graph.dog_mode)}.npz"
    out = {}
    t0 = time.monotonic()
    save_index(graph, str(path), layout=layout)
    out["save_s"] = time.monotonic() - t0
    out["file_bytes"] = path.stat().st_size
    t0 = time.monotonic()
    with open(path, "rb") as f:
        while f.read(1 << 24):
            pass
    out["read_s"] = time.monotonic() - t0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    g = load_index(str(path))
    out["load_s"] = time.monotonic() - t0
    ix = index_tensors(get_device_index(g, layout), device)
    torch.cuda.synchronize()
    out["ready_s"] = time.monotonic() - t0
    for a, b in zip(ix.tensors(), built_ix.tensors()):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{tag} the loaded index tensors differ "
                                 "from the built ones")
    del ix, g
    torch.cuda.empty_cache()
    path.unlink()
    cs.log(f"{tag} --load-index leg: file {out['file_bytes']} B saved in "
           f"{out['save_s']:.3f} s, read alone in {out['read_s']:.3f} s; "
           f"host load {out['load_s']:.3f} s, tensors on the card after "
           f"{out['ready_s']:.3f} s (upload "
           f"{out['ready_s'] - out['load_s']:.3f} s); loaded tensors == "
           f"built tensors")
    return out


def run_workload(name, layouts, modes, reps, device, card, copy_rate):
    """One JSON-ready dict per (workload, layout) cell; the workload and
    its graphs are made once and shared by the layouts."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from dbgtpu_torch.engine import runner
    from dbgtpu_torch.engine.index import index_tensors
    from dbgtpu_torch.index.build import build_graph
    from dbgtpu_torch.index.device import hbm_report
    from dbgtpu_torch.kernels import build

    make, n_spec = WORKLOADS[name]
    t0 = time.monotonic()
    unitigs, codes_all = make()
    workload_s = time.monotonic() - t0
    chars = np.frombuffer(b"ACGT", np.uint8)
    td = Path(tempfile.mkdtemp(dir=SCRATCH))
    uf, rf = td / "unitig.fa", td / "reads.fa"
    cs.write_fasta(uf, unitigs)
    cs.write_fasta(rf, (chars[r].tobytes() for r in codes_all))
    cs.write_fasta(td / "prefix.fa", (chars[r].tobytes()
                                      for r in codes_all[:n_spec]))
    graphs, graph_s = {}, {}
    for dog in sorted({m == "anchors" for m in modes}):
        t0 = time.monotonic()
        graphs[dog] = build_graph(str(uf), K, dog_mode=dog)
        graph_s[dog] = time.monotonic() - t0
        cs.log(f"[{name}] {len(unitigs)} unitigs{' (dog mode)' * dog}: "
               f"graph {graph_s[dog]:.3f} s"
               + (f", {len(graphs[dog].anchors)} anchors" if dog else ""))
    cells = []
    for layout in layouts:
        out = {"cell": f"{name}:{layout}", "card": card,
               "copy_bytes_per_s": copy_rate, "workload_s": workload_s,
               "unitigs": len(unitigs), "modes": {}}
        built = {}
        for dog, graph in graphs.items():
            ib = {"graph_s": graph_s[dog]}
            t0 = time.monotonic()
            di = runner.get_device_index(graph, layout)
            ib["device_index_s"] = time.monotonic() - t0
            build.reset_launches()
            t0 = time.monotonic()
            ix = index_tensors(di, device)
            torch.cuda.synchronize()
            ib["upload_s"] = time.monotonic() - t0
            # K7's launches: the check of each MPHF table at upload
            ib["upload_mphf_slots_launches"] = build.launches["mphf_slots"]
            ib["index_bytes"] = cs.nbytes(*ix.tensors())
            ib["hbm_report"] = hbm_report(di)
            built[dog] = (graph, di, ix)
            out["dog_index" if dog else "index"] = ib
            cs.log(f"[{name}:{layout}]{' (dog mode)' * dog} graph "
                   f"{ib['graph_s']:.3f} s, device index "
                   f"{ib['device_index_s']:.3f} s, upload "
                   f"{ib['upload_s']:.3f} s with "
                   f"{ib['upload_mphf_slots_launches']} mphf_slots launches "
                   f"(the table check), index tensors "
                   f"{ib['index_bytes']} B, hbm_report {ib['hbm_report']}")
            ib["load"] = load_leg(
                f"[{name}:{layout}]{' (dog mode)' * dog}", graph, layout, ix,
                device, td)
        for mode in modes:
            out["modes"][mode] = run_mode(
                f"{name}:{layout}", mode, layout, reps, device, codes_all, rf,
                uf, td, n_spec, copy_rate, *built[mode == "anchors"])
        cells.append(out)
        # the next layout's tables take this one's place on the card
        for graph, di, _ in built.values():
            di._torch_ix.clear()
        del built
        torch.cuda.empty_cache()
    return cells


def run_mode(cell, mode, layout, reps, device, codes_all, rf, uf, td, n_spec,
             copy_rate, graph, di, ix):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from dbgtpu_torch import native
    from dbgtpu_torch.engine import runner
    from dbgtpu_torch.engine.pack import out_dtype_for
    from dbgtpu_torch.kernels import build
    from dbgtpu_torch.kernels.measure import device_busy
    from dbgtpu_torch.pipeline import run_pipeline
    from dbgtpu_torch.spec import run_pipeline as spec_pipeline

    tag = f"[{cell} {mode}]"
    out = {}

    def mapped():
        return run_pipeline([str(rf)], str(uf), k=K, m=M, effort=EFFORT,
                            batch_size=BATCH, graph=graph, device=device,
                            mode=mode, index_layout=layout)

    n_reads, read_len = codes_all.shape
    B, L = min(BATCH, n_reads), runner._bucket_len(read_len, K)
    pmax = min(runner._pmax_for(di, L), runner._pmax_cap(L))
    st = StageTimer()
    saved = [(runner, "pack_records"), (runner, "upload"),
             (runner, "align_batch_packed_compact"),
             (runner, "expand_compact"), (native, "format_paths_native"),
             (native, "format_notaligned_native")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in saved]
    st.wrap(runner, "pack_records", "pack")
    st.wrap(runner, "upload", "h2d", sync=True)
    st.wrap(runner, "align_batch_packed_compact", "kernels", sync=True)
    st.wrap(runner, "expand_compact", "expand")
    st.wrap(native, "format_paths_native", "format")
    st.wrap(native, "format_notaligned_native", "format")
    out["warm"] = []
    try:
        for rep in range(reps):
            st.t.clear()
            build.reset_launches()
            t0 = time.monotonic()
            _, _, stats = mapped()
            wall = time.monotonic() - t0
            row = dict(wall_s=wall, reads_per_s=stats.read_number / wall,
                       aligned=stats.aligned, parse_s=stats.leg("parse_seconds"),
                       align_s=stats.leg("align_seconds"),
                       **{f"{k}_s": v for k, v in st.t.items()})
            out["warm"].append(row)
            cs.log(f"{tag} warm {rep}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items()))
        out["launches"] = dict(build.launches)
        item = torch.empty(0, dtype=out_dtype_for(
            ix.umeta.shape[0], L)).element_size()
        out["d2h_bytes"] = stats.payload_d2h_bytes
        out["d2h_padded_bytes"] = n_reads * (2 + pmax) * item
        out["h2d_bytes"] = stats.payload_h2d_bytes
        cs.log(f"{tag} launches {out['launches']}; payload H2D "
               f"{out['h2d_bytes']} B, D2H {out['d2h_bytes']} B compact "
               f"(padded rows of {item}-byte slots: "
               f"{out['d2h_padded_bytes']} B)")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            mapped()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    dev_ms, share, by_name = device_busy(prof, wall)
    out.update(profiled_wall_s=wall, device_ms=dev_ms, busy_share=share,
               device_ms_by_name={n[:80]: v for n, v in by_name.items()})
    cs.log(f"{tag} profiled warm run: {dev_ms:.3f} ms of device events "
           f"in {wall * 1e3:.1f} ms wall, busy share {share:.4f}")
    for n, (v, count) in list(by_name.items())[:10]:
        cs.log(f"{tag}   {v:.3f} ms in {count} events  {n[:100]}")

    batches = cs.survey_batches(codes_all, L, device)
    words, nmbits, lens = batches[0]
    perpos = (dataclasses.replace(ix, pt_rows=ix.pt_rows[:0])
              if layout == "mphf" and mode != "anchors" else None)
    res = cs.compare_kernels(ix, words, nmbits, lens, mode=mode, k=K, m=M,
                             effort=EFFORT, L=L, pmax=pmax, timed=True,
                             perpos_ix=perpos, more=batches[1:])
    if layout == "mphf" and mode == "greedy":
        # K7 on this path: the check of the junction table at upload
        res["mphf_slots"] = cs.time_mphf_check(
            f"{cell}: the junction MPHF", di.mphf_junction.mphf,
            di.mphf_junction.jrows, device)
    for r in res.values():
        r["bound_at_copy_rate_ms"] = 1e3 * max(
            r["bound_bytes"] / copy_rate, r["bound_ops"] / cs.INT_OPS_PER_S)
    out["kernels"] = res
    for n, r in res.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        base = (f", baseline alone {r['baseline_alone_ms']:.4f} ms (turns "
                + ", ".join(f"{t:.4f}" for t in r["alone_turns_ms"]) + ")"
                if "baseline_alone_ms" in r else "")
        base += cs.graph_part(r)
        cs.log(f"{tag} kernel {n}: == plain (err {r['max_abs_err']}), "
               f"alone {r['alone_ms']:.4f} ms (rotating over "
               f"{r.get('alone_batches', 1)} batches){base}, through the "
               f"wrapper "
               f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
               f"call {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
               f"{r['bound_at_copy_rate_ms']:.4f} ms at the measured copy "
               f"rate)" + (f", junction evaluations (plain version) "
                           f"{r['evaluations']}" if "evaluations" in r
                           else "") + f" per {B}-read batch")

    got = run_pipeline([str(td / "prefix.fa")], str(uf), k=K, m=M,
                       graph=graph, device=device, mode=mode,
                       index_layout=layout)
    want = spec_pipeline([str(td / "prefix.fa")], str(uf), k=K, m=M,
                         graph=graph, mode=mode)
    if got[0] != want[0] or got[1] != want[1]:
        raise AssertionError(f"{tag} output differs from the spec")
    out["spec_equal_reads"] = n_spec
    cs.log(f"{tag} first {n_spec} reads byte-identical to the spec")
    return out


SHARD_WORKLOADS = ("survey1M", "scale1M")


def shard_kernels(tag, di, batches, meshes, L, pmax, device) -> dict:
    """K2 and K3 alone on the first batch against their plain versions
    (chip_smoke.compare_kernels, greedy, timed), on the index replicated
    on `device` and, for each D in `meshes`, cut into D ranges resident
    on `device` and cut over the first D cards where there are D (remote
    share (D - 1) / D of the table rows read): (D, where) -> results of
    member and greedy_walk beside the replicated index's."""
    import torch

    import chip_smoke as cs
    from dbgtpu_torch.engine.index import index_tensors, sharded_index_tensors

    out = {}
    whole = index_tensors(di, device)
    rep = cs.compare_kernels(whole, *batches[0], mode="greedy", k=K, m=M,
                             effort=EFFORT, L=L, pmax=pmax, timed=True,
                             more=batches[1:])
    layouts = [(D, "one card", [device] * D, 0.0) for D in meshes if D > 1]
    layouts += [(D, f"{D} cards",
                 [torch.device("cuda", i) for i in range(D)], (D - 1) / D)
                for D in meshes if D <= torch.cuda.device_count()]
    for D, where, devices, share in layouts:
        sx = sharded_index_tensors(di, devices)[0]
        res = cs.compare_kernels(sx, *batches[0], mode="greedy", k=K, m=M,
                                 effort=EFFORT, L=L, pmax=pmax, timed=True,
                                 more=batches[1:], remote_share=share)
        out[f"{D} on {where}"] = {}
        for name in ("member", "greedy_walk"):
            r, w = res[name], rep[name]
            out[f"{D} on {where}"][name] = dict(
                sharded_alone_ms=r["alone_ms"], replicated_alone_ms=w[
                    "alone_ms"], sharded_bound_ms=r["bound_ms"],
                replicated_bound_ms=w["bound_ms"], plain_ms=r["plain_ms"])
            cs.log(f"{tag} {name} alone on the index cut into {D} ranges "
                   f"on {where}: {r['alone_ms']:.4f} ms (== plain version, "
                   f"err {r['max_abs_err']}; bound {r['bound_ms']:.4f} ms "
                   f"with {r['bound_remote_bytes']:.0f} B over NVLink: "
                   f"{share:.3f} of the cut tables' rows read in place), "
                   f"replicated "
                   f"{w['alone_ms']:.4f} ms (bound {w['bound_ms']:.4f} ms), "
                   f"plain {r['plain_ms']:.4f} ms")
    return out


@contextlib.contextmanager
def k3_path(path: str):
    """K3's plan forced to `path` ("direct" or "staged"; "plan": its
    rule) in the runs inside: engine/walk.py plan_for, which walk_stage
    reads as each batch starts."""
    from dbgtpu_torch.engine import walk

    rule = walk.plan_for
    if path != "plan":
        walk.plan_for = functools.partial(rule, staged=path == "staged")
    try:
        yield
    finally:
        walk.plan_for = rule


def shard_runs(name, meshes, turns, device, card, batch_sizes=(BATCH,),
               k3_paths=("plan",)) -> dict:
    """`--shard-index` against the replicated mesh, greedy / scan, warm
    through `cli.main` from a loaded index: survey1M maps 1,048,576
    survey reads (chip_smoke's [runner] reads) with `--mesh D` and
    `--mesh D --shard-index` for each D in `meshes`, in turns (the order,
    then reversed, `turns` times); scale1M its 131,072 reads with
    `--mesh D` and `--mesh D --shard-index` for the largest D.  Each at
    every `--batch-size` of `batch_sizes`, the sharded runs once for each
    of `k3_paths` (`k3_path`).  Bytes must be equal across every run; each
    run's align seconds, end-to-end reads/s, the index bytes each card
    holds and K3's calls by path (each as its plan, or the forced path,
    says) are logged.  Then K2 and K3 alone on the index replicated and
    cut into D ranges (shard_kernels).  Mesh sizes beyond the local cards
    run no CLI."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from dbgtpu_torch.engine import runner, walk
    from dbgtpu_torch.engine.index import index_tensors
    from dbgtpu_torch.index.build import build_graph
    from dbgtpu_torch.index.persist import load_index, save_index

    td = Path(tempfile.mkdtemp(dir=SCRATCH))
    uf = td / "unitig.fa"
    chars = np.frombuffer(b"ACGT", np.uint8)
    t0 = time.monotonic()
    if name == "survey1M":
        unitigs, codes_all = survey()
        rf = td / "r1m.fa"
        cs.write_fasta(uf, unitigs)
        cs.runner_reads(rf)
        n_reads = cs.RUNNER_READS
    else:
        unitigs, codes_all = scale1m()
        rf = td / "reads.fa"
        cs.write_fasta(uf, unitigs)
        cs.write_fasta(rf, (chars[r].tobytes() for r in codes_all))
        n_reads = codes_all.shape[0]
        meshes = meshes[-1:]
    graph = build_graph(str(uf), K)
    npz = td / "index.npz"
    save_index(graph, str(npz), layout="scan")
    tag = f"[shard {name}]"
    cs.log(f"{tag} {len(unitigs)} unitigs, {n_reads} reads: workload, "
           f"graph, device index and --save-index "
           f"{time.monotonic() - t0:.1f} s; index file "
           f"{npz.stat().st_size} B")
    argv = ["-r", str(rf), "--load-index", str(npz), "-m", str(M), "-e",
            str(EFFORT), "-f", str(td / "paths"),
            "-a", str(td / "notAligned.fa"), "--json-summary",
            str(td / "summary.json")]
    g = load_index(str(npz))
    di = runner.get_device_index(g, "scan")
    nb, cols = index_tensors(di, device).st_fused.shape
    cards = torch.cuda.device_count()
    if max(meshes) > cards:
        cs.log(f"{tag} {cards} cards: runs with --mesh "
               f"{[D for D in meshes if D > cards]} not taken")
    configs = [(D, bs, path) for D in meshes if D <= cards
               for bs in batch_sizes for path in (None,) + tuple(k3_paths)]
    order = (configs + configs[::-1]) * turns
    runs, first = {}, None
    for D, bs, path in order:
        sharded = path is not None
        flags = (["--mesh", str(D), "--batch-size", str(bs)]
                 + ["--shard-index"] * sharded)
        # K3's path on each card's share of a batch
        staged = sharded and D > 1 and walk.walk_plan(
            bs // D, nb // D, cols, [i == 0 for i in range(D)],
            None if path == "plan" else path == "staged").staged
        want = (cs.PATH_KERNELS["greedy"] + ("sharded_rows",) * sharded
                + ("walk_stage",) * staged)
        walk.calls.update(direct=0, staged=0)
        with k3_path(path or "plan"):
            r = cs.cli_timed(argv + flags, want)
        k3 = dict(walk.calls)
        if sharded and k3["direct" if staged else "staged"]:
            raise AssertionError(f"{tag} {' '.join(flags)} (K3 {path}): "
                                 f"K3's calls by path {k3}")
        got = ((td / "paths").read_bytes(),
               (td / "notAligned.fa").read_bytes())
        first = first or got
        if got != first:
            raise AssertionError(f"{tag} {' '.join(flags)}: bytes differ")
        summ = r["summ"]
        row = dict(align_s=summ["align_seconds"], wall_s=r["wall"],
                   e2e_rps=n_reads / r["wall"],
                   map_rps=n_reads / summ["align_seconds"],
                   upload_s=summ["upload_seconds"],
                   card_bytes=summ["index_card_bytes"],
                   sharded_rows=r["launches"]["sharded_rows"],
                   walk_stage=r["launches"]["walk_stage"], k3_calls=k3)
        key = " ".join(flags) + (f" (K3 {path})" if sharded else "")
        runs.setdefault(key, []).append(row)
        cs.log(f"{tag} {key}: align_seconds {row['align_s']}, "
               f"wall {row['wall_s']:.3f} s (end-to-end {row['e2e_rps']:.1f}"
               f" reads/s, mapping {row['map_rps']:.1f} reads/s), upload "
               f"{row['upload_s']} s; index bytes each card holds "
               f"{row['card_bytes']}; sharded_rows launches "
               f"{row['sharded_rows']}, walk_stage {row['walk_stage']}; "
               f"K3's calls by path {k3}; bytes == the first run's")
    for flags, rows in runs.items():
        cs.log(f"{tag} {flags}: median of {len(rows)}: align_seconds "
               f"{statistics.median(x['align_s'] for x in rows):.4f} "
               f"(runs {[x['align_s'] for x in rows]}), end-to-end "
               f"{statistics.median(x['e2e_rps'] for x in rows):.1f} reads/s")
    L = runner._bucket_len(codes_all.shape[1], K)
    pmax = min(runner._pmax_for(di, L), runner._pmax_cap(L))
    kern = shard_kernels(tag, di, cs.survey_batches(codes_all, L, device),
                         meshes, L, pmax, device)
    npz.unlink()
    return {"shard": name, "card": card, "runs": runs, "kernels": kern}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=DEFAULT_CELLS)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shard", metavar="WORKLOADS",
                    help="instead of the cells: --shard-index against the "
                         "replicated mesh on WORKLOADS (comma separated: "
                         "survey1M, scale1M; shard_runs)")
    ap.add_argument("--meshes", default="1,2,4",
                    help="with --shard: the mesh sizes (scale1M takes the "
                         "largest)")
    ap.add_argument("--turns", type=int, default=1,
                    help="with --shard: passes of the runs in turns")
    ap.add_argument("--batch-sizes", default=str(BATCH),
                    help="with --shard: the runs' --batch-size values")
    ap.add_argument("--k3-paths", default="plan",
                    help="with --shard: K3's path in the sharded runs, "
                         "each of plan, direct, staged (k3_path)")
    ap.add_argument("--baseline-csrc", metavar="DIR",
                    help="also build the kernels of DIR (another tree's "
                         "dbgtpu_torch/csrc) and time each kernel alone "
                         "beside this tree's, in turns")
    args = ap.parse_args(argv)
    modes = tuple(args.modes.split(","))
    cells: dict[str, list[str]] = {}
    for c in args.cells.split(","):
        name, _, layout = c.partition(":")
        if (name not in WORKLOADS or layout not in ("scan", "mphf")
                or not set(modes) <= set(MODES)):
            ap.error(f"unknown cell {c!r} or mode in {args.modes!r}")
        cells.setdefault(name, []).append(layout)
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    SCRATCH.mkdir(parents=True, exist_ok=True)
    cs.SCRATCH.mkdir(parents=True, exist_ok=True)   # the survey's cache
    os.environ["DBGTPU_NATIVE_CACHE"] = str(SCRATCH / "native")
    cs.block_reference_packages()
    from dbgtpu_torch import native
    from dbgtpu_torch.kernels import build

    device = torch.device("cuda", 0)
    card = cs.card_line()
    cs.log(f"[card] {card}")
    build.load()
    if args.baseline_csrc:
        cs.BASELINE["lib"] = build.load_from(Path(args.baseline_csrc))
    if not native.available():
        raise AssertionError("the native parser / formatter did not build")
    copy_rate = measure_copy_rate(device)
    cs.log(f"[card] device-to-device copy of 1 GiB: {copy_rate / 1e12:.4f} "
           f"TB/s read + written (published memory rate "
           f"{cs.HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    floor = cs.launch_floor_ms()
    cs.log(f"[floor] a kernel that does nothing, 200 launches a run: "
           f"{floor[0]:.4f} ms a launch back to back from Python, "
           f"{floor[1]:.4f} ms replayed from a CUDA graph")
    results = []
    if args.shard:
        meshes = [int(x) for x in args.meshes.split(",")]
        for name in args.shard.split(","):
            if name not in SHARD_WORKLOADS:
                ap.error(f"unknown --shard workload {name!r}")
            paths = tuple(args.k3_paths.split(","))
            if not set(paths) <= {"plan", "direct", "staged"}:
                ap.error(f"unknown --k3-paths {args.k3_paths!r}")
            results.append(shard_runs(
                name, meshes, args.turns, device, card,
                tuple(int(x) for x in args.batch_sizes.split(",")), paths))
        cells = {}
    for name, layouts in cells.items():
        results += run_workload(name, layouts, modes, args.reps, device, card,
                                copy_rate)
    cs.assert_reference_packages_unused()
    cs.log(f"[card] {cs.card_line()}")
    for r in results:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
