#!/usr/bin/env python3
"""Where the time goes in dbgtpu_torch on one NVIDIA GPU.

    python3 torch_profile.py [--cells survey,scale1M] [--reps 3]

For each cell it builds the graph, the device index and the index
tensors (timed; a dog-mode graph with its anchor table for -G), then,
in each mode the cell runs, maps the cell's 131,072 reads warm with
`dbgtpu_torch.pipeline.run_pipeline` `--reps` times, splitting the
align phase into host pack, H2D, the mode's kernels (synchronized) and
native formatting.  One more warm run goes under torch.profiler: the
device busy share is the summed duration of the device-side events
(kernels, copies, memsets) over that run's host wall.  Then each kernel
of the mode is timed against its plain version on the first
32,768-read batch, and the first reads are checked byte for byte
against dbgtpu's python spec in that mode.

Cells:
  survey   bench.build_workload(): 2 Mbp genome, ~30.7k unitigs of
           40-150 bp, 131,072 reads of 100 bp, k=31, m=2, e=2; greedy,
           -G and -b.
  scale1M  the workload of scripts/bench_scale.py: seed 404, 65 Mbp
           genome, ~1M unitigs of 40-150 bp, 131,072 reads of 100 bp;
           greedy and -b (its ~34M dog anchors take the MPHF anchor
           layout, which the port does not run yet).

Prints one line per measurement and, last, one JSON object per cell.
Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCRATCH = ROOT / "build" / "torch_profile"
K, M, EFFORT, BATCH = 31, 2, 2, 32768


def survey():
    import bench

    return bench.build_workload()


def scale1m():
    import numpy as np

    from dbgtpu.seq import encode
    from tests import synth

    rng = np.random.default_rng(404)
    genome = synth.make_genome(rng, 1_000_000 * 65)
    unitigs = synth.chop_unitigs(genome, K, rng, 40, 150)
    reads = synth.sample_reads(genome, rng, 131072, 100, err_frac=0.5)
    return unitigs, np.stack([encode(r) for r in reads])


# name: (workload, reads checked against the spec, modes)
CELLS = {
    "survey": (survey, 4096, ("greedy", "anchors", "exhaustive")),
    "scale1M": (scale1m, 2048, ("greedy", "exhaustive")),
}


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


def device_busy(prof, wall_s: float):
    """(summed device-event ms, busy share, per-name device ms)."""
    from torch.autograd import DeviceType

    total_us, by_name = 0.0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        total_us += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    ms = {n: v / 1e3 for n, v in sorted(by_name.items(), key=lambda x: -x[1])}
    return total_us / 1e3, total_us / 1e3 / (wall_s * 1e3), ms


def run_cell(name, reps, device, card):
    import numpy as np
    import torch

    import chip_smoke as cs
    from dbgtpu.index.build import build_graph
    from dbgtpu_torch.engine import runner
    from dbgtpu_torch.engine.index import index_tensors

    make, n_spec, modes = CELLS[name]
    out = {"cell": name, "card": card}
    t0 = time.monotonic()
    unitigs, codes_all = make()
    out["workload_s"] = time.monotonic() - t0
    chars = np.frombuffer(b"ACGT", np.uint8)
    td = Path(tempfile.mkdtemp(dir=SCRATCH))
    uf, rf = td / "unitig.fa", td / "reads.fa"
    cs.write_fasta(uf, unitigs)
    cs.write_fasta(rf, (chars[r].tobytes() for r in codes_all))
    cs.write_fasta(td / "prefix.fa", (chars[r].tobytes()
                                      for r in codes_all[:n_spec]))
    out["unitigs"] = len(unitigs)
    graphs = {}
    for dog in sorted({m == "anchors" for m in modes}):
        t0 = time.monotonic()
        graph = build_graph(str(uf), K, dog_mode=dog)
        ib = {"graph_s": time.monotonic() - t0}
        t0 = time.monotonic()
        di = runner.get_device_index(graph)
        ib["device_index_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        ix = index_tensors(di, device)
        torch.cuda.synchronize()
        ib["upload_s"] = time.monotonic() - t0
        ib["index_bytes"] = sum(t.numel() * t.element_size() for t in (
            ix.st_fused, ix.umeta, ix.pool_rows, ix.pt_rows, ix.at_fused))
        graphs[dog] = (graph, di, ix)
        out["dog_index" if dog else "index"] = ib
        cs.log(f"[{name}] {len(unitigs)} unitigs{' (dog mode)' * dog}: "
               f"graph {ib['graph_s']:.3f} s, device index "
               f"{ib['device_index_s']:.3f} s, upload {ib['upload_s']:.3f} "
               f"s, index tensors {ib['index_bytes']} B")
    out["modes"] = {
        mode: run_mode(name, mode, reps, device, codes_all, rf, uf, td,
                       n_spec, *graphs[mode == "anchors"])
        for mode in modes}
    return out


def run_mode(name, mode, reps, device, codes_all, rf, uf, td, n_spec, graph,
             di, ix):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from dbgtpu import native
    from dbgtpu.pipeline import run_pipeline as spec_pipeline
    from dbgtpu_torch.engine import runner
    from dbgtpu_torch.pipeline import run_pipeline

    tag = f"[{name} {mode}]"
    out = {}

    def mapped():
        return run_pipeline([str(rf)], str(uf), k=K, m=M, effort=EFFORT,
                            batch_size=BATCH, graph=graph, device=device,
                            mode=mode)

    st = StageTimer()
    saved = [(runner, "pack_records"), (runner, "to_device"),
             (runner, "align_batch_packed"), (native, "format_paths_native"),
             (native, "format_notaligned_native")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in saved]
    st.wrap(runner, "pack_records", "pack")
    st.wrap(runner, "to_device", "h2d", sync=True)
    st.wrap(runner, "align_batch_packed", "kernels", sync=True)
    st.wrap(native, "format_paths_native", "format")
    st.wrap(native, "format_notaligned_native", "format")
    out["warm"] = []
    try:
        for rep in range(reps):
            st.t.clear()
            t0 = time.monotonic()
            _, _, stats = mapped()
            wall = time.monotonic() - t0
            row = dict(wall_s=wall, reads_per_s=stats.read_number / wall,
                       parse_s=stats.parse_seconds,
                       align_s=stats.align_seconds,
                       **{f"{k}_s": v for k, v in st.t.items()})
            out["warm"].append(row)
            cs.log(f"{tag} warm {rep}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items()))
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
    for n, v in list(by_name.items())[:10]:
        cs.log(f"{tag}   {v:.3f} ms  {n[:100]}")

    n_reads, read_len = codes_all.shape
    B, L = min(BATCH, n_reads), runner._bucket_len(read_len, K)
    codes = np.zeros((B, L), np.uint8)
    codes[:, :read_len] = codes_all[:B]
    words, nmbits = cs.batch_tensors(codes, np.zeros((B, L), bool), device)
    lens = torch.full((B,), read_len, dtype=torch.int32, device=device)
    pmax = min(runner._pmax_for(di, L), runner._pmax_cap(L))
    res = cs.compare_kernels(ix, words, nmbits, lens, mode=mode, k=K, m=M,
                             effort=EFFORT, L=L, pmax=pmax, timed=True)
    out["kernels"] = {n: dict(max_abs_err=e, ms=ms, plain_ms=pms)
                      for n, (e, ms, pms) in res.items()}
    for n, (e, ms, pms) in res.items():
        cs.log(f"{tag} kernel {n}: == plain (err {e}), {ms:.4f} ms, "
               f"plain {pms:.4f} ms per {B}-read batch")

    got = run_pipeline([str(td / "prefix.fa")], str(uf), k=K, m=M,
                       graph=graph, device=device, mode=mode)
    want = spec_pipeline([str(td / "prefix.fa")], str(uf), k=K, m=M,
                         impl="python", graph=graph, mode=mode)
    if got[0] != want[0] or got[1] != want[1]:
        raise AssertionError(f"{tag} output differs from the spec")
    out["spec_equal_reads"] = n_spec
    cs.log(f"{tag} first {n_spec} reads byte-identical to the spec")
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="survey,scale1M")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    SCRATCH.mkdir(parents=True, exist_ok=True)
    os.environ["DBGTPU_BENCH_CACHE"] = str(SCRATCH / "workload.npz")
    os.environ["DBGTPU_NATIVE_CACHE"] = str(SCRATCH / "native")

    import chip_smoke as cs
    from dbgtpu import native
    from dbgtpu_torch.kernels import build

    card = cs.card_line()
    cs.log(f"[card] {card}")
    build.load()
    native.available()
    results = [run_cell(c, args.reps, torch.device("cuda", 0), card)
               for c in args.cells.split(",")]
    cs.log(f"[card] {cs.card_line()}")
    for r in results:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
