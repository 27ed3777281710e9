"""Can a hand-written gather beat the library's on the member stage's
access pattern?  The question of scripts/exp_r5_pallas.py and
scripts/archive/exp_pallas_gather.py, asked of one NVIDIA GPU.

    python -m dbgtpu_torch.tools.exp_gather [--device cpu]
                                            [--geometries scripts,beyond_l2]
                                            [--baseline-csrc DIR]
                                            [--turns N]

Runs the four gather kernels K9-K12 (engine/gather.py, csrc/gather.cu) on
inputs made from numpy `default_rng(7)`:

  scripts    the two scripts' geometries: a closure-probe-sized table of
             2^17 rows x 24 words (12.6 MB, inside the 50 MB L2) with
             917,504 row gathers, the member stage's count per
             32,768-read batch (K9 at G=1 and G=8, K10 in chunks of
             4,096); and 32,768 x 128 indices into 2^15 rows x 16 words
             (K11) and into 2^15 words (K12), gathered 8 times;
  beyond_l2  the same index counts into tables far beyond the L2: 2^22
             rows x 24 words (403 MB; K9, K10), 2^22 rows x 16 words
             (268 MB; K11) and 2^22 words (16.8 MB, more than a block's
             shared memory).

K11 and K12 gather from shared memory under a plan (engine/gather.py
gather_plan): the table whole in every block where it fits one (K12 at
"scripts"), else cut into slices with the indices bucketed per slice
first.  On a CUDA device a line before each of their results gives the
plan and, for a bucketed plan, the time of each pass alone (count; scan
and scatter; gather: each 50 back-to-back launches of that pass alone).

Each kernel must equal its plain torch version exactly (integers,
tolerance 0).  On a CUDA device each is then timed beside its plain
version and beside the one PyTorch gather that computes the same
function (`tbl[idx]`, and `tbl[idx].sum(...)`: what the scripts call the
XLA gather).  The kernel's time is the kernel alone: CUDA events around
a run of back-to-back launches through its C entry point into outputs
allocated once, which must equal the wrapper's result; one call through
the wrapper, with its checks and allocations, is printed beside it.  The
rows per second of kernel and library call count the function's rows
once on both sides (K11 and K12 read them 8 times over), and the bound
is printed last.  K10, whose launch is short, is also timed by the
device alone: its launches captured once into a CUDA graph and replayed
between the events (kernels/measure.py graph_ms), beside the same timer
on a kernel that does nothing (the launch floor, printed first).
`--baseline-csrc DIR` builds the kernels of DIR (another tree's
dbgtpu_torch/csrc, older K10, K11 and K12 entry points included) and
times them alone in turns with these (baseline, this, this, baseline),
K10 with both timers.
`--turns N` times each kernel alone and its library call in N pairs of
turns (kernel first in even pairs, the library call first in odd ones)
and prints how many pairs the kernel won, with the spread of both.
With `--device cpu` the wrappers take their plain versions and only the
control flow is checked: a small geometry, no timing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..kernels.measure import (
    bound_ms, cuda_ms, graph_ms, in_turns, launch_floor_ms, on,
)

REPS = 8                        # gathers per launch of K11 and K12

# name: NB rows x W words for K9/K10 with N gathers in chunks of CH;
# NB2 rows x W2 words (K11) and NB1 words (K12) with B x J indices
GEOMETRIES = {
    "scripts": dict(NB=1 << 17, W=24, N=917504, CH=4096,
                    NB2=1 << 15, W2=16, NB1=1 << 15, B=32768, J=128),
    "beyond_l2": dict(NB=1 << 22, W=24, N=917504, CH=4096,
                      NB2=1 << 22, W2=16, NB1=1 << 22, B=32768, J=128),
    "small": dict(NB=1 << 10, W=24, N=8192, CH=512,
                  NB2=1 << 9, W2=16, NB1=1 << 9, B=256, J=128),
}
# Integer operations the functions need, whatever the kernel's layout:
# K9 copies and needs none; K10 to K12 need one add per table word they
# sum.  K11 and K12 are defined as REPS gathers, so their words count
# REPS times.  (Index and address arithmetic belongs to an implementation
# and is not counted.)


def make_inputs(geometry: str, device) -> dict:
    """The tensors of one geometry on `device`, from default_rng(7)."""
    import torch

    g = GEOMETRIES[geometry]
    rng = np.random.default_rng(7)

    def table(*shape):
        a = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
        return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(device)

    def indices(high, *shape):
        return torch.from_numpy(
            rng.integers(0, high, size=shape).astype(np.int32)).to(device)

    tbl = table(g["NB"], g["W"])
    idx = indices(g["NB"], g["N"])
    return dict(
        g, tbl=tbl, idx=idx,
        # G=8: idx as ids of blocks of 8 consecutive rows (the script's
        # `idx[: N // G] % (NB // G)`)
        idx8=(idx[: g["N"] // 8] % (g["NB"] // 8)).contiguous(),
        tbl2=table(g["NB2"], g["W2"]), tbl1=table(g["NB1"]),
        idx2=indices(g["NB2"], g["B"], g["J"]),
        idx1=indices(g["NB1"], g["B"], g["J"]),
    )


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cases(inp: dict) -> list[dict]:
    """One entry per kernel run on `inp`: its wrapper, plain version and
    library call; `alone(lib=None)` -> (launch, out), the bare C entry
    point of `lib` (default: this tree's kernels; an older tree's through
    kernels/measure.py `on`) on outputs and scratch allocated once (CUDA
    only); K11 and K12 also their `plan()`; K10
    `graph`: it is also timed by the graph timer; the rows of the
    function; and the cost that bounds it (`bound`: bytes streamed once,
    bytes of table rows touched, the table's bytes, integer
    operations)."""
    import torch

    from ..engine import gather as G

    tbl, idx, idx8 = inp["tbl"], inp["idx"], inp["idx8"]
    tbl2, tbl1, idx2, idx1 = inp["tbl2"], inp["tbl1"], inp["idx2"], inp["idx1"]
    W, W2, CH = inp["W"], inp["W2"], inp["CH"]
    N, B, J = inp["N"], inp["B"], inp["J"]
    N8 = idx8.shape[0] * 8
    i64, i8_64 = idx.to(torch.int64), idx8.to(torch.int64)
    i2_64, i1_64 = idx2.to(torch.int64), idx1.to(torch.int64)
    tbl_blocks = tbl.view(inp["NB"] // 8, 8 * W)
    i32 = torch.int32

    def empty(*shape):
        return torch.empty(shape, dtype=i32, device=idx.device)

    def alone_rows(ix, g, lib=None):
        out = empty(ix.shape[0] * g, W)
        return (lambda: G.launch_gather_rows(tbl, ix, g, out, lib)), out

    def alone_rowsum(lib=None):
        """K10 through `lib`'s entry point, its arguments and the current
        stream bound once."""
        out = empty(N // CH, 1)
        return on(lib, G.rowsum_launch(
            tbl, idx, CH, G.plan_rowsum(tbl, idx, CH), out)), out

    def alone_sum(t, ix, lib=None):
        """K11 / K12 alone: launch(passes) through `lib`'s entry point
        (passes: one of plan.passes(), for that pass alone; an older
        tree's entry point runs them all), its arguments bound once."""
        out = empty(B)
        plan = G.plan_for(t, ix)
        scratch = G.gather_scratch(plan, ix)
        go = {bit: on(lib, G.sum_launch(t, ix, REPS, out, plan, *scratch,
                                        bit))
              for bit in (G.ALL_PASSES, *plan.passes().values())}
        return (lambda passes=G.ALL_PASSES: go[passes]()), out

    return [
        dict(name="gather_rows", label="K9 gather_rows G=1",
             kernel=lambda: G.gather_rows(tbl, idx, 1),
             alone=lambda lib=None: alone_rows(idx, 1, lib),
             plain=lambda: G.gather_rows_ref(tbl, idx, 1),
             library=lambda: tbl[i64], rows=N,
             bound=(nbytes(idx) + N * W * 4, N * W * 4, nbytes(tbl), 0)),
        dict(name="gather_rows", label="K9 gather_rows G=8",
             kernel=lambda: G.gather_rows(tbl, idx8, 8),
             alone=lambda lib=None: alone_rows(idx8, 8, lib),
             plain=lambda: G.gather_rows_ref(tbl, idx8, 8),
             library=lambda: tbl_blocks[i8_64], rows=N8,
             bound=(nbytes(idx8) + N8 * W * 4, N8 * W * 4, nbytes(tbl), 0)),
        dict(name="gather_rowsum", label=f"K10 gather_rowsum CH={CH}",
             kernel=lambda: G.gather_rowsum(tbl, idx, CH),
             alone=alone_rowsum, graph=True,
             plain=lambda: G.gather_rowsum_ref(tbl, idx, CH),
             library=lambda: tbl[i64].view(N // CH, CH * W).sum(
                 1, dtype=i32),
             rows=N,
             bound=(nbytes(idx) + (N // CH) * 4, N * W * 4, nbytes(tbl),
                    N * W)),
        dict(name="gather_rows_sum", label=f"K11 gather_rows_sum x{REPS}",
             kernel=lambda: G.gather_rows_sum(tbl2, idx2, REPS),
             alone=lambda lib=None: alone_sum(tbl2, idx2, lib),
             plan=lambda: G.plan_for(tbl2, idx2),
             plain=lambda: G.gather_rows_sum_ref(tbl2, idx2, REPS),
             library=lambda: tbl2[i2_64].sum((1, 2), dtype=i32) * REPS,
             rows=B * J,
             bound=(nbytes(idx2) + B * 4, B * J * W2 * 4, nbytes(tbl2),
                    REPS * B * J * W2)),
        dict(name="gather_take_sum", label=f"K12 gather_take_sum x{REPS}",
             kernel=lambda: G.gather_take_sum(tbl1, idx1, REPS),
             alone=lambda lib=None: alone_sum(tbl1, idx1, lib),
             plan=lambda: G.plan_for(tbl1, idx1),
             plain=lambda: G.gather_take_sum_ref(tbl1, idx1, REPS),
             library=lambda: tbl1[i1_64].sum(1, dtype=i32) * REPS,
             rows=B * J,
             bound=(nbytes(idx1) + B * 4, B * J * 4, nbytes(tbl1),
                    REPS * B * J)),
    ]


def run(geometry: str, device, timed: bool, baseline=None,
        turns: int = 0) -> list[dict]:
    """Every kernel on one geometry: equal to its plain version, or an
    AssertionError; timed on a CUDA device when `timed`: alone, through
    the wrapper, plain and the library call, and for a bucketed K11 / K12
    plan each pass alone (`pass_ms`).  With `baseline` (a kernel library
    of other sources, kernels.build.load_from) its kernels are timed
    alone too, in turns with these (baseline, this, this, baseline), and
    their outputs must equal the plain version's as well.  With `turns`,
    the kernel alone and the library call also in that many pairs of
    turns (`library_turns`: [(kernel ms, library ms)]).  A case marked
    `graph` (K10) is timed by the graph timer too (`graph_ms`; with
    `baseline`, in turns: `baseline_graph_ms`, `graph_turns_ms`)."""
    import torch

    from ..kernels import build

    results = []
    for case in cases(make_inputs(geometry, device)):
        got, want = case["kernel"](), case["plain"]()
        if (got.shape != want.shape or got.dtype != want.dtype
                or not torch.equal(got, want)):
            raise AssertionError(f"{case['label']} on {geometry}: the kernel "
                                 "differs from its plain version")
        lib = case["library"]()
        if not torch.equal(lib.reshape(want.shape), want):
            raise AssertionError(f"{case['label']} on {geometry}: the "
                                 "library call computes another function")
        stream, touched, table, ops = case["bound"]
        res = dict(name=case["name"], label=case["label"], geometry=geometry,
                   rows=case["rows"], max_abs_err=0, ms=None, wrapper_ms=None,
                   plain_ms=None, library_ms=None,
                   bound_bytes=stream + min(touched, table), bound_ops=ops)
        res["bound_ms"], res["bound_by"] = bound_ms(*case["bound"])
        if "plan" in case and torch.device(device).type == "cuda":
            res["plan"] = case["plan"]()
        if timed:
            # this tree's library looked up once, as the baseline's is
            launch, out = case["alone"](build.load())
            alone = {None: launch}
            outs = [(out, "the kernel")]
            if baseline is not None:
                alone[baseline], base_out = case["alone"](baseline)
                outs.append((base_out, "the baseline kernel"))
            res.update(in_turns(lambda lib: cuda_ms(alone[lib], 5,
                                                    launches=50), baseline))
            if case.get("graph"):
                res.update(in_turns(lambda lib: _graph_ms(case, lib, want),
                                    baseline, "graph_"))
            if "plan" in res and not res["plan"].direct:
                res["pass_ms"] = {
                    name: cuda_ms(lambda bit=bit: launch(bit), 5, launches=50)
                    for name, bit in res["plan"].passes().items()}
                launch()            # the passes alone leave out unfinished
            pairs = []
            for k in range(turns):
                order = ((launch, 50), (case["library"], 1))
                ms = {f: cuda_ms(f, 5, launches=n)
                      for f, n in (order if k % 2 == 0 else order[::-1])}
                pairs.append((ms[launch], ms[case["library"]]))
            if pairs:
                res["library_turns"] = pairs
            torch.cuda.synchronize()
            for o, who in outs:
                if not torch.equal(o, want):
                    raise AssertionError(
                        f"{case['label']} on {geometry}: {who} through its "
                        "C entry point differs from its plain version")
            del launch, out, outs
            res["wrapper_ms"] = cuda_ms(case["kernel"], 20)
            res["plain_ms"] = cuda_ms(case["plain"], 3)
            res["library_ms"] = cuda_ms(case["library"], 5)
        results.append(res)
    return results


def _graph_ms(case, lib, want) -> float:
    """The graph timer on `case` through `lib`'s kernel (50 launches per
    replay); the outputs of the graph's launches must equal the plain
    version's."""
    import torch

    def bind():
        launch, out = case["alone"](lib)
        return launch, (out,)

    ms, (out,) = graph_ms(bind, 5, launches=50)
    if not torch.equal(out, want):
        raise AssertionError(f"{case['label']}: the graph's launches "
                             "differ from the plain version")
    return ms


def plan_line(plan) -> str:
    """A K11 / K12 plan in words."""
    if plan.direct:
        return (f"direct: the table staged whole by each of {plan.grid} "
                f"blocks of {plan.threads}")
    return (f"bucketed: {plan.P} slices of {plan.S} rows, {plan.share} work "
            f"item(s) per slice, {plan.grid} blocks of {plan.threads}, "
            f"{plan.entry_bits}-bit entries, {plan.tiles} count tiles")


def main(argv: list[str] | None = None, results: list | None = None) -> int:
    """The command line; `results`, when given, receives every result
    dict of the run (what chip_smoke.py reports)."""
    import torch

    ap = argparse.ArgumentParser(
        prog="exp_gather", description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda); 'cpu' checks the control "
                         "flow on a small geometry with the plain versions")
    ap.add_argument("--geometries", default=None,
                    help="comma separated (scripts,beyond_l2 on a GPU; "
                         "small on the CPU)")
    ap.add_argument("--baseline-csrc", metavar="DIR",
                    help="also build the kernels of DIR (another tree's "
                         "dbgtpu_torch/csrc) and time them alone in turns "
                         "with these (CUDA only)")
    ap.add_argument("--turns", type=int, default=0, metavar="N",
                    help="also time each kernel alone and its library call "
                         "in N pairs of turns (CUDA only)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    on_gpu = device.type == "cuda"
    if on_gpu and not torch.cuda.is_available():
        print("exp_gather: no CUDA device is available; pass --device cpu "
              "for the plain versions on a small geometry", file=sys.stderr)
        return 1
    if (args.baseline_csrc or args.turns) and not on_gpu:
        ap.error("--baseline-csrc and --turns need a CUDA device")
    names = (args.geometries.split(",") if args.geometries
             else ["scripts", "beyond_l2"] if on_gpu else ["small"])
    for name in names:
        if name not in GEOMETRIES:
            ap.error(f"unknown geometry {name!r}")
    baseline = None
    if args.baseline_csrc:
        from pathlib import Path

        from ..kernels import build

        baseline = build.load_from(Path(args.baseline_csrc))
    if on_gpu:
        print(f"device {torch.cuda.get_device_name(device)}")
        floor = launch_floor_ms()
        print(f"launch floor: a kernel that does nothing, 200 launches per "
              f"run: {floor[0]:.4f} ms a launch back to back from Python, "
              f"{floor[1]:.4f} ms replayed from a CUDA graph", flush=True)
    for name in names:
        g = GEOMETRIES[name]
        print(f"[{name}] table {g['NB']} x {g['W']} words "
              f"({g['NB'] * g['W'] * 4 >> 20} MB), {g['N']} gathers; "
              f"{g['B']} x {g['J']} indices into {g['NB2']} x {g['W2']} "
              f"words and into {g['NB1']} words")
        for r in run(name, device, timed=on_gpu, baseline=baseline,
                     turns=args.turns):
            if "plan" in r:
                print(f"[{name}] {r['label']:<28} plan: {plan_line(r['plan'])}"
                      + ("; passes alone " + ", ".join(
                          f"{k} {v:.4f} ms" for k, v in r["pass_ms"].items())
                         if "pass_ms" in r else ""))
            line = f"[{name}] {r['label']:<28} == plain version (exact)"
            if r["ms"] is not None:
                line += (
                    f"; kernel alone {r['ms']:.4f} ms = "
                    f"{r['rows'] / r['ms'] / 1e3:.0f}M rows/s (one call "
                    f"through the wrapper {r['wrapper_ms']:.4f} ms), library "
                    f"call {r['library_ms']:.4f} ms = "
                    f"{r['rows'] / r['library_ms'] / 1e3:.0f}M rows/s "
                    f"({r['library_ms'] / r['ms']:.2f}x the kernel's time), "
                    f"plain {r['plain_ms']:.4f} ms, bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
                    f"{r['bound_bytes']} B, {r['bound_ops']} operations; the "
                    f"kernel takes {r['ms'] / r['bound_ms']:.2f}x its bound)")
            if "baseline_ms" in r:
                line += (f"; baseline kernel alone {r['baseline_ms']:.4f} ms "
                         f"(turns baseline, this, this, baseline: "
                         + ", ".join(f"{t:.4f}" for t in r["turns_ms"]) + ")")
            if "graph_ms" in r:
                line += (f"; graph timer {r['graph_ms']:.4f} ms"
                         + (f", baseline {r['baseline_graph_ms']:.4f} ms "
                            f"(turns " + ", ".join(
                                f"{t:.4f}" for t in r["graph_turns_ms"])
                            + ")" if "baseline_graph_ms" in r else ""))
            print(line, flush=True)
            if "library_turns" in r:
                k_ms, l_ms = zip(*r["library_turns"])
                won = sum(k < lib for k, lib in r["library_turns"])
                print(f"[{name}] {r['label']:<28} kernel alone vs library "
                      f"call in {len(k_ms)} pairs of turns: the kernel is "
                      f"faster in {won}; kernel {min(k_ms):.4f}-"
                      f"{max(k_ms):.4f} ms, library {min(l_ms):.4f}-"
                      f"{max(l_ms):.4f} ms", flush=True)
            if results is not None:
                results.append(r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
