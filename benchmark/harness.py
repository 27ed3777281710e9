"""One run of one cell: set-up, the measured window, the metrics, and
the comparison with the plain reference that decides `correct`.

Everything is found by name from `BENCHMARK.json`: a cell names its
configuration (a file under `configs/`) and its traffic mix
(`traffic/<name>.json`); a metric is read by `metrics/<name>.py`, whose
`read(run)` returns a number, or None where it finds nothing to read (the
metric is then left out of the result).  A cell reports, with `--trace
0`, the end-to-end metrics that list it (or list no cells) and, with
`--trace 1`, the per-layer ones.

The window drives the program's entry point, `dbgtpu_torch.cli.main`,
in this process: each step is one job, the bgreat command line of the
configuration on the traffic's read file, writing `paths`,
`notAligned.fa` (each job its own two files) and a `--json-summary`.
Jobs run back to back until `--seconds` have passed; the last one
started runs to its end.  With a trace, torch.profiler records the
window (CPU and CUDA activity), the window and each job marked by a span
(`trace.py`).
"""

from __future__ import annotations

import ast
import contextlib
import gc
import hashlib
import importlib.util
import io
import json
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

from . import data, roofline
from .trace import Trace, from_chrome

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "dbgtpu")
PROGRAM = "dbgtpu_torch"
SAMPLE = 8192       # reads of a run that the reference maps one by one


class OffCard(RuntimeError):
    """A device metric asked for off the card."""


class Forbidden(RuntimeError):
    """A forbidden module was loaded."""


@dataclass
class Job:
    start: float
    end: float
    rc: int | None
    error: str | None
    out: tuple                   # its paths and notAligned.fa
    summary: dict | None = None
    digest: str | None = None    # of both files, read after the window


@dataclass
class Run:
    """What a metric's reader sees of a run."""

    config: dict
    traffic: dict
    cards: int
    graph: data.GraphFiles
    n_reads: int
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)
    jobs: list = field(default_factory=list)
    trace: Trace | None = None

    @property
    def done(self) -> list:
        """The jobs that ran to their end (exit code 0)."""
        return [j for j in self.jobs if j.rc == 0 and j.summary]

    @property
    def split(self) -> int:
        """The devices each batch is split over (`--mesh`)."""
        return max(1, self.config.get("mesh") or 1)

    def batch_size(self) -> int:
        bs, n = self.config["batch_size"], self.split
        return -(-bs // n) * n

    def batches(self) -> int:
        """Batches of the jobs that ran to their end."""
        return len(self.done) * -(-self.n_reads // self.batch_size())

    def leg_sum(self, key: str) -> float:
        return sum(j.summary[key] for j in self.done)

    def mapping_kernel_s(self) -> float | None:
        """Device seconds of the mapping kernels in the window, all cards."""
        if self.trace is None:
            return None
        return sum(s for name, s in self.trace.time_by_name().items()
                   if roofline.mapping_kernel(name))

    def bound_s(self) -> float:
        """Σ of the kernel bounds of the jobs that ran to their end."""
        c = self.config
        return len(self.done) * roofline.job_bound_s(
            self.n_reads, self.traffic["read_len"], c["k"],
            self.graph.min_unitig_len, self.graph.n_unitigs,
            c["batch_size"], self.split)

    def idle_pct(self) -> float | None:
        if self.trace is None:
            return None
        lo, hi = self.trace.window
        busy = sum(self.trace.busy_s(c) for c in range(self.cards))
        return 100.0 * (1.0 - busy / self.cards / (hi - lo))


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_parts(spec: dict, workload: str, root: Path = ROOT):
    """(cell, configuration, traffic) of `workload`."""
    cell = _named(spec["workloads"], workload, "workload")
    entry = _named(spec["configs"], cell["config"], "configuration")
    with open(root / entry["file"]) as f:
        config = dict(json.load(f), name=entry["name"])
    with open(root / "benchmark" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def metrics_of(spec: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of `workload` reports: end-to-end without
    a trace, per-layer with one; a metric without `workloads` is reported
    in every cell that reports the metric it moves."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in
                                 names else [])]


def reader(name: str, root: Path = ROOT):
    """`read` of metrics/<name>.py."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def reference_imports(root: Path = ROOT) -> list:
    """Imports of the program, the JAX package or JAX by the reference:
    its sources' import statements, and the modules and objects its
    loaded modules hold."""
    bad = set(FORBIDDEN) | {PROGRAM}
    found = []
    for src in sorted((root / "benchmark" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(src.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and not node.level else [])
            found += [f"{src.name}: {n}" for n in names
                      if n.split(".")[0] in bad]
    for name, mod in list(sys.modules.items()):
        if not name.startswith("benchmark.reference"):
            continue
        for key, val in vars(mod).items():
            owner = getattr(val, "__module__", None) or (
                getattr(val, "__name__", "") if type(val) is type(sys) else "")
            if isinstance(owner, str) and owner.split(".")[0] in bad:
                found.append(f"{name}.{key}: {owner}")
    return found


def job_argv(config: dict, traffic: dict, graph: data.GraphFiles,
             reads: Path, out: tuple, m: int) -> list:
    """The bgreat command line of one job (without --json-summary) that
    writes its paths and notAligned.fa to `out`."""
    argv = ["-r", str(reads), "-k", str(config["k"]), "-g",
            str(graph.unitigs), "-m", str(m), "-e", str(config["e"]),
            "-f", str(out[0]), "-a", str(out[1]),
            "--index-layout", config["index_layout"],
            "--batch-size", str(config["batch_size"])]
    if config["mode"] != "greedy":
        raise ValueError(f"mode {config['mode']!r}: the reference maps "
                         "the greedy mode only")
    if traffic["index"] == "load":
        argv += ["--load-index", str(graph.index)]
    if config.get("mesh"):
        argv += ["--mesh", str(config["mesh"])]
    return argv


def _digest(paths: tuple) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            while chunk := f.read(1 << 24):
                h.update(chunk)
        h.update(b"\0")
    return h.hexdigest()


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _call(main, argv: list) -> int:
    """One call of the program's entry point; its stats block, printed on
    standard output, is kept off the harness's."""
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def _phases(job: Job, span: tuple, build: bool) -> list:
    """[(name, start, end)] of a job's host phases on the trace's clock,
    from its summary's legs in the order the program runs them."""
    s = job.summary or {}
    t, out = span[0], []
    for name, dur in (
            ("graph_build" if build else "index_load",
             s.get("index_seconds", 0.0)),
            ("device_index_and_upload", s.get("device_index_seconds", 0.0)
             + s.get("upload_seconds", 0.0)),
            ("parse", s.get("parse_seconds", 0.0)),
            ("align", s.get("align_seconds", 0.0))):
        out.append((name, t, min(t + dur, span[1])))
        t = min(t + dur, span[1])
    out.append(("write_and_exit", t, span[1]))
    return out


def breakdown(run: Run) -> dict:
    """The device operations that took most time, and the cards' idle
    time by what the host was doing (a job's phase, or the harness
    between jobs), mean over the cards: 10 of each, longest first."""
    tr = run.trace
    ops = sorted(tr.time_by_name().items(), key=lambda x: -x[1])[:10]
    build = run.traffic["index"] == "build"
    phases = [p for job, span in zip(run.jobs, tr.jobs)
              for p in _phases(job, span, build)]
    idle: dict = {}
    for card in range(run.cards):
        for gs, ge in tr.idle_gaps(card):
            inside = 0.0
            for name, ps, pe in phases:
                d = min(ge, pe) - max(gs, ps)
                if d > 0:
                    idle[name] = idle.get(name, 0.0) + d / run.cards
                    inside += d
            rest = (ge - gs) - inside
            if rest > 0:
                idle["harness"] = idle.get("harness", 0.0) + rest / run.cards
    gaps = sorted(idle.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: Path = ROOT,
             cache: Path = data.CACHE, t_process: float | None = None,
             control: bool = False, sample: int = SAMPLE) -> dict:
    """One run of `workload`; returns the result (the keys of the
    result line, then `compared`: {name: {"value", "limit"}}).

    `device` "cpu" runs the program's plain kernels (tests) and refuses a
    trace.  `t_process` is the process's start on time.monotonic()'s
    clock (set-up is measured from it; from this call without it).
    `control`: the jobs map with one mismatch fewer than the
    configuration states (`-m`), the program's own lower setting, which
    the comparison must refuse."""
    import torch

    from dbgtpu_torch import cli

    t0 = time.monotonic() if t_process is None else t_process
    spec = load_spec(root)
    cell, config, traffic = cell_parts(spec, workload, root)
    cards = int(cell["chips"])
    on_card = device == "cuda"
    if trace and not on_card:
        raise OffCard("device metrics are read from a card's trace; "
                      f"this run is on {device!r}")
    if on_card and torch.cuda.device_count() < cards:
        raise OffCard(f"{workload} needs {cards} cards, "
                      f"{torch.cuda.device_count()} found")
    dev_argv = ["--device", device]
    tmp = Path(tempfile.mkdtemp(prefix="dbgbench."))
    try:
        def save_job(argv):
            rc = _call(cli.main, argv + dev_argv)
            if rc != 0:
                raise RuntimeError(f"index save exited {rc}")

        graph = data.graph_files(config, traffic["index"] == "load",
                                 save_job, cache)
        t_graph = time.monotonic()
        reads, warm = tmp / "reads.fa", tmp / "warm.fa"
        n_reads = data.make_reads(config, traffic, seed, reads, warm)
        t_reads = time.monotonic()
        m = config["m"] - (1 if control else 0)

        def argv_of(r, tag):
            out = (tmp / f"paths.{tag}", tmp / f"notAligned.{tag}.fa")
            return (job_argv(config, traffic, graph, r, out, m) + dev_argv
                    + ["--json-summary", str(tmp / f"summary.{tag}.json")],
                    out)

        # warm-up: one job on one batch of reads, the window's shapes
        # (kernel library, native parser, CUDA context, allocator); it
        # must succeed
        rc = _call(cli.main, argv_of(warm, "warm")[0])
        if rc != 0:
            raise RuntimeError(f"warm-up job exited {rc}")
        gc.collect()
        _log(f"set-up: graph files {t_graph - t0:.3f} s, reads "
             f"{t_reads - t_graph:.3f} s, warm-up job "
             f"{time.monotonic() - t_reads:.3f} s")
        run = Run(config, traffic, cards, graph, n_reads)
        jobs = run.jobs
        prof = contextlib.nullcontext()
        if trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
        mark = (torch.profiler.record_function if trace
                else lambda name: contextlib.nullcontext())
        with prof:
            with mark("bench.window"):
                t_start = time.monotonic()
                run.setup_s = t_start - t0
                while True:
                    argv, out = argv_of(reads, len(jobs))
                    ts = time.monotonic()
                    err = None
                    try:
                        with mark("bench.job"):
                            rc = _call(cli.main, argv)
                    except Exception:       # a job's failure is a result
                        rc, err = None, traceback.format_exc()
                    te = time.monotonic()
                    jobs.append(Job(ts, te, rc, err, out))
                    if rc != 0 or te - t_start >= seconds:
                        break
            if on_card:
                torch.cuda.synchronize()
        run.window = (t_start, jobs[-1].end)
        for i, job in enumerate(jobs):
            p = tmp / f"summary.{i}.json"
            if job.rc == 0 and p.exists():
                job.summary = json.loads(p.read_text())
                job.digest = _digest(job.out)
            if job.error:
                print(job.error, file=sys.stderr)
        if trace:
            prof.export_chrome_trace(str(tmp / "trace.json"))
            run.trace = from_chrome(tmp / "trace.json")
            (tmp / "trace.json").unlink()
        bad = forbidden_modules()
        if bad:
            raise Forbidden("loaded after the window: " + ", ".join(bad))

        dev = {"platform": "gpu" if on_card else device,
               "kind": (torch.cuda.get_device_name(0) if on_card
                        else device),
               "count": cards,
               "memory_peak_bytes": (max(torch.cuda.max_memory_allocated(d)
                                         for d in range(cards))
                                     if on_card else 0)}
        metrics = {}
        for m_entry in metrics_of(spec, workload, trace):
            value = reader(m_entry["name"], root)(run)
            if value is not None:
                metrics[m_entry["name"]] = {"value": value,
                                            "unit": m_entry["unit"]}
        result = {"correct": False, "attempted": len(jobs),
                  "failed": sum(1 for j in jobs if j.rc != 0),
                  "metrics": metrics, "device": dev}
        if trace:
            lo, hi = run.trace.window
            dev["busy_s"] = sum(run.trace.busy_s(c)
                                for c in range(cards)) / cards
            dev["window_s"] = hi - lo
            result["breakdown"] = breakdown(run)

        # the comparison, once the program's state is freed
        del prof
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_check = time.monotonic()
        compared = check(run, reads, seed, sample,
                         device if on_card else "cpu")
        for i, j in enumerate(run.done):
            legs = " ".join(f"{k[:-8]} {j.summary[k]:.3f}" for k in (
                "index_seconds", "upload_seconds", "parse_seconds",
                "align_seconds", "format_seconds") if k in j.summary)
            _log(f"job {i}: wall {j.end - j.start:.3f} s; {legs}")
        walls = sorted(j.end - j.start for j in jobs)
        _log(f"window {run.window[1] - run.window[0]:.3f} s, {len(jobs)} "
             f"jobs of {walls[0]:.3f}-{walls[-1]:.3f} s (median "
             f"{walls[len(walls) // 2]:.3f}); reference check "
             f"{time.monotonic() - t_check:.3f} s")
        found = reference_imports(root)
        if found:
            raise Forbidden("the reference imports " + ", ".join(found))
        result["correct"] = all(v <= lim for v, lim in compared.values())
        result["compared"] = {k: {"value": v, "limit": lim}
                              for k, (v, lim) in compared.items()}
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check(run: Run, reads: Path, seed: int, sample: int,
          device: str) -> dict:
    """{name: (value, limit)}: the reference's comparison of what the
    last job wrote; the jobs whose files differ from the last job's (every
    job maps the same read file); the jobs that failed; and, where the
    traffic builds the index, the jobs that did not build it."""
    from .reference import check as ref_check
    from .reference.graph import build_graph

    g = build_graph(str(run.graph.unitigs), run.config["k"])
    last = run.jobs[-1]
    if last.rc == 0:
        compared = ref_check.compare(
            g, reads.read_bytes(), last.out[0].read_bytes(),
            last.out[1].read_bytes(), [j.summary for j in run.done],
            run.config["m"], run.config["e"], sample, seed, device)
        compared["jobs_differ"] = (sum(1 for j in run.done
                                       if j.digest != last.digest), 0)
    else:
        compared = {}
    compared["failed_jobs"] = (sum(1 for j in run.jobs if j.rc != 0), 0)
    if run.traffic["index"] == "build":
        compared["jobs_not_cold"] = (sum(
            1 for j in run.done if not (j.summary["index_seconds"] > 0
                                        and j.summary["device_index_seconds"]
                                        > 0)), 0)
    return compared
