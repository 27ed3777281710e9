#!/usr/bin/env python3
"""Chip smoke test of dbgtpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from dbgtpu_torch/csrc (K1-K6; K3 has two entry
points, each its own kernel), then:
  1. prints the card's name and power limit and the kernel build time;
  2. runs the kernels of each mode's path and their plain torch versions
     on the same CUDA inputs (the first 32,768-read batch of the survey
     workload) and requires exactly equal integer outputs; prints both
     times.  Greedy: K1 read_scan, K2 member, K3 greedy_walk, K4
     pack_paths; anchors (-G): K5 dog_anchors, K3 walk_inits (the walk
     from K5's inits);
     exhaustive (-b): K2's exhaustive mode, K6 exhaustive_dfs;
  3. maps the survey workload (bench.build_workload: 2 Mbp genome, ~30.7k
     unitigs of 40-150 bp, 131,072 reads of 100 bp, k=31, m=2, e=2,
     batch 32,768) through `dbgtpu_torch.cli.main` in greedy mode, with
     -G and with -b, and requires each path's kernels to be launched
     > 0 times in its own run and no other kernel launched (counts set
     to 0 just before each run);
  4. requires byte equality with dbgtpu's executable spec
     (dbgtpu.pipeline.run_pipeline, impl="python") and each kernel of
     the mode equal to its plain version on each of these files:
     greedy: the first 4,096 survey reads, a k=21 dataset with N, the
     same with a probe-less index, the same with a pool-chunk index, a
     k=32 dataset of 300-bp reads and a dataset whose paths overflow
     pmax; -G: the first 4,096 survey reads, k=21 with N, the same with
     a pool-chunk index, k=32 with 300-bp reads; -b and -b -i: the first
     4,096 survey reads, 1,500 k=21 reads with N, the same with a
     probe-less index;
  5. prints the kernels' JSON line and, last, the result line.
Any failure raises, and the script exits non-zero without a result.
The machine with the card has no JAX: nothing here imports it, and the
reference on the card is dbgtpu's python spec.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCRATCH = ROOT / "build" / "chip_smoke"

KERNELS = (
    # name, source, the TPU-era stage it replaces
    ("read_scan", "dbgtpu_torch/csrc/read_scan.cu", "dbgtpu/engine/core.py:683"),
    ("member", "dbgtpu_torch/csrc/member.cu", "dbgtpu/engine/core.py:470"),
    ("greedy_walk", "dbgtpu_torch/csrc/walk.cu", "dbgtpu/engine/core.py:1099"),
    ("walk_inits", "dbgtpu_torch/csrc/walk.cu", "dbgtpu/engine/core.py:1099"),
    ("pack_paths", "dbgtpu_torch/csrc/pack.cu", "dbgtpu/engine/core.py:864"),
    ("dog_anchors", "dbgtpu_torch/csrc/dog.cu", "dbgtpu/engine/dog.py:59"),
    ("exhaustive_dfs", "dbgtpu_torch/csrc/exhaustive.cu",
     "dbgtpu/engine/exhaustive.py:83"),
)
# the kernels each mode's path launches, and the mode whose phase-2 run
# gives each kernel's time in the JSON line
PATH_KERNELS = {
    "greedy": ("read_scan", "member", "greedy_walk", "pack_paths"),
    "anchors": ("read_scan", "dog_anchors", "walk_inits", "pack_paths"),
    "exhaustive": ("read_scan", "member", "exhaustive_dfs", "pack_paths"),
}
TIMED_IN = {"dog_anchors": "anchors", "walk_inits": "anchors",
            "exhaustive_dfs": "exhaustive"}
MODE_FLAGS = {"greedy": [], "anchors": ["-G"], "exhaustive": ["-b"]}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn` over `reps` timed runs (CUDA events,
    after one warm-up run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _max_abs_err(got, want) -> int:
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"shape/dtype {tuple(got.shape)} {got.dtype} != "
            f"{tuple(want.shape)} {want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def walks_pairs(wk, wr):
    """(kernel, plain) pairs of two Walks; only lbuf[:llen] and
    rbuf[:rlen] are meaningful."""
    import torch

    col = torch.arange(wk.lbuf.shape[1], device=wk.lbuf.device)[None, :]
    lm = col < wr.llen[:, None]
    rm = col < wr.rlen[:, None]
    pairs = [(getattr(wk, f), getattr(wr, f))
             for f in ("status", "orient", "offset", "llen", "rlen")]
    return pairs + [(wk.lbuf[lm], wr.lbuf[lm]), (wk.rbuf[rm], wr.rbuf[rm])]


def compare_kernels(ix, words, nmbits, lens, *, mode, k, m, effort, L, pmax,
                    timed: bool, partial: bool = False):
    """Each kernel of `mode`'s path against its plain version on the same
    CUDA inputs.  Integer outputs must be exactly equal (tolerance 0).
    Returns {name: (max_abs_err, ms, plain_ms)}; K2's exhaustive mode is
    "member (inter)"."""
    import torch

    from dbgtpu_torch.engine.dog import dog_anchors, dog_anchors_ref
    from dbgtpu_torch.engine.exhaustive import exhaustive_dfs, exhaustive_ref
    from dbgtpu_torch.engine.member import inter, inter_ref, member, member_ref
    from dbgtpu_torch.engine.pack import out_dtype_for, pack_paths, pack_ref
    from dbgtpu_torch.engine.read_scan import read_scan, read_scan_ref
    from dbgtpu_torch.engine.walk import (
        greedy_walk, walk_inits, walk_inits_ref, walk_ref,
    )

    k1 = k - 1
    out = {}

    def record(name, pairs, fk, fr, reps_k=20, reps_r=3):
        torch.cuda.synchronize()
        err = max(_max_abs_err(g, w) for g, w in pairs)
        if err:
            raise AssertionError(f"{name}: kernel != plain version "
                                 f"(max abs err {err})")
        ms = cuda_ms(fk, reps_k) if timed else None
        pms = cuda_ms(fr, reps_r) if timed else None
        out[name] = (err, ms, pms)

    sk = read_scan(words, nmbits, lens, L=L, k1=k1)
    sr = read_scan_ref(words, nmbits, lens, L=L, k1=k1)
    record("read_scan", list(zip(sk, sr)),
           lambda: read_scan(words, nmbits, lens, L=L, k1=k1),
           lambda: read_scan_ref(words, nmbits, lens, L=L, k1=k1))

    kw = dict(k=k, m=m, effort=effort, L=L)
    if mode == "greedy":
        mk = member(ix, sk, lens, L=L, k1=k1)
        mr = member_ref(ix, sk, lens, L=L, k1=k1)
        record("member", list(zip(mk, mr)),
               lambda: member(ix, sk, lens, L=L, k1=k1),
               lambda: member_ref(ix, sk, lens, L=L, k1=k1))
        wk = greedy_walk(ix, sk, *mk, lens, **kw)
        wr = walk_ref(ix, sk, *mk, lens, **kw)
        record("greedy_walk", walks_pairs(wk, wr),
               lambda: greedy_walk(ix, sk, *mk, lens, **kw),
               lambda: walk_ref(ix, sk, *mk, lens, **kw), reps_r=2)
    elif mode == "anchors":
        ik = dog_anchors(ix, sk.rows, lens, **kw)
        ir = dog_anchors_ref(ix, sk.rows, lens, **kw)
        # init rows e >= n_f (n_r) are never read
        used = (torch.arange(effort, device=lens.device)[None, None, :]
                < torch.stack([ir.n_f, ir.n_r])[:, :, None])
        record("dog_anchors", [(ik.n_f, ir.n_f), (ik.n_r, ir.n_r),
                               (ik.planes[:, used], ir.planes[:, used])],
               lambda: dog_anchors(ix, sk.rows, lens, **kw),
               lambda: dog_anchors_ref(ix, sk.rows, lens, **kw))
        wk = walk_inits(ix, sk.rows, lens, ik, k=k, L=L)
        wr = walk_inits_ref(ix, sk.rows, lens, ik, k=k, L=L)
        record("walk_inits", walks_pairs(wk, wr),
               lambda: walk_inits(ix, sk.rows, lens, ik, k=k, L=L),
               lambda: walk_inits_ref(ix, sk.rows, lens, ik, k=k, L=L),
               reps_r=2)
    elif mode == "exhaustive":
        xk = inter(ix, sk, lens, L=L, k1=k1)
        xr = inter_ref(ix, sk, lens, L=L, k1=k1)
        record("member (inter)", [(xk, xr)],
               lambda: inter(ix, sk, lens, L=L, k1=k1),
               lambda: inter_ref(ix, sk, lens, L=L, k1=k1))
        xw = dict(k=k, m=m, partial=partial, L=L)
        wk = exhaustive_dfs(ix, sk, xk, lens, **xw)
        wr = exhaustive_ref(ix, sk, xk, lens, **xw)
        record("exhaustive_dfs", walks_pairs(wk, wr),
               lambda: exhaustive_dfs(ix, sk, xk, lens, **xw),
               lambda: exhaustive_ref(ix, sk, xk, lens, **xw), reps_r=2)
    else:
        raise ValueError(mode)

    dtype = out_dtype_for(ix.umeta.shape[0], L)
    pk = pack_paths(wk, pmax=pmax, dtype=dtype)
    pr = pack_ref(wk, pmax=pmax, dtype=dtype)
    record("pack_paths", [(pk, pr)],
           lambda: pack_paths(wk, pmax=pmax, dtype=dtype),
           lambda: pack_ref(wk, pmax=pmax, dtype=dtype))
    return out


def batch_tensors(codes, nmask, device):
    """[B, L] codes + N-mask -> the packed CUDA batch of the runner."""
    import numpy as np

    from dbgtpu_torch.engine.index import to_device
    from dbgtpu_torch.engine.runner import pack_words_batch

    words, nmbits = pack_words_batch(codes, nmask)
    if not nmbits.any():
        nmbits = np.zeros((codes.shape[0], 0), np.uint32)
    return to_device(words, device), to_device(nmbits, device)


def write_fasta(path: Path, seqs) -> None:
    with open(path, "wb") as f:
        f.write(b"".join(b">r" + str(i).encode() + b"\n" + bytes(s) + b"\n"
                         for i, s in enumerate(seqs)))


def spec_bytes_equal(label, reads_fa, unitigs_fa, k, m, graph, device,
                     check_ix=None, mode="greedy", partial=False):
    """The port on `device` against dbgtpu's python spec in `mode`, byte
    for byte; also the mode's kernels against their plain versions on
    the whole file as one batch."""
    import numpy as np
    import torch

    from dbgtpu import native
    from dbgtpu.pipeline import run_pipeline as spec_pipeline
    from dbgtpu_torch.engine.index import index_tensors, to_device
    from dbgtpu_torch.engine.runner import (
        _bucket_len, _pmax_cap, _pmax_for, get_device_index, pack_records,
    )
    from dbgtpu_torch.pipeline import run_pipeline

    t0 = time.monotonic()
    got = run_pipeline([str(reads_fa)], str(unitigs_fa), k=k, m=m,
                       batch_size=32768, graph=graph, device=device,
                       mode=mode, partial=partial)
    t1 = time.monotonic()
    want = spec_pipeline([str(reads_fa)], str(unitigs_fa), k=k, m=m,
                         impl="python", graph=graph, mode=mode,
                         partial=partial)
    t2 = time.monotonic()
    for what, a, b in (("paths", got[0], want[0]),
                       ("notAligned.fa", got[1], want[1])):
        if a != b:
            raise AssertionError(f"{label}: {what} differs from the spec "
                                 f"({len(a)} vs {len(b)} bytes)")
    for f in ("read_number", "aligned", "not_aligned", "no_overlap"):
        if getattr(got[2], f) != getattr(want[2], f):
            raise AssertionError(f"{label}: stats {f} differs")
    di = get_device_index(graph)
    ix = index_tensors(di, device)
    if check_ix is not None:
        check_ix(ix)
    parsed = native.parse_reads(str(reads_fa), k, False)
    lens_all = np.diff(parsed.seq_off).astype(np.int32)
    L = _bucket_len(int(lens_all.max()), k)
    words, nmbits, blens = pack_records(parsed, lens_all, 0, parsed.n, L)
    errs = compare_kernels(
        ix, to_device(words, device), to_device(nmbits, device),
        to_device(blens, device), mode=mode, k=k, m=m, effort=2, L=L,
        pmax=min(_pmax_for(di, L), _pmax_cap(L)), timed=False,
        partial=partial,
    )
    torch.cuda.synchronize()
    flags = " ".join(MODE_FLAGS[mode] + (["-i"] if partial else []))
    log(f"[bytes] {label} [{flags or 'greedy'}]: {got[2].read_number} "
        f"reads, {got[2].aligned} "
        f"aligned, paths {len(got[0])} B, notAligned {len(got[1])} B: "
        f"byte-identical to the spec (port {t1 - t0:.2f} s, spec "
        f"{t2 - t1:.2f} s); kernels == plain on the file "
        f"({', '.join(f'{n} {e[0]}' for n, e in errs.items())})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    SCRATCH.mkdir(parents=True, exist_ok=True)
    # bench.build_workload caches its reads here; dbgtpu.native builds
    # its parser library here (both default to the system temp dir)
    os.environ["DBGTPU_BENCH_CACHE"] = str(SCRATCH / "workload.npz")
    os.environ["DBGTPU_NATIVE_CACHE"] = str(SCRATCH / "native")

    import numpy as np

    import bench
    from dbgtpu.index import device as dev_index
    from dbgtpu.index.build import build_graph_from_seqs
    from tests import synth
    from dbgtpu_torch import cli
    from dbgtpu_torch.engine.index import index_tensors
    from dbgtpu_torch.engine.runner import (
        _bucket_len, _pmax_cap, _pmax_for, get_device_index,
    )
    from dbgtpu_torch.kernels import build

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---- phase 1: build ----
    t0 = time.monotonic()
    lib_path = build.build()
    build.load()
    log(f"[build] {lib_path.name}: {time.monotonic() - t0:.1f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    from dbgtpu import native

    t0 = time.monotonic()
    log(f"[build] dbgtpu native parser/formatter: available "
        f"{native.available()} ({time.monotonic() - t0:.1f} s, g++)")

    # ---- phase 2: kernels against their plain versions ----
    t0 = time.monotonic()
    unitigs, codes_all = bench.build_workload()
    n_reads, read_len = codes_all.shape
    log(f"[workload] {len(unitigs)} unitigs, {n_reads} reads of "
        f"{read_len} bp ({time.monotonic() - t0:.1f} s)")
    k, m, effort, B = bench.K, bench.M, bench.EFFORT, bench.BATCH
    graphs, ixs = {}, {}
    for dog in (False, True):
        t0 = time.monotonic()
        g = build_graph_from_seqs(unitigs, k, dog_mode=dog)
        di = get_device_index(g)
        graphs[dog], ixs[dog] = g, index_tensors(di, device)
        torch.cuda.synchronize()
        ix = ixs[dog]
        log(f"[index] {'dog-mode ' if dog else ''}graph + device index "
            f"{time.monotonic() - t0:.1f} s: st_fused "
            f"{tuple(ix.st_fused.shape)}, umeta {tuple(ix.umeta.shape)}, "
            f"pt_rows {tuple(ix.pt_rows.shape)}, at_fused "
            f"{tuple(ix.at_fused.shape)}")
    graph, di = graphs[False], get_device_index(graphs[False])
    L = _bucket_len(read_len, k)
    pmax = min(_pmax_for(di, L), _pmax_cap(L))
    codes = np.zeros((B, L), np.uint8)
    codes[:, :read_len] = codes_all[:B]
    words, nmbits = batch_tensors(codes, np.zeros((B, L), bool), device)
    lens = torch.full((B,), read_len, dtype=torch.int32, device=device)
    results = {}
    for mode in PATH_KERNELS:
        results[mode] = compare_kernels(
            ixs[mode == "anchors"], words, nmbits, lens, mode=mode, k=k, m=m,
            effort=effort, L=L, pmax=pmax, timed=True)
        for name, (err, ms, pms) in results[mode].items():
            log(f"[kernel] {mode}: {name}: == plain version (max abs err "
                f"{err}, tolerance 0); kernel {ms:.4f} ms, plain {pms:.4f} "
                f"ms per {B}-read batch (L={L}, pmax={pmax})")

    # ---- phase 3: each mode's path at real size through the CLI ----
    with tempfile.TemporaryDirectory(dir=SCRATCH) as td:
        td = Path(td)
        uf, rf = td / "unitig.fa", td / "reads.fa"
        write_fasta(uf, unitigs)
        chars = np.frombuffer(b"ACGT", np.uint8)
        write_fasta(rf, (chars[r].tobytes() for r in codes_all))
        launches = {}
        for mode, flags in MODE_FLAGS.items():
            js = td / "summary.json"
            argv = ["-r", str(rf), "-k", str(k), "-g", str(uf), "-m", str(m),
                    "-e", str(effort), "--batch-size", str(B),
                    "-f", str(td / "paths"), "-a", str(td / "notAligned.fa"),
                    "--json-summary", str(js)] + flags
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            t0 = time.monotonic()
            rc = cli.main(argv)
            wall = time.monotonic() - t0
            peak = torch.cuda.max_memory_allocated()
            launches[mode] = dict(build.launches)
            if rc != 0:
                raise AssertionError(f"cli.main {flags} exited {rc}")
            summ = json.loads(js.read_text())
            n_paths = (td / "paths").read_bytes().count(b"\n") // 2
            tag = f"[slice {' '.join(flags) or 'greedy'}]"
            log(f"{tag} python -m dbgtpu_torch {' '.join(argv)}")
            log(f"{tag} index build {summ['index_seconds']} s (graph) + "
                f"{summ['device_index_seconds']} s (device index); upload "
                f"{summ['upload_seconds']} s; parse {summ['parse_seconds']} "
                f"s; mapping {summ['reads'] / summ['align_seconds']:.1f} "
                f"reads/s ({summ['align_seconds']} s for pack + kernels + "
                f"unpack + format of {summ['reads']} reads); end-to-end "
                f"{summ['reads'] / wall:.1f} reads/s ({wall:.2f} s wall, "
                f"map_seconds {summ['map_seconds']}); max_memory_allocated "
                f"{peak} B, of which {peak - held} B above the {held} B "
                f"the script held before the run")
            log(f"{tag} {summ['aligned']} aligned, {summ['no_overlap']} no "
                f"overlap, {summ['not_aligned']} not aligned; launches "
                f"{launches[mode]}")
            if summ["reads"] != n_reads or n_paths != summ["aligned"]:
                raise AssertionError(f"{tag} output does not match its stats")
            if not summ["aligned"]:
                raise AssertionError(f"{tag} aligned no read")
            missing = [n for n in PATH_KERNELS[mode]
                       if launches[mode][n] <= 0]
            if missing:
                raise AssertionError(f"{tag} kernels not launched: {missing}")
            extra = [n for n, c in launches[mode].items()
                     if c and n not in PATH_KERNELS[mode]]
            if extra:
                raise AssertionError(f"{tag} kernels of another path "
                                     f"launched: {extra}")

        # ---- phase 4: bytes against the spec ----
        from dbgtpu.index.build import build_graph

        def probe_present(ix_):
            if ix_.pt_rows.shape[0] == 0:
                raise AssertionError("expected a probe table")

        def probe_less(ix_):
            if ix_.pt_rows.shape[0] != 0:
                raise AssertionError("expected a probe-less index")

        def pool_chunk(ix_):
            if ix_.seq_words != 0:
                raise AssertionError("expected a pool-chunk index")

        def pool_graph(path, k_, dog):
            cap = dev_index.EMBED_CAP_BASES
            dev_index.EMBED_CAP_BASES = 8
            try:
                g = build_graph(str(path), k_, dog_mode=dog)
                get_device_index(g)
            finally:
                dev_index.EMBED_CAP_BASES = cap
            return g

        def probeless_graph(path, k_):
            g = build_graph(str(path), k_)
            get_device_index(g).probe_tbl = None
            return g

        n4 = 4096
        write_fasta(td / "r4096.fa", (chars[r].tobytes()
                                      for r in codes_all[:n4]))
        spec_bytes_equal(f"survey first {n4} reads", td / "r4096.fa", uf,
                         k, m, graph, device)
        spec_bytes_equal(f"survey first {n4} reads", td / "r4096.fa", uf,
                         k, m, graphs[True], device, mode="anchors")
        for partial in (False, True):
            spec_bytes_equal(f"survey first {n4} reads", td / "r4096.fa", uf,
                             k, m, graph, device, probe_present,
                             mode="exhaustive", partial=partial)
        reads_fa, unitigs_fa = synth.make_dataset(
            seed=4242, genome_len=60000, k=21, n_reads=3000, n_frac=0.1)
        nr, nu = td / "nr.fa", td / "nu.fa"
        nr.write_bytes(reads_fa)
        nu.write_bytes(unitigs_fa)
        spec_bytes_equal("k=21 with N", nr, nu, 21, 1, build_graph(str(nu), 21),
                         device, probe_present)
        spec_bytes_equal("k=21 with N, probe-less index", nr, nu, 21, 1,
                         probeless_graph(nu, 21), device, probe_less)
        spec_bytes_equal("k=21 with N, pool-chunk index", nr, nu, 21, 1,
                         pool_graph(nu, 21, False), device, pool_chunk)
        spec_bytes_equal("k=21 with N", nr, nu, 21, 1,
                         build_graph(str(nu), 21, dog_mode=True), device,
                         mode="anchors")
        spec_bytes_equal("k=21 with N, pool-chunk index", nr, nu, 21, 1,
                         pool_graph(nu, 21, True), device, pool_chunk,
                         mode="anchors")
        reads_fa, unitigs_fa = synth.make_dataset(
            seed=4244, genome_len=60000, k=21, n_reads=1500, n_frac=0.1)
        br, bu = td / "br.fa", td / "bu.fa"
        br.write_bytes(reads_fa)
        bu.write_bytes(unitigs_fa)
        for partial in (False, True):
            spec_bytes_equal("1,500 k=21 reads with N", br, bu, 21, 1,
                             build_graph(str(bu), 21), device, probe_present,
                             mode="exhaustive", partial=partial)
            spec_bytes_equal("1,500 k=21 reads with N, probe-less index", br,
                             bu, 21, 1, probeless_graph(bu, 21), device,
                             probe_less, mode="exhaustive", partial=partial)
        # 64-bit k-mers with 300-bp reads (L=512): k-1 = 31 in greedy
        # mode, whole 32-mers in dog mode; and stride-1 unitigs whose
        # paths overflow pmax (host recompute)
        for label, k_, modes, kw in (
            ("k=32, 300-bp reads with N", 32, ("greedy", "anchors"),
             dict(n_frac=0.1, read_len=300, genome_len=60000)),
            ("k=15, 15-18 bp unitigs (pmax overflow)", 15, ("greedy",),
             dict(min_unitig=15, max_unitig=18, decoy_frac=0.0,
                  genome_len=20000)),
        ):
            reads_fa, unitigs_fa = synth.make_dataset(
                seed=4343, k=k_, n_reads=2000, **kw)
            (td / "xr.fa").write_bytes(reads_fa)
            (td / "xu.fa").write_bytes(unitigs_fa)
            for mode in modes:
                spec_bytes_equal(
                    label, td / "xr.fa", td / "xu.fa", k_, 2,
                    build_graph(str(td / "xu.fa"), k_,
                                dog_mode=mode == "anchors"),
                    device, mode=mode)

    # ---- phase 5: result ----
    kernels = []
    for name, source, replaces in KERNELS:
        mode = TIMED_IN.get(name, "greedy")
        err, ms, pms = results[mode][name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=launches[mode][name],
                            max_abs_err=err, ms=ms, plain_ms=pms))
    log(card_line())        # the card's name and power limit, as printed
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
