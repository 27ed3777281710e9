#!/usr/bin/env python3
"""Chip smoke test of dbgtpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the four CUDA kernels from dbgtpu_torch/csrc, then:
  1. prints the card's name and power limit and the kernel build time;
  2. runs each kernel and its plain torch version on the same CUDA
     inputs (the first 32,768-read batch of the survey workload) and
     requires exactly equal integer outputs; prints both times;
  3. maps the survey workload (bench.build_workload: 2 Mbp genome, ~30.7k
     unitigs of 40-150 bp, 131,072 reads of 100 bp, k=31, m=2, e=2,
     batch 32,768) through `dbgtpu_torch.cli.main`, and requires every
     kernel's launch count from that run to be > 0;
  4. requires byte equality with dbgtpu's executable spec
     (dbgtpu.pipeline.run_pipeline, impl="python") on the first 4,096
     survey reads, a k=21 dataset with N, the same with a probe-less
     index, the same with a pool-chunk index, a k=32 dataset of 300-bp
     reads and a dataset whose paths overflow pmax; and each kernel
     equal to its plain version on each of these files;
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
    ("pack_paths", "dbgtpu_torch/csrc/pack.cu", "dbgtpu/engine/core.py:864"),
)


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


def compare_kernels(ix, words, nmbits, lens, *, k, m, effort, L, pmax,
                    timed: bool):
    """Each kernel against its plain version on the same CUDA inputs.
    Integer outputs must be exactly equal (tolerance 0).  Returns
    {name: (max_abs_err, ms, plain_ms)}."""
    import torch

    from dbgtpu_torch.engine.member import member, member_ref
    from dbgtpu_torch.engine.pack import out_dtype_for, pack_paths, pack_ref
    from dbgtpu_torch.engine.read_scan import read_scan, read_scan_ref
    from dbgtpu_torch.engine.walk import greedy_walk, walk_ref

    k1 = k - 1
    out = {}

    def record(name, pairs, fk, fr, reps_k=20, reps_r=3):
        err = max(_max_abs_err(g, w) for g, w in pairs)
        if err:
            raise AssertionError(f"{name}: kernel != plain version "
                                 f"(max abs err {err})")
        ms = cuda_ms(fk, reps_k) if timed else None
        pms = cuda_ms(fr, reps_r) if timed else None
        out[name] = (err, ms, pms)

    sk = read_scan(words, nmbits, lens, L=L, k1=k1)
    sr = read_scan_ref(words, nmbits, lens, L=L, k1=k1)
    torch.cuda.synchronize()
    record("read_scan", list(zip(sk, sr)),
           lambda: read_scan(words, nmbits, lens, L=L, k1=k1),
           lambda: read_scan_ref(words, nmbits, lens, L=L, k1=k1))

    mk = member(ix, sk, lens, L=L, k1=k1)
    mr = member_ref(ix, sk, lens, L=L, k1=k1)
    torch.cuda.synchronize()
    record("member", list(zip(mk, mr)),
           lambda: member(ix, sk, lens, L=L, k1=k1),
           lambda: member_ref(ix, sk, lens, L=L, k1=k1))

    kw = dict(k=k, m=m, effort=effort, L=L)
    wk = greedy_walk(ix, sk, *mk, lens, **kw)
    wr = walk_ref(ix, sk, *mk, lens, **kw)
    torch.cuda.synchronize()
    # only lbuf[:llen] and rbuf[:rlen] are meaningful
    P = wk.lbuf.shape[1]
    col = torch.arange(P, device=wk.lbuf.device)[None, :]
    lm = col < wr.llen[:, None]
    rm = col < wr.rlen[:, None]
    pairs = [(getattr(wk, f), getattr(wr, f))
             for f in ("status", "orient", "offset", "llen", "rlen")]
    pairs += [(wk.lbuf[lm], wr.lbuf[lm]), (wk.rbuf[rm], wr.rbuf[rm])]
    record("greedy_walk", pairs,
           lambda: greedy_walk(ix, sk, *mk, lens, **kw),
           lambda: walk_ref(ix, sk, *mk, lens, **kw), reps_r=2)

    dtype = out_dtype_for(ix.umeta.shape[0], L)
    pk = pack_paths(wk, pmax=pmax, dtype=dtype)
    pr = pack_ref(wk, pmax=pmax, dtype=dtype)
    torch.cuda.synchronize()
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
                     check_ix=None):
    """The port on `device` against dbgtpu's python spec, byte for byte;
    also its kernels against their plain versions on the whole file as
    one batch."""
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
                       batch_size=32768, graph=graph, device=device)
    t1 = time.monotonic()
    want = spec_pipeline([str(reads_fa)], str(unitigs_fa), k=k, m=m,
                         impl="python", graph=graph)
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
        to_device(blens, device), k=k, m=m, effort=2, L=L,
        pmax=min(_pmax_for(di, L), _pmax_cap(L)), timed=False,
    )
    torch.cuda.synchronize()
    log(f"[bytes] {label}: {got[2].read_number} reads, {got[2].aligned} "
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
    t0 = time.monotonic()
    graph = build_graph_from_seqs(unitigs, k)
    di = get_device_index(graph)
    ix = index_tensors(di, device)
    torch.cuda.synchronize()
    log(f"[index] graph + device index {time.monotonic() - t0:.1f} s: "
        f"st_fused {tuple(ix.st_fused.shape)}, umeta "
        f"{tuple(ix.umeta.shape)}, pt_rows {tuple(ix.pt_rows.shape)}")
    L = _bucket_len(read_len, k)
    pmax = min(_pmax_for(di, L), _pmax_cap(L))
    codes = np.zeros((B, L), np.uint8)
    codes[:, :read_len] = codes_all[:B]
    words, nmbits = batch_tensors(codes, np.zeros((B, L), bool), device)
    lens = torch.full((B,), read_len, dtype=torch.int32, device=device)
    results = compare_kernels(ix, words, nmbits, lens, k=k, m=m,
                              effort=effort, L=L, pmax=pmax, timed=True)
    for name, (err, ms, pms) in results.items():
        log(f"[kernel] {name}: == plain version (max abs err {err}, "
            f"tolerance 0); kernel {ms:.4f} ms, plain {pms:.4f} ms "
            f"per {B}-read batch (L={L}, pmax={pmax})")

    # ---- phase 3: the slice at real size through the CLI ----
    with tempfile.TemporaryDirectory(dir=SCRATCH) as td:
        td = Path(td)
        uf, rf = td / "unitig.fa", td / "reads.fa"
        write_fasta(uf, unitigs)
        chars = np.frombuffer(b"ACGT", np.uint8)
        write_fasta(rf, (chars[r].tobytes() for r in codes_all))
        js = td / "summary.json"
        argv = ["-r", str(rf), "-k", str(k), "-g", str(uf), "-m", str(m),
                "-e", str(effort), "--batch-size", str(B),
                "-f", str(td / "paths"), "-a", str(td / "notAligned.fa"),
                "--json-summary", str(js)]
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.monotonic()
        rc = cli.main(argv)
        wall = time.monotonic() - t0
        launches = dict(build.launches)
        if rc != 0:
            raise AssertionError(f"cli.main exited {rc}")
        summ = json.loads(js.read_text())
        n_paths = (td / "paths").read_bytes().count(b"\n") // 2
        log(f"[slice] python -m dbgtpu_torch {' '.join(argv)}")
        log(f"[slice] index build {summ['index_seconds']} s (graph) + "
            f"{summ['device_index_seconds']} s (device index); upload "
            f"{summ['upload_seconds']} s; parse {summ['parse_seconds']} s; "
            f"mapping {summ['reads'] / summ['align_seconds']:.1f} reads/s "
            f"({summ['align_seconds']} s for pack + kernels + unpack + "
            f"format of {summ['reads']} reads); end-to-end "
            f"{summ['reads'] / wall:.1f} reads/s ({wall:.2f} s wall, "
            f"map_seconds {summ['map_seconds']}); max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} B")
        log(f"[slice] {summ['aligned']} aligned, {summ['no_overlap']} no "
            f"overlap, {summ['not_aligned']} not aligned; launches "
            f"{launches}")
        if summ["reads"] != n_reads or n_paths != summ["aligned"]:
            raise AssertionError("slice output does not match its stats")
        if not summ["aligned"]:
            raise AssertionError("slice aligned no read")
        missing = [n for n, c in launches.items() if c <= 0]
        if missing:
            raise AssertionError(f"kernels not launched by the slice: {missing}")

        # ---- phase 4: bytes against the spec ----
        n4 = 4096
        write_fasta(td / "r4096.fa", (chars[r].tobytes()
                                      for r in codes_all[:n4]))
        spec_bytes_equal(f"survey first {n4} reads", td / "r4096.fa", uf,
                         k, m, graph, device)
        reads_fa, unitigs_fa = synth.make_dataset(
            seed=4242, genome_len=60000, k=21, n_reads=3000, n_frac=0.1)
        (td / "nr.fa").write_bytes(reads_fa)
        (td / "nu.fa").write_bytes(unitigs_fa)
        from dbgtpu.index.build import build_graph

        def probe_present(ix_):
            if ix_.pt_rows.shape[0] == 0:
                raise AssertionError("expected a probe table")

        spec_bytes_equal("k=21 with N", td / "nr.fa", td / "nu.fa", 21, 1,
                         build_graph(str(td / "nu.fa"), 21), device,
                         probe_present)
        g = build_graph(str(td / "nu.fa"), 21)
        get_device_index(g).probe_tbl = None

        def probe_less(ix_):
            if ix_.pt_rows.shape[0] != 0:
                raise AssertionError("expected a probe-less index")

        spec_bytes_equal("k=21 with N, probe-less index", td / "nr.fa",
                         td / "nu.fa", 21, 1, g, device, probe_less)
        cap = dev_index.EMBED_CAP_BASES
        dev_index.EMBED_CAP_BASES = 8
        try:
            g = build_graph(str(td / "nu.fa"), 21)
            get_device_index(g)
        finally:
            dev_index.EMBED_CAP_BASES = cap

        def pool_chunk(ix_):
            if ix_.seq_words != 0:
                raise AssertionError("expected a pool-chunk index")

        spec_bytes_equal("k=21 with N, pool-chunk index", td / "nr.fa",
                         td / "nu.fa", 21, 1, g, device, pool_chunk)
        # beyond the four: 62-bit k-mers with 300-bp reads (L=512), and
        # stride-1 unitigs whose paths overflow pmax (host recompute)
        for label, k_, kw in (
            ("k=32, 300-bp reads with N", 32,
             dict(n_frac=0.1, read_len=300, genome_len=60000)),
            ("k=15, 15-18 bp unitigs (pmax overflow)", 15,
             dict(min_unitig=15, max_unitig=18, decoy_frac=0.0,
                  genome_len=20000)),
        ):
            reads_fa, unitigs_fa = synth.make_dataset(
                seed=4343, k=k_, n_reads=2000, **kw)
            (td / "xr.fa").write_bytes(reads_fa)
            (td / "xu.fa").write_bytes(unitigs_fa)
            spec_bytes_equal(label, td / "xr.fa", td / "xu.fa", k_, 2,
                             build_graph(str(td / "xu.fa"), k_), device)

    # ---- phase 5: result ----
    kernels = []
    for name, source, replaces in KERNELS:
        err, ms, pms = results[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=err, ms=ms, plain_ms=pms))
    log(card_line())        # the card's name and power limit, as printed
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
