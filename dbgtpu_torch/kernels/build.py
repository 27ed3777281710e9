"""Build, load and count the CUDA kernels of dbgtpu_torch.

`nvcc` compiles every `dbgtpu_torch/csrc/*.cu` for sm_90a into one
shared library (one nvcc process per source, all started together,
then one link) with a plain C interface under `build/dbgtpu_torch/` at
the repository root (see `_build_dir` for an installed copy), at first
use, and again whenever a source changes (the library name carries a
hash of the sources).  The library is bound
with ctypes: pointers and the stream are passed as `c_void_p`.  ptxas's
report of the build (registers and spills per kernel) is kept beside
the library (`kernel_resources`).  Every C
entry point returns `cudaGetLastError()` from right after its launch,
and `check` raises when it is not 0.

Each kernel has a plain-integer launch counter in `launches`; a wrapper
adds one where it launches its kernel and nowhere else.  `mphf_slots`
counts launches of K7's standalone kernel only (its lookup, and its
check mode: the check of each MPHF table at upload, one launch per
table, engine/mphf.py check_mphf_table); the mapping kernels
run the same device function (csrc/mphf.cuh) inline under an MPHF
layout and count as themselves.  Likewise `sharded_rows` (K13) counts
its own kernels only, once per call whichever path its plan takes (the
check of each sharded table at upload, engine/shard.py); the pull of
K3's stage (K13's pull pass over whole ranges, csrc/shard.cu
dbg_walk_stage, engine/walk.py walk_stage) counts as `walk_stage`, once
per pull; K2 and K3 read a sharded
index through the same address arithmetic (csrc/common.cuh scan_row)
inline, and K2's staged path (its stage pass, then K2: one C entry
point, engine/member.py member_plan) counts as `member`, once per call,
as its direct path does; K3 from its stage counts as `greedy_walk`.  The gather
kernels K9-K12 (csrc/gather.cu, engine/gather.py) are launched by
tools/exp_gather.py and by no mapping run.
The device index goes to the kernels as one struct (`IndexC`, csrc/common.cuh
`dbg::Index`), passed by pointer to the C entry point and by value to
the kernel; `load` checks that both sides agree on its size.

Nothing here runs at import time: the CPU tests import every module,
and a machine without the CUDA toolkit has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_ROOT = Path(__file__).resolve().parents[2]


def _build_dir() -> Path:
    """`build/dbgtpu_torch/` in a checkout of the repository; for an
    installed package, `$DBGTPU_TORCH_CACHE` or the temp directory, as
    dbgtpu's native parser does, never the shared site-packages parent."""
    if (_ROOT / "pyproject.toml").exists() and (_ROOT / "dbgtpu_torch").is_dir():
        return _ROOT / "build" / "dbgtpu_torch"
    return Path(os.environ.get("DBGTPU_TORCH_CACHE",
                               tempfile.gettempdir())) / "dbgtpu_torch"


BUILD_DIR = _build_dir()
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

KERNELS = ("read_scan", "member", "greedy_walk", "walk_inits", "pack_paths",
           "dog_anchors", "exhaustive_dfs", "mphf_slots", "compact_result",
           "gather_rows", "gather_rowsum", "gather_rows_sum",
           "gather_take_sum", "sharded_rows", "walk_stage")
launches = dict.fromkeys(KERNELS, 0)

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_LL = ctypes.c_longlong
_ARGTYPES = {
    "dbg_read_scan": [_P, _I, _P, _I, _P, _I, _I, _I,
                      _P, _P, _P, _P, _P, _P, _P, _P],
    "dbg_member": [_P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I,
                   _P, _P, _P, _P, _P],
    "dbg_greedy_walk": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _P, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P, _P],
    "dbg_walk_inits": [_P, _P, _P, _P, _I, _I,
                       _P, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P, _P, _P],
    "dbg_pack_paths": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "dbg_dog_anchors": [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P],
    "dbg_exhaustive_dfs": [_P, _P, _P, _P, _I, _I, _I,
                           _P, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P, _P, _P, _P],
    "dbg_mphf_slots": [_P, _P, _P, _P, _LL, _I, _I, _P, _P],
    "dbg_mphf_check": [_P, _P, _P, _P, _I, _LL, _I, _I, _P, _P],
    "dbg_empty": [_P],
    "dbg_compact_result": [_P, _I, _I, _I, _P, _P, _P, _P],
    "dbg_gather_rows": [_P, _P, _LL, _I, _I, _P, _P],
    "dbg_gather_rowsum": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
    "dbg_gather_rowsum_occupancy": [_I],
    "dbg_gather_rows_sum": [_P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I,
                            _P, _P],
    "dbg_gather_take_sum": [_P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P],
    "dbg_sharded_rows": [_P],
    "dbg_member_staged": [_P],
    "dbg_walk_stage": [_P],
    "dbg_enable_peer_access": [_I, _I],
}

MPHF_MAX_LEVELS = 25    # csrc/common.cuh; index/mphf.py build_mphf's cap
MAX_SHARDS = 8          # csrc/common.cuh: the most cards of a sharded index
COMPACT_TILE = 256      # csrc/compact.cu kTile: K8's scratch unit (rows)


class MphfMetaC(ctypes.Structure):
    """csrc/common.cuh dbg::MphfMeta."""
    _fields_ = [
        ("n_levels", ctypes.c_int32),
        ("has_final", ctypes.c_int32),
        ("final_mask", ctypes.c_uint32),
        ("n_keys", ctypes.c_int32),
        ("seed_hi", ctypes.c_uint32 * MPHF_MAX_LEVELS),
        ("seed_lo", ctypes.c_uint32 * MPHF_MAX_LEVELS),
        ("mask", ctypes.c_uint32 * MPHF_MAX_LEVELS),
        ("row_off", ctypes.c_int32 * MPHF_MAX_LEVELS),
    ]


class MphfC(ctypes.Structure):
    """csrc/common.cuh dbg::Mphf."""
    _fields_ = [
        ("rows", _P), ("frows", _P), ("vrows", _P), ("meta", MphfMetaC),
    ]


class IndexC(ctypes.Structure):
    """csrc/common.cuh dbg::Index."""
    _fields_ = [
        ("st", _P), ("umeta", _P), ("pool", _P), ("pt", _P), ("at", _P),
        ("st_nb", ctypes.c_int32), ("st_cols", ctypes.c_int32),
        ("st_seed", ctypes.c_uint32),
        ("ucols", ctypes.c_int32),
        ("pool_cols", ctypes.c_int32), ("n_chunks", ctypes.c_int32),
        ("pt_nb", ctypes.c_int32), ("pt_cols", ctypes.c_int32),
        ("pt_seed", ctypes.c_uint32), ("pt_slots", ctypes.c_int32),
        ("at_nb", ctypes.c_int32), ("at_cols", ctypes.c_int32),
        ("at_seed", ctypes.c_uint32),
        ("jl_mphf", ctypes.c_int32), ("al_mphf", ctypes.c_int32),
        ("jm", MphfC), ("am", MphfC),
        ("st_shards", _P * MAX_SHARDS), ("pt_shards", _P * MAX_SHARDS),
        ("n_shards", ctypes.c_int32),
    ]


class ShardTableC(ctypes.Structure):
    """csrc/shard.cu ShardTable: K13's table, `n_shards` pointers to
    shards of `nb_local` rows of `cols` words."""
    _fields_ = [
        ("shards", _P * MAX_SHARDS), ("n_shards", ctypes.c_int32),
        ("nb_local", ctypes.c_int32), ("cols", ctypes.c_int32),
    ]


class ShardPlanC(ctypes.Structure):
    """csrc/shard.cu ShardPlan (engine/shard.py ShardPlan)."""
    _fields_ = [
        ("staged", ctypes.c_int32), ("remote_rows", ctypes.c_int32),
        ("n_remote", ctypes.c_int32),
        ("stage_base", ctypes.c_int32 * MAX_SHARDS),
        ("remote", ctypes.c_int32 * MAX_SHARDS),
    ]


class ShardArgsC(ctypes.Structure):
    """csrc/shard.cu ShardArgs: one K13 call's arguments."""
    _fields_ = [
        ("table", ShardTableC), ("plan", ShardPlanC), ("ids", _P),
        ("Q", ctypes.c_longlong), ("flags", _P), ("stage", _P), ("out", _P),
        ("stream", _P),
    ]


class MemberStageArgsC(ctypes.Structure):
    """csrc/shard.cu MemberStageArgs: one staged K2 call's arguments
    (dbg_member's, the plans of its probe and junction tables, the
    scratch)."""
    _fields_ = [
        *((f, _P) for f in ("rep1", "le1", "rep2", "bug", "rwf", "lens",
                            "index", "has_n", "member1", "member2",
                            "stream", "flags", "stage")),
        *((f, ctypes.c_int32) for f in ("exhaustive", "RWr", "B", "L",
                                        "k1", "passes")),
        ("plan", ShardPlanC * 2),
    ]


class WalkStageArgsC(ctypes.Structure):
    """csrc/shard.cu WalkStageArgs: one pull of K3's stage (the junction
    table's ranges, the plan that stages the remote ones, the stage and
    the stream)."""
    _fields_ = [
        ("table", ShardTableC), ("plan", ShardPlanC), ("stage", _P),
        ("stream", _P),
    ]


class GatherPlanC(ctypes.Structure):
    """csrc/gather.cu GatherPlan (engine/gather.py GatherPlan)."""
    _fields_ = [(f, ctypes.c_int32) for f in (
        "S", "sbits", "P", "share", "grid", "threads", "entry64", "tiles",
        "tile", "smem", "scatter_smem", "buf_words", "acc")]


_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def count(name: str) -> None:
    launches[name] += 1


def sources(csrc: Path = _CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def source_hash(csrc: Path = _CSRC) -> str:
    h = hashlib.sha256()
    for p in sources(csrc):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the dbgtpu_torch CUDA kernels cannot be built"
        )
    return found


def library_path(csrc: Path = _CSRC) -> Path:
    return BUILD_DIR / f"libdbgtpu_torch.{source_hash(csrc)}.so"


def ptxas_path(csrc: Path = _CSRC) -> Path:
    """ptxas's report (-Xptxas -v) of the build of `csrc`'s library."""
    return library_path(csrc).with_suffix(".ptxas.txt")


def kernel_resources(csrc: Path = _CSRC) -> dict[str, dict]:
    """Per kernel entry of `csrc`'s library, from ptxas's report of its
    build: the source's stem, registers per thread and bytes of spill
    stores and loads."""
    out, name, stem = {}, None, None
    text = ptxas_path(csrc).read_text() if ptxas_path(csrc).exists() else ""
    for line in text.splitlines():
        m = re.match(r"== (\S+)\.cu$", line)
        if m:
            stem, name = m.group(1), None
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"source": stem}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def build(csrc: Path = _CSRC) -> Path:
    """Compile the kernels of `csrc` (default: this package's sources)
    unless a library for these sources exists."""
    so = library_path(csrc)
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(csrc.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    tmp = so.with_name(f"{tag}.tmp.so")
    try:
        report = []
        for src, cmd, proc in procs:
            output = proc.communicate()[0]
            _finish(cmd, output, proc.returncode)
            report.append(f"== {src.name}\n{output}")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *[str(o) for o in objs]]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        _finish(cmd, res.stdout, res.returncode)
        ptxas_path(csrc).write_text("".join(report))
        os.replace(tmp, so)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so


def _finish(cmd: list[str], output: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{output}")


def load() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _open(build())
        return _lib


def load_from(csrc: Path) -> ctypes.CDLL:
    """The kernels of another source tree (`csrc`: a `dbgtpu_torch/csrc`
    directory with the same index struct and the C entry points of its
    time; an entry point it does not have stays unbound, and one whose
    arguments changed since is launched through kernels/measure.py
    `on`), built into its own library beside this tree's:
    what a measurement compares this tree's kernels with.  No wrapper
    launches it."""
    return _open(build(Path(csrc).resolve()), older=True)


def _open(path: Path, older: bool = False) -> ctypes.CDLL:
    """Bind a built kernel library's entry points and check that it
    agrees with this module on the struct sizes and the K8 tile
    (`older`: another tree's, which may lack entry points)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ARGTYPES.items():
        if older and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dbg_error_string.argtypes = [ctypes.c_int]
    lib.dbg_error_string.restype = ctypes.c_char_p
    sizes = [(lib.dbg_sizeof_index, IndexC),
             (lib.dbg_sizeof_mphf_meta, MphfMetaC)]
    if hasattr(lib, "dbg_sizeof_gather_plan"):   # not in older sources
        sizes.append((lib.dbg_sizeof_gather_plan, GatherPlanC))
    if hasattr(lib, "dbg_sizeof_shard_table"):
        sizes.append((lib.dbg_sizeof_shard_table, ShardTableC))
    if hasattr(lib, "dbg_sizeof_shard_args"):
        sizes.append((lib.dbg_sizeof_shard_args, ShardArgsC))
    if hasattr(lib, "dbg_sizeof_member_stage_args"):
        sizes.append((lib.dbg_sizeof_member_stage_args, MemberStageArgsC))
    if hasattr(lib, "dbg_sizeof_walk_stage_args"):
        sizes.append((lib.dbg_sizeof_walk_stage_args, WalkStageArgsC))
    for fn, ours in sizes:
        fn.argtypes, fn.restype = [], ctypes.c_int
        if fn() != ctypes.sizeof(ours):
            raise RuntimeError(
                f"{ours.__name__} is {ctypes.sizeof(ours)} bytes "
                f"here and {fn()} in the kernel library")
    lib.dbg_compact_tile.argtypes = []
    lib.dbg_compact_tile.restype = ctypes.c_int
    if lib.dbg_compact_tile() != COMPACT_TILE:
        raise RuntimeError("COMPACT_TILE differs from csrc/compact.cu")
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = load().dbg_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg}")


class Launch:
    """One call of kernel `name`'s C entry point `entry` with `args`
    (pointers and ints, fixed when the wrapper allocated its outputs);
    `tensors` keeps every tensor the pointers point into alive.  Calling
    it launches into the same outputs again, on `lib` (default: this
    tree's library) and raises on a launch error.  It counts nothing:
    the wrappers count, and a measurement of the kernel alone calls it
    back to back (chip_smoke.py)."""

    def __init__(self, name: str, entry: str, args, tensors):
        self.name, self.entry = name, entry
        self.args, self.tensors = tuple(args), tuple(tensors)

    def __call__(self, lib: ctypes.CDLL | None = None) -> None:
        lib = load() if lib is None else lib
        check(getattr(lib, self.entry)(*self.args), self.name)


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
