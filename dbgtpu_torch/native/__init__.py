"""Native (C++) runtime bindings.

Copy of dbgtpu/native for the torch port, built into a library file of
its own.  The reference's runtime is C++ (reader, indexer, writers —
aligner.cpp); this layer stays native too: io.cpp implements the
batch read parser/packer and the paths-file formatter, compiled on
first use with g++ into a cached shared library and bound via ctypes
(no pybind11 in this environment).

`available()` is False when compilation fails or DBGTPU_NO_NATIVE=1 is
set; every caller must fall back to the pure-python implementations
(io.fasta / spec.py), which remain the behavioral spec.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).with_name("io.cpp")
_LIB_CACHE = Path(
    os.environ.get("DBGTPU_NATIVE_CACHE", tempfile.gettempdir())
) / "dbgtpu_torch_native"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_lib() -> Optional[ctypes.CDLL]:
    _LIB_CACHE.mkdir(parents=True, exist_ok=True)
    tag = f"{_SRC.stat().st_mtime_ns:x}"
    so = _LIB_CACHE / f"libdbgtpu_torch_io.{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared",
            "-fPIC", "-pthread", str(_SRC), "-o", str(tmp),
        ]
        try:
            subprocess.run(
                cmd, check=True, capture_output=True, timeout=120
            )
        except (subprocess.SubprocessError, OSError):
            return None
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.dbg_parse_reads_into.restype = ctypes.c_int32
    lib.dbg_parse_reads_into.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dbg_format_paths.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.dbg_format_paths.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dbg_format_notaligned.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.dbg_format_notaligned.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dbg_format_corrected.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.dbg_format_corrected.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dbg_pack_batch.restype = None
    lib.dbg_pack_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.dbg_free_buf.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if os.environ.get("DBGTPU_NO_NATIVE") == "1":
        return None
    if not _tried:
        _tried = True
        _lib = _build_lib()
    return _lib


def available() -> bool:
    return _get_lib() is not None


class ParsedReads:
    """Bulk-parsed read file: flat arrays, zero python-per-record work.

    codes  uint8 [seq_bytes]   2-bit codes, records back to back
    nmask  bool  [seq_bytes]   'N' positions
    seq_off int64 [n+1]
    headers bytes              concatenated header lines (no newlines)
    hdr_off int64 [n+1]
    """

    __slots__ = ("n", "codes", "nmask", "seq_off", "headers", "hdr_off")

    def __init__(self, n, codes, nmask, seq_off, headers, hdr_off):
        self.n = n
        self.codes = codes
        self.nmask = nmask
        self.seq_off = seq_off
        self.headers = headers
        self.hdr_off = hdr_off

    def record(self, i: int):
        """(header, codes, nmask) views for record i."""
        s, e = self.seq_off[i], self.seq_off[i + 1]
        h = self.headers[self.hdr_off[i] : self.hdr_off[i + 1]]
        return h, self.codes[s:e], self.nmask[s:e]

    def seq_bytes(self, i: int) -> bytes:
        """Reconstructed ASCII sequence of record i."""
        _, codes, nm = self.record(i)
        chars = np.frombuffer(b"ACGT", np.uint8)[codes].copy()
        chars[nm] = ord("N")
        return chars.tobytes()

    def slice_records(self, s: int, e: int) -> "ParsedReads":
        """Records [s, e) as a new ParsedReads (rebased offsets); used
        for per-process record-range input sharding (dist.multihost)."""
        so, ho = self.seq_off, self.hdr_off
        return ParsedReads(
            e - s,
            self.codes[so[s] : so[e]],
            self.nmask[so[s] : so[e]],
            (so[s : e + 1] - so[s]).copy(),
            self.headers[ho[s] : ho[e]],
            (ho[s : e + 1] - ho[s]).copy(),
        )


# A FASTA file is cut into one chunk a started _CHUNK_BYTES, parsed at
# once on up to _MAX_THREADS of the usable cores.
_CHUNK_BYTES = 8 << 20
_MAX_THREADS = 8


def parse_threads(nbytes: int, fastq: bool) -> int:
    """Chunks a read file of `nbytes` bytes is parsed in at once: 1 for
    FASTQ ('@' may open a quality line, so no cut is safe)."""
    if fastq:
        return 1
    return max(1, min(len(os.sched_getaffinity(0)), _MAX_THREADS,
                      -(-nbytes // _CHUNK_BYTES)))


def parse_reads_chunked(
    path: str, k: int, fastq: bool, threads: Optional[int] = None,
) -> tuple[ParsedReads, int]:
    """(parsed, chunks): the file parsed by `dbg_parse_reads_into` in
    one pass over up to `threads` chunks (default `parse_threads`) cut
    at record starts, straight into arrays allocated here once
    (np.empty: untouched pages cost nothing) and sized from the file:
    codes, nmask and headers at most its bytes, the offsets at most one
    a `min_rec` bytes and one a chunk.  The result holds views of them;
    only the headers are copied, into `bytes`."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native io unavailable")
    size = os.stat(path).st_size
    if threads is None:
        threads = parse_threads(size, fastq)
    if threads < 1:
        raise ValueError(f"threads must be >= 1, got {threads}")
    # the fewest file bytes one accepted record takes: FASTA '>', the
    # header's newline and more than max(k, 2) bases; FASTQ a newline
    # and 3 bases
    min_rec = 4 if fastq else max(k, 2) + 3
    cap = size // min_rec + threads + 1
    codes = np.empty(size, np.uint8)
    nmask = np.empty(size, np.uint8)
    hdrs = np.empty(size, np.uint8)
    seq_off = np.empty(cap, np.int64)
    hdr_off = np.empty(cap, np.int64)
    out = np.zeros(4, np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.dbg_parse_reads_into(
        os.fsencode(path), k, 1 if fastq else 0, threads, min_rec, size,
        cap, codes.ctypes.data_as(u8p), nmask.ctypes.data_as(u8p),
        hdrs.ctypes.data_as(u8p), seq_off.ctypes.data_as(i64p),
        hdr_off.ctypes.data_as(i64p), out.ctypes.data_as(i64p),
    )
    if rc == -1:
        raise OSError(f"cannot read {path}")
    if rc != 0:
        raise RuntimeError(f"{path} changed while it was parsed")
    n, sb, hb, chunks = (int(v) for v in out)
    return ParsedReads(
        n=n,
        codes=codes[:sb],
        nmask=nmask[:sb].view(bool),
        seq_off=seq_off[: n + 1],
        headers=bytes(hdrs[:hb]),
        hdr_off=hdr_off[: n + 1],
    ), chunks


def parse_reads_python(path: str, k: int, fastq: bool) -> ParsedReads:
    """Same bulk structure via the python spec parser (fallback)."""
    from ..io.fasta import iter_reads
    from ..seq import encode, n_mask

    codes_parts, nm_parts, hdrs = [], [], []
    seq_off, hdr_off = [0], [0]
    for header, seq in iter_reads(path, k, fastq):
        codes_parts.append(encode(seq))
        nm_parts.append(n_mask(seq))
        hdrs.append(header)
        seq_off.append(seq_off[-1] + len(seq))
        hdr_off.append(hdr_off[-1] + len(header))
    return ParsedReads(
        n=len(hdrs),
        codes=(
            np.concatenate(codes_parts) if codes_parts
            else np.zeros(0, np.uint8)
        ),
        nmask=(
            np.concatenate(nm_parts) if nm_parts else np.zeros(0, bool)
        ),
        seq_off=np.array(seq_off, np.int64),
        headers=b"".join(hdrs),
        hdr_off=np.array(hdr_off, np.int64),
    )


def parse_reads(path: str, k: int, fastq: bool, count=None) -> ParsedReads:
    """Bulk parse; native when available, python spec otherwise.
    `count(name, n)`, when given, receives `threads`: the chunks parsed
    at once."""
    if available():
        parsed, chunks = parse_reads_chunked(path, k, fastq)
    else:
        parsed, chunks = parse_reads_python(path, k, fastq), 1
    if count is not None:
        count("threads", chunks)
    return parsed


def format_paths_native(
    headers: bytes,
    hdr_off: np.ndarray,
    status: np.ndarray,
    path_off: np.ndarray,
    paths_flat: np.ndarray,
) -> bytes:
    """Paths-file bytes for aligned reads (status 1/2)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native io unavailable")
    n = len(status)
    hdr_arr = np.frombuffer(headers, np.uint8)
    hdr_off = np.ascontiguousarray(hdr_off, np.int64)
    status = np.ascontiguousarray(status, np.int32)
    path_off = np.ascontiguousarray(path_off, np.int64)
    paths_flat = np.ascontiguousarray(paths_flat, np.int32)
    out_len = ctypes.c_int64(0)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    buf = lib.dbg_format_paths(
        hdr_arr.ctypes.data_as(u8p),
        hdr_off.ctypes.data_as(i64p),
        status.ctypes.data_as(i32p),
        path_off.ctypes.data_as(i64p),
        paths_flat.ctypes.data_as(i32p),
        n,
        ctypes.byref(out_len),
    )
    try:
        return bytes(
            np.ctypeslib.as_array(buf, shape=(out_len.value,))
        ) if out_len.value else b""
    finally:
        lib.dbg_free_buf(buf)


def pack_batch_native(
    parsed: ParsedReads, s0: int, nb: int, B: int, L: int,
):
    """Records [s0, s0+nb) -> (words uint32 [B, ceil(L/16)], nmbits
    uint32 [B, ceil(L/32)], lens int32 [B]), zero-padded — the device
    H2D layout of engine.runner.pack_words_batch, built in one C pass
    in place of the numpy slice, pad and pack."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native io unavailable")
    Lw, Lb = (L + 15) // 16, (L + 31) // 32
    words = np.zeros((B, Lw), np.uint32)
    nmbits = np.zeros((B, Lb), np.uint32)
    lens = np.zeros(B, np.int32)
    codes = np.ascontiguousarray(parsed.codes, np.uint8)
    nmask = np.ascontiguousarray(parsed.nmask).view(np.uint8)
    seq_off = np.ascontiguousarray(parsed.seq_off, np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.dbg_pack_batch(
        codes.ctypes.data_as(u8p),
        nmask.ctypes.data_as(u8p),
        seq_off.ctypes.data_as(i64p),
        s0, nb, L,
        words.ctypes.data_as(u32p),
        nmbits.ctypes.data_as(u32p),
        lens.ctypes.data_as(i32p),
    )
    return words, nmbits, lens


def format_corrected_native(
    headers: bytes,
    hdr_off: np.ndarray,
    status: np.ndarray,
    path_off: np.ndarray,
    paths_flat: np.ndarray,
    seq_off: np.ndarray,
    pool: np.ndarray,
    uoff: np.ndarray,
    ulen: np.ndarray,
    k: int,
) -> bytes:
    """Correction-mode output bytes (reference recoverPath,
    aligner.cpp:270-290 + RC-back, alignerGreedy.cpp:394-399) for
    aligned reads; replaces the former per-read host python loop."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native io unavailable")
    n = len(status)
    hdr_arr = np.frombuffer(headers, np.uint8)
    hdr_off = np.ascontiguousarray(hdr_off, np.int64)
    status = np.ascontiguousarray(status, np.int32)
    path_off = np.ascontiguousarray(path_off, np.int64)
    paths_flat = np.ascontiguousarray(paths_flat, np.int32)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    pool = np.ascontiguousarray(pool, np.uint8)
    uoff = np.ascontiguousarray(uoff, np.int32)
    ulen = np.ascontiguousarray(ulen, np.int32)
    out_len = ctypes.c_int64(0)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    buf = lib.dbg_format_corrected(
        hdr_arr.ctypes.data_as(u8p),
        hdr_off.ctypes.data_as(i64p),
        status.ctypes.data_as(i32p),
        path_off.ctypes.data_as(i64p),
        paths_flat.ctypes.data_as(i32p),
        seq_off.ctypes.data_as(i64p),
        pool.ctypes.data_as(u8p),
        uoff.ctypes.data_as(i32p),
        ulen.ctypes.data_as(i32p),
        k,
        n,
        ctypes.byref(out_len),
    )
    try:
        return bytes(
            np.ctypeslib.as_array(buf, shape=(out_len.value,))
        ) if out_len.value else b""
    finally:
        lib.dbg_free_buf(buf)


def format_notaligned_native(
    headers: bytes,
    hdr_off: np.ndarray,
    status: np.ndarray,
    chars: np.ndarray,
    seq_off: np.ndarray,
) -> bytes:
    """notAligned.fa bytes for non-aligned reads (header + sequence;
    reference alignerGreedy.cpp:400-427).  `chars` is the whole file's
    ASCII base stream with Ns restored."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native io unavailable")
    n = len(status)
    hdr_arr = np.frombuffer(headers, np.uint8)
    hdr_off = np.ascontiguousarray(hdr_off, np.int64)
    status = np.ascontiguousarray(status, np.int32)
    chars = np.ascontiguousarray(chars, np.uint8)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    out_len = ctypes.c_int64(0)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    buf = lib.dbg_format_notaligned(
        hdr_arr.ctypes.data_as(u8p),
        hdr_off.ctypes.data_as(i64p),
        status.ctypes.data_as(i32p),
        chars.ctypes.data_as(u8p),
        seq_off.ctypes.data_as(i64p),
        n,
        ctypes.byref(out_len),
    )
    try:
        return bytes(
            np.ctypeslib.as_array(buf, shape=(out_len.value,))
        ) if out_len.value else b""
    finally:
        lib.dbg_free_buf(buf)
