"""The port's one-pass read parser (`native.parse_reads_chunked`, C entry
`dbg_parse_reads_into`): array for array equal to the python spec
parser (`parse_reads_python`) and to dbgtpu's native parser, on files
cut into several chunks at record starts, and the `parse` span's
`threads` counter."""

import json

import numpy as np
import pytest

import dbgtpu.native
from dbgtpu_torch import cli, native

from . import synth

K = 5
THREADS = (1, 3, 8)


def _fasta(records, wrap=None, eol=b"\n"):
    """FASTA bytes of (header, seq) pairs, sequences wrapped at `wrap`."""
    out = []
    for h, s in records:
        out.append(h + eol)
        step = wrap or max(len(s), 1)
        out.extend(s[i : i + step] + eol for i in range(0, len(s), step))
    return b"".join(out)


def _seqs(seed, n, lo=3, hi=40, alphabet=b"ACGTN"):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return [a[rng.integers(0, len(a), int(rng.integers(lo, hi)))].tobytes()
            for _ in range(n)]


def _cut_records(n_chunks):
    """Records of one byte length, so that the cuts of `n_chunks` chunks
    (the first "\\n>" at or after t * size / T) land on known records;
    rejected records at and right before the cuts, one of each rule."""
    seq_len, n = 24, 60

    def rec(h, s):  # 12-byte headers
        return h + b"#" * (12 - len(h)), s

    good = _seqs(7, n, seq_len, seq_len + 1, b"ACGT")
    records = [rec(b">r%d" % i, s) for i, s in enumerate(good)]
    size = len(_fasta(records))
    length = size // n
    bad = [b"ACGTX" + b"A" * (seq_len - 5),            # a bad byte
           b"ACGT" + b"\n" * (seq_len - 4),            # len 4 <= k
           b"AC" + b"\n" * (seq_len - 2),              # len 2 <= 2
           b"AcGT" + b"A" * (seq_len - 4)]             # lower case
    at = [-(-(size * t // n_chunks) // length) for t in range(1, n_chunks)]
    for j, i in enumerate(at):
        records[i] = rec(b">cut%d" % j, bad[j % len(bad)])
        records[i - 1] = rec(b">pre%d" % j, bad[(j + 1) % len(bad)])
    return records, len(at) + 1


def _case(name):
    """(file bytes, fastq, chunks when cut into 8) of a named case."""
    if name == "multiline":
        recs = [(b">m%d desc" % i, s) for i, s in enumerate(_seqs(1, 80))]
        return _fasta(recs, wrap=7), False, 8
    if name == "reject_at_cut":
        recs, chunks = _cut_records(8)
        return _fasta(recs), False, chunks
    if name == "before_first_header":
        recs = [(b">h%d" % i, s) for i, s in enumerate(_seqs(2, 40))]
        return b"ACGTACGTAC\n\nGGGG\n" + _fasta(recs), False, 8
    if name == "no_trailing_newline":
        recs = [(b">t%d" % i, s) for i, s in enumerate(_seqs(3, 40))]
        return _fasta(recs, wrap=11)[:-1], False, 8
    if name == "empty":
        return b"", False, 1
    if name == "bare_header":
        recs = [(b">", s) for s in _seqs(4, 40)]
        return _fasta(recs), False, 8
    if name == "crlf":
        recs = [(b">c%d" % i, s) for i, s in enumerate(_seqs(5, 40))]
        lf = _fasta(recs[:20], wrap=9)
        return lf + _fasta(recs[20:], wrap=9, eol=b"\r\n") + lf, False, 8
    if name == "fuzz":
        # header lines, empty lines and base lines with a stray '>',
        # '\r' or 'X' now and then
        rng = np.random.default_rng(6)
        a = np.frombuffer(b"ACGTN" * 12 + b">\rX", np.uint8)
        lines = [b">f%d" % i if rng.random() < 0.3 else
                 a[rng.integers(0, len(a), int(rng.integers(0, 16)))].tobytes()
                 for i in range(300)]
        return b"\n".join(lines), False, 8
    if name == "fastq_truncated":
        body = synth.to_fastq(_seqs(8, 40, 1, 30))
        return body + b"@last\nACGTACGT\n+\n", True, 1
    raise KeyError(name)


CASES = ("multiline", "reject_at_cut", "before_first_header",
         "no_trailing_newline", "empty", "bare_header", "crlf", "fuzz",
         "fastq_truncated")


def _assert_same(got, want, where):
    assert type(got.n) is int and got.n == want.n, where
    for f in ("codes", "nmask", "seq_off", "hdr_off"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}.{f}")
    assert type(got.headers) is bytes and got.headers == want.headers, where


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("name", CASES)
def test_chunked_parse_equals_both_parsers(tmp_path, name, threads):
    data, fastq, chunks8 = _case(name)
    path = tmp_path / ("r.fq" if fastq else "r.fa")
    path.write_bytes(data)
    got, chunks = native.parse_reads_chunked(str(path), K, fastq, threads)
    _assert_same(got, native.parse_reads_python(str(path), K, fastq),
                 "python spec")
    _assert_same(got, dbgtpu.native.parse_reads(str(path), K, fastq),
                 "dbgtpu native")
    if threads == 8:
        assert chunks == chunks8
    assert 1 <= chunks <= threads
    if name == "reject_at_cut":
        assert not any(h.startswith((b">cut", b">pre"))
                       for h in got.headers.split(b"#") if h)
    if name not in ("empty", "crlf"):
        assert got.n > 0


def test_one_thread_equals_eight(tmp_path):
    reads, _ = synth.make_dataset(seed=1919, genome_len=6000, k=21,
                                  n_reads=300, n_frac=0.1)
    path = tmp_path / "r.fa"
    path.write_bytes(reads)
    one, c1 = native.parse_reads_chunked(str(path), 21, False, 1)
    eight, c8 = native.parse_reads_chunked(str(path), 21, False, 8)
    assert (c1, c8) == (1, 8) and one.n > 200 and one.nmask.any()
    _assert_same(eight, one, "8 vs 1")
    _assert_same(native.parse_reads(str(path), 21, False), one, "default")
    assert eight.slice_records(7, 90).seq_bytes(3) == one.seq_bytes(10)


def test_thread_count_follows_the_input(monkeypatch):
    monkeypatch.setattr(native.os, "sched_getaffinity",
                        lambda pid: set(range(6)))
    chunk = native._CHUNK_BYTES
    assert native.parse_threads(0, False) == 1
    assert native.parse_threads(chunk, False) == 1
    assert native.parse_threads(chunk + 1, False) == 2
    assert native.parse_threads(100 * chunk, False) == 6
    assert native.parse_threads(100 * chunk, True) == 1
    monkeypatch.setattr(native.os, "sched_getaffinity",
                        lambda pid: set(range(64)))
    assert native.parse_threads(100 * chunk, False) == native._MAX_THREADS


@pytest.mark.parametrize("fastq", [False, True])
def test_parse_span_counts_threads(tmp_path, monkeypatch, fastq):
    """With the recorder on, the `parse` span's `threads` counter reads
    the chunks parsed at once: more than 1 on a FASTA of several chunks,
    1 on FASTQ."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(native, "_CHUNK_BYTES", 1024)
    monkeypatch.setattr(native.os, "sched_getaffinity",
                        lambda pid: set(range(4)))
    reads, unitigs = synth.make_dataset(seed=1920, genome_len=5000, k=21,
                                        n_reads=60)
    if fastq:
        reads = synth.to_fastq(reads.split(b"\n")[1::2])
    rf, uf = tmp_path / "r", tmp_path / "u.fa"
    rf.write_bytes(reads)
    uf.write_bytes(unitigs)
    summary = tmp_path / "s.json"
    argv = ["-r", str(rf), "-k", "21", "-g", str(uf), "--device", "cpu",
            "-f", str(tmp_path / "p"), "-a", str(tmp_path / "na"),
            "--json-summary", str(summary)] + (["-q"] if fastq else [])
    with profile(activities=[ProfilerActivity.CPU]):
        assert cli.main(argv) == 0
    s = json.loads(summary.read_text())
    fields = s["trace"]["fields"]
    (parse,) = [dict(zip(fields, r)) for r in s["trace"]["spans"]
                if r[0] == "parse"]
    assert parse["counters"]["reads"] == s["reads"] > 0
    assert parse["counters"]["threads"] == (1 if fastq else 4)
