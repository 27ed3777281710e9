"""The comparison that decides `correct`: what the timed jobs wrote
against the plain reference.

A job of the greedy mapper reads one read FASTA and writes `paths` (for
each aligned read, in input order, its header line and its path line)
and `notAligned.fa` (every other read, in input order, header and
sequence), and a summary with four counters: reads, aligned,
not_aligned (anchors found, no alignment) and no_overlap (no anchor).

Numbers compared, each with the limit 0 (the output contract is exact):
  - sample_reads_differ: of a sample drawn from the seed of the reads
    that hold a junction (k-1)-mer, those whose outcome in the job's
    files (aligned with this path text, or written to notAligned.fa) is
    not the reference's; and every read without one (bgreat's
    noOverlap, which the reference finds for all reads at once) that the
    job aligned;
  - records_misplaced: records of the two files whose header is not a
    read's, repeated or out of input order, reads in neither file, and
    notAligned.fa sequences that are not the read's;
  - counters_differ: counters of any job's summary that differ from the
    files (reads; aligned against the paths records; not_aligned +
    no_overlap against the notAligned.fa records) or, for no_overlap,
    from the reference's count over every read.
"""

from __future__ import annotations

import numpy as np

from .graph import Graph
from .model import ALIGNED, align_read_greedy, format_path, get_n_overlap
from .seq import encode, n_mask, rc_codes

BLOCK = 131072


def fasta_pairs(blob: bytes) -> tuple[list, list]:
    """(headers, second lines) of a file of two-line records."""
    lines = blob.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    if len(lines) % 2:
        lines.append(b"")
    return lines[0::2], lines[1::2]


_M = (0x3333333333333333, 0x0F0F0F0F0F0F0F0F, 0x00FF00FF00FF00FF,
      0x0000FFFF0000FFFF)


def _kmers_t(codes, n: int):
    """All n-mers of each row of int64 codes [B, L] (n <= 31): [B, L-n+1],
    by doubling (a 2w-mer is a w-mer shifted and or-ed with the w-mer w
    bases on), then the powers of two that make up n."""
    Lk = codes.shape[1] - n + 1
    pw = {1: codes}
    w = 1
    while 2 * w <= n:
        prev = pw[w]
        pw[2 * w] = (prev[:, : prev.shape[1] - w] << (2 * w)) | prev[:, w:]
        w *= 2
    out, acc = None, 0
    for b in sorted(pw, reverse=True):
        if acc + b <= n:
            part = pw[b][:, acc : acc + Lk]
            out = part if out is None else (out << (2 * b)) | part
            acc += b
    return out


def _rcb_t(v, n: int):
    """rcb of int64 n-mers (n <= 31): complement, then reverse the 2-bit
    groups by swaps; the masks clear what an arithmetic shift brings in."""
    x = ~v
    for s, m in zip((2, 4, 8, 16), _M):
        x = ((x & m) << s) | ((x >> s) & m)
    x = (x << 32) | ((x >> 32) & 0xFFFFFFFF)
    return (x >> (64 - 2 * n)) & ((1 << (2 * n)) - 1)


def no_overlap(g: Graph, seqs: list, device="cpu") -> np.ndarray:
    """bool [reads]: the reads with no junction (k-1)-mer, bgreat's
    noOverlap.  A read without N has one, forward or reverse, at the same
    positions, so one scan of canonical (k-1)-mers decides, in blocks of
    reads of one length, on `device` in plain torch; a read with N goes
    through the reference's own scans, forward then reverse."""
    import torch

    k1 = g.k - 1
    out = np.zeros(len(seqs), bool)
    by_len: dict = {}
    for i, s in enumerate(seqs):
        if b"N" in s:
            codes, nm = encode(s), n_mask(s)
            out[i] = (not get_n_overlap(g, codes, nm, 1) or not get_n_overlap(
                g, rc_codes(codes), np.zeros(len(codes), bool), 1))
        else:
            by_len.setdefault(len(s), []).append(i)
    jkeys = torch.from_numpy(g.jkeys.astype(np.int64)).to(device)
    nj = len(g.jkeys)
    for L, rows in by_len.items():
        if L < k1 or nj == 0:
            out[rows] = True
            continue
        for a in range(0, len(rows), BLOCK):
            part = rows[a : a + BLOCK]
            codes = torch.from_numpy(encode(b"".join(
                seqs[i] for i in part)).astype(np.int64))
            codes = codes.reshape(len(part), L).to(device)
            fwd = _kmers_t(codes, k1)
            keys = torch.minimum(fwd, _rcb_t(fwd, k1))
            at = torch.searchsorted(jkeys, keys).clamp_(max=nj - 1)
            hit = (jkeys[at] == keys).any(dim=1)
            out[part] = (~hit).cpu().numpy()
    return out


def _placed(idx: np.ndarray, n: int) -> tuple[int, np.ndarray]:
    """(misplaced records, per-read count) of one file's read indices
    (-1: a header that is no read's)."""
    bad = int((idx < 0).sum())
    ok = idx[idx >= 0]
    bad += int((np.diff(ok) <= 0).sum())
    seen = np.bincount(ok, minlength=n)
    return bad, seen


def compare(g: Graph, read_blob: bytes, paths_blob: bytes, na_blob: bytes,
            summaries: list, m: int, effort: int,
            sample: int, seed: int, device="cpu") -> dict:
    """{name: (value, limit)} of the numbers compared."""
    headers, seqs = fasta_pairs(read_blob)
    n = len(headers)
    index = {h: i for i, h in enumerate(headers)}
    p_hdr, p_path = fasta_pairs(paths_blob)
    n_hdr, n_seq = fasta_pairs(na_blob)
    p_idx = np.array([index.get(h, -1) for h in p_hdr], np.int64)
    n_idx = np.array([index.get(h, -1) for h in n_hdr], np.int64)
    bad_p, seen_p = _placed(p_idx, n)
    bad_n, seen_n = _placed(n_idx, n)
    seen = seen_p + seen_n
    misplaced = bad_p + bad_n + int((seen != 1).sum())
    misplaced += sum(1 for i, s in zip(n_idx.tolist(), n_seq)
                     if i >= 0 and seqs[i] != s)

    none = no_overlap(g, seqs, device)
    ref_no_overlap = int(none.sum())
    counters = 0
    for s in summaries:
        counters += int(s.get("reads") != n)
        counters += int(s.get("aligned") != len(p_hdr))
        counters += int(s.get("not_aligned", -1) + s.get("no_overlap", -1)
                        != len(n_hdr))
        counters += int(s.get("no_overlap") != ref_no_overlap)

    path_of = {int(i): t for i, t in zip(p_idx.tolist(), p_path) if i >= 0}
    differ = int((none & (seen_p > 0)).sum())
    anchored = np.flatnonzero(~none)
    rng = np.random.default_rng([seed, 0x5EED])
    picks = np.sort(rng.choice(anchored, size=min(sample, len(anchored)),
                               replace=False))
    for i in picks.tolist():
        status, path = align_read_greedy(g, encode(seqs[i]), n_mask(seqs[i]),
                                         m, effort)
        got = path_of.get(i)
        if status in ALIGNED:
            differ += int(got is None
                          or got + b"\n" != format_path(path))
        else:
            differ += int(got is not None or seen_n[i] != 1)
    return {
        "sample_reads_differ": (differ, 0),
        "records_misplaced": (misplaced, 0),
        "counters_differ": (counters, 0),
    }
