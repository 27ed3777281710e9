"""The yardstick of the mapping kernels: the H100's peaks, the kernels
by name, and the least time a batch's kernels could take.

Peaks (NVIDIA H100 SXM data sheet, at its 700 W power limit):
  - HBM: 3.35 TB/s, published;
  - 32-bit integer operations: 16.75 Top/s, derived: a quarter of the
    published 67 TFLOP/s of float32, which counts a fused multiply-add as
    two operations on twice as many lanes.

The bound of one batch (one card's share of it under a mesh) is the
larger of its bytes over the HBM rate and its operations over the
integer rate, for the five kernels of the greedy path: K1 read_scan, K2
member, K3 greedy_walk, K4 pack_paths, K8 compact_result (under the mphf
layout K7's lookup runs inline in K2 and K3 and is not a kernel of its
own).  Everything is counted from shapes, once per tensor.  Left out,
because it depends on the data and the bench does not count it: the
index rows K2 and K3 read, K3's junction evaluations and their
operations, K2's lookup operations, K3's path buffers beyond their
lengths, K8's populated slots.  So the bound is low and a share of it
errs low; it never reads over 100% for counting too much.  The
per-unit operation counts are frozen from the kernel bodies in
`dbgtpu_torch/csrc` (as counted in the repository's chip_smoke.py).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 4

# the mapping kernels of the greedy path, by a part of their CUDA name
MAPPING_KERNELS = {
    "read_scan_kernel": "K1 read_scan",
    "member_probe_kernel": "K2 member",
    "member_scan_kernel": "K2 member",
    "member_mphf_kernel": "K2 member",
    "greedy_walk_kernel": "K3 greedy_walk",
    "pack_paths_kernel": "K4 pack_paths",
    "compact_kernel": "K8 compact_result",
}

OPS_BASE_AT = 5     # base_at: i >> 4, i & 15, * 2, shift, and
OPS_NM_BIT = 4      # nm_bit: i >> 5, i & 31, shift, and
OPS_RCB = 9         # rcb: not, brev, 2 x (shift, and), or, 64 - 2n, shift
OPS_PACK_ELEM = 11  # pack_value: case compares (6), index (2), ends (2), pack
# compact.cu per row: row_count, match-any, popcount, lane mask, index,
# rank add in steps 1 and 4; position and the meta copy in step 4
OPS_COMPACT_ROW = 2 * (6 + 4 + 2 + 1) + 2 + 4
PMAX_CAP = 30       # the runner's device path-slot bound


def mapping_kernel(name: str) -> str | None:
    """The mapping kernel a device event's name belongs to, or None."""
    for part, kernel in MAPPING_KERNELS.items():
        if part in name:
            return kernel
    return None


def bucket_len(n: int, k: int) -> int:
    """The runner's padded read length of a batch whose longest read has
    n bases: multiples of 16 up to 256, then of 256."""
    n = max(n, k + 1, 64)
    if n <= 256:
        return ((n + 15) // 16) * 16
    return ((n + 255) // 256) * 256


def pmax_of(L: int, k: int, min_unitig_len: int) -> int:
    """The runner's path-slot bound of a batch of padded length L."""
    stride = max(1, min_unitig_len - (k - 1))
    span = L - (k - 1)
    return min(1 + (span + stride - 1) // stride + 4, max(PMAX_CAP, L // 4))


def ops_read_scan(B: int, Lk: int, Lw: int, k1: int) -> int:
    per_pos = k1 * (OPS_BASE_AT + 2 + 3 + OPS_NM_BIT + 2) + OPS_RCB + 5
    per_word = 16 * (OPS_BASE_AT + 2 + OPS_NM_BIT + 2 + 2 + OPS_BASE_AT + 3)
    return B * (Lk * per_pos + Lw * per_word)


def batch_counts(B: int, read_len: int, k: int, min_unitig_len: int,
                 id_bytes: int) -> tuple[int, int]:
    """(bytes, operations) of the greedy path's kernels on a batch of B
    reads of `read_len` bases (no N).  `id_bytes`: 2 where the path slots
    are int16 (at most 32,767 unitigs), else 4."""
    k1 = k - 1
    L = bucket_len(read_len, k)
    Lw, Lk = (L + 15) // 16, L - k1 + 1
    pmax = pmax_of(L, k, min_unitig_len)
    rows = 3 * B * (2 * Lw + 1) * 4
    plane = B * Lk * 8
    masks = 2 * B * Lk
    fused = B * (2 + pmax) * id_bytes
    k1_bytes = B * Lw * 4 + B * 4 + rows + 4 * plane + B * Lk + 4
    k2_bytes = plane + B * 4 + masks          # rep1 and lens in, masks out
    k3_bytes = masks + B * 4 + rows + 5 * B * 4
    k4_bytes = 4 * B * 4 + fused
    k8_bytes = fused + B * 2 * id_bytes
    ops = (ops_read_scan(B, Lk, Lw, k1)
           + 2 * B * Lk                       # K3's anchor tests
           + B * (pmax + 2) * OPS_PACK_ELEM
           + B * OPS_COMPACT_ROW)
    return k1_bytes + k2_bytes + k3_bytes + k4_bytes + k8_bytes, ops


def bound_s(nbytes: int, ops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)


def job_bound_s(n_reads: int, read_len: int, k: int, min_unitig_len: int,
                n_unitigs: int, batch_size: int, cards: int) -> float:
    """Σ of the batch bounds of one job: its batches, each split into
    `cards` contiguous shards as the runner splits it."""
    id_bytes = 2 if n_unitigs + 1 <= 32767 else 4
    if cards > 1:
        batch_size = -(-batch_size // cards) * cards
    total = 0.0
    for s0 in range(0, n_reads, batch_size):
        nb = min(batch_size, n_reads - s0)
        step = -(-nb // cards)
        for a in range(0, nb, step):
            b = min(a + step, nb)
            total += bound_s(*batch_counts(b - a, read_len, k,
                                           min_unitig_len, id_bytes))
    return total
