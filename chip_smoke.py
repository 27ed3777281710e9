#!/usr/bin/env python3
"""Chip smoke test of dbgtpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Runs with `dbgtpu` and `jax` blocked in sys.modules (the port stands on
its own) and fails if either was imported by the end.  Builds the CUDA
kernels from dbgtpu_torch/csrc (K1-K13; K3 has two entry points, each
its own kernel), then:
  1. prints the card's name and power limit, the kernel build time and
     ptxas's registers and spills per mapping kernel (with the warps per
     SM they allow; with `--baseline-csrc`, those of K2, K3, K5 and K6,
     which run K7's device function inline, beside the baseline's); the
     native parser / formatter must build too;
  2. runs the kernels of each mode's path and their plain torch versions
     on the same CUDA inputs (the first 32,768-read batch of the survey
     workload) and requires exactly equal integer outputs; prints each
     kernel's time alone (back-to-back launches of its C entry point,
     rotating over the survey's 4 batches, into outputs allocated once
     per batch and checked equal to the wrapper's: `alone_ms`), through
     its wrapper (`ms`), its plain version's and its bound.  With
     `--baseline-csrc DIR` the kernels built from DIR (an older tree's
     dbgtpu_torch/csrc) are timed alone beside these in turns (baseline,
     this, this, baseline).  Greedy: K1 read_scan, K2 member, K3
     greedy_walk, K4 pack_paths, K8 compact_result (int16 and int32);
     anchors (-G): K5 dog_anchors, K3 walk_inits (the walk from K5's
     inits); exhaustive (-b): K2's exhaustive mode, K6 exhaustive_dfs.
     The same again on the mphf index as the main path holds it (with
     its probe table, so K2 takes the closure-probe branch on this
     batch; K3, walk_inits, K5 and K6 run K7's device function inline).
     Under each layout K2 once more on the index without its probe table
     (its per-position branch, which batches with N take; no main-path
     launch count goes with that row).  K2 (greedy and exhaustive mode,
     both branches, scan and mphf), K5 (scan and MPHF anchors, efforts 1,
     2 and 5), K3 greedy_walk, K3 walk_inits on K5's inits and K6 (with
     and without -i; scan, mphf and a pool-chunk index) against their
     plain versions on the edge batch (dbgtpu_torch/kernels/edge_batch.py:
     lane-group, window and chunk edges, ragged warps, tied and 0 / 4
     candidates, dead ends, deep searches).  K4 pack_paths and K8
     compact_result against their plain versions at B = 1, 255, 256,
     257, 32,768 and 262,144, pmax = 3, 30, 31, 62 and 120, int16 and
     int32 (K4 on walks with llen / rlen 0 and plen > pmax, K8 on the
     mixed, unaligned, over-pmax, equal-count and full cases); K4 is
     also timed alone by the graph timer (its launches captured into a
     CUDA graph and replayed: the device's own pace, where the
     back-to-back timer from Python reads the host's launch rate),
     beside the floor of both timers, a kernel that does nothing.  K7
     mphf_slots itself against its plain version on the survey junction
     MPHF, the survey anchor MPHF and a tight-gamma MPHF that uses the
     final table, each with keys of the set, keys outside it and the
     all-ones key, and on an empty MPHF; it is timed on the stored keys
     of each survey table, the shape the main path gives it, by both
     timers (with `--baseline-csrc`, in turns with DIR's K7) and through
     its wrapper, and in its check mode on each survey table (the check
     of a table at upload: one launch, a count of the keys at the wrong
     slot) by both timers and through `check_mphf_table`.  The check
     mode against its plain version on tables of 0, 1, 31 and 33 keys, a
     tight-gamma MPHF whose keys reach the final table, and each survey
     table with two rows swapped (a count of exactly 2).  K11
     gather_rows_sum and K12 gather_take_sum against their plain
     versions at the edges of their plan (kernels/edge_batch.py
     gather_edges: direct and bucketed paths, B = 1, J = 1 to 128, slice
     and switch edges, one bucket, 64-bit entries, unaligned tables,
     indices outside the table; reps 0, 1, 8), K2 (both branches) and K3
     greedy_walk on the edge batch's scan index cut into the most ranges
     (up to 8) that dbgtpu's --shard-index guards allow, resident on the
     card, K10 gather_rowsum at the
     edges of its one-launch schedule (rowsum_edges: CH = 1 to 4,097,
     chunk counts around the grid's warp count, warp ranges that end on
     or cross chunk boundaries, W = 1 to 25, an unaligned table, stray
     indices, sums that wrap).  The sharded index (--shard-index,
     `[shard]` lines): the survey scan index cut into 2, 4 and 8 ranges
     resident on the card (peer pointers and local ones are one address
     space), and, where two or more cards reach each other, into one
     range per card; on each, K13 sharded_rows against its plain version
     at every range's first and last row and outside the table, and on
     the upload check's ids and the batch's probe keys by its plan's
     path, timed alone (also by the graph timer; with `--baseline-csrc`
     in turns with DIR's K13), through its wrapper, plain and beside
     `whole[ids]` on the unsharded table, and, on 8 ranges and on the
     real cards, each path forced (direct, staged; the distinct rows
     staged); the
     sparse shape, a seeded [1,048,576, 96] table in 4 ranges on the
     card and one per card, at 917,504 uniform ids; K2 (both branches) and K3
     greedy_walk against their plain versions on the survey batch, timed
     on 8 ranges on one card and on the real cards.  Then
     `tools.exp_gather.main()`, the entry
     point of the gather kernels (counts set to 0 just before, each of the four
     launched > 0 times): K9 gather_rows (G=1 and G=8), K10
     gather_rowsum, K11 and K12 against their plain versions and the one
     PyTorch gather that computes the same function at the "scripts" and
     "beyond_l2" geometries (dbgtpu_torch/tools/exp_gather.py), each
     timed alone (back-to-back launches through its C entry point; K10
     also by the graph timer; with `--baseline-csrc` in turns with
     DIR's) and through its wrapper; K11 and K12 with their plan and,
     bucketed, each pass alone;
  3. maps the survey workload (2 Mbp genome, ~30.7k unitigs of 40-150
     bp, 131,072 reads of 100 bp, k=31, m=2, e=2, batch 32,768) through
     `dbgtpu_torch.cli.main` in greedy mode, with -G and with -b, under
     `--index-layout scan` and then `--index-layout mphf`, bytes equal
     across the layouts, and requires each path's kernels to be launched
     > 0 times in its own run and no other kernel launched (counts set
     to 0 just before each run).  mphf_slots counts only launches of the
     standalone K7 kernel: one per MPHF table of the run's index and
     card of the run (its check at upload, whatever the table's size),
     none under the scan layout.  Then
     `--save-index` followed by `--load-index` in greedy/scan, -G/mphf
     and -b/scan:
     bytes equal to the built run, the mode's kernels launched,
     mphf_slots still once per MPHF table, the loaded run's index seconds
     printed beside the built run's; and one `--resume` run killed after
     its first segment and resumed, bytes equal;
  4. requires byte equality with the port's executable spec
     (dbgtpu_torch.spec.run_pipeline) and each kernel of the mode equal
     to its plain version on each of these files: scan layout as before
     (survey prefix, k=21 with N, probe-less, pool-chunk, k=32 with
     300-bp reads, pmax overflow); mphf layout: the survey prefix in
     every mode, k=21 with N in every mode, probe-less, k=32 -G; and -G
     on a scan-layout index whose dog keyset takes the MPHF anchor
     layout (ANCHOR_MPHF_MIN lowered); `-p` and `-p -b` on the first 512
     survey reads against the spec (host only: no kernel may launch), and
     a run sharded over 2 processes and merged against the single run;
  5. the run modes.  `[runner]`: 1,048,576 reads of 100 bp on the survey
     genome (32 batches of 32,768; survey_workload's generator and seed)
     through `cli.main` from a loaded index, greedy / scan and -G / mphf,
     four times: this tree's pipelined runner and, with
     `--baseline-runner FILE` (an older tree's
     dbgtpu_torch/engine/runner.py, loaded into this tree's engine
     package), that runner, in turns (baseline, this, this, baseline,
     twice); each run's align_seconds, mapping and
     end-to-end reads/s, the legs per batch (launch, drain, the drain's
     wait for the device, the launching thread's wait for the drain),
     peak device memory, payload bytes and launches, then one run of
     each under torch.profiler for the device busy share; bytes equal
     across every run and, on 128 reads of each batch, to the spec.
     `[mesh]`: `--mesh -1` (every local device) in greedy / scan and -b /
     mphf, bytes equal to the run without a mesh, launches checked as in
     phase 3.  `[shard-index]`: `--mesh -1 --shard-index` in greedy /
     scan (with one card `--mesh 1 --shard-index`, a mesh of one device
     holding the tables as one range; the line says which ran): bytes
     equal to the run without a mesh, sharded_rows launched twice per
     card (the upload's check of each table), the index bytes each card
     holds; `-G`, `-b` and `--index-layout mphf` with `--shard-index
     --mesh 1` each raise dbgtpu's ValueError text and write nothing.
     `[coordinator]`: two processes on the card joined by
     `--coordinator 127.0.0.1:<free port> --num-processes 2` (each with
     jax and dbgtpu blocked): process 0's stats block holds the whole
     file's counts, process 1 prints none, the merged shards equal the
     single run.  `[profile]`: greedy / scan with `--profile-dir`: the
     trace names the `__global__` functions of K1, K2, K3, K4 and K8, the
     bytes equal the run without the profiler;
  6. prints the kernels' JSON line and, last, the result line.  The
     line holds each kernel once with the launches of its scan-layout
     run and that run's batch timings, and `<kernel>@mphf` entries for
     K2, K3, walk_inits, K5 and K6 with the launches of the
     `--index-layout mphf` runs and the timings on the mphf index; K9-K12
     carry the launches of the `tools.exp_gather.main()` run and their
     "scripts" timings; sharded_rows, member@shard and greedy_walk@shard
     carry the launches of the `[shard-index]` run, K13 its timing at the
     upload check's shape (the batch's probe keys under `batch`), K2 and
     K3 their timings on 8 ranges on one card.
Any failure raises, and the script exits non-zero without a result.

Bounds.  `bound_ms` is the larger of bytes / 3.35e12 B/s (the H100's
published memory rate) and operations / 16.75e12 op/s (32-bit integer
operations: a quarter of the published 67 TFLOP/s of float32, which
counts a fused multiply-add as two on twice as many lanes).  Bytes are
the tensors a kernel must read and write once, plus the table rows this
batch's lookups touch (never more than the table).  For K3 and K6 the
lookups are every junction evaluation the function makes, counted by
the plain versions (engine/walk.py count_probe; K3's successful and
failed steps, K6's populated frames): per evaluation the junction row's
32 key-hi words and, where the key is found, a key-lo sector and a
values sector (MPHF: the level row and the jrows row), and per valid
candidate the sectors of its umeta header and window words; of the
k-mer planes bug and rcs, only the sectors read at the anchors (K3's
greedy entry: the first E forward and last E RC anchors of each read;
K6: each anchor FETCHX takes; walk.count_read_sectors).  K6's stack is
the kernel's own scratch, not part of the function, and stays out of
its bound.  K1's outputs are the tensors it hands to K2-K6
(four int64 k-mer planes, a byte plane, the packed rows); its bound
from the packed batch in and the packed rows out alone is printed
beside it.  Operations are counted from the kernel bodies, per position,
slot, evaluation, candidate, window word or key: the OPS_* constants and
ops_* functions below.  For
the gathers K9-K12 they are what the function needs whatever the
kernel's layout (tools/exp_gather.py): no operation for K9's copy, one
add per table word summed for K10-K12.  K13's bound counts the ids,
its rows written and the distinct table rows the ids ask for, read
once; those in shards on other cards cross NVLink at 450 GB/s into the
card, and the byte time is the larger of that and the memory's
(kernels/measure.py).  `library_ms` is the time of one PyTorch
call that computes the same function: for K9-K12 a gather, for K13
`whole[ids]` on the unsharded table, for the mapping kernels none
(null).
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# the timer and the bound convention, shared with torch_profile.py and
# dbgtpu_torch/tools/exp_gather.py
from dbgtpu_torch.kernels.measure import (  # noqa: F401
    HBM_BYTES_PER_S, INT_OPS_PER_S, cuda_ms, graph_ms, in_turns,
    launch_floor_ms, on, turns,
)
from dbgtpu_torch.kernels.measure import bound_ms as bound_of

ROOT = Path(__file__).resolve().parent
SCRATCH = ROOT / "build" / "chip_smoke"

# the survey workload (SURVEY.md §6): the same seed and steps as the JAX
# package's benchmark, so both map the same reads
SEED, GENOME_LEN, K, M, EFFORT, READ_LEN = 20260817, 2_000_000, 31, 2, 2, 100
BATCH, N_BATCHES = 32768, 4

# Integer operations per unit of work, counted from the kernel bodies in
# dbgtpu_torch/csrc.  A shift, mask, add, compare, select, multiply,
# popcount or bit reversal is one operation, an index computation counts
# its arithmetic, a load, store or branch is none.  Where the work
# depends on the data the count is the least a unit can do (one level of
# an MPHF, one candidate and one window word of a junction step), so the
# operation time is a lower bound like the byte time.
# the least a device memory read moves (one sector), for a table row
# of which the function needs one slot's word
SECTOR_BYTES = 32
OPS_MIX32 = 10      # common.cuh mix32: mul, xor, 3 x (shift, xor), 2 mul
OPS_BASE_AT = 5     # base_at: i >> 4, i & 15, * 2, shift, and
OPS_NM_BIT = 4      # read_scan.cu nm_bit: i >> 5, i & 31, shift, and
OPS_RCB = 9         # rcb: not, brev, 2 x (shift, and), or, 64 - 2n, shift
OPS_WORD_AT = 8     # word_at: s >> 4, s & 15, * 2, 2 range tests, 2 shifts, or
# mphf.cuh mphf_slot, one level: 2 seed xors, mix32, mask, word and bit
# index (2), row address (shift, add, multiply), word select, bit test (2)
OPS_MPHF_LEVEL = 2 + OPS_MIX32 + 1 + 2 + 3 + 1 + 2
# the rank at a hit: popcount + add of the words below (0-3, mean 1.5),
# then the bit mask (shift, subtract), and, popcount, add
OPS_MPHF_RANK = 3 + 5
# mphf_row: slot range (2), row address (2), two key compares and an and
OPS_MPHF_VERIFY = 7
# junction.cuh probe_candidate without its window: row address (2), four
# joins (8), orientation (1), ended (2), window start (4), signed id (2),
# the follow-on selects (2), read start and window length (8)
OPS_CANDIDATE = 29
# window_miss, one 16-base word: two word_at, xor, the 2-bit compare (3),
# the N-mask word_at and or, the lane mask (5), popcount and add
OPS_WINDOW_WORD = 2 * OPS_WORD_AT + 1 + 3 + OPS_WORD_AT + 1 + 5 + 2
OPS_WALK_UPDATE = 8  # walk.cu junction: budget, buffer index clamp (2),
#                      length, position, k-mer, phase, status


def ops_scan_lookup(slots: int, vals: int) -> int:
    """common.cuh st_lookup / dog.cu at_lookup of one key: split (2), seed
    xor, mix32, bucket mask, row address (2), per slot two compares and
    an and, then `vals` adds for the one matching slot."""
    return 2 + 1 + OPS_MIX32 + 1 + 2 + 3 * slots + vals


def ops_mphf_lookup(vals: int, verify: bool = True) -> int:
    """mphf.cuh mphf_slot (+ mphf_row) of a key of the set that hits at
    its first level, which nearly every key does at gamma 16; a key
    outside the set visits every level, so this is the least."""
    return (2 + OPS_MPHF_LEVEL + OPS_MPHF_RANK
            + (OPS_MPHF_VERIFY if verify else 0) + vals)


def ops_read_scan(B: int, Lk: int, Lw: int, k1: int) -> int:
    """read_scan.cu.  Per scan position: k1 steps of base_at, the std
    shift-or (2), the N test of the bug scan (compare, nm_bit, and,
    select) and its shift-or (2); then rcb, 3 compares and 2 selects.
    Per packed-row word: 16 bases of base_at + shift-or forward, nm_bit +
    shift-or for the N row, and compare, index, base_at, complement,
    shift-or for the RC row."""
    per_pos = k1 * (OPS_BASE_AT + 2 + 3 + OPS_NM_BIT + 2) + OPS_RCB + 5
    per_word = 16 * (OPS_BASE_AT + 2 + OPS_NM_BIT + 2 + 2 + OPS_BASE_AT + 3)
    return B * (Lk * per_pos + Lw * per_word)


def ops_member_probe(windows: int, positions: int, pt_slots: int,
                     window: int) -> int:
    """member.cu closure-probe branch as the function needs it.  Per
    window of `window` positions one probe: split (2), seed xor, mix32,
    bucket mask, row address (2); per slot two compares, an and and
    window - 2 adds.  Per valid position the bit pick: the window's probe
    position (5), orientation (1), the neighbour-bit index (clamp,
    base_at, 3 of arithmetic), the bit (3) and the valid test (3)."""
    return (windows * (2 + 1 + OPS_MIX32 + 1 + 2 + pt_slots * (3 + window - 2))
            + positions * (5 + 1 + (2 + OPS_BASE_AT + 3) + 3 + 3))


def ops_junction_eval(j_lookup: int) -> int:
    """One junction evaluation of walk.cu / exhaustive.cu besides its
    candidates: the reverse complement, canonical compare and select,
    the lookup with the 4 values of its side (`j_lookup`), the side
    select and the walk's state update."""
    return OPS_RCB + 2 + j_lookup + 1 + OPS_WALK_UPDATE


# dog.cu per scanned k-mer besides its lookup: kmer_at (two word_at, shift
# and or, rev_groups 6, the final shift 2), rcb, compare and select
OPS_DOG_KMER = 2 * OPS_WORD_AT + 2 + 6 + 2 + OPS_RCB + 2
# dog.cu Place per anchor: metadata address (2), orientation (2),
# oriented position (3), joins and selects (10), the four-case geometry
# (13), 9 plane stores of address (5) + value (1), one window word
OPS_DOG_PLACE = 2 + 2 + 3 + 10 + 13 + 9 * 6 + OPS_WINDOW_WORD
OPS_PACK_ELEM = 11   # pack.cu pack_value: the case compares (6), source
#                      index (2), next column and row end (2), the pack (1)
# compact.cu per row, in steps 1 and 4 each: row_count (row address 2, 2
# compares, or, min), match-any + popcount + lane mask (4), the leader's
# table index (2), the rank add (1); in step 4 its position (2) and the
# meta copy (2 elements, address 2 each)
OPS_COMPACT_ROW = 2 * (6 + 4 + 2 + 1) + 2 + 4


def ops_compact_slot(pmax: int) -> int:
    """compact.cu per populated slot: the binary search for its column
    (compare, select and midpoint per level of ceil(log2 pmax)), the
    position, the global rank (4 adds) and the source address (3)."""
    return 3 * max(1, (pmax - 1).bit_length()) + 1 + 4 + 3


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
    ("mphf_slots", "dbgtpu_torch/csrc/mphf.cu", "dbgtpu/engine/core.py:293"),
    ("compact_result", "dbgtpu_torch/csrc/compact.cu",
     "dbgtpu/engine/core.py:1529"),
)
# K9-K12: the Pallas kernels of the gather experiments, launched by
# dbgtpu_torch/tools/exp_gather.py and by no mapping run
GATHER_KERNELS = (
    ("gather_rows", "dbgtpu_torch/csrc/gather.cu",
     "scripts/exp_r5_pallas.py:93"),
    ("gather_rowsum", "dbgtpu_torch/csrc/gather.cu",
     "scripts/exp_r5_pallas.py:138"),
    ("gather_rows_sum", "dbgtpu_torch/csrc/gather.cu",
     "scripts/archive/exp_pallas_gather.py:40"),
    ("gather_take_sum", "dbgtpu_torch/csrc/gather.cu",
     "scripts/archive/exp_pallas_gather.py:81"),
)
# the kernels each mode's path launches under the scan layout (an index
# with MPHF tables adds mphf_slots: one launch of K7's kernel per table
# at upload; the lookups of K2-K6 run its device function inline), and
# the (layout, mode) run that gives each kernel's launches and times in
# the JSON line
PATH_KERNELS = {
    "greedy": ("read_scan", "member", "greedy_walk", "pack_paths",
               "compact_result"),
    "anchors": ("read_scan", "dog_anchors", "walk_inits", "pack_paths",
                "compact_result"),
    "exhaustive": ("read_scan", "member", "exhaustive_dfs", "pack_paths",
                   "compact_result"),
}
TIMED_IN = {"dog_anchors": ("scan", "anchors"),
            "walk_inits": ("scan", "anchors"),
            "exhaustive_dfs": ("scan", "exhaustive"),
            "mphf_slots": ("mphf", "greedy")}
# the kernels that run K7's device function inline under an MPHF layout:
# name -> (mode of its path, the mphf branch of the TPU-era stage); each
# gets a `<name>@mphf` entry in the JSON line.  K2 takes that branch only
# where it looks up per position (batches with N, probe-less indexes); on
# the survey batch its @mphf entry is the closure-probe branch again.
MPHF_ENTRIES = {
    "member": ("greedy", "dbgtpu/engine/core.py:434"),
    "greedy_walk": ("greedy", "dbgtpu/engine/core.py:409"),
    "walk_inits": ("anchors", "dbgtpu/engine/core.py:409"),
    "dog_anchors": ("anchors", "dbgtpu/engine/dog.py:68"),
    "exhaustive_dfs": ("exhaustive", "dbgtpu/engine/core.py:409"),
}
# K13 and the kernels that read a sharded index (--shard-index) through
# csrc/common.cuh scan_row: the `<kernel>@shard` entries of the JSON line
SHARD_KERNELS = (
    ("sharded_rows", "dbgtpu_torch/csrc/shard.cu",
     "dbgtpu/engine/core.py:351"),
    ("member@shard", "dbgtpu_torch/csrc/member.cu",
     "dbgtpu/engine/core.py:498"),
    ("greedy_walk@shard", "dbgtpu_torch/csrc/walk.cu",
     "dbgtpu/engine/core.py:388"),
)
MODE_FLAGS = {"greedy": [], "anchors": ["-G"], "exhaustive": ["-b"]}
# what the kernels' JSON line states of a kernel besides its name, route,
# source, the stage it replaces and its launches
KERNEL_KEYS = ("max_abs_err", "ms", "alone_ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def block_reference_packages() -> None:
    """Make `import dbgtpu` and `import jax` fail: the port and this
    script must run without either."""
    for name in ("dbgtpu", "jax"):
        if name in sys.modules and sys.modules[name] is not None:
            raise AssertionError(f"{name} was imported before the run")
        sys.modules[name] = None


def assert_reference_packages_unused() -> None:
    bad = [n for n, mod in sys.modules.items()
           if n.split(".")[0] in ("dbgtpu", "jax", "jaxlib")
           and mod is not None]
    if bad:
        raise AssertionError(f"imported during the run: {bad[:5]}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def survey_workload():
    """(unitig_seqs list[bytes], reads [131072, 100] uint8 codes), cached
    under SCRATCH."""
    import numpy as np

    from dbgtpu_torch.seq import encode
    from tests import synth

    cache = SCRATCH / "workload.npz"
    key = f"{SEED}-{GENOME_LEN}-{K}-{READ_LEN}-{BATCH * N_BATCHES}"
    if cache.exists():
        z = np.load(cache, allow_pickle=True)
        if str(z["key"]) == key:
            return list(z["unitigs"]), z["codes"]
    rng = np.random.default_rng(SEED)
    genome = synth.make_genome(rng, GENOME_LEN)
    unitigs = synth.chop_unitigs(genome, K, rng, 40, 150)
    unitigs = synth.orient_shuffle(unitigs, rng)
    reads = synth.sample_reads(genome, rng, BATCH * N_BATCHES, READ_LEN,
                               err_frac=0.5)
    codes = np.stack([encode(r) for r in reads])
    np.savez(cache, key=key, unitigs=np.array(unitigs, dtype=object),
             codes=codes)
    return unitigs, codes


def _max_abs_err(got, want) -> int:
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"shape/dtype {tuple(got.shape)} {got.dtype} != "
            f"{tuple(want.shape)} {want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


# another tree's kernels, timed alone beside this tree's in turns when
# chip_smoke.py / torch_profile.py get --baseline-csrc (build.load_from)
BASELINE = {"lib": None}
ALONE_LAUNCHES, ALONE_REPS = 50, 5
TIMED_LAUNCHES = 200    # time_both: launches a run of a short kernel


def time_alone(name, alones, graph: bool = False) -> dict:
    """Kernel `name` alone: ALONE_LAUNCHES back-to-back launches of its C
    entry point, the median of ALONE_REPS runs.  `alones` holds one
    (prep, pairs_of) per batch of the run: prep() gives the kernel's
    launch on that batch into outputs allocated once, and those outputs;
    pairs_of(outputs) pairs them with the wrapper's result on the batch.
    The launches rotate over the batches, so a launch does not find the
    rows the previous one read still in L2 (a real run maps one batch
    after another); each batch's outputs must then equal the wrapper's.
    With a baseline library, the baseline and this tree's kernel in
    turns (baseline, this, this, baseline) on the same inputs, and the
    baseline's outputs must equal the wrapper's too.  `graph`: also the
    same rotation captured into a CUDA graph (`graph_rotation`, in
    turns with the baseline's kernel when there is one)."""
    import torch

    preps = [(prep(), pairs_of) for prep, pairs_of in alones]
    base = BASELINE["lib"]
    graphed = in_turns(lambda lib: graph_rotation(name, alones, lib), base,
                       "graph_") if graph else {}

    def timed(lib):
        turn = itertools.count()
        lib = this_or(lib)

        def launch():
            (go, _), _ = preps[next(turn) % len(preps)]
            go(lib)

        return cuda_ms(launch, ALONE_REPS, launches=ALONE_LAUNCHES)

    def check(who):
        torch.cuda.synchronize()
        for (_, outputs), pairs_of in preps:
            err = max(_max_abs_err(g, w) for g, w in pairs_of(outputs))
            if err:
                raise AssertionError(f"{name}: {who} alone != the "
                                     f"wrapper's result (max abs err {err})")

    alone = in_turns(timed, base, "alone_")
    check("the kernel")
    if base is not None:
        for (go, _), _ in preps:
            go(base)
        check("the baseline kernel")
    return dict(**alone, alone_batches=len(preps), **graphed)


def this_or(lib):
    """`lib`, or this tree's kernel library for None, looked up once: a
    timer of launches from Python must not charge this tree's launches a
    library lookup (`build.load`, a lock) that the baseline's skip."""
    from dbgtpu_torch.kernels import build

    return build.load() if lib is None else lib


def graph_rotation(name, alones, lib) -> float:
    """`time_alone`'s rotation over the batches captured into a CUDA
    graph (ALONE_LAUNCHES launches, each batch's outputs and launch bound
    inside the capture) and replayed: ms a launch; every batch's outputs
    of the replays must equal the wrapper's."""
    runs = []

    def bind():
        runs[:] = [(prep(), pairs_of) for prep, pairs_of in alones]
        turn = itertools.count()

        def launch():
            (go, _), _ = runs[next(turn) % len(runs)]
            go(lib)

        tensors = []
        for (_, outputs), _ in runs:
            tensors.extend(outputs if isinstance(outputs, (tuple, list))
                           else (outputs,))
        return launch, tensors

    ms, _ = graph_ms(bind, ALONE_REPS, ALONE_LAUNCHES)
    for (_, outputs), pairs_of in runs:
        err = max(_max_abs_err(g, w) for g, w in pairs_of(outputs))
        if err:
            raise AssertionError(f"{name}: the graph's launches != the "
                                 f"wrapper's result (max abs err {err})")
    return ms


def compare_kernels(ix, words, nmbits, lens, *, mode, k, m, effort, L, pmax,
                    timed: bool, partial: bool = False, perpos_ix=None,
                    more=(), remote_share: float = 0.0):
    """Each kernel of `mode`'s path against its plain version on the same
    CUDA inputs.  Integer outputs must be exactly equal (tolerance 0).
    Returns {name: dict(max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms, and the bound's inputs bound_bytes and bound_ops)}; K2's
    exhaustive mode is "member (inter)", K8 on the other result dtype
    "compact_result (int32)" or "(int16)".  `perpos_ix` (the same index
    without its probe table) adds K2 on its per-position branch as
    "member (per-position)" / "member (inter, per-position)".  `more`
    holds the run's other batches, (words, nmbits, lens) each: the alone
    timer rotates over them and this one.  On an index sharded over cards
    `remote_share` of the table rows read lie on other cards (the bounds
    count their bytes over NVLink too); the table bytes are the whole
    table's."""
    import types

    import torch

    from dbgtpu_torch.engine.compact import (
        compact_ref, compact_result, compact_result_launch,
    )
    from dbgtpu_torch.engine.dog import (
        anchor_lookup_ref, dog_anchors, dog_anchors_launch, dog_anchors_ref,
    )
    from dbgtpu_torch.engine.exhaustive import (
        exhaustive_dfs, exhaustive_dfs_launch, exhaustive_ref,
    )
    from dbgtpu_torch.engine.kmer import le_ref, rcb_ref
    from dbgtpu_torch.engine.member import (
        inter, inter_ref, member, member_launch, member_ref,
    )
    from dbgtpu_torch.engine.pack import (
        out_dtype_for, pack_paths, pack_paths_launch, pack_ref,
    )
    from dbgtpu_torch.engine.read_scan import (
        _scan, read_scan, read_scan_launch, read_scan_ref, unpack_fields,
    )
    from dbgtpu_torch.engine.walk import (
        greedy_walk, greedy_walk_launch, walk_inits, walk_inits_launch,
        walk_inits_ref, walk_ref,
    )

    k1 = k - 1
    B = words.shape[0]
    out = {}
    jl_mphf = ix.mph_meta is not None
    # bytes of one junction lookup and of the junction table
    j_row = 20 + 40 if jl_mphf else ix.st_fused.shape[1] * 4
    j_table = (nbytes(ix.mph_rows, ix.mph_jrows, ix.mph_f) if jl_mphf
               else nbytes(*ix.st_shards or [ix.st_fused]))

    def j_ops(vals):
        return (ops_mphf_lookup(vals) if jl_mphf
                else ops_scan_lookup(ix.st_slots, vals))

    u_row = ix.umeta.shape[1] * 4
    dtype = out_dtype_for(ix.umeta.shape[0], L)
    xw = dict(k=k, m=m, partial=partial, L=L)
    kw = dict(k=k, m=m, effort=effort, L=L)

    def chain(words, nmbits, lens):
        """The mode's path through the wrappers on one batch: every
        kernel's inputs and outputs there."""
        c = types.SimpleNamespace(lens=lens)
        c.sk = read_scan(words, nmbits, lens, L=L, k1=k1)
        if mode == "greedy":
            c.mk = member(ix, c.sk, lens, L=L, k1=k1)
            c.wk = greedy_walk(ix, c.sk, *c.mk, lens, **kw)
        elif mode == "anchors":
            c.ik = dog_anchors(ix, c.sk.rows, lens, **kw)
            c.wk = walk_inits(ix, c.sk.rows, lens, c.ik, k=k, L=L)
        elif mode == "exhaustive":
            c.xk = inter(ix, c.sk, lens, L=L, k1=k1)
            c.wk = exhaustive_dfs(ix, c.sk, c.xk, lens, **xw)
        else:
            raise ValueError(mode)
        c.pk = pack_paths(c.wk, pmax=pmax, dtype=dtype)
        c.words, c.nmbits = words, nmbits
        return c

    c0 = chain(words, nmbits, lens)
    chains = [c0] + ([chain(*b) for b in more] if timed else [])
    sk, wk, pk = c0.sk, c0.wk, c0.pk

    def record(name, pairs, fk, fr, *, stream, touched=0, table=0, ops,
               alone, reps_k=20, reps_r=3, min_stream=None, graph=False):
        """`alone(c)` = (prep, pairs_of) on the batch of chain c: prep()
        allocates the kernel's outputs once and gives (its build.Launch,
        those outputs); pairs_of(outputs) pairs them with the wrapper's
        result on that batch.  `graph`: the alone time by the graph
        timer too."""
        torch.cuda.synchronize()
        err = max(_max_abs_err(g, w) for g, w in pairs)
        if err:
            raise AssertionError(f"{name}: kernel != plain version "
                                 f"(max abs err {err})")
        bound_ms, bound_by = bound_of(stream, touched, table, ops,
                                      remote_share)
        ms = cuda_ms(fk, reps_k) if timed else None
        pms = cuda_ms(fr, reps_r) if timed else None
        # no one PyTorch call computes any of these kernels' functions
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None,
                         bound_bytes=stream + min(touched, table),
                         bound_ops=ops, alone_ms=None)
        if min_stream is not None:
            out[name]["bound_min_bytes_ms"] = bound_of(
                min_stream, 0, 0, 0)[0]
        if timed:
            out[name].update(time_alone(name, [alone(c) for c in chains],
                                        graph=graph))

    def walk_out_bytes(w):
        return 5 * B * 4 + 4 * int(w.llen.sum() + w.rlen.sum())

    def probe_cost(counts):
        """(touched, ops) of the junction evaluations the plain version
        counted (engine/walk.py count_probe): per evaluation the table
        row's 32 key-hi words, and where the key was found a key-lo
        sector and a values sector (MPHF: the level row and the jrows
        row), its lookup and the walk's update; per valid candidate the
        sectors of its umeta header and window words, OPS_CANDIDATE and
        OPS_WINDOW_WORD per window word."""
        n = counts["evals"]
        touched = (n * j_row if jl_mphf else
                   n * ix.st_slots * 4 + counts["found"] * 2 * SECTOR_BYTES)
        ops = (n * ops_junction_eval(j_ops(4)) + counts["cands"] * OPS_CANDIDATE
               + counts["words"] * OPS_WINDOW_WORD)
        return touched + counts["sectors"] * SECTOR_BYTES, ops

    sr = read_scan_ref(words, nmbits, lens, L=L, k1=k1)
    Lk = sk.bug.shape[1]
    record("read_scan", list(zip(sk, sr)),
           lambda: read_scan(words, nmbits, lens, L=L, k1=k1),
           lambda: read_scan_ref(words, nmbits, lens, L=L, k1=k1),
           stream=nbytes(words, nmbits, lens, *sk),
           ops=ops_read_scan(B, Lk, words.shape[1], k1),
           alone=lambda c: (
               lambda: read_scan_launch(c.words, c.nmbits, c.lens, L=L,
                                        k1=k1),
               lambda s: list(zip(s, c.sk))),
           min_stream=nbytes(words, nmbits, lens, sk.rows))
    has_n = bool(sk.has_n.item())

    # positions a read's masks must answer (i <= len - k1) and, for the
    # closure probes, the windows of W positions that cover them
    nvalid = (lens.to(torch.int64) - k1 + 1).clamp(0, Lk)
    valid = torch.arange(Lk, device=lens.device)[None, :] < nvalid[:, None]

    def member_cost(ix_, masks):
        """(stream, touched, table, ops) of K2 writing `masks` (its
        outputs on this batch: member1 and member2, or inter) from the
        index ix_, as the function needs them on the valid positions.  A
        probe of a fused row must read the row's S slot key-hi words; one
        that finds its key also reads a key-lo sector and, for a closure
        probe, one sector of each of the W - 2 neighbour-word arrays it
        sums (a found key sets the self bit of the probe position, so
        counting those bits never overcounts).  An MPHF lookup reads its
        level row and its verify row.  rep2 needs a lookup only where it
        differs from rep1.  The exhaustive per-position branch also takes
        the reverse complement and the smaller of the two (OPS_RCB + 2)."""
        n_masks = len(masks)
        positions = int(nvalid.sum())
        if ix_.pt_rows.shape[0] > 0 and not has_n:
            W = ix_.pt_window
            S = ix_.pt_rows.shape[1] // W
            windows = int(((nvalid + W - 1) // W).sum())
            p = (torch.arange(0, Lk, W, device=lens.device) + 1).clamp(
                max=Lk - 1)
            found = int((masks[0][:, p] != 0).sum())
            return dict(
                stream=nbytes(sk.rep1, sk.le1, sk.rows[0], lens)
                + n_masks * B * Lk,
                touched=windows * S * 4 + found * SECTOR_BYTES * (W - 1),
                table=nbytes(*ix_.pt_shards or [ix_.pt_rows]),
                ops=ops_member_probe(windows, positions, S, W))
        found = int((masks[0][:, 1:].bool() & valid[:, 1:]).sum())
        lookups = positions
        if n_masks == 2:
            differ = (sk.rep2 != sk.rep1) & valid
            lookups += int(differ.sum())
            found += int((masks[1].bool() & differ).sum())
        return dict(
            stream=n_masks * nbytes(sk.rep1) + nbytes(lens)
            + n_masks * B * Lk,
            touched=(lookups * j_row if jl_mphf else
                     lookups * ix_.st_slots * 4 + found * SECTOR_BYTES),
            table=j_table,
            ops=lookups * j_ops(0) + positions * (
                3 + (OPS_RCB + 2 if n_masks == 1 else 0)))

    def member_alone(ix_, exhaustive):
        """K2 alone on chain c's batch, against the wrapper there."""
        def alone(c):
            if exhaustive:
                want = c.xk if ix_ is ix else inter(ix_, c.sk, c.lens, L=L,
                                                    k1=k1)
                return (lambda: member_launch(ix_, c.sk, c.lens, L=L, k1=k1,
                                              exhaustive=True),
                        lambda x: [(x, want)])
            want = c.mk if ix_ is ix else member(ix_, c.sk, c.lens, L=L,
                                                 k1=k1)
            return (lambda: member_launch(ix_, c.sk, c.lens, L=L, k1=k1,
                                          exhaustive=False),
                    lambda r: list(zip(r, want)))
        return alone

    if mode == "greedy":
        mk = c0.mk
        record("member", list(zip(mk, member_ref(ix, sk, lens, L=L, k1=k1))),
               lambda: member(ix, sk, lens, L=L, k1=k1),
               lambda: member_ref(ix, sk, lens, L=L, k1=k1),
               alone=member_alone(ix, False), **member_cost(ix, mk))
        if perpos_ix is not None:
            px = perpos_ix
            mp = member(px, sk, lens, L=L, k1=k1)
            record("member (per-position)",
                   list(zip(mp, member_ref(px, sk, lens, L=L, k1=k1))),
                   lambda: member(px, sk, lens, L=L, k1=k1),
                   lambda: member_ref(px, sk, lens, L=L, k1=k1),
                   alone=member_alone(px, False), **member_cost(px, mp))
        counts = {}
        wr = walk_ref(ix, sk, *mk, lens, counts=counts, **kw)
        touched, ops = probe_cost(counts)
        record("greedy_walk", walks_pairs(wk, wr),
               lambda: greedy_walk(ix, sk, *mk, lens, **kw),
               lambda: walk_ref(ix, sk, *mk, lens, **kw), reps_r=2,
               alone=lambda c: (
                   lambda: greedy_walk_launch(ix, c.sk, *c.mk, c.lens, **kw),
                   lambda w: walks_pairs(w, c.wk)),
               # bug and rcs: the sectors read at the anchors
               stream=nbytes(*mk, lens, sk.rows) + walk_out_bytes(wk)
               + counts["anchor_sectors"] * SECTOR_BYTES,
               touched=touched, table=j_table + nbytes(ix.umeta),
               # the anchors: a test per member byte
               ops=2 * B * Lk + ops)
        out["greedy_walk"]["evaluations"] = counts
    elif mode == "anchors":
        ik = c0.ik
        ir = dog_anchors_ref(ix, sk.rows, lens, **kw)
        # init rows e >= n_f (n_r) are never read

        def used_of(i):
            return (torch.arange(effort, device=lens.device)[None, None, :]
                    < torch.stack([i.n_f, i.n_r])[:, :, None])

        # k-mers K5 must look up: a read is scanned from the start up to
        # its E-th hit and from the end down to its E-th hit from there;
        # a position both scans reach is looked up once
        f = _scan(unpack_fields(sk.rows[0], 2, L), k)
        r = rcb_ref(f, k)
        hit = anchor_lookup_ref(ix, torch.where(le_ref(f, r), f, r))[0]
        col = torch.arange(f.shape[1], device=f.device)[None, :]
        live = col <= (lens.to(torch.int64) - k)[:, None]
        hit = (hit & live).to(torch.int64)
        before = hit.cumsum(1) - hit                      # hits ahead of i
        after = torch.flip(torch.flip(hit, [1]).cumsum(1), [1]) - hit
        need = live & ((before < effort) | (after < effort))
        looked = int(need.sum())
        hits = int((hit.bool() & need).sum())
        anchors = int(ir.n_f.sum() + ir.n_r.sum())
        al_mphf = ix.amph_meta is not None
        # an MPHF lookup reads its level row and its verify row; a scan
        # lookup the row's S slot key-hi words, and a hit also a key-lo
        # sector and the sector of its three values
        a_bytes = (looked * (20 + 20) if al_mphf
                   else looked * ix.at_slots * 4 + hits * 2 * SECTOR_BYTES)
        a_table = (nbytes(ix.amph_rows, ix.amph_arows, ix.amph_f) if al_mphf
                   else nbytes(ix.at_fused))
        a_ops = (ops_mphf_lookup(3) if al_mphf
                 else ops_scan_lookup(ix.at_slots, 3))

        def inits_pairs(got, want):
            u = used_of(want)
            return [(got.n_f, want.n_f), (got.n_r, want.n_r),
                    (got.planes[:, u], want.planes[:, u])]

        record("dog_anchors", inits_pairs(ik, ir),
               lambda: dog_anchors(ix, sk.rows, lens, **kw),
               lambda: dog_anchors_ref(ix, sk.rows, lens, **kw),
               alone=lambda c: (
                   lambda: dog_anchors_launch(ix, c.sk.rows, c.lens, k=k,
                                              m=m, effort=effort),
                   lambda i: inits_pairs(i, c.ik)),
               stream=nbytes(sk.rows, lens) + anchors * 9 * 8 + 2 * B * 4,
               touched=a_bytes + anchors * u_row,
               table=a_table + nbytes(ix.umeta),
               ops=looked * (OPS_DOG_KMER + a_ops) + anchors * OPS_DOG_PLACE)
        counts = {}
        wr = walk_inits_ref(ix, sk.rows, lens, ik, k=k, L=L, counts=counts)
        touched, ops = probe_cost(counts)
        record("walk_inits", walks_pairs(wk, wr),
               lambda: walk_inits(ix, sk.rows, lens, ik, k=k, L=L),
               lambda: walk_inits_ref(ix, sk.rows, lens, ik, k=k, L=L),
               reps_r=2,
               alone=lambda c: (
                   lambda: walk_inits_launch(ix, c.sk.rows, c.lens, c.ik,
                                             k=k, L=L),
                   lambda w: walks_pairs(w, c.wk)),
               stream=anchors * 9 * 8 + 2 * B * 4 + nbytes(lens, sk.rows)
               + walk_out_bytes(wk),
               touched=touched, table=j_table + nbytes(ix.umeta), ops=ops)
        out["walk_inits"]["evaluations"] = counts
    else:
        xk = c0.xk
        record("member (inter)", [(xk, inter_ref(ix, sk, lens, L=L, k1=k1))],
               lambda: inter(ix, sk, lens, L=L, k1=k1),
               lambda: inter_ref(ix, sk, lens, L=L, k1=k1),
               alone=member_alone(ix, True), **member_cost(ix, (xk,)))
        if perpos_ix is not None:
            px = perpos_ix
            xp = inter(px, sk, lens, L=L, k1=k1)
            record("member (inter, per-position)",
                   [(xp, inter_ref(px, sk, lens, L=L, k1=k1))],
                   lambda: inter(px, sk, lens, L=L, k1=k1),
                   lambda: inter_ref(px, sk, lens, L=L, k1=k1),
                   alone=member_alone(px, True), **member_cost(px, (xp,)))
        counts = {}
        wr = exhaustive_ref(ix, sk, xk, lens, counts=counts, **xw)
        touched, ops = probe_cost(counts)
        record("exhaustive_dfs", walks_pairs(wk, wr),
               lambda: exhaustive_dfs(ix, sk, xk, lens, **xw),
               lambda: exhaustive_ref(ix, sk, xk, lens, **xw), reps_r=2,
               alone=lambda c: (
                   lambda: exhaustive_dfs_launch(ix, c.sk, c.xk, c.lens,
                                                 **xw),
                   lambda w: walks_pairs(w, c.wk)),
               # bug: the sectors FETCHX reads at its anchors
               stream=nbytes(xk, lens, sk.rows) + walk_out_bytes(wk)
               + counts["anchor_sectors"] * SECTOR_BYTES,
               touched=touched, table=j_table + nbytes(ix.umeta),
               # the anchor scan: a test per inter byte; the stack's
               # frames are the kernel's own scratch, not the function's
               ops=B * Lk + ops)
        out["exhaustive_dfs"]["evaluations"] = counts

    pr = pack_ref(wk, pmax=pmax, dtype=dtype)
    record("pack_paths", [(pk, pr)],
           lambda: pack_paths(wk, pmax=pmax, dtype=dtype),
           lambda: pack_ref(wk, pmax=pmax, dtype=dtype),
           alone=lambda c: (
               lambda: pack_paths_launch(c.wk, pmax=pmax, dtype=dtype),
               lambda o: [(o, c.pk)]),
           # K4's launch is shorter than a launch from Python
           graph=True,
           stream=walk_out_bytes(wk) - B * 4 + nbytes(pk),
           ops=B * (pmax + 2) * OPS_PACK_ELEM)
    if dtype == torch.int16:
        variants = ((None, "compact_result"),
                    (torch.int32, "compact_result (int32)"))
    elif int(pk.abs().max()) <= 32767:
        variants = ((None, "compact_result"),
                    (torch.int16, "compact_result (int16)"))
    else:
        variants = ((None, "compact_result"),)
    aligned = (pk[:, 0] == 1) | (pk[:, 0] == 2)
    slots = int((pk[:, 1].clamp(max=pmax) * aligned).sum())   # populated
    for cast, name in variants:
        fused = pk if cast is None else pk.to(cast)
        ck = compact_result(fused, pmax)
        cr = compact_ref(fused, pmax)

        def compact_alone(c, cast=cast):
            f = c.pk if cast is None else c.pk.to(cast)
            want = compact_result(f, pmax)
            return (lambda: compact_result_launch(f, pmax),
                    lambda r: list(zip(r, want)))

        record(name, list(zip(ck, cr)),
               lambda fused=fused: compact_result(fused, pmax),
               lambda fused=fused: compact_ref(fused, pmax),
               alone=compact_alone,
               stream=nbytes(fused, *ck),
               ops=B * OPS_COMPACT_ROW + slots * ops_compact_slot(pmax))
    return out


def compare_edge_batch(device):
    """K2 (greedy and exhaustive mode; closure-probe branch with windows
    of 3 and 4 and per-position branch; scan and mphf junction layouts),
    K5 (scan anchors, MPHF anchors under the mphf layout and beside a
    scan junction table; efforts 1, 2 and 5), and K3 greedy_walk (on
    K2's masks), K3 walk_inits (on K5's inits) and K6 exhaustive_dfs
    (on K2's `inter`, with and without -i) under the scan and mphf
    layouts and on a pool-chunk index (unitigs longer than the embedded
    width), and K2 (both branches) with K3 greedy_walk on the scan index
    cut into the most ranges its tables allow (`shard_count`), against
    their plain versions on each case of the edge batch
    (dbgtpu_torch/kernels/edge_batch.py), exact.  Returns the number of
    comparisons."""
    import numpy as np
    import torch

    from dbgtpu_torch.engine.dog import dog_anchors, dog_anchors_ref
    from dbgtpu_torch.engine.exhaustive import (
        depth_for, exhaustive_dfs, exhaustive_ref,
    )
    from dbgtpu_torch.engine.index import index_tensors, sharded_index_tensors
    from dbgtpu_torch.engine.member import inter, inter_ref, member, member_ref
    from dbgtpu_torch.engine.read_scan import read_scan
    from dbgtpu_torch.engine.walk import (
        greedy_walk, walk_inits, walk_inits_ref, walk_ref,
    )
    from dbgtpu_torch.index import device as dev_index
    from dbgtpu_torch.index.build import build_graph_from_seqs
    from dbgtpu_torch.kernels.edge_batch import edge_cases
    from dbgtpu_torch.seq import encode, n_mask

    def with_floor(name, value, fn):
        old = getattr(dev_index, name)
        setattr(dev_index, name, value)
        try:
            return fn()
        finally:
            setattr(dev_index, name, old)

    compared = 0
    for case in edge_cases():
        k, L = case.k, case.L
        graph = build_graph_from_seqs(list(case.unitigs), k, dog_mode=True)
        dis = {layout: dev_index.build_device_index(graph, layout=layout)
               for layout in ("scan", "mphf")}
        dis["window4"] = dev_index.build_device_index(graph)
        dis["window4"].probe_tbl = dev_index.build_probe_table(
            graph.jkeys, k - 1, window=4)
        dis["anchor_mphf"] = with_floor(
            "ANCHOR_MPHF_MIN", 1, lambda: dev_index.build_device_index(graph))
        dis["pool"] = with_floor(
            "EMBED_CAP_BASES", 8, lambda: dev_index.build_device_index(graph))
        ixs = {name: index_tensors(di, device) for name, di in dis.items()}
        if (ixs["window4"].pt_window != 4
                or ixs["anchor_mphf"].amph_meta is None
                or ixs["pool"].seq_words != 0):
            raise AssertionError(f"edge {case.name}: index variants")
        B = len(case.reads)
        codes = np.zeros((B, L), np.uint8)
        nmask = np.zeros((B, L), bool)
        lens_np = np.zeros(B, np.int32)
        for i, r in enumerate(case.reads):
            codes[i, : len(r)] = encode(r)
            nmask[i, : len(r)] = n_mask(r)
            lens_np[i] = len(r)
        words, nmbits = batch_tensors(codes, nmask, device)
        lens = torch.from_numpy(lens_np).to(device)
        sk = read_scan(words, nmbits, lens, L=L, k1=k - 1)
        branches = set()
        for name in ("scan", "window4", "mphf"):
            ix = ixs[name]
            for probe in (True, False):
                px = ix if probe else dataclasses.replace(
                    ix, pt_rows=ix.pt_rows[:0])
                pairs = list(zip(member(px, sk, lens, L=L, k1=k - 1),
                                 member_ref(px, sk, lens, L=L, k1=k - 1)))
                pairs.append((inter(px, sk, lens, L=L, k1=k - 1),
                              inter_ref(px, sk, lens, L=L, k1=k - 1)))
                torch.cuda.synchronize()
                err = max(_max_abs_err(g, w) for g, w in pairs)
                if err:
                    raise AssertionError(
                        f"edge {case.name}: K2 on {name} "
                        f"{'probe' if probe else 'probe-less'} != plain "
                        f"(max abs err {err})")
                compared += 3
                branches.add("closure probes" if probe and not sk.has_n.item()
                             else "per-position")
        for name in ("scan", "mphf", "anchor_mphf"):
            for effort in (1, 2, 5):
                kw = dict(k=k, m=2, effort=effort, L=L)
                got = dog_anchors(ixs[name], sk.rows, lens, **kw)
                want = dog_anchors_ref(ixs[name], sk.rows, lens, **kw)
                used = (torch.arange(effort, device=device)[None, None, :]
                        < torch.stack([want.n_f, want.n_r])[:, :, None])
                torch.cuda.synchronize()
                err = max(_max_abs_err(g, w) for g, w in (
                    (got.n_f, want.n_f), (got.n_r, want.n_r),
                    (got.planes[:, used], want.planes[:, used])))
                if err:
                    raise AssertionError(
                        f"edge {case.name}: K5 on {name}, E={effort} != "
                        f"plain (max abs err {err})")
                compared += 1
        deepest = 0
        for name in ("scan", "mphf", "pool"):
            ix = ixs[name]
            kw = dict(k=k, m=2, effort=case.effort, L=L)
            m1, m2 = member(ix, sk, lens, L=L, k1=k - 1)
            runs = [("K3 greedy_walk", greedy_walk(ix, sk, m1, m2, lens, **kw),
                     walk_ref(ix, sk, m1, m2, lens, **kw))]
            ik = dog_anchors(ix, sk.rows, lens, **kw)
            runs.append(("K3 walk_inits",
                         walk_inits(ix, sk.rows, lens, ik, k=k, L=L),
                         walk_inits_ref(ix, sk.rows, lens, ik, k=k, L=L)))
            xk = inter(ix, sk, lens, L=L, k1=k - 1)
            for partial in (False, True):
                xw = dict(k=k, m=2, partial=partial, L=L)
                got = exhaustive_dfs(ix, sk, xk, lens, **xw)
                runs.append((f"K6 exhaustive_dfs{' -i' if partial else ''}",
                             got, exhaustive_ref(ix, sk, xk, lens, **xw)))
                deepest = max(deepest, int(got.llen.max()),
                              int(got.rlen.max()))
            torch.cuda.synchronize()
            for what, got, want in runs:
                err = max(_max_abs_err(g, w) for g, w in walks_pairs(got,
                                                                      want))
                if err:
                    raise AssertionError(f"edge {case.name}: {what} on "
                                         f"{name} != plain (max abs err "
                                         f"{err})")
                compared += 1
        # the scan index cut into the most ranges its tables allow (up to
        # 8) on this card (--shard-index): K2 on both branches, K3
        # greedy_walk on its masks
        D = shard_count(dis["scan"])
        sx = sharded_index_tensors(dis["scan"], [device] * D)[0]
        kw = dict(k=k, m=2, effort=case.effort, L=L)
        for probe in (True, False):
            px = sx if probe else dataclasses.replace(
                sx, pt_rows=sx.pt_rows[:0], pt_shards=())
            m1, m2 = member(px, sk, lens, L=L, k1=k - 1)
            pairs = list(zip((m1, m2), member_ref(px, sk, lens, L=L,
                                                  k1=k - 1)))
            pairs += walks_pairs(greedy_walk(px, sk, m1, m2, lens, **kw),
                                 walk_ref(px, sk, m1, m2, lens, **kw))
            torch.cuda.synchronize()
            err = max(_max_abs_err(g, w) for g, w in pairs)
            if err:
                raise AssertionError(
                    f"edge {case.name}: K2 / K3 on the index cut into {D} "
                    f"ranges, {'probe' if probe else 'probe-less'} != plain "
                    f"(max abs err {err})")
            compared += 2
        log(f"[edge] {case.name} (k={k}, L={L}, Lk={case.Lk}, {B} reads, "
            f"{len(case.unitigs)} unitigs, lens {int(lens_np.min())}-"
            f"{int(lens_np.max())}, N {bool(sk.has_n.item())}): K2 member "
            f"and inter ({', '.join(sorted(branches))}; scan, window 4, "
            f"mphf; member also on the scan index cut into {D} ranges, "
            f"with K3 greedy_walk there), K5 (scan, mphf, MPHF anchors "
            f"beside scan; E = 1, 2, "
            f"5), K3 greedy_walk and walk_inits and K6 exhaustive_dfs "
            f"(with and without -i; scan, mphf, pool chunks; deepest K6 "
            f"path {deepest} of D = {depth_for(L, k)}) == plain versions "
            f"(tolerance 0)")
    return compared


def shard_count(di) -> int:
    """The most ranges (1 to 8) that dbgtpu's --shard-index guards let
    `di`'s scan and probe tables be cut into."""
    nb_st = di.scan_tbl.keys.shape[0]
    nb_pt = di.probe_tbl.rows.shape[0] if di.probe_tbl is not None else 0
    return max(D for D in (1, 2, 4, 8)
               if nb_st >= D and not nb_st % D and not nb_pt % D
               and not 0 < nb_pt < D)


def compare_result_edges(device) -> int:
    """K4 pack_paths and K8 compact_result against their plain versions
    on CUDA inputs at their geometry edges (kernels/edge_batch.py), exact:
    B in RESULT_BATCHES (one row, a tile +- 1, more tiles than the grid
    holds at once), pmax in RESULT_PMAX (rows narrower and wider than a
    warp; 120 > the walks' P), int16 and int32; K4 on the walk cases of
    WALK_PACK_CASES (llen / rlen 0, plen > pmax), K8 on RESULT_CASES.
    Returns the number of comparisons."""
    import numpy as np
    import torch

    from dbgtpu_torch.engine.compact import compact_ref, compact_result
    from dbgtpu_torch.engine.pack import pack_paths, pack_ref
    from dbgtpu_torch.engine.walk import Walks
    from dbgtpu_torch.kernels.edge_batch import (
        RESULT_BATCHES, RESULT_CASES, RESULT_PMAX, WALK_PACK_CASES,
        fused_rows, pack_walks,
    )

    dtypes = ((torch.int16, np.int16), (torch.int32, np.int32))
    compared = 0
    for B in RESULT_BATCHES:
        t0 = time.monotonic()
        for case in WALK_PACK_CASES:
            w = pack_walks(B * 7 + len(case), B, case)
            walks = Walks(*(torch.from_numpy(w[f]).to(device)
                            for f in Walks._fields))
            for pmax in RESULT_PMAX:
                for tdt, _ in dtypes:
                    got = pack_paths(walks, pmax=pmax, dtype=tdt)
                    want = pack_ref(walks, pmax=pmax, dtype=tdt)
                    torch.cuda.synchronize()
                    err = _max_abs_err(got, want)
                    if err:
                        raise AssertionError(
                            f"edge K4 {case}, B={B}, pmax={pmax}, {tdt}: "
                            f"kernel != plain (max abs err {err})")
                    compared += 1
        for case in RESULT_CASES:
            for pmax in RESULT_PMAX:
                for tdt, ndt in dtypes:
                    fused = torch.from_numpy(fused_rows(
                        B * 31 + pmax, B, pmax, ndt, case)).to(device)
                    got = compact_result(fused, pmax)
                    want = compact_ref(fused, pmax)
                    torch.cuda.synchronize()
                    err = max(_max_abs_err(g, w_)
                              for g, w_ in zip(got, want))
                    if err:
                        raise AssertionError(
                            f"edge K8 {case}, B={B}, pmax={pmax}, {tdt}: "
                            f"kernel != plain (max abs err {err})")
                    compared += 2
        log(f"[edge] K4 pack_paths (walks {', '.join(WALK_PACK_CASES)}) "
            f"and K8 compact_result ({', '.join(RESULT_CASES)}) at B={B}, "
            f"pmax {', '.join(map(str, RESULT_PMAX))}, int16 and int32 == "
            f"plain versions (tolerance 0; {time.monotonic() - t0:.1f} s)")
    return compared


def time_both(bind, check, entry: str) -> dict:
    """A kernel alone by both timers: TIMED_LAUNCHES back-to-back launches
    from Python (cuda_ms: `alone_ms`) and the same launches captured once
    into a CUDA graph (graph_ms: `graph_ms`), the median of ALONE_REPS
    runs each.  bind(lib) -> (launch, outputs) binds the launch on `lib`
    (None: this tree's library) into outputs of its own, its stream at
    the call (the graph timer calls it inside the capture);
    check(outputs) raises unless they are right.  With a baseline library
    that has the C entry point `entry`, each timer in turns (baseline,
    this, this, baseline): `baseline_alone_ms`, `alone_turns_ms`,
    `baseline_graph_ms`, `graph_turns_ms`."""
    import torch

    def plain(lib):
        launch, outputs = bind(this_or(lib))
        ms = cuda_ms(launch, ALONE_REPS, launches=TIMED_LAUNCHES)
        torch.cuda.synchronize()
        check(outputs)
        return ms

    def graph(lib):
        ms, outputs = graph_ms(lambda: bind(lib), ALONE_REPS, TIMED_LAUNCHES)
        check(outputs)
        return ms

    base = BASELINE["lib"]
    return {**in_turns(plain, base, "alone_", entry),
            **in_turns(graph, base, "graph_", entry)}


def plan_turns(what, n, plan, bind_plan, check) -> dict:
    """K7's plan (`plan`, engine/mphf.py mphf_plan, for n keys) against
    each other plan it could have taken (1, 2 or 4 keys a thread in
    blocks of mphf_block's size, and its own keys a thread in blocks of
    MPHF_THREADS), by the graph timer in turns (chosen, other, other,
    chosen): {"<per_thread>x<threads>": (chosen ms, other ms, the four
    times)}.  bind_plan(plan) -> (launch, outputs) as time_both's
    bind."""
    import torch

    from dbgtpu_torch.engine.gather import _card_of
    from dbgtpu_torch.engine.mphf import MPHF_THREADS, MphfPlan, mphf_block

    sms = _card_of(torch.device("cuda"))[0]
    others = {MphfPlan(q, mphf_block(n, q, sms)) for q in (1, 2, 4)}
    others.add(MphfPlan(plan.per_thread, MPHF_THREADS))
    others.discard(plan)

    def timer(p):
        ms, outputs = graph_ms(lambda: bind_plan(p), ALONE_REPS,
                               TIMED_LAUNCHES)
        check(outputs)
        return ms

    out = {}
    for other in sorted(others, key=lambda p: (p.per_thread, p.threads)):
        out[f"{other.per_thread}x{other.threads}"] = res = turns(
            lambda: timer(plan), lambda: timer(other))
        log(f"[plan] K7 {what}: the plan, {plan.per_thread} key(s) a thread "
            f"in blocks of {plan.threads}, {res[0]:.4f} ms against "
            f"{other.per_thread} in blocks of {other.threads} "
            f"{res[1]:.4f} ms by the graph timer (turns plan, other, other, "
            f"plan: " + ", ".join(f"{t:.4f}" for t in res[2]) + ")")
    return out


def key_sector_bytes(n: int, cols: int) -> int:
    """Bytes of the 32-byte sectors that hold the first 8 bytes (the key)
    of each of n rows of `cols` words: what reading the keys in place
    moves."""
    import numpy as np

    start = np.arange(n, dtype=np.int64) * cols * 4
    return np.union1d(start // SECTOR_BYTES,
                      (start + 7) // SECTOR_BYTES).size * SECTOR_BYTES


def graph_part(r) -> str:
    """The graph timer of a result in words ("" if it has none)."""
    if "graph_ms" not in r:
        return ""
    return (f", replayed from a CUDA graph {r['graph_ms']:.4f} ms"
            + (f" (baseline {r['baseline_graph_ms']:.4f} ms; turns "
               + ", ".join(f"{t:.4f}" for t in r["graph_turns_ms"]) + ")"
               if "baseline_graph_ms" in r else ""))


def timers_line(r) -> str:
    """Both timers of a `time_both` result in words."""
    def one(key, what):
        line = f"{what} {r[f'{key}_ms']:.4f} ms"
        if f"baseline_{key}_ms" in r:
            line += (f" (baseline {r[f'baseline_{key}_ms']:.4f} ms; turns "
                     f"baseline, this, this, baseline: " + ", ".join(
                         f"{t:.4f}" for t in r[f"{key}_turns_ms"]) + ")")
        return line

    return (one("alone", "kernel alone, back-to-back launches from Python")
            + "; " + one("graph", "replayed from a CUDA graph"))


def compare_mphf(label, mphf, device, extra_keys, timed: bool):
    """K7 against its plain version (and, for keys of the build set,
    against the host lookup) on one host MPHF.  Timed: alone by both
    timers (`time_both`, with the baseline's kernel in turns) on these
    keys, and its plan against the other plans (`plan_turns`)."""
    import numpy as np
    import torch

    from dbgtpu_torch.engine.index import fuse_mphf, mphf_meta_of, to_device
    from dbgtpu_torch.engine.mphf import (
        mphf_slot_ref, mphf_slots, mphf_slots_launch, plan_mphf,
    )
    from dbgtpu_torch.kernels import build

    rows_np, frows_np = fuse_mphf(mphf)
    rows, frows = to_device(rows_np, device), to_device(frows_np, device)
    meta = mphf_meta_of(mphf)
    keys = to_device(np.ascontiguousarray(extra_keys).view(np.int64), device)
    before = build.launches["mphf_slots"]
    got = mphf_slots(rows, frows, meta, keys)
    want = mphf_slot_ref(rows, frows, meta, keys)
    torch.cuda.synchronize()
    if keys.numel() and build.launches["mphf_slots"] != before + 1:
        raise AssertionError(f"{label}: the K7 wrapper did not launch")
    err = _max_abs_err(got, want)
    host = torch.from_numpy(mphf.lookup(extra_keys).astype(np.int32))
    # the host lookup takes the first matching slot of the final table,
    # the device lookups sum matching slots: equal wherever found
    found = host >= 0
    if err or not torch.equal(got.cpu()[found], host[found]):
        raise AssertionError(f"{label}: K7 != plain version (err {err}) or "
                             "!= the host lookup")
    n = keys.numel()
    # per key: the thread's index (2) and the lookup without the verify
    ops = n * (2 + ops_mphf_lookup(0, verify=False))
    res = dict(max_abs_err=err, bound_ops=ops,
               bound_bytes=n * 12 + min(n * 20, nbytes(rows, frows)))
    res["bound_ms"], res["bound_by"] = bound_of(
        n * 12, n * 20, nbytes(rows, frows), ops)
    line = ""
    if timed and n:
        plan = plan_mphf(n, keys.device)

        def bind_plan(p, lib=None):
            out = torch.empty_like(got)
            launch = on(lib, mphf_slots_launch(rows, frows, meta, keys, out,
                                               p))
            return launch, (out,)

        def same(outputs):
            if not torch.equal(outputs[0], got):
                raise AssertionError(f"{label}: K7 alone differs from K7 "
                                     "through its wrapper")

        res.update(time_both(lambda lib: bind_plan(plan, lib), same,
                             "dbg_mphf_slots"))
        res["plans"] = plan_turns(f"lookup on {label}", n, plan, bind_plan,
                                  same)
        res["wrapper_ms"] = cuda_ms(
            lambda: mphf_slots(rows, frows, meta, keys), 20)
        res["plain_ms"] = cuda_ms(
            lambda: mphf_slot_ref(rows, frows, meta, keys), 3)
        line = (f"; plan {plan.per_thread} key(s) a thread in blocks of "
                f"{plan.threads}; {timers_line(res)} ({TIMED_LAUNCHES} "
                f"launches a run), one launch through the wrapper "
                f"{res['wrapper_ms']:.4f} ms, plain {res['plain_ms']:.4f} "
                f"ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    log(f"[kernel] mphf_slots on {label}: {n} keys ({int(found.sum())} of "
        f"the set), {meta.n_levels} levels, final table "
        f"{meta.final_nb} buckets: == plain version and host lookup "
        f"(max abs err {err}, tolerance 0)" + line)
    return res


def time_mphf_check(label, mphf, vrows, device) -> dict:
    """K7's check mode at the shape the main path gives it: the check of
    an MPHF-backed table at upload (`vrows`, uint32 [n, cols], n > 0;
    engine/mphf.py check_mphf_table), against its plain version; alone
    by both timers (in turns with the baseline's, where its library has
    the check), its plan against the other plans, one call of
    `check_mphf_table` (launch and 4-byte read) and, beside it, the check
    it replaced (the keys built from the table by torch ops, a lookup of
    every key, an arange and torch.equal).  The bound: the sectors that
    hold each row's key, the level rows (at most the tables) and the
    count."""
    import torch

    from dbgtpu_torch.engine.index import fuse_mphf, mphf_meta_of, to_device
    from dbgtpu_torch.engine.kmer import M32
    from dbgtpu_torch.engine.mphf import (
        check_mphf_table, mphf_check, mphf_check_launch, mphf_check_ref,
        mphf_slots, plan_mphf,
    )

    rows, frows = (to_device(a, device) for a in fuse_mphf(mphf))
    meta, table = mphf_meta_of(mphf), to_device(vrows, device)
    n, cols = table.shape
    got, want = mphf_check(rows, frows, table, meta), mphf_check_ref(
        rows, frows, table, meta)
    if got or want:
        raise AssertionError(f"{label}: the check counts {got} keys at the "
                             f"wrong slot, its plain version {want}")
    # per key: the thread's index (2), the lookup without the verify and
    # the compare (1)
    ops = n * (3 + ops_mphf_lookup(0, verify=False))
    stream = key_sector_bytes(n, cols) + 4
    res = dict(max_abs_err=abs(got - want), library_ms=None,
               bound_bytes=stream + min(n * 20, nbytes(rows, frows)),
               bound_ops=ops)
    res["bound_ms"], res["bound_by"] = bound_of(
        stream, n * 20, nbytes(rows, frows), ops)
    plan = plan_mphf(n, table.device)

    def bind_plan(p, lib=None):
        bad = torch.empty(1, dtype=torch.int32, device=device)
        return on(lib, mphf_check_launch(rows, frows, table, meta, bad,
                                         p)), (bad,)

    def none_bad(outputs):
        if int(outputs[0].item()) != 0:
            raise AssertionError(f"{label}: the check mode counts "
                                 f"{int(outputs[0].item())} keys at the "
                                 "wrong slot")

    res.update(time_both(lambda lib: bind_plan(plan, lib), none_bad,
                         "dbg_mphf_check"))
    res["plans"] = plan_turns(f"check mode on {label}", n, plan, bind_plan,
                              none_bad)
    # one call through the wrapper: check_mphf_table
    res["ms"] = res["wrapper_ms"] = cuda_ms(lambda: check_mphf_table(
        rows, frows, table, meta, label), 20)
    res["plain_ms"] = cuda_ms(lambda: mphf_check_ref(
        rows, frows, table, meta), 3)

    def lookup_and_compare():
        # the check this one replaced: the stored keys built by torch
        # ops, a lookup of every key, an arange and a compare (a sync)
        part = table[:, :2].to(torch.int64) & M32
        got = mphf_slots(rows, frows, meta, (part[:, 0] << 32) | part[:, 1])
        return torch.equal(got, torch.arange(
            got.shape[0], dtype=torch.int32, device=device))

    res["replaced_ms"] = cuda_ms(lookup_and_compare, 20)
    log(f"[kernel] mphf_slots check mode on {label} ({n} rows of {cols} "
        f"words): 0 keys at the wrong slot == plain version; plan "
        f"{plan.per_thread} key(s) a thread in blocks of {plan.threads}; "
        f"{timers_line(res)} ({TIMED_LAUNCHES} launches a run), plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}); check_mphf_table (one launch and a 4-byte "
        f"read) {res['wrapper_ms']:.4f} ms, the lookup of every key and "
        f"compare it replaced {res['replaced_ms']:.4f} ms")
    return res


def compare_mphf_check_edges(device, survey) -> int:
    """K7's check mode on the card against its plain version on the same
    CUDA tensors (kernels/edge_batch.py mphf_check_tables: tables of 0,
    1, 31 and 33 keys, a tight-gamma MPHF whose keys reach the final
    table), each a count of 0 through one launch (none for 0 keys); and
    `survey` (name, host MPHF, uint32 rows) with two rows swapped: the
    count must be exactly 2 on both.  Returns the number of
    comparisons."""
    from dbgtpu_torch.engine.index import fuse_mphf, mphf_meta_of, to_device
    from dbgtpu_torch.engine.mphf import mphf_check, mphf_check_ref
    from dbgtpu_torch.kernels import build
    from dbgtpu_torch.kernels.edge_batch import mphf_check_tables

    compared = 0
    cases = [(name, m, v, 0) for name, m, v in mphf_check_tables()]
    for name, m, v in survey:
        swapped = v.copy()
        swapped[[3, v.shape[0] - 2]] = swapped[[v.shape[0] - 2, 3]]
        cases.append((f"{name}, rows 3 and {v.shape[0] - 2} swapped", m,
                      swapped, 2))
    for name, m, v, bad in cases:
        rows, frows = (to_device(a, device) for a in fuse_mphf(m))
        meta, table = mphf_meta_of(m), to_device(v, device)
        before = build.launches["mphf_slots"]
        got = mphf_check(rows, frows, table, meta)
        launched = build.launches["mphf_slots"] - before
        want = mphf_check_ref(rows, frows, table, meta)
        if got != bad or want != bad or launched != int(v.shape[0] > 0):
            raise AssertionError(
                f"edge K7 check on {name}: kernel {got}, plain {want}, want "
                f"{bad} keys at the wrong slot ({launched} launches)")
        log(f"[edge] K7 check mode on {name} ({v.shape[0]} keys, "
            f"{meta.n_levels} levels, final table {meta.final_nb} buckets): "
            f"{got} keys at the wrong slot == plain version, {launched} "
            f"launch")
        compared += 1
    return compared


def compare_rowsum_edges(device) -> int:
    """K10 gather_rowsum against its plain version on CUDA inputs at the
    edges of its one-launch schedule (kernels/edge_batch.py
    rowsum_edges, around the warp count of this card's grid), exact; the
    plain version takes the indices the kernel takes (an index outside
    the table as its last row: `in_table`).  Returns the number of
    comparisons."""
    import numpy as np
    import torch

    from dbgtpu_torch.engine import gather as G
    from dbgtpu_torch.kernels.edge_batch import (
        rowsum_edge_inputs, rowsum_edges,
    )

    sms = G._card_of(device)[0]
    resident = G._rowsum_resident(device.index or 0, True)
    warps = G.rowsum_plan(1 << 30, 1, sms, resident).warps
    t0 = time.monotonic()
    edges = rowsum_edges(warps)
    paths = set()
    for n, case in enumerate(edges):
        buf, idx_np = rowsum_edge_inputs(SEED + n, case)
        words = torch.from_numpy(buf.view(np.int32)).to(device)
        tbl = words[case.offset:].view(case.NB, case.W)
        idx = torch.from_numpy(idx_np).to(device)
        plan = G.plan_rowsum(tbl, idx, case.CH)
        paths.add(("16-byte vectors" if G.rowsum_vec(tbl) else "words")
                  + (", full grid" if plan.warps == warps else ""))
        got = G.gather_rowsum(tbl, idx, case.CH)
        want = G.gather_rowsum_ref(tbl, G.in_table(idx, case.NB), case.CH)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if err:
            raise AssertionError(
                f"edge K10 gather_rowsum {case.name} (NB={case.NB}, "
                f"W={case.W}, CH={case.CH}, {case.n_chunks} chunks, "
                f"{plan.warps} warps): kernel != plain (max abs err {err})")
    log(f"[edge] K10 gather_rowsum: {len(edges)} cases (grid of {warps} "
        f"warps, {resident} blocks per SM; {'; '.join(sorted(paths))}) == "
        f"plain versions (tolerance 0; {time.monotonic() - t0:.1f} s)")
    return len(edges)


def compare_gather_edges(device) -> int:
    """K11 gather_rows_sum (rows of 16 words) and K12 gather_take_sum
    against their plain versions on CUDA inputs at the edges of their
    plan (kernels/edge_batch.py gather_edges, at every reps of
    GATHER_REPS), exact; the plain version takes the indices the kernels
    take (an index outside the table as its last row: `in_table`).
    Returns the number of comparisons."""
    import numpy as np
    import torch

    from dbgtpu_torch.engine import gather as G
    from dbgtpu_torch.kernels.edge_batch import (
        GATHER_REPS, gather_edge_inputs, gather_edges,
    )

    sms, optin = G._card_of(device)
    compared = 0
    for label, W, wrapper, plain in (
            ("K11 gather_rows_sum", 16, G.gather_rows_sum,
             G.gather_rows_sum_ref),
            ("K12 gather_take_sum", 1, G.gather_take_sum,
             G.gather_take_sum_ref)):
        t0 = time.monotonic()
        direct_max = G.direct_rows_max(W, optin)
        S = G.gather_plan(direct_max + 1, W, 300, 128, sms, optin).S
        paths = set()
        for n, case in enumerate(gather_edges(direct_max, S)):
            buf, idx_np = gather_edge_inputs(SEED + n, case, W, S)
            words = torch.from_numpy(buf.view(np.int32)).to(device)
            tbl = words[case.offset:]
            tbl = tbl.view(case.NB, W) if W > 1 else tbl
            idx = torch.from_numpy(idx_np).to(device)
            plan = G.plan_for(tbl, idx)
            paths.add("direct" if plan.direct
                      else f"bucketed ({plan.entry_bits}-bit entries)")
            for reps in GATHER_REPS:
                got = wrapper(tbl, idx, reps)
                want = plain(tbl, G.in_table(idx, case.NB), reps)
                torch.cuda.synchronize()
                err = _max_abs_err(got, want)
                if err:
                    raise AssertionError(
                        f"edge {label} {case.name} (NB={case.NB}, B={case.B}"
                        f", J={case.J}, reps={reps}): kernel != plain (max "
                        f"abs err {err})")
                compared += 1
        log(f"[edge] {label}: {len(gather_edges(direct_max, S))} cases "
            f"(direct up to {direct_max} rows, slices of {S}; "
            f"{', '.join(sorted(paths))}) at reps "
            f"{', '.join(map(str, GATHER_REPS))} == plain versions "
            f"(tolerance 0; {time.monotonic() - t0:.1f} s)")
    return compared


def report_gathers(results) -> dict:
    """Log K9-K12's results of one `tools.exp_gather.main()` run (both
    geometries: equal to the plain version and to the one PyTorch gather
    computing the same function, timed alone beside them; K11 and K12
    with their plan and, bucketed, each pass alone).  Returns {kernel
    name: result dict} of the "scripts" geometry; K9's entry is its G=1
    run."""
    from dbgtpu_torch.tools.exp_gather import plan_line

    out = {}
    for r in results:
        if "plan" in r:
            log(f"[kernel] {r['geometry']} {r['label']} plan: "
                f"{plan_line(r['plan'])}"
                + ("; passes alone (50 back-to-back launches each) "
                   + ", ".join(f"{k} {v:.4f} ms"
                               for k, v in r["pass_ms"].items())
                   if "pass_ms" in r else ""))
        log(f"[kernel] {r['geometry']} {r['label']}: == plain version (max "
            f"abs err {r['max_abs_err']}, tolerance 0) and == the library "
            f"call; kernel alone {r['ms']:.4f} ms (50 back-to-back launches "
            f"through the C entry point, {r['rows'] / r['ms'] / 1e3:.0f}M "
            f"rows/s)"
            + (f", baseline kernel alone {r['baseline_ms']:.4f} ms (turns "
               f"baseline, this, this, baseline: "
               + ", ".join(f"{t:.4f}" for t in r["turns_ms"]) + ")"
               if "baseline_ms" in r else "")
            + graph_part(r)
            + f", one launch through the wrapper "
            f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library call {r['library_ms']:.4f} ms "
            f"({r['library_ms'] / r['ms']:.2f}x the kernel's time), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bound_bytes']} B, "
            f"{r['bound_ops']} operations)")
        if r["geometry"] == "scripts":
            out.setdefault(r["name"], dict(r, alone_ms=r["ms"]))
    return out


# the guards of --shard-index, word for word as dbgtpu raises them
# (dbgtpu/engine/runner.py:294-296): -G, -b and the mphf layout fail so
SHARD_GUARD_TEXT = ("--shard-index requires greedy mode and index tables "
                    "with at least one bucket row per device")
SHARD_COUNTS = (2, 4, 8)    # shards of the survey index on one card


SPARSE_ROWS, SPARSE_W = 1_048_576, 96   # scale1M's probe table: 403 MB
SPARSE_IDS, SPARSE_SEED = 917_504, 1313


def on_any(prep):
    """prep() -> (build.Launch, outputs) as prep() -> (go, outputs), go(lib)
    launching on any kernel library: an older tree's through
    measure.on (OLDER_ENTRIES), its arguments mapped once per library."""
    def wrapped():
        launch, outputs = prep()
        bound = {}

        def go(lib=None):
            if id(lib) not in bound:
                bound[id(lib)] = on(lib, launch)
            bound[id(lib)]()

        return go, outputs

    return wrapped


def staged_ones(shards, device):
    """Which shards a staged measurement stages: those on other cards, or,
    with every shard on `device`, all but the first (as if the others
    lay on other cards: the same passes, the rows from this card)."""
    local = [s.device == device for s in shards]
    return local if not all(local) else [i == 0 for i in range(len(local))]


def sharded_rows_case(name, shards, ids, whole, paths: bool = False) -> dict:
    """K13 on `shards` for the global bucket ids `ids` (int32, inside the
    table, on the card that reads) against its plain version and the
    whole table's rows,
    exact, by the host's plan, and timed: alone (its C entry point back
    to back; with `--baseline-csrc`, in turns with the older tree's
    K13), by the graph timer, through its wrapper, its plain version, and
    the one PyTorch call that computes the same function on the whole
    table (`whole[ids]`).  `paths`: each path forced (direct, staged) too,
    exact and timed alone and by graph, the staged run's distinct remote
    rows read back from its flags.  Bound: the ids read once, the rows
    written once, the distinct rows the ids ask for read once; those in
    shards on other cards cross NVLink."""
    import torch

    from dbgtpu_torch.engine.shard import (
        plan_for, shard_plan, sharded_rows, sharded_rows_launch,
        sharded_rows_ref,
    )

    got = sharded_rows(shards, ids)
    want = sharded_rows_ref(shards, ids)
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    ids64 = ids.long()
    if err or not torch.equal(want, whole[ids64]):
        raise AssertionError(f"{name}: sharded_rows != plain version (max "
                             f"abs err {err}) or the whole table's rows")
    plan = plan_for(shards, ids)
    nbl, W = shards[0].shape
    distinct = torch.unique(ids64)
    remote = sum(int(((distinct // nbl) == s).sum())
                 for s, sh in enumerate(shards) if sh.device != ids.device)
    rows = nbytes(got)
    bound, by = bound_of(nbytes(ids) + rows, distinct.numel() * W * 4,
                         nbytes(*shards), 0,
                         remote / max(1, distinct.numel()))
    res = dict(max_abs_err=err, ms=cuda_ms(lambda: sharded_rows(shards, ids),
                                           20),
               plain_ms=cuda_ms(lambda: sharded_rows_ref(shards, ids), 3),
               library_ms=cuda_ms(lambda: whole[ids64], 20),
               bound_ms=bound, bound_by=by, q=ids.numel(), w=W,
               d=len(shards), path="direct" if plan.direct else "staged",
               distinct=distinct.numel(),
               remote_distinct=remote)
    res.update(time_alone(name, [(on_any(lambda: sharded_rows_launch(
        shards, ids)), lambda o: [(o, want)])], graph=True))
    log(f"[shard] {name}: K13 == plain version (max abs err {err}, "
        f"tolerance 0; == the whole table's rows); Q {res['q']} ids of rows "
        f"of {W} words over {res['d']} shards, {res['distinct']} distinct "
        f"rows, {remote} of them on other cards; plan: {res['path']}; "
        f"alone {res['alone_ms']:.4f} ms"
        + (f" (baseline K13 {res['baseline_alone_ms']:.4f} ms; turns "
           + ", ".join(f"{t:.4f}" for t in res["alone_turns_ms"]) + ")"
           if "baseline_alone_ms" in res else "")
        + graph_part(res) + f", wrapper {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, whole[ids] {res['library_ms']:.4f} ms, "
        f"bound {res['bound_ms']:.6f} ms ({by})")
    if not paths:
        return res
    forced = {"direct": plan_for(shards, ids, staged=False),
              "staged": shard_plan(ids.numel(), nbl, W,
                                   staged_ones(shards, ids.device),
                                   staged=True)}
    res["paths"] = {}
    for label, p in forced.items():
        def bind(p=p):
            launch, out = sharded_rows_launch(shards, ids, p)
            return launch, (out, launch.tensors[3])

        launch, (out, flags) = bind()
        alone = cuda_ms(launch, ALONE_REPS, launches=ALONE_LAUNCHES)
        torch.cuda.synchronize()
        if _max_abs_err(out, want):
            raise AssertionError(f"{name}: K13 {label} != plain version")
        graph, (gout, _) = graph_ms(bind, ALONE_REPS, ALONE_LAUNCHES)
        if _max_abs_err(gout, want):
            raise AssertionError(f"{name}: K13 {label} from a graph != "
                                 "plain version")
        staged_rows = int(flags.sum()) if flags.numel() else 0
        res["paths"][label] = dict(alone_ms=alone, graph_ms=graph,
                                   staged_rows=staged_rows,
                                   remote_rows=p.remote_rows)
        log(f"[shard] {name}, {label} (forced): == plain version (tolerance "
            f"0); alone {alone:.4f} ms, graph {graph:.4f} ms"
            + (f"; {staged_rows} distinct rows of {p.remote_rows} staged "
               f"(shards {list(p.remote)}"
               + (", on this card" if all(s.device == ids.device
                                          for s in shards) else "")
               + ")" if p.staged else ""))
    return res


def edge_ids(nb: int, D: int, device):
    """Every shard's first and last row and one id on each side of a
    table of nb rows cut into D ranges (int32 on `device`)."""
    import numpy as np
    import torch

    nbl = nb // D
    ids = np.concatenate([np.arange(D) * nbl, np.arange(1, D + 1) * nbl - 1,
                          [-1, nb]]).astype(np.int32)
    return torch.from_numpy(ids).to(device)


def compare_shard_edges(shards, whole, device, what) -> int:
    """K13 at every shard's first and last row and outside the table:
    equal to its plain version, the table's rows, zeros outside."""
    import torch

    from dbgtpu_torch.engine.shard import sharded_rows, sharded_rows_ref

    nb = shards[0].shape[0] * len(shards)
    ids = edge_ids(nb, len(shards), device)
    got = sharded_rows(shards, ids)
    want = sharded_rows_ref(shards, ids)
    torch.cuda.synchronize()
    inside = (ids >= 0) & (ids < nb)
    if (_max_abs_err(got, want)
            or not torch.equal(got[inside], whole[ids[inside].long()])
            or bool(got[~inside].any())):
        raise AssertionError(f"[edge] K13 {what} over {len(shards)} shards: "
                             "the shards' edge rows differ")
    return 1


def compare_shards(di, ix, batches, device, *, k, m, effort, L, pmax):
    """Phase 2's sharded index (--shard-index): the survey's scan index cut
    into D = 2, 4 and 8 ranges resident on `device` (peer pointers and
    local ones are one address space, so this runs on one card), and,
    where two or more cards can reach each other, into one range per card
    (up to 8).  On each: K13 at every shard's edge rows and on the batch's
    probe keys against its plain version (every path forced too, on 8
    shards on one card and on the real cards), and on the sparse shape
    (`compare_sparse_shape`); K2 (both branches) and K3 greedy_walk
    against theirs on the survey batch (compare_kernels, timed on 8
    shards on one card and on the real cards).  With `--baseline-csrc`
    K13 is timed in turns with the older tree's; K2 and K3 are not (an
    older tree's K2 and K3 may read no sharded index).  Returns the JSON
    line's sharded_rows, member@shard and greedy_walk@shard results."""
    import torch

    from dbgtpu_torch.dist.mesh import make_mesh
    from dbgtpu_torch.engine.index import sharded_index_tensors
    from dbgtpu_torch.engine.kmer import mix32_ref, split_ref
    from dbgtpu_torch.engine.read_scan import read_scan

    words, nmbits, lens = batches[0]
    k1 = k - 1
    sk = read_scan(words, nmbits, lens, L=L, k1=k1)
    W = ix.pt_window
    Lk = sk.rep1.shape[1]
    p = (torch.arange(0, Lk, W, device=device) + 1).clamp(max=Lk - 1)
    hi, lo = split_ref(sk.rep1[:, p].reshape(-1))
    whole = {"junction": ix.st_fused, "probe": ix.pt_rows}
    seeds = {"junction": ix.st_seed, "probe": ix.pt_seed}
    layouts = [("one card", [device] * D) for D in SHARD_COUNTS]
    cards = make_mesh(None, device)[:8]
    n = len(cards)
    if n > 1 and all(torch.cuda.can_device_access_peer(a.index, b.index)
                     for a in cards for b in cards if a != b):
        layouts.append((f"{n} cards", cards))
    elif n > 1:
        log(f"[shard] {n} cards that cannot all reach each other: no run "
            "over real cards")
    out, ids_of = {}, {}
    for where, devices in layouts:
        D = len(devices)
        share = (D - 1) / D if where != "one card" else 0.0
        t0 = time.monotonic()
        ixs = sharded_index_tensors(di, devices)
        sx = ixs[0]
        log(f"[shard] the survey index cut into {D} ranges on {where} "
            f"({time.monotonic() - t0:.1f} s, K13's check at upload): "
            f"junction {tuple(sx.st_fused.shape)} and probe "
            f"{tuple(sx.pt_rows.shape)} per range; bytes each device holds "
            f"{[x.held_bytes() for x in ixs]}, replicated "
            f"{ix.held_bytes()}")
        tag = f"{D} shards on {where}"
        for what, shards in (("junction", sx.st_shards),
                             ("probe", sx.pt_shards)):
            compare_shard_edges(shards, whole[what], device, f"{what} {tag}")
            nb = shards[0].shape[0] * D
            if what not in ids_of:
                ids_of[what] = (mix32_ref(hi ^ seeds[what], lo)
                                & (nb - 1)).to(torch.int32)
            # the upload's check (the main path's shape) and the batch's
            # probe keys (a lookup's shape)
            check = edge_ids(nb, D, device)[: 2 * D]
            timed = (D == max(SHARD_COUNTS) or where != "one card")
            for shape, ids in (("upload check", check),
                               ("batch probe keys", ids_of[what])):
                r = sharded_rows_case(
                    f"sharded_rows {what} {tag}, {shape}", shards, ids,
                    whole[what], paths=timed and shape != "upload check")
                out[what, D, where, shape] = r
        perpos = dataclasses.replace(sx, pt_rows=sx.pt_rows[:0],
                                     pt_shards=())
        # an older tree's K2 and K3 may read no sharded index
        saved, BASELINE["lib"] = BASELINE["lib"], None
        try:
            res = compare_kernels(sx, words, nmbits, lens, mode="greedy",
                                  k=k, m=m, effort=effort, L=L, pmax=pmax,
                                  timed=timed, perpos_ix=perpos,
                                  more=batches[1:], remote_share=share)
        finally:
            BASELINE["lib"] = saved
        for name in ("member", "member (per-position)", "greedy_walk"):
            r = res[name]
            log(f"[shard] {name} on {tag}: == plain version (max abs err "
                f"{r['max_abs_err']}, tolerance 0)" + (
                    f"; alone {r['alone_ms']:.4f} ms, wrapper "
                    f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
                    if timed else ""))
        out[D, where] = res
    for where, devices in ([("one card", [device] * 4)]
                           + layouts[len(SHARD_COUNTS):]):
        out["sparse", where] = compare_sparse_shape(devices, device, where)
    D = max(SHARD_COUNTS)
    return {"sharded_rows": out["junction", D, "one card", "upload check"],
            "member": out[D, "one card"]["member"],
            "greedy_walk": out[D, "one card"]["greedy_walk"],
            "all": out}


def compare_sparse_shape(devices, device, where) -> dict:
    """K13 on the sparse shape: a seeded int32 table of [SPARSE_ROWS,
    SPARSE_W] (the size of scale1M's probe table) cut into one range per
    device of `devices`, read on `device` at SPARSE_IDS uniform ids:
    fewer ids than rows, so they cannot repeat much (the plan's
    choice).  Every path against the plain version, exact, timed, beside
    `whole[ids]`."""
    import torch

    g = torch.Generator(device=device).manual_seed(SPARSE_SEED)
    whole = torch.randint(0, 2**31 - 1, (SPARSE_ROWS, SPARSE_W),
                          generator=g, device=device, dtype=torch.int32)
    ids = torch.randint(0, SPARSE_ROWS, (SPARSE_IDS,), generator=g,
                        device=device, dtype=torch.int32)
    D = len(devices)
    shards = [c.to(d) for c, d in zip(whole.chunk(D), devices)]
    return sharded_rows_case(
        f"sharded_rows sparse [{SPARSE_ROWS}, {SPARSE_W}] table, {D} "
        f"shards on {where}, {SPARSE_IDS} uniform ids", shards, ids, whole,
        paths=True)


def survey_batches(codes_all, L, device):
    """The survey's reads as the run's batches of BATCH reads, each
    (words, nmbits, lens) on the device, padded to L bases."""
    import numpy as np
    import torch

    n_reads, read_len = codes_all.shape
    out = []
    for s0 in range(0, n_reads, BATCH):
        part = codes_all[s0 : s0 + BATCH]
        codes = np.zeros((part.shape[0], L), np.uint8)
        codes[:, :read_len] = part
        words, nmbits = batch_tensors(codes, np.zeros(codes.shape, bool),
                                      device)
        out.append((words, nmbits, torch.full(
            (part.shape[0],), read_len, dtype=torch.int32, device=device)))
    return out


def occupancy_warps(registers: int, block: int) -> int:
    """Resident warps per SM that `registers` per thread allow blocks of
    `block` threads (65,536 registers per SM, allocated per warp in
    units of 256; at most 64 warps and 32 blocks per SM)."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = block // 32
    blocks = min(65536 // (per_warp * warps), 32, 64 // warps)
    return blocks * warps


def log_resources(who, resources, lib) -> None:
    """ptxas's registers and spills per kernel entry of `lib`, and the
    warps per SM they allow in blocks of the size that the entry's source
    launches (its `dbg_<source>_threads()`, where the library has one)."""
    for entry, r in sorted(resources.items(),
                           key=lambda e: (e[1]["source"] or "", e[0])):
        if "registers" not in r:
            continue
        threads = getattr(lib, f"dbg_{r['source']}_threads", None)
        occ = "block size not reported"
        if threads is not None:
            threads.argtypes, threads.restype = [], ctypes.c_int
            block = threads()
            occ = (f"{occupancy_warps(r['registers'], block)} warps per SM "
                   f"in blocks of {block} threads")
        log(f"[ptxas] {who}: {r['source']}.cu {entry}: {r['registers']} "
            f"registers, spill stores {r.get('spill_stores', 0)} B, loads "
            f"{r.get('spill_loads', 0)} B; {occ}")


def log_resource_pairs(ours, base, sources) -> None:
    """ptxas's registers and spills of each kernel entry of `sources`
    (file stems) in this tree's library beside the baseline's, and
    whether they moved.  Entries are matched without the hash that names
    a file's anonymous namespace (it differs between trees)."""
    import re

    def key(entry):
        return re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}", "",
                      entry)

    base = {key(e): r for e, r in base.items()}
    for entry, r in sorted(ours.items()):
        if r.get("source") not in sources or "registers" not in r:
            continue
        b = base.get(key(entry), {})

        def of(x):
            return (x.get("registers"), x.get("spill_stores", 0),
                    x.get("spill_loads", 0))

        log(f"[ptxas] {r['source']}.cu {entry}: this tree / baseline "
            f"registers {of(r)[0]} / {of(b)[0]}, spill stores {of(r)[1]} / "
            f"{of(b)[1]} B, loads {of(r)[2]} / {of(b)[2]} B"
            + ("" if of(r) == of(b) else " (moved)"))


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
                     check_ix=None, mode="greedy", partial=False,
                     layout="scan"):
    """The port on `device` against its python spec in `mode`, byte for
    byte; also the mode's kernels against their plain versions on the
    whole file as one batch."""
    import numpy as np
    import torch

    from dbgtpu_torch import native
    from dbgtpu_torch.engine.index import index_tensors, to_device
    from dbgtpu_torch.engine.runner import (
        _bucket_len, _pmax_cap, _pmax_for, get_device_index, pack_records,
    )
    from dbgtpu_torch.pipeline import run_pipeline
    from dbgtpu_torch.spec import run_pipeline as spec_pipeline

    t0 = time.monotonic()
    got = run_pipeline([str(reads_fa)], str(unitigs_fa), k=k, m=m,
                       batch_size=32768, graph=graph, device=device,
                       mode=mode, partial=partial, index_layout=layout)
    t1 = time.monotonic()
    want = spec_pipeline([str(reads_fa)], str(unitigs_fa), k=k, m=m,
                         graph=graph, mode=mode, partial=partial)
    t2 = time.monotonic()
    for what, a, b in (("paths", got[0], want[0]),
                       ("notAligned.fa", got[1], want[1])):
        if a != b:
            raise AssertionError(f"{label}: {what} differs from the spec "
                                 f"({len(a)} vs {len(b)} bytes)")
    for f in ("read_number", "aligned", "not_aligned", "no_overlap"):
        if getattr(got[2], f) != getattr(want[2], f):
            raise AssertionError(f"{label}: stats {f} differs")
    di = get_device_index(graph, layout)
    ix = index_tensors(di, device)
    if (ix.mph_meta is not None) != (layout == "mphf"):
        raise AssertionError(f"{label}: junction layout is not {layout}")
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
    errs_s = ", ".join(f"{n} {e['max_abs_err']}" for n, e in errs.items())
    flags = " ".join(MODE_FLAGS[mode] + (["-i"] if partial else [])
                     + (["--index-layout", "mphf"] if layout == "mphf"
                        else []))
    log(f"[bytes] {label} [{flags or 'greedy'}]: {got[2].read_number} "
        f"reads, {got[2].aligned} "
        f"aligned, paths {len(got[0])} B, notAligned {len(got[1])} B: "
        f"byte-identical to the spec (port {t1 - t0:.2f} s, spec "
        f"{t2 - t1:.2f} s); kernels == plain on the file ({errs_s})")


RUNNER_READS = 1 << 20      # [runner]: 32 batches of BATCH reads
# the `__global__` functions of the greedy path that a profiler trace
# must name: K1, K2 (either branch), K3, K4, K8
TRACE_KERNELS = {
    "K1 read_scan": "read_scan_kernel",
    "K2 member": "member_(probe|scan|mphf)_kernel",
    "K3 greedy_walk": "greedy_walk_kernel",
    "K4 pack_paths": "pack_paths_kernel",
    "K8 compact_result": "compact_kernel",
}


def runner_reads(path: Path) -> None:
    """RUNNER_READS reads of READ_LEN bases on the survey's genome, from
    survey_workload's generator and seed (the same genome and unitigs),
    written to `path` as FASTA."""
    import numpy as np

    from tests import synth

    rng = np.random.default_rng(SEED)
    genome = synth.make_genome(rng, GENOME_LEN)
    synth.orient_shuffle(synth.chop_unitigs(genome, K, rng, 40, 150), rng)
    write_fasta(path, synth.sample_reads(genome, rng, RUNNER_READS,
                                         READ_LEN, err_frac=0.5))


def load_runner(path: str):
    """An older tree's dbgtpu_torch/engine/runner.py as a module of this
    tree's engine package (its relative imports reach this tree's
    kernels and host code): the runner alone is what differs."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "dbgtpu_torch.engine.baseline_runner", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class runner_variant:
    """Within the block, `dbgtpu_torch.pipeline` maps with `variant`:
    "pipelined" (this tree's runner) or "baseline" (the module of
    `load_runner`, whose align_bulk takes no mesh and times no legs)."""

    def __init__(self, variant: str, baseline=None):
        self.variant, self.baseline = variant, baseline

    def __enter__(self):
        from dbgtpu_torch import pipeline

        self.saved = pipeline.align_bulk
        if self.variant == "baseline":
            older = self.baseline.align_bulk

            def align_bulk(*a, mesh=None, xfer=None, **kw):
                if mesh is not None:
                    raise AssertionError("the baseline runner has no mesh")
                xfer = {} if xfer is None else xfer
                out = older(*a, xfer=xfer, **kw)
                for key in ("launch_s", "drain_s", "format_s", "wait_s",
                            "stall_s"):
                    xfer.setdefault(key, 0)
                return out

            pipeline.align_bulk = align_bulk
        return self

    def __exit__(self, *exc):
        from dbgtpu_torch import pipeline

        pipeline.align_bulk = self.saved
        return False


def cli_timed(argv, want_kernels, profiled=False) -> dict:
    """One `cli.main(argv)` run with the launch counts set to 0 just
    before it: its wall, peak device memory above what was held, the
    summary, the launches (each of `want_kernels` > 0, no other mapping
    kernel) and, `profiled`, the device busy share of a torch.profiler
    trace of the run."""
    import torch

    from dbgtpu_torch import cli
    from dbgtpu_torch.kernels import build
    from dbgtpu_torch.kernels.measure import device_busy

    js = Path(argv[argv.index("--json-summary") + 1])
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    prof = None
    t0 = time.monotonic()
    if profiled:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rc = cli.main(argv)
            torch.cuda.synchronize()
    else:
        rc = cli.main(argv)
    wall = time.monotonic() - t0
    if rc != 0:
        raise AssertionError(f"cli.main {argv} exited {rc}")
    counts = dict(build.launches)
    missing = [n for n in want_kernels if counts[n] <= 0]
    other = [n for n, c in counts.items()
             if c and n not in want_kernels and n != "mphf_slots"]
    if missing or other:
        raise AssertionError(f"{argv}: kernels not launched {missing}, "
                             f"kernels of another path launched {other}")
    out = dict(wall=wall, summ=json.loads(js.read_text()), launches=counts,
               peak=torch.cuda.max_memory_allocated() - held)
    if prof is not None:
        out["device_ms"], out["busy"], _ = device_busy(prof, wall)
    return out


def records(blob: bytes) -> dict:
    """Header line -> its two-line record (paths, notAligned.fa)."""
    lines = blob.split(b"\n")
    return {lines[i]: lines[i] + b"\n" + lines[i + 1] + b"\n"
            for i in range(0, len(lines) - 1, 2)}


def runner_phase(td: Path, uf: Path, graphs, baseline_path) -> None:
    """[runner]: RUNNER_READS survey reads through `cli.main` from a
    loaded index, greedy / scan and -G / mphf, this tree's pipelined
    runner and, with `baseline_path`, an older tree's runner, in turns;
    bytes equal across the runs and, on 128 reads of every batch, to
    the spec."""
    import numpy as np

    from dbgtpu_torch import native
    from dbgtpu_torch.index.persist import save_index
    from dbgtpu_torch.spec import run_pipeline as spec_pipeline

    rf = td / "r1m.fa"
    t0 = time.monotonic()
    runner_reads(rf)
    log(f"[runner] {RUNNER_READS} reads of {READ_LEN} bases on the survey "
        f"genome: {time.monotonic() - t0:.1f} s to make")
    baseline = load_runner(baseline_path) if baseline_path else None
    names = (["baseline"] if baseline else []) + ["pipelined"]
    order = (names + names[::-1]) * 2
    # 128 reads of each batch, against the spec
    parsed = native.parse_reads(str(rf), K, False)
    sample = np.concatenate([np.arange(s, s + 128)
                             for s in range(0, parsed.n, BATCH)])
    sf = td / "r1m_sample.fa"
    with open(sf, "wb") as f:
        for i in sample:
            f.write(b">r" + str(i).encode() + b"\n"
                    + parsed.seq_bytes(int(i)) + b"\n")
    # the profiler's first session sets up its tracing (seconds, once per
    # process): here, so that each profiled run below times the run alone
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    for layout, mode in (("scan", "greedy"), ("mphf", "anchors")):
        graph = graphs[mode == "anchors"]
        npz = td / f"runner_{layout}_{mode}.npz"
        save_index(graph, str(npz), layout=layout)
        tag = f"[runner {' '.join(MODE_FLAGS[mode] + [layout])}]"
        argv = ["-r", str(rf), "--load-index", str(npz), "-m", str(M),
                "-e", str(EFFORT), "--batch-size", str(BATCH),
                "-f", str(td / "paths"), "-a", str(td / "notAligned.fa"),
                "--json-summary", str(td / "summary.json"),
                "--index-layout", layout] + MODE_FLAGS[mode]
        runs = {name: [] for name in names}
        outputs = {}
        for turn, name in enumerate(order + names):
            profiled = turn >= len(order)
            with runner_variant(name, baseline):
                r = cli_timed(argv, PATH_KERNELS[mode], profiled)
            got = ((td / "paths").read_bytes(),
                   (td / "notAligned.fa").read_bytes())
            if outputs.setdefault("bytes", got) != got:
                raise AssertionError(f"{tag} {name}: bytes differ from the "
                                     "first run's")
            summ, nb = r["summ"], -(-RUNNER_READS // BATCH)
            if summ["reads"] != RUNNER_READS:
                raise AssertionError(f"{tag} {summ['reads']} reads mapped")
            if profiled:
                log(f"{tag} {name}, under torch.profiler: device busy "
                    f"share {r['busy']:.6f} ({r['device_ms']:.3f} ms of "
                    f"device events in {r['wall'] * 1e3:.1f} ms wall)")
                runs[name].append(dict(busy=r["busy"]))
                continue
            row = dict(align_s=summ["align_seconds"], wall=r["wall"],
                       map_rps=RUNNER_READS / summ["align_seconds"],
                       e2e_rps=RUNNER_READS / r["wall"], peak=r["peak"],
                       **{leg: summ[f"{leg}_seconds"] * 1e3 / nb
                          for leg in ("launch", "drain", "format", "wait",
                                      "stall")})
            runs[name].append(row)
            log(f"{tag} {name}, turn {turn + 1}: align_seconds "
                f"{summ['align_seconds']} (mapping {row['map_rps']:.1f} "
                f"reads/s), wall {r['wall']:.3f} s (end-to-end "
                f"{row['e2e_rps']:.1f} reads/s; index load "
                f"{summ['index_seconds']} s, upload "
                f"{summ['upload_seconds']} s, parse {summ['parse_seconds']}"
                f" s); per batch: launch leg {row['launch']:.2f} ms, drain "
                f"leg {row['drain']:.2f} ms (of which on_batch's format "
                f"{row['format']:.2f} ms), drain waiting "
                f"{row['wait']:.2f} ms, launch thread stalled "
                f"{row['stall']:.2f} ms; max_memory_allocated +{r['peak']}"
                f" B; payload H2D {summ['payload_h2d_bytes']} B, D2H "
                f"{summ['payload_d2h_bytes']} B; launches "
                f"{r['launches']}")
        want = spec_pipeline([str(sf)], str(uf), k=K, m=M, graph=graph,
                             mode=mode)
        for what, blob, spec_blob in (("paths", outputs["bytes"][0], want[0]),
                                      ("notAligned.fa", outputs["bytes"][1],
                                       want[1])):
            got_recs = records(blob)
            picked = b"".join(got_recs.get(b">r" + str(i).encode(), b"")
                              for i in sample)
            if picked != spec_blob:
                raise AssertionError(f"{tag} {what}: the {len(sample)} "
                                     "sampled reads differ from the spec")
        for name in names:
            rows = [x for x in runs[name] if "align_s" in x]
            med = {key: statistics.median(x[key] for x in rows)
                   for key in rows[0]}
            med["busy"] = runs[name][-1]["busy"]
            log(f"{tag} {name}: median of {len(rows)} turns: align_seconds"
                f" {med['align_s']:.3f}, mapping {med['map_rps']:.1f} "
                f"reads/s, end-to-end {med['e2e_rps']:.1f} reads/s, launch "
                f"leg {med['launch']:.2f} ms and drain leg "
                f"{med['drain']:.2f} ms (format {med['format']:.2f} ms) per "
                f"batch, device busy share "
                f"{med['busy']:.6f}, peak +{med['peak']:.0f} B")
        log(f"{tag} bytes equal across {len(order) + len(names)} runs "
            f"({', '.join(names)}); {len(sample)} sampled reads "
            f"(128 of each batch) byte-identical to the spec")
        npz.unlink()


def coordinator_phase(td: Path, rf: Path, uf: Path, single, single_summ):
    """[coordinator]: two processes on the card joined by `--coordinator`
    (each with jax and dbgtpu blocked): process 0's stats block holds
    the whole file's counts, process 1 prints none, the merged shards
    equal the single run's bytes."""
    import socket

    from dbgtpu_torch.dist.multihost import merge_shards

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['dbgtpu'] = None\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from dbgtpu_torch import cli\n"
            "rc = cli.main(sys.argv[1:])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'dbgtpu') and sys.modules[m] is not None]\n"
            "if bad:\n"
            "    raise SystemExit(f'imported during the run: {bad[:5]}')\n"
            "sys.exit(rc)\n")
    argv = ["-r", str(rf), "-k", str(K), "-g", str(uf), "-m", str(M),
            "-e", str(EFFORT), "--batch-size", str(BATCH),
            "-f", str(td / "cpaths"), "-a", str(td / "cna.fa"),
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *argv, "--process-id", str(pid)],
        cwd=td, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.monotonic() - t0
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"[coordinator] process {pid} exited "
                                 f"{p.returncode}: {err[-2000:]}")
    block = [f"Reads : {single_summ['reads']}\n",
             f"No overlap : {single_summ['no_overlap']} ",
             f"Overlap and aligned : {single_summ['aligned']} ",
             f"Overlap but not aligned : {single_summ['not_aligned']} "]
    missing = [ln for ln in block if ln not in outs[0][0]]
    if missing or "Reads :" in outs[1][0]:
        raise AssertionError(f"[coordinator] process 0's block lacks "
                             f"{missing}, or process 1 printed one")
    merge_shards(str(td / "cpaths"), 2)
    merge_shards(str(td / "cna.fa"), 2)
    if ((td / "cpaths").read_bytes(), (td / "cna.fa").read_bytes()) != single:
        raise AssertionError("[coordinator] the merged shards differ from "
                             "the single run's bytes")
    log(f"[coordinator] 2 processes on the card, --coordinator "
        f"127.0.0.1:{port} --num-processes 2 (gloo): process 0 printed the "
        f"global block ({single_summ['reads']} reads, "
        f"{single_summ['aligned']} aligned), process 1 none; merged shards "
        f"== the single run's bytes ({wall:.1f} s for both processes)")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-csrc", metavar="DIR",
                    help="also build the kernels of DIR (another tree's "
                         "dbgtpu_torch/csrc) and time each kernel alone "
                         "beside this tree's, in turns")
    ap.add_argument("--baseline-runner", metavar="FILE",
                    help="also map the [runner] reads with FILE (another "
                         "tree's dbgtpu_torch/engine/runner.py), in turns "
                         "with this tree's runner")
    ap.add_argument("--shard-only", action="store_true",
                    help="build, then run the sharded index's [shard] "
                         "lines alone (K13, K2 and K3 on the survey index "
                         "cut into ranges) and stop without a result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    block_reference_packages()
    sys.path.insert(0, str(ROOT))
    SCRATCH.mkdir(parents=True, exist_ok=True)
    # the native parser builds its library here (default: the temp dir)
    os.environ["DBGTPU_NATIVE_CACHE"] = str(SCRATCH / "native")

    import numpy as np

    from dbgtpu_torch import cli, native
    from dbgtpu_torch.engine.index import index_tensors
    from dbgtpu_torch.engine.runner import (
        _bucket_len, _pmax_cap, _pmax_for, get_device_index,
    )
    from dbgtpu_torch.index import device as dev_index
    from dbgtpu_torch.index.build import build_graph, build_graph_from_seqs
    from dbgtpu_torch.index.mphf import build_mphf
    from dbgtpu_torch.kernels import build
    from tests import synth

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
    log_resources("this tree", build.kernel_resources(), build.load())
    if args.baseline_csrc:
        t0 = time.monotonic()
        BASELINE["lib"] = build.load_from(Path(args.baseline_csrc))
        log(f"[build] baseline kernels from {args.baseline_csrc}: "
            f"{build.library_path(Path(args.baseline_csrc).resolve()).name}"
            f", {time.monotonic() - t0:.1f} s")
        base_resources = build.kernel_resources(
            Path(args.baseline_csrc).resolve())
        log_resources("baseline", base_resources, BASELINE["lib"])
        # the kernels that run K7's device function inline
        log_resource_pairs(build.kernel_resources(), base_resources,
                           ("member", "walk", "dog", "exhaustive"))
    t0 = time.monotonic()
    if not native.available():
        raise AssertionError("the native parser / formatter did not build "
                             "(g++): the run would take the python fallback")
    log(f"[build] native parser/formatter: available "
        f"({time.monotonic() - t0:.1f} s, g++)")

    if args.shard_only:
        unitigs, codes_all = survey_workload()
        di = get_device_index(build_graph_from_seqs(unitigs, K), "scan")
        L = _bucket_len(codes_all.shape[1], K)
        t0 = time.monotonic()
        compare_shards(di, index_tensors(di, device),
                       survey_batches(codes_all, L, device), device, k=K,
                       m=M, effort=EFFORT, L=L,
                       pmax=min(_pmax_for(di, L), _pmax_cap(L)))
        assert_reference_packages_unused()
        log(f"[shard] the sharded index: {time.monotonic() - t0:.1f} s; "
            "--shard-only: no result line")
        return 0

    # ---- phase 2: kernels against their plain versions ----
    t0 = time.monotonic()
    unitigs, codes_all = survey_workload()
    n_reads, read_len = codes_all.shape
    log(f"[workload] {len(unitigs)} unitigs, {n_reads} reads of "
        f"{read_len} bp ({time.monotonic() - t0:.1f} s)")
    k, m, effort, B = K, M, EFFORT, BATCH
    graphs, ixs = {}, {}
    for dog in (False, True):
        graphs[dog] = build_graph_from_seqs(unitigs, k, dog_mode=dog)
        for layout in ("scan", "mphf"):
            t0 = time.monotonic()
            di = get_device_index(graphs[dog], layout)
            ix = ixs[layout, dog] = index_tensors(di, device)
            torch.cuda.synchronize()
            log(f"[index] {'dog-mode ' if dog else ''}{layout} device index "
                f"{time.monotonic() - t0:.1f} s: st_fused "
                f"{tuple(ix.st_fused.shape)}, umeta {tuple(ix.umeta.shape)}, "
                f"pt_rows {tuple(ix.pt_rows.shape)}, at_fused "
                f"{tuple(ix.at_fused.shape)}, mph_rows/jrows/f "
                f"{tuple(ix.mph_rows.shape)}/{tuple(ix.mph_jrows.shape)}/"
                f"{tuple(ix.mph_f.shape)}, amph_rows/arows/f "
                f"{tuple(ix.amph_rows.shape)}/{tuple(ix.amph_arows.shape)}/"
                f"{tuple(ix.amph_f.shape)}; hbm_report "
                f"{dev_index.hbm_report(di)}")
    graph, di = graphs[False], get_device_index(graphs[False], "scan")
    L = _bucket_len(read_len, k)
    pmax = min(_pmax_for(di, L), _pmax_cap(L))
    batches = survey_batches(codes_all, L, device)
    words, nmbits, lens = batches[0]
    results = {}
    for layout in ("scan", "mphf"):
        for mode in PATH_KERNELS:
            ix = ixs[layout, mode == "anchors"]
            # also K2's per-position branch, which the survey batch (no
            # N, a probe table) does not take
            perpos = (dataclasses.replace(ix, pt_rows=ix.pt_rows[:0])
                      if mode != "anchors" else None)
            results[layout, mode] = compare_kernels(
                ix, words, nmbits, lens, mode=mode, k=k, m=m, effort=effort,
                L=L, pmax=pmax, timed=True, perpos_ix=perpos,
                more=batches[1:])
            for name, r in results[layout, mode].items():
                log(f"[kernel] {layout} {mode}: {name}: == plain version "
                    f"(max abs err {r['max_abs_err']}, tolerance 0); kernel "
                    f"alone {r['alone_ms']:.4f} ms ({ALONE_LAUNCHES} "
                    f"back-to-back launches through the C entry point, "
                    f"rotating over {r['alone_batches']} batches)"
                    + (f", baseline kernel alone "
                       f"{r['baseline_alone_ms']:.4f} ms (turns baseline, "
                       f"this, this, baseline: " + ", ".join(
                           f"{t:.4f}" for t in r["alone_turns_ms"]) + ")"
                       if "baseline_alone_ms" in r else "")
                    + graph_part(r)
                    + f", one call through the wrapper {r['ms']:.4f} ms, "
                    f"plain {r['plain_ms']:.4f} ms, bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
                    f"{r['bound_bytes']} B, {r['bound_ops']} operations)"
                    + (f", from the packed batch in and the packed rows "
                       f"out alone {r['bound_min_bytes_ms']:.4f} ms"
                       if "bound_min_bytes_ms" in r else "")
                    + (f", junction evaluations (plain version) "
                       f"{r['evaluations']}" if "evaluations" in r else "")
                    + f" per {B}-read batch (L={L}, pmax={pmax})")

    # K2, K3, K5 and K6 on the edge batch (lane-group, window and chunk
    # edges), K4 and K8 at their tile and grid edges
    t0 = time.monotonic()
    n_edge = compare_edge_batch(device) + compare_result_edges(device)
    log(f"[edge] {n_edge} kernel outputs == plain versions "
        f"({time.monotonic() - t0:.1f} s)")

    # --shard-index: K13 and K2 / K3 on the survey index cut into ranges
    t0 = time.monotonic()
    shard_results = compare_shards(di, ixs["scan", False], batches, device,
                                   k=k, m=m, effort=effort, L=L, pmax=pmax)
    log(f"[shard] the sharded index: {time.monotonic() - t0:.1f} s")

    # the timers' floor: a kernel that does nothing
    floor = launch_floor_ms()
    log(f"[floor] a kernel that does nothing (one block of one warp), 200 "
        f"launches a run: {floor[0]:.4f} ms a launch back to back from "
        f"Python, {floor[1]:.4f} ms replayed from a CUDA graph")

    # K7 alone: keys of the set, keys outside it, the all-ones key
    rng = np.random.default_rng(SEED)
    outside = rng.integers(0, 1 << 62, size=100_000, dtype=np.uint64)
    ones = np.array([0xFFFFFFFFFFFFFFFF], np.uint64)

    def table_keys(vrows):
        return ((vrows[:, 0].astype(np.uint64) << np.uint64(32))
                | vrows[:, 1].astype(np.uint64))

    mj = get_device_index(graphs[False], "mphf").mphf_junction
    ma = get_device_index(graphs[True], "mphf").anchor_mphf
    compare_mphf("the survey junction MPHF", mj.mphf, device,
                 np.concatenate([table_keys(mj.jrows), outside, ones]), False)
    compare_mphf("the survey anchor MPHF", ma.mphf, device,
                 np.concatenate([table_keys(ma.arows), outside, ones]), False)
    tight_keys = np.unique(rng.integers(0, 1 << 62, size=200_000,
                                        dtype=np.uint64))
    tight = build_mphf(tight_keys, gamma=1.0, max_levels=2)
    if tight.final_tbl is None:
        raise AssertionError("the tight-gamma MPHF has no final table")
    compare_mphf("a tight-gamma MPHF (gamma 1, 2 levels)", tight, device,
                 np.concatenate([tight_keys, outside, ones]), False)
    compare_mphf("an empty MPHF", build_mphf(np.zeros(0, np.uint64)), device,
                 np.concatenate([outside[:1000], ones]), False)
    # timed at the shape the main path gives it: the check of a table at
    # upload (engine/mphf.py check_mphf_table) in the check mode that
    # runs there; the JSON line's entry is the junction table's (the one
    # MPHF table of the greedy run), its lookup of the same keys beside it
    lookups = [compare_mphf(f"the survey {what} MPHF, its stored keys",
                            m.mphf, device, table_keys(v), True)
               for what, m, v in (("junction", mj, mj.jrows),
                                  ("anchor", ma, ma.arows))]
    checks = [time_mphf_check(f"the survey {what} MPHF", m.mphf, v, device)
              for what, m, v in (("junction", mj, mj.jrows),
                                 ("anchor", ma, ma.arows))]
    results["mphf", "greedy"]["mphf_slots"] = dict(checks[0], lookup={
        key: lookups[0][key] for key in ("alone_ms", "graph_ms", "bound_ms",
                                         "bound_by")})
    t0 = time.monotonic()
    n_edge = compare_mphf_check_edges(device, [
        ("the survey junction MPHF", mj.mphf, mj.jrows),
        ("the survey anchor MPHF", ma.mphf, ma.arows)])
    log(f"[edge] {n_edge} K7 check counts == plain versions "
        f"({time.monotonic() - t0:.1f} s)")

    # K11 and K12 at the edges of their plan; then K9-K12 through the
    # entry point that runs them (both geometries, timed), with its
    # launches
    t0 = time.monotonic()
    n_edge = compare_gather_edges(device) + compare_rowsum_edges(device)
    log(f"[edge] {n_edge} gather outputs == plain versions "
        f"({time.monotonic() - t0:.1f} s)")
    from dbgtpu_torch.tools import exp_gather

    build.reset_launches()
    t0 = time.monotonic()
    exp_results = []
    rc = exp_gather.main(
        ["--baseline-csrc", args.baseline_csrc] if args.baseline_csrc
        else [], results=exp_results)
    gather_launches = dict(build.launches)
    if rc != 0:
        raise AssertionError(f"tools.exp_gather.main exited {rc}")
    log(f"[gather] python -m dbgtpu_torch.tools.exp_gather: "
        f"{time.monotonic() - t0:.1f} s, launches {gather_launches}")
    gather_results = report_gathers(exp_results)
    for name, _, _ in GATHER_KERNELS:
        if gather_launches[name] <= 0:
            raise AssertionError(f"exp_gather did not launch {name}")
    others = [n for n, c in gather_launches.items()
              if c and n not in gather_results]
    if others:
        raise AssertionError(f"exp_gather launched mapping kernels: {others}")

    # ---- phase 3: each mode's path at real size through the CLI ----
    with tempfile.TemporaryDirectory(dir=SCRATCH) as td:
        td = Path(td)
        uf, rf = td / "unitig.fa", td / "reads.fa"
        write_fasta(uf, unitigs)
        chars = np.frombuffer(b"ACGT", np.uint8)
        write_fasta(rf, (chars[r].tobytes() for r in codes_all))
        launches, outputs, summaries = {}, {}, {}

        def cli_run(layout, mode, extra=(), reads=rf, batch=B, suffix="",
                    also=()):
            """One `cli.main` run of `mode` under `layout` with the counts
            set to 0 just before it: (paths bytes, notAligned bytes,
            summary, launches); `suffix` is what the run appends to its
            output files' names (a shard).  Fails unless the run's output
            matches its stats, each kernel of the mode's path and of
            `also` was launched, mphf_slots once per MPHF table of the
            run's index that holds keys and card of the run (its check
            at upload), and no other kernel."""
            flags = MODE_FLAGS[mode] + ["--index-layout", layout, *extra]
            js = td / "summary.json"
            argv = ["-r", str(reads), "-k", str(k), "-g", str(uf),
                    "-m", str(m), "-e", str(effort),
                    "--batch-size", str(batch), "-f", str(td / "paths"),
                    "-a", str(td / "notAligned.fa"),
                    "--json-summary", str(js)] + flags
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            t0 = time.monotonic()
            rc = cli.main(argv)
            wall = time.monotonic() - t0
            peak = torch.cuda.max_memory_allocated()
            counts = dict(build.launches)
            if rc != 0:
                raise AssertionError(f"cli.main {flags} exited {rc}")
            summ = json.loads(js.read_text())
            paths_b = (td / f"paths{suffix}").read_bytes()
            na_b = (td / f"notAligned.fa{suffix}").read_bytes()
            n_paths = paths_b.count(b"\n") // 2
            tag = f"[slice {' '.join(flags)}]"
            log(f"{tag} python -m dbgtpu_torch {' '.join(argv)}")
            log(f"{tag} index {summ['index_seconds']} s (graph build, or "
                f"the index file's load) + "
                f"{summ['device_index_seconds']} s (device index); "
                f"upload {summ['upload_seconds']} s; parse "
                f"{summ['parse_seconds']} s; mapping "
                f"{summ['reads'] / summ['align_seconds']:.1f} reads/s "
                f"({summ['align_seconds']} s for pack + kernels + "
                f"unpack + format of {summ['reads']} reads); end-to-end "
                f"{summ['reads'] / wall:.1f} reads/s ({wall:.2f} s "
                f"wall, map_seconds {summ['map_seconds']}); "
                f"max_memory_allocated {peak} B, of which "
                f"{peak - held} B above the {held} B the script held "
                f"before the run")
            log(f"{tag} {summ['aligned']} aligned, {summ['no_overlap']} "
                f"no overlap, {summ['not_aligned']} not aligned; "
                f"launches {counts}; hbm_report "
                f"{summ['index_hbm_bytes']}; payload H2D "
                f"{summ['payload_h2d_bytes']} B, D2H "
                f"{summ['payload_d2h_bytes']} B (padded rows would be "
                f"{summ['reads'] * (2 + pmax) * 2} B)")
            if n_paths != summ["aligned"]:
                raise AssertionError(f"{tag} output does not match its stats")
            if not summ["aligned"]:
                raise AssertionError(f"{tag} aligned no read")
            want = PATH_KERNELS[mode] + tuple(also) + (
                ("mphf_slots",) if layout == "mphf" else ())
            # one K7 launch per MPHF table of the run's index and card
            # that holds it (a mesh uploads the index to each), at its
            # upload, whatever the table's size
            ix = ixs[layout, mode == "anchors"]
            checks = len(summ["index_card_bytes"]) * sum(
                1 for meta in (ix.mph_meta, ix.amph_meta)
                if meta is not None and meta.n_keys)
            if counts["mphf_slots"] != checks:
                raise AssertionError(
                    f"{tag} mphf_slots launched {counts['mphf_slots']} "
                    f"times, its index's tables on its cards need {checks}")
            missing = [n for n in want if counts[n] <= 0]
            if missing:
                raise AssertionError(f"{tag} kernels not launched: {missing}")
            other = [n for n, c in counts.items() if c and n not in want]
            if other:
                raise AssertionError(f"{tag} kernels of another path "
                                     f"launched: {other}")
            return paths_b, na_b, summ, counts

        for layout in ("scan", "mphf"):
            for mode in MODE_FLAGS:
                paths_b, na_b, summ, counts = cli_run(layout, mode)
                if summ["reads"] != n_reads:
                    raise AssertionError(f"{layout} {mode}: {summ['reads']} "
                                         f"reads mapped of {n_reads}")
                outputs[layout, mode] = (paths_b, na_b)
                launches[layout, mode] = counts
                summaries[layout, mode] = summ
        for mode in MODE_FLAGS:
            if outputs["scan", mode] != outputs["mphf", mode]:
                raise AssertionError(f"{mode}: the mphf layout's bytes "
                                     "differ from the scan layout's")
        log("[slice] every mode: --index-layout mphf bytes == scan bytes")

        # a persisted index: built and saved, then loaded
        for layout, mode in (("scan", "greedy"), ("mphf", "anchors"),
                             ("scan", "exhaustive")):
            npz = td / f"index_{layout}_{mode}.npz"
            built = summaries[layout, mode]
            runs = [("--save-index", cli_run(
                layout, mode, ["--save-index", str(npz)]))]
            t0 = time.monotonic()
            with open(npz, "rb") as f:
                while f.read(1 << 24):
                    pass
            read_s = time.monotonic() - t0
            runs.append(("--load-index", cli_run(
                layout, mode, ["--load-index", str(npz)])))
            for what, (paths_b, na_b, summ, _) in runs:
                if (paths_b, na_b) != outputs[layout, mode]:
                    raise AssertionError(
                        f"{layout} {mode} {what}: bytes differ from the "
                        "built run's")
                for f in ("reads", "aligned", "not_aligned", "no_overlap"):
                    if summ[f] != built[f]:
                        raise AssertionError(
                            f"{layout} {mode} {what}: stats {f} differs")
                log(f"[persist {layout} {mode}] {what}: bytes == the built "
                    f"run's; index_seconds {summ['index_seconds']} + "
                    f"device_index_seconds {summ['device_index_seconds']} + "
                    f"upload_seconds {summ['upload_seconds']} (built run: "
                    f"{built['index_seconds']} + "
                    f"{built['device_index_seconds']} + "
                    f"{built['upload_seconds']}); file "
                    f"{npz.stat().st_size} B, read alone in {read_s:.3f} s")
            npz.unlink()

        # a journaled run killed after its first segment, then resumed
        # (4 segments of 4 batches of 8,192 reads)
        from dbgtpu_torch import pipeline as pipeline_mod

        real_align, calls = pipeline_mod.align_bulk, []

        def dying(*a, **kw):
            calls.append(1)
            if len(calls) == 2:
                raise KeyboardInterrupt("killed in the second segment")
            return real_align(*a, **kw)

        for name in ("paths", "notAligned.fa"):
            (td / name).unlink()
        pipeline_mod.align_bulk = dying
        try:
            cli_run("scan", "greedy", ["--resume"], batch=B // 4)
        except KeyboardInterrupt:
            pass
        finally:
            pipeline_mod.align_bulk = real_align
        journal = json.loads((td / "paths.resume.json").read_text())
        if journal["record_off"] != B or len(calls) != 2:
            raise AssertionError(f"the killed run journaled {journal}")
        paths_b, na_b, summ, _ = cli_run("scan", "greedy", ["--resume"],
                                         batch=B // 4)
        if ((paths_b, na_b) != outputs["scan", "greedy"]
                or summ["reads"] != n_reads
                or (td / "paths.resume.json").exists()):
            raise AssertionError("--resume: the resumed run's bytes differ "
                                 "from the uninterrupted run's")
        log(f"[resume] killed after {journal['record_off']} of {n_reads} "
            f"reads ({journal['paths_bytes']} B of paths journaled), "
            f"resumed: bytes == the uninterrupted run's, journal removed")

        # ---- phase 4: bytes against the spec ----
        def probe_present(ix_):
            if ix_.pt_rows.shape[0] == 0:
                raise AssertionError("expected a probe table")

        def probe_less(ix_):
            if ix_.pt_rows.shape[0] != 0:
                raise AssertionError("expected a probe-less index")

        def pool_chunk(ix_):
            if ix_.seq_words != 0:
                raise AssertionError("expected a pool-chunk index")

        def mphf_anchors_on_scan(ix_):
            if ix_.amph_meta is None or ix_.mph_meta is not None:
                raise AssertionError("expected MPHF anchors beside a scan "
                                     "junction table")

        def pool_graph(path, k_, dog):
            cap = dev_index.EMBED_CAP_BASES
            dev_index.EMBED_CAP_BASES = 8
            try:
                g = build_graph(str(path), k_, dog_mode=dog)
                get_device_index(g)
            finally:
                dev_index.EMBED_CAP_BASES = cap
            return g

        def probeless_graph(path, k_, layout="scan"):
            g = build_graph(str(path), k_)
            get_device_index(g, layout).probe_tbl = None
            return g

        def small_mphf_anchor_graph(path, k_):
            """A dog-mode graph whose scan-layout index takes the MPHF
            anchor layout, as keysets of 4,000,000 keys or more do."""
            floor = dev_index.ANCHOR_MPHF_MIN
            dev_index.ANCHOR_MPHF_MIN = 1
            try:
                g = build_graph(str(path), k_, dog_mode=True)
                get_device_index(g)
            finally:
                dev_index.ANCHOR_MPHF_MIN = floor
            return g

        n4 = 4096
        write_fasta(td / "r4096.fa", (chars[r].tobytes()
                                      for r in codes_all[:n4]))
        for layout in ("scan", "mphf"):
            spec_bytes_equal(f"survey first {n4} reads", td / "r4096.fa", uf,
                             k, m, graph, device, layout=layout)
            spec_bytes_equal(f"survey first {n4} reads", td / "r4096.fa", uf,
                             k, m, graphs[True], device, mode="anchors",
                             layout=layout)
            for partial in (False, True):
                spec_bytes_equal(f"survey first {n4} reads", td / "r4096.fa",
                                 uf, k, m, graph, device, probe_present,
                                 mode="exhaustive", partial=partial,
                                 layout=layout)
        spec_bytes_equal(f"survey first {n4} reads, MPHF anchors on the scan "
                         "layout", td / "r4096.fa", uf, k, m,
                         small_mphf_anchor_graph(uf, k), device,
                         mphf_anchors_on_scan, mode="anchors")
        reads_fa, unitigs_fa = synth.make_dataset(
            seed=4242, genome_len=60000, k=21, n_reads=3000, n_frac=0.1)
        nr, nu = td / "nr.fa", td / "nu.fa"
        nr.write_bytes(reads_fa)
        nu.write_bytes(unitigs_fa)
        for layout in ("scan", "mphf"):
            spec_bytes_equal("k=21 with N", nr, nu, 21, 1,
                             build_graph(str(nu), 21), device, probe_present,
                             layout=layout)
            spec_bytes_equal("k=21 with N, probe-less index", nr, nu, 21, 1,
                             probeless_graph(nu, 21, layout), device,
                             probe_less, layout=layout)
            spec_bytes_equal("k=21 with N", nr, nu, 21, 1,
                             build_graph(str(nu), 21, dog_mode=True), device,
                             mode="anchors", layout=layout)
        spec_bytes_equal("k=21 with N, pool-chunk index", nr, nu, 21, 1,
                         pool_graph(nu, 21, False), device, pool_chunk)
        spec_bytes_equal("k=21 with N, pool-chunk index", nr, nu, 21, 1,
                         pool_graph(nu, 21, True), device, pool_chunk,
                         mode="anchors")
        spec_bytes_equal("k=21 with N, MPHF anchors on the scan layout", nr,
                         nu, 21, 1, small_mphf_anchor_graph(nu, 21), device,
                         mphf_anchors_on_scan, mode="anchors")
        reads_fa, unitigs_fa = synth.make_dataset(
            seed=4244, genome_len=60000, k=21, n_reads=1500, n_frac=0.1)
        br, bu = td / "br.fa", td / "bu.fa"
        br.write_bytes(reads_fa)
        bu.write_bytes(unitigs_fa)
        for partial in (False, True):
            for layout in ("scan", "mphf"):
                spec_bytes_equal("1,500 k=21 reads with N", br, bu, 21, 1,
                                 build_graph(str(bu), 21), device,
                                 probe_present, mode="exhaustive",
                                 partial=partial, layout=layout)
            spec_bytes_equal("1,500 k=21 reads with N, probe-less index", br,
                             bu, 21, 1, probeless_graph(bu, 21), device,
                             probe_less, mode="exhaustive", partial=partial)
        # path modes: host spec only, no kernel may launch
        from dbgtpu_torch.spec import run_pipeline as spec_pipeline

        n5 = 512
        write_fasta(td / "r512.fa", (chars[r].tobytes()
                                     for r in codes_all[:n5]))
        for flags, mode in ((["-p"], "paths"),
                            (["-p", "-b"], "paths-exhaustive")):
            js = td / "summary.json"
            build.reset_launches()
            t0 = time.monotonic()
            rc = cli.main(["-r", str(td / "r512.fa"), "-k", str(k), "-g",
                           str(uf), "-m", str(m), "-f", str(td / "paths"),
                           "-a", str(td / "notAligned.fa"),
                           "--json-summary", str(js)] + flags)
            wall = time.monotonic() - t0
            summ = json.loads(js.read_text())
            want = spec_pipeline([str(td / "r512.fa")], str(uf), k=k, m=m,
                                 graph=graph, mode=mode)
            if (rc != 0 or any(build.launches.values())
                    or summ["device"] != "host-spec"
                    or (td / "paths").read_bytes() != want[0]
                    or (td / "notAligned.fa").read_bytes() != want[1]
                    or not summ["aligned"]):
                raise AssertionError(
                    f"{' '.join(flags)}: rc {rc}, launches "
                    f"{build.launches}, device {summ['device']}, or bytes "
                    "differ from the spec")
            log(f"[bytes] first {n5} survey reads [{' '.join(flags)}]: "
                f"{summ['aligned']} aligned, byte-identical to the spec, "
                f"device {summ['device']}, no kernel launched "
                f"({wall:.2f} s)")

        # 2 processes, each its record range of the file, merged
        single = cli_run("scan", "greedy", reads=td / "r4096.fa")
        shard_launches = [
            cli_run("scan", "greedy",
                    ["--num-processes", "2", "--process-id", str(pid)],
                    reads=td / "r4096.fa", suffix=f".shard{pid}")[3]
            for pid in (0, 1)]
        if cli.main(["-r", str(td / "r4096.fa"), "-f", str(td / "paths"),
                     "-a", str(td / "notAligned.fa"),
                     "--merge-shards", "2"]) != 0:
            raise AssertionError("--merge-shards failed")
        if ((td / "paths").read_bytes(),
                (td / "notAligned.fa").read_bytes()) != single[:2]:
            raise AssertionError("the merged shards differ from the single "
                                 "run")
        log(f"[shards] {n4} reads over 2 processes, merged: bytes == the "
            f"single run's; launches {shard_launches}")

        # 64-bit k-mers with 300-bp reads (L=512): k-1 = 31 in greedy
        # mode, whole 32-mers in dog mode (through the anchor MPHF too);
        # and stride-1 unitigs whose paths overflow pmax (host recompute)
        for label, k_, cases, kw in (
            ("k=32, 300-bp reads with N", 32,
             (("greedy", "scan"), ("anchors", "scan"), ("anchors", "mphf")),
             dict(n_frac=0.1, read_len=300, genome_len=60000)),
            ("k=15, 15-18 bp unitigs (pmax overflow)", 15,
             (("greedy", "scan"), ("greedy", "mphf")),
             dict(min_unitig=15, max_unitig=18, decoy_frac=0.0,
                  genome_len=20000)),
        ):
            reads_fa, unitigs_fa = synth.make_dataset(
                seed=4343, k=k_, n_reads=2000, **kw)
            (td / "xr.fa").write_bytes(reads_fa)
            (td / "xu.fa").write_bytes(unitigs_fa)
            for mode, layout in cases:
                spec_bytes_equal(
                    label, td / "xr.fa", td / "xu.fa", k_, 2,
                    build_graph(str(td / "xu.fa"), k_,
                                dog_mode=mode == "anchors"),
                    device, mode=mode, layout=layout)

        # ---- phase 5: the run modes: the pipelined runner at 1M reads,
        # a mesh, a coordinated run, a profiler trace ----
        runner_phase(td, uf, graphs, args.baseline_runner)
        import re

        from dbgtpu_torch.dist.mesh import make_mesh

        mesh = make_mesh(None, device)
        for layout, mode in (("scan", "greedy"), ("mphf", "exhaustive")):
            paths_b, na_b, summ, counts = cli_run(layout, mode,
                                                  ["--mesh", "-1"])
            if (paths_b, na_b) != outputs[layout, mode]:
                raise AssertionError(f"[mesh] {layout} {mode}: bytes differ "
                                     "from the run without a mesh")
            flags = " ".join(["--mesh", "-1", *MODE_FLAGS[mode],
                              "--index-layout", layout])
            log(f"[mesh] {flags}: the mesh took "
                f"{[str(d) for d in mesh]}; bytes == the run without a mesh;"
                f" launches {counts}; align_seconds {summ['align_seconds']}")
        # --shard-index: every local card's range of the two large tables
        # (one card: the mesh of one, the tables as one range); K13 checks
        # each table at upload, one launch per card and table
        n_cards = torch.cuda.device_count()
        mesh_flag = "-1" if n_cards > 1 else "1"
        paths_b, na_b, summ, shard_launches = cli_run(
            "scan", "greedy", ["--mesh", mesh_flag, "--shard-index"],
            also=("sharded_rows",))
        held = summ["index_card_bytes"]
        if (paths_b, na_b) != outputs["scan", "greedy"]:
            raise AssertionError("[shard-index] bytes differ from the run "
                                 "without a mesh")
        if shard_launches["sharded_rows"] != 2 * len(held):
            raise AssertionError(f"[shard-index] sharded_rows launched "
                                 f"{shard_launches['sharded_rows']} times for "
                                 f"{len(held)} cards and 2 tables")
        log(f"[shard-index] ran --mesh {mesh_flag} --shard-index ("
            + ("every local card" if n_cards > 1 else "one card: a mesh of "
               "one device, the tables as one range")
            + f"): bytes == the run without a mesh; index bytes each card "
            f"holds {held} (replicated: {summ['index_hbm_bytes']['total']} "
            f"B, hbm_report {summ['index_hbm_bytes']}); launches "
            f"{shard_launches}; align_seconds {summ['align_seconds']}")
        for flags in (["-G"], ["-b"], ["--index-layout", "mphf"]):
            argv = ["-r", str(td / "r4096.fa"), "-k", str(k), "-g", str(uf),
                    "-f", str(td / "refused_paths"), "-a",
                    str(td / "refused_na"), "--mesh", "1",
                    "--shard-index"] + flags
            try:
                cli.main(argv)
            except ValueError as e:
                if str(e) != SHARD_GUARD_TEXT:
                    raise
            else:
                raise AssertionError(f"[shard-index] {' '.join(flags)} with "
                                     "--shard-index --mesh 1 ran")
            if (td / "refused_paths").exists():
                raise AssertionError(f"[shard-index] {' '.join(flags)} wrote "
                                     "output")
            log(f"[shard-index] {' '.join(flags)} --shard-index --mesh 1: "
                f"ValueError, dbgtpu's text: {SHARD_GUARD_TEXT!r}")
        coordinator_phase(td, rf, uf, outputs["scan", "greedy"],
                          summaries["scan", "greedy"])
        prof_dir = td / "prof"
        paths_b, na_b, summ, counts = cli_run(
            "scan", "greedy", ["--profile-dir", str(prof_dir)])
        traces = sorted(prof_dir.glob("*.json"))
        if (paths_b, na_b) != outputs["scan", "greedy"] or len(traces) != 1:
            raise AssertionError(f"[profile] bytes differ from the run "
                                 f"without the profiler, or traces {traces}")
        text = traces[0].read_text()
        found = {what: len(re.findall(rf'"name":\s*"[^"]*{pattern}', text))
                 for what, pattern in TRACE_KERNELS.items()}
        if not all(found.values()):
            raise AssertionError(f"[profile] the trace lacks kernels: {found}")
        log(f"[profile] --profile-dir: {traces[0].name} "
            f"({traces[0].stat().st_size} B) names " + ", ".join(
                f"{what} ({n} events)" for what, n in found.items())
            + "; bytes == the run without the profiler")

    # ---- phase 6: result ----
    assert_reference_packages_unused()
    kernels = []
    for name, source, replaces in KERNELS:
        run = TIMED_IN.get(name, ("scan", "greedy"))
        r = results[run][name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches[run][name],
                            **{key: r[key] for key in KERNEL_KEYS},
                            **({"lookup": r["lookup"]} if "lookup" in r
                               else {})))
    sources = {name: source for name, source, _ in KERNELS}
    for name, (mode, replaces) in MPHF_ENTRIES.items():
        r = results["mphf", mode][name]
        kernels.append(dict(name=f"{name}@mphf", route="cuda",
                            source=sources[name], replaces=replaces,
                            launches=launches["mphf", mode][name],
                            **{key: r[key] for key in KERNEL_KEYS}))
    for name, source, replaces in GATHER_KERNELS:
        r = gather_results[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=gather_launches[name],
                            **{key: r[key] for key in KERNEL_KEYS}))
    # K13 at its main-path shape (the upload check) with the batch's probe
    # keys beside it; K2 and K3 on the survey index cut into 8 ranges on
    # one card, with the launches of the [shard-index] run
    for name, source, replaces in SHARD_KERNELS:
        base = name.split("@")[0]
        r = shard_results[base]
        extra = {}
        if base == "sharded_rows":
            # the batch's probe keys and the sparse shape, on one card and
            # over the cards, by the plan's path
            for key, b in shard_results["all"].items():
                if key[-1] == "batch probe keys" and (
                        key[1] == max(SHARD_COUNTS) or key[2] != "one card"):
                    label = f"{key[0]} {key[1]} shards on {key[2]}"
                elif key[0] == "sparse":
                    label = f"sparse on {key[1]}"
                else:
                    continue
                extra.setdefault("batch", {})[label] = {k: b[k] for k in (
                    "q", "w", "d", "path", "alone_ms", "ms", "plain_ms",
                    "bound_ms", "library_ms")}
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=shard_launches[base],
                            **{key: r[key] for key in KERNEL_KEYS}, **extra))
    log(card_line())        # the card's name and power limit, as printed
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
