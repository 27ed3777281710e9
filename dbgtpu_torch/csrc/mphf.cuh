// K7's device function: the BBHash-style MPHF lookup, and the two
// MPHF-backed tables built on it (junction rows, dog anchor rows).
//
// Replaces dbgtpu/engine/core.py _mphf_slot_arrays (:293) over the rows
// of _fuse_mphf (:160), index/mphf.py device_lookup (:248), the MPHF
// branch of _junction_vals (:409-412; junction.cuh group_cands, K2's
// per-position branch) and of dog._anchor_lookup (dog.py:68-79).
//
// A level lookup is one 20-byte rank-group row: word 0 is the rank of
// the group's first bit (rank_base + sample), words 1..4 are 128 bits of
// the level's bitvector.  The JAX version evaluates every level of every
// query, unrolled, and keeps the first hit; a thread here leaves at the
// first level whose bit is set, so a key of the build set costs one row
// read at gamma 16 in nearly every case.  Keys that miss every level go
// to the two-choice final table (4 slots per bucket: 4 key-hi, 4 key-lo,
// 4 values).
#pragma once

#include "common.cuh"

namespace dbg {

// The lookup in two steps, so that a thread can have the row loads of
// several keys in flight before it tests any of them (csrc/mphf.cu):
// the address step (`mphf_probe`): the key's rank-group row at a level
// and the word and bit of its position there; the test step
// (`mphf_hit`, then `mphf_rank`): whether that bit is set in the row's
// word 1 + wsel, and the slot it gives.  `mphf_slot` is the same two
// steps level after level.
struct MphfProbe {
  const uint32_t* row;
  int wsel;
  uint32_t sh;
};

__device__ __forceinline__ MphfProbe mphf_probe(
    const uint32_t* __restrict__ rows, const MphfMeta& mt, int lvl,
    uint32_t hi, uint32_t lo) {
  const uint32_t pos =
      mix32(hi ^ mt.seed_hi[lvl], lo ^ mt.seed_lo[lvl]) & mt.mask[lvl];
  const uint32_t w = pos >> 5;
  return {rows + (static_cast<size_t>(mt.row_off[lvl]) + (w >> 2)) * 5,
          static_cast<int>(w & 3u), pos & 31u};
}

// `word`: the probe's row word 1 + wsel
__device__ __forceinline__ bool mphf_hit(const MphfProbe& p, uint32_t word) {
  return (word >> p.sh) & 1u;
}

// rank = bits set before the position: the group's base, the full words
// below the selected one, and the selected word below bit sh
__device__ __forceinline__ int mphf_rank(const MphfProbe& p, uint32_t word) {
  int rank = static_cast<int>(p.row[0]);
  for (int j = 0; j < p.wsel; ++j) rank += __popc(p.row[1 + j]);
  return rank + __popc(word & ((1u << p.sh) - 1u));
}

// the two-choice final table of the keys that miss every level
__device__ __forceinline__ int mphf_final(const uint32_t* __restrict__ frows,
                                          const MphfMeta& mt, uint32_t hi,
                                          uint32_t lo) {
  int fval = -1;
  if (mt.has_final) {
    // values of every matching slot are summed, as the JAX masked
    // row-sum does (empty slots hold the all-ones key and value 0); the
    // first of the two buckets with a match wins
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t b = (h == 0 ? mix32(hi, lo) : mix32b(hi, lo)) &
                         mt.final_mask;
      const uint32_t* frow = frows + static_cast<size_t>(b) * 12;
      bool any = false;
      uint32_t v = 0;
      for (int s = 0; s < 4; ++s) {
        if (frow[s] == hi && frow[4 + s] == lo) {
          any = true;
          v += frow[8 + s];
        }
      }
      if (fval < 0 && any) fval = static_cast<int>(v);
    }
  }
  return fval;
}

// the lookup from level `first` on: the first level whose bit is set,
// else the final table
__device__ __forceinline__ int mphf_slot_from(
    const uint32_t* __restrict__ rows, const uint32_t* __restrict__ frows,
    const MphfMeta& mt, uint32_t hi, uint32_t lo, int first) {
  for (int lvl = first; lvl < mt.n_levels; ++lvl) {
    const MphfProbe p = mphf_probe(rows, mt, lvl, hi, lo);
    const uint32_t word = p.row[1 + p.wsel];
    if (mphf_hit(p, word)) return mphf_rank(p, word);
  }
  return mphf_final(frows, mt, hi, lo);
}

// key (hi, lo) -> slot in [0, n), or a negative value: not found.  A key
// outside the build set may alias another key's slot; callers verify
// against the key stored at the slot.
__device__ __forceinline__ int mphf_slot(const uint32_t* __restrict__ rows,
                                         const uint32_t* __restrict__ frows,
                                         const MphfMeta& mt, uint32_t hi,
                                         uint32_t lo) {
  return mphf_slot_from(rows, frows, mt, hi, lo, 0);
}

// the row of `t.vrows` (`cols` words wide) at the key's slot when the
// key stored there is the query, else nullptr
__device__ __forceinline__ const uint32_t* mphf_row(const Mphf& t, int cols,
                                                    uint64_t key) {
  const uint32_t hi = khi(key), lo = klo(key);
  const int slot = mphf_slot(t.rows, t.frows, t.meta, hi, lo);
  if (slot < 0 || slot >= t.meta.n_keys) return nullptr;
  const uint32_t* row = t.vrows + static_cast<size_t>(slot) * cols;
  return (row[0] == hi && row[1] == lo) ? row : nullptr;
}

}  // namespace dbg
