// The junction probe shared by K3 (walk.cu), K5 (dog.cu) and K6
// (exhaustive.cu): one candidate lookup of a junction (k-1)-mer in the
// junction table (the fused scan table, or the MPHF layout through
// mphf.cuh) and the windowed Hamming compare of a candidate unitig
// against the read.
//
// Replaces, in dbgtpu/engine/core.py: _junction_vals (:376),
// _junction_probe (:777) and _window_miss (:703).
// The JAX version evaluates all 4 candidates of a batch at once as
// [B, 4] arrays; here a caller asks for one candidate at a time, so the
// greedy walk keeps only the best so far and the DFS only the valid
// ones, in registers.
#pragma once

#include "mphf.cuh"

namespace dbg {

// Mismatches between the oriented unitig of `meta` at bases
// [ustart, ustart+win) and the read row `rrow` at [rstart, rstart+win),
// plus the set bits of the N-mask row `nrow` (nullptr: none counted).
__device__ __forceinline__ int window_miss(const Index& ix,
                                           const int32_t* meta, bool is_fwd,
                                           int ustart, int rstart, int win,
                                           const uint32_t* rrow,
                                           const uint32_t* nrow, int RWr) {
  const int SW = (ix.ucols - META_COLS) / 2;
  const uint32_t* src;
  int nsrc, s0;
  if (SW > 0) {
    // the unitig's packed bases ride in its own umeta row
    src = reinterpret_cast<const uint32_t*>(meta + META_COLS +
                                            (is_fwd ? 0 : SW));
    nsrc = SW;
    s0 = ustart;
  } else {
    // halo'd pool chunk row covering [ustart, ustart + win)
    const int g = meta[0] + ustart;
    const int r = (g >> CHUNK_SHIFT) + (is_fwd ? 0 : ix.n_chunks);
    src = ix.pool + static_cast<size_t>(max(r, 0)) * ix.pool_cols;
    nsrc = ix.pool_cols;
    s0 = g & ((1 << CHUNK_SHIFT) - 1);
  }
  int miss = 0;
  for (int t = 0; 16 * t < win; ++t) {
    const uint32_t x =
        word_at(src, nsrc, s0 + 16 * t) ^ word_at(rrow, RWr, rstart + 16 * t);
    uint32_t mm = (x | (x >> 1)) & LANE_LO;
    if (nrow) mm |= word_at(nrow, RWr, rstart + 16 * t);
    const int v = min(win - 16 * t, 16);
    const uint32_t lane =
        (v >= 16 ? 0xFFFFFFFFu : ((1u << (2 * v)) - 1u)) & LANE_LO;
    miss += __popc(mm & lane);
  }
  return miss;
}

// One junction evaluation: the walk phase (mL: LEFT, mRF: RIGHT-FIRST,
// neither: RIGHT-CONTINUE), the junction (k-1)-mer, the remaining read
// and the <= 4 candidate ids (0 = no candidate).
struct Junction {
  bool mL, mRF;
  uint64_t cur;
  int pos, rem, k1;
  int32_t cand[4];
};

__device__ __forceinline__ Junction junction_lookup(const Index& ix, bool mL,
                                                    bool mRF, uint64_t cur,
                                                    int pos, int len, int k1) {
  Junction j;
  j.mL = mL;
  j.mRF = mRF;
  j.cur = cur;
  j.pos = pos;
  j.k1 = k1;
  j.rem = mL ? pos : (mRF ? len - pos - k1 : len - pos);
  const uint64_t rc = rcb(cur, k1);
  const bool is_canon = cur <= rc;
  int32_t vals8[8];
  const bool found = junction_vals(ix, is_canon ? cur : rc, vals8);
  // LEFT wants unitigs ending with the k-mer, RIGHT unitigs beginning
  // with it; the table's 4 left / 4 right slots are per canonical form
  const bool use_right = mL ? is_canon : !is_canon;
  for (int c = 0; c < 4; ++c) j.cand[c] = found ? vals8[(use_right ? 4 : 0) + c] : 0;
  return j;
}

// candidate c of a junction, core._junction_probe's per-candidate fields
struct Candidate {
  bool valid, ended;
  int sid;        // signed id: negative when the unitig is reverse
  int miss;       // window mismatches, BIG when not valid
  int ul;         // unitig length
  int ust;        // window start in the oriented unitig
  uint64_t nxt_l, nxt_r;   // follow-on junction k-mers, left / right
};

__device__ __forceinline__ Candidate probe_candidate(const Index& ix,
                                                     const Junction& j, int c,
                                                     const uint32_t* rrow,
                                                     const uint32_t* nrow,
                                                     int RWr) {
  const int cand = j.cand[c];
  const int k1 = j.k1;
  const int32_t* meta =
      ix.umeta + static_cast<size_t>(cand > 0 ? cand : 0) * ix.ucols;
  const int ul = meta[1];
  const uint64_t beg = join(meta[2], meta[3]);
  const uint64_t end = join(meta[4], meta[5]);
  const bool is_fwd = (j.mL ? end : beg) == j.cur;
  Candidate o;
  o.valid = cand > 0;
  o.ended = (ul - k1) >= j.rem;
  o.ul = ul;
  o.ust = (j.mL && o.ended) ? ul - j.rem - k1 : (j.mRF ? k1 : 0);
  o.sid = is_fwd ? cand : -cand;
  // LEFT fwd -> begin, rc -> rc(end); RIGHT fwd -> end, rc -> rc(begin)
  o.nxt_l = is_fwd ? beg : join(meta[8], meta[9]);
  o.nxt_r = is_fwd ? end : join(meta[6], meta[7]);
  o.miss = BIG;
  if (o.valid) {
    const int rstart = j.mL ? (o.ended ? 0 : j.pos - (ul - k1))
                            : (j.mRF ? j.pos + k1 : j.pos);
    const int win = o.ended ? j.rem
                            : ((j.mL || j.mRF) ? ul - k1 : min(ul, j.rem));
    o.miss = window_miss(ix, meta, is_fwd, o.ust, rstart, win, rrow, nrow,
                         RWr);
  }
  return o;
}

}  // namespace dbg
