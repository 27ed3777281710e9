// The junction probe shared by K3 (walk.cu) and K6 (exhaustive.cu), and
// the window compare that K5 (dog.cu) also uses: one lookup of a
// junction (k-1)-mer in the junction table (the fused scan table, or
// the MPHF layout through mphf.cuh), then the windowed Hamming compare
// of each of its <= 4 candidate unitigs against the read.
//
// Replaces, in dbgtpu/engine/core.py: _junction_vals (:376),
// _junction_probe (:777) and _window_miss (:703).
//
// Bound on the card: one junction evaluation is a chain of dependent
// reads: the table row (on the scan layout the 32 key-hi and key-lo
// words of a 1,280-byte st_fused row, then one 32-byte sector of values;
// on the MPHF layout a level row and a jrows row), then each candidate's
// umeta header and window words.  The JAX version evaluates all 4
// candidates of a batch at once as [B, 4] arrays.  One thread per read
// (the first port) walked the 32 slots with scalar loads and the
// candidates one after another, at 8 warps per SM.  Here a group of
// GROUP = 8 lanes owns a read (common.cuh): the group compares the row's
// keys as 16-byte vectors (group_slots), the lane that finds the key
// loads the side's 4 ids as one vector and the group sums them by
// shuffle; on the MPHF layout lane 0 runs the chain and the group takes
// the row by shuffle.  Then lane g takes candidate g & 3: lanes c and
// c + 4 read its umeta header and compare alternate 16-base words of its
// window, so the four candidates' reads are in flight together, and
// their misses are summed by one shuffle.  Every lane of `mask` (the
// group's lanes, or the whole warp) must call group_probe together.
//
// Under --shard-index the scan table is cut over the cards of a mesh
// (common.cuh Index, st_row): the row of a key on another card is read
// through its peer pointer inside the walk, as dbgtpu's _junction_vals
// reads it through _sharded_rows (core.py:388-392); the same __ldg vector
// loads serve both, and the chip run holds the walk on an index cut over
// real cards equal to its plain version (csrc/shard.cu says why peer
// reads, not a collective).
#pragma once

#include "mphf.cuh"

namespace dbg {

// Mismatches between the oriented unitig of `meta` at bases
// [ustart, ustart+win) and the read row `rrow` at [rstart, rstart+win),
// plus the set bits of the N-mask row `nrow` (nullptr: none counted),
// over the 16-base words t0, t0 + dt, ... of the window.
__device__ __forceinline__ int window_miss(const Index& ix,
                                           const int32_t* meta, bool is_fwd,
                                           int ustart, int rstart, int win,
                                           const uint32_t* rrow,
                                           const uint32_t* nrow, int RWr,
                                           int t0 = 0, int dt = 1) {
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
  for (int t = t0; 16 * t < win; t += dt) {
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

// candidate c of a junction, core._junction_probe's per-candidate fields
struct Candidate {
  bool valid, ended;
  int sid;        // signed id: negative when the unitig is reverse
  int miss;       // window mismatches, BIG when not valid
  int ul;         // unitig length
  int ust;        // window start in the oriented unitig
  uint64_t nxt_l, nxt_r;   // follow-on junction k-mers, left / right
};

// K3 and K6 give each read a group of GROUP lanes, 4 reads per warp, and
// each group runs its own walk: their shuffles name the group's lanes
// (group_mask()).  A warp per read, its 4 groups repeating the read's
// work so that every shuffle could name the full warp, ran 1.7-2x
// slower on an H100.  The read of this lane's group (groups past the
// batch leave whole):
__device__ __forceinline__ int read_index() {
  return static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / GROUP);
}

// The id in candidate slot group_lane() & 3 of the junction table entry
// of the canonical (k-1)-mer `key` (0 when absent): the 4 right slots
// where `right`, else the 4 left ones (core._junction_vals).  Values of
// every matching slot are summed, as the JAX masked row-sum does (keys
// are unique, so at most one slot matches).
__device__ __forceinline__ int32_t group_cands(const Index& ix, uint64_t key,
                                               bool right, unsigned mask) {
  const int c = group_lane() & 3;
  if (ix.jl_mphf) {
    // the chain of a 20-byte level row and a 40-byte jrows row has
    // nothing to share: lane 0 runs it, the group takes the row
    const uint32_t* row = group_lane() == 0 ? mphf_row(ix.jm, 10, key)
                                            : nullptr;
    row = group_bcast(row, 0, mask);
    return row ? static_cast<int32_t>(__ldg(row + 2 + (right ? 4 : 0) + c))
               : 0;
  }
  const int S = ix.st_cols / 10;
  const uint32_t* row = st_row(ix, key);
  const uint32_t* vals = row + 2 * S + (right ? 4 : 0);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  group_slots(row, S, khi(key), klo(key), 0u, [&](int s) {
    if ((S & 1) == 0) {   // the slot's 4 ids are one 16-byte vector
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(vals + 8 * s));
      v[0] += x.x;
      v[1] += x.y;
      v[2] += x.z;
      v[3] += x.w;
    } else {
      for (int j = 0; j < 4; ++j) v[j] += __ldg(vals + 8 * s + j);
    }
  });
  uint32_t mine = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t sum = group_sum(v[j], mask);
    if (j == c) mine = sum;
  }
  return static_cast<int32_t>(mine);
}

// One junction evaluation by the read's group: the walk phase (mL:
// LEFT, mRF: RIGHT-FIRST, neither: RIGHT-CONTINUE), the junction
// (k-1)-mer `cur` at read position `pos`.  Returns candidate
// group_lane() & 3 with its window misses over the whole window (lanes c
// and c + 4 hold the same candidate); rrow / nrow are the oriented read
// row and its N-mask row (nullptr: none).
__device__ __forceinline__ Candidate group_probe(const Index& ix, bool mL,
                                                 bool mRF, uint64_t cur,
                                                 int pos, int len, int k1,
                                                 const uint32_t* rrow,
                                                 const uint32_t* nrow,
                                                 int RWr, unsigned mask) {
  const uint64_t rc = rcb(cur, k1);
  const bool is_canon = cur <= rc;
  // LEFT wants unitigs ending with the k-mer, RIGHT unitigs beginning
  // with it; the table's 4 left / 4 right slots are per canonical form
  const int32_t cand =
      group_cands(ix, is_canon ? cur : rc, mL ? is_canon : !is_canon, mask);
  const int rem = mL ? pos : (mRF ? len - pos - k1 : len - pos);
  const int32_t* meta =
      ix.umeta + static_cast<size_t>(cand > 0 ? cand : 0) * ix.ucols;
  const int ul = meta[1];
  const uint64_t beg = join(meta[2], meta[3]);
  const uint64_t end = join(meta[4], meta[5]);
  const bool is_fwd = (mL ? end : beg) == cur;
  Candidate o;
  o.valid = cand > 0;
  o.ended = (ul - k1) >= rem;
  o.ul = ul;
  o.ust = (mL && o.ended) ? ul - rem - k1 : (mRF ? k1 : 0);
  o.sid = is_fwd ? cand : -cand;
  // LEFT fwd -> begin, rc -> rc(end); RIGHT fwd -> end, rc -> rc(begin)
  o.nxt_l = is_fwd ? beg : join(meta[8], meta[9]);
  o.nxt_r = is_fwd ? end : join(meta[6], meta[7]);
  int part = 0;
  if (o.valid) {
    const int rstart = mL ? (o.ended ? 0 : pos - (ul - k1))
                          : (mRF ? pos + k1 : pos);
    const int win = o.ended ? rem : ((mL || mRF) ? ul - k1 : min(ul, rem));
    part = window_miss(ix, meta, is_fwd, o.ust, rstart, win, rrow, nrow,
                       RWr, group_lane() >> 2, 2);
  }
  const int miss = part + __shfl_xor_sync(mask, part, 4);
  o.miss = o.valid ? miss : BIG;
  return o;
}

// The candidate of the fewest misses, the earliest on ties (strict <,
// jnp.argmin), given each lane's candidate misses from group_probe: its
// index 0..3, on every lane of the group.
__device__ __forceinline__ int group_argmin(int miss, unsigned mask) {
  int bm = miss, bc = group_lane() & 3;
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const int om = __shfl_xor_sync(mask, bm, o);
    const int oc = __shfl_xor_sync(mask, bc, o);
    if (om < bm || (om == bm && oc < bc)) {
      bm = om;
      bc = oc;
    }
  }
  return bc;
}

}  // namespace dbg
