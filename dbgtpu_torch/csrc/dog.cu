// K5 dog_anchors: the anchor stage of dog mode (-G), one warp per read.
//
// Replaces, in dbgtpu/engine/dog.py: the k-mer scan and both branches
// of _anchor_lookup (:59, used at :195-231: the fused scan table, or
// for large keysets and the mphf layout the MPHF slot plus the
// stored-key verify in arows, mphf.cuh), the anchor pick
// (core.py:643 _first_k_hits and :656 _last_k_hits_rc with n_mer = k,
// :626 _masked_rank_extract) and _dog_inits (:101), whose placement
// verify is one window compare (junction.cuh window_miss, core.py:703
// _window_miss); align_batch_anchors (:161) chains them.
//
// Bound on the card: one random row per scanned k-mer (a 640-byte row
// of the anchor scan table, 168 MB on the survey and beyond the 50 MB
// L2; under the MPHF layout a 20-byte level row and
// a 20-byte arows row), then one umeta row and one window compare per
// anchor.  Only the first / last E hits are used, so a read is scanned
// from the start until it has E forward hits and from the end until it
// has E RC hits.  One thread per read made that scan a chain of
// dependent lookups (a read with few hits chained ~2 Lk of them, and the
// kernel waited for the longest chain) at 12% of the card's threads.
// Here a warp takes a read and looks up a chunk of consecutive
// positions from each end at once: lane groups 0-1 scan forward and 2-3
// from the end while both directions still need hits, all four the one
// left.  On the scan layout a group probes R positions per step with
// 16-byte loads of the keys and of the values beside them, one round
// trip per row (at_group_slots; R = 1, 2, 2, ...: 2, 4, 4, ...
// positions per direction while both scan); on the MPHF layout each
// lane runs its own position's chain (8 positions per group).  Once the
// two scans meet, one that the other found empty ahead of it stops: a
// read without a hit costs one pass over its positions, not two.  The hits
// of a chunk are ranked by ballot and popcount in read order (from the
// end for RC), a direction stops at the first chunk that completes E,
// and each picked hit is placed at once by the lane that looked it up,
// so the placements of a step run side by side.  Lookups past the E-th
// hit of the last chunk are speculative.
//
// Output: int64 planes [9, 2, B, E] in walk.INIT_FIELDS order (rows
// e >= n are left as they are and never read) and the anchor counts
// n [2, B].
#include "junction.cuh"

namespace {

constexpr int kWarps = 4;                 // reads per block
constexpr int kGroupsPerWarp = 32 / dbg::GROUP;
constexpr int kMaxPerGroup = 2;           // scan layout: positions per group

struct AnchorHit {
  bool hit;
  int uid, upos, ucan;
};

struct Place {
  int64_t* planes;
  int B, E, b, k, m, len, RWr;
  const dbg::Index& ix;   // the kernel's grid-constant parameter

  __device__ void put(int f, int orient, int e, int64_t v) const {
    planes[((static_cast<size_t>(f) * 2 + orient) * B + b) * E + e] = v;
  }

  // dog._dog_inits for one anchor: the placement case and its walk init.
  // le: the read k-mer at the anchor is the canonical key; rrow / nrow:
  // packed rows of the oriented read (no N-mask for the RC read)
  __device__ void operator()(int orient, int e, const AnchorHit& h, bool le,
                             int rpos, const uint32_t* rrow,
                             const uint32_t* nrow) const {
    const int k1 = k - 1;
    const int32_t* meta = ix.umeta + static_cast<size_t>(h.uid) * ix.ucols;
    const int ul = meta[1];
    const bool fwd = static_cast<int>(le) == h.ucan;
    const int upos_o = fwd ? h.upos : ul - k - h.upos;
    // oriented begin / end (k-1)-mers straight from the metadata row
    const uint64_t beg = fwd ? dbg::join(meta[2], meta[3])
                             : dbg::join(meta[8], meta[9]);
    const uint64_t end = fwd ? dbg::join(meta[4], meta[5])
                             : dbg::join(meta[6], meta[7]);
    const bool rge = rpos >= upos_o;         // unitig start inside the read
    const int vu = rge ? 0 : upos_o - rpos;  // unitig-side verify start
    const int vr = rge ? rpos - upos_o : 0;  // read-side verify start
    const int w = min(ul - vu, len - vr);    // all four cases unified
    const int errors =
        dbg::window_miss(ix, meta, fwd, vu, vr, w, rrow, nrow, RWr);
    const bool covers = (len - rpos) >= (ul - upos_o);  // reaches unitig end
    const bool case3 = !rge && covers;
    const bool case4 = !rge && !covers;
    put(0, orient, e, case4 ? dbg::DONE : (case3 ? dbg::RFIRST : dbg::LEFT));
    put(1, orient, e, static_cast<int64_t>(case3 ? end : beg));
    put(2, orient, e, rge ? vr : (case3 ? ul - vu - k1 : 0));
    put(3, orient, e, static_cast<int64_t>(end));
    // case 2 parks the right restart at len-k+1, where RIGHT-FIRST ends
    put(4, orient, e, (rge && covers) ? vr + ul - k1 : len - k1);
    put(5, orient, e, m - errors);
    put(6, orient, e, rge ? 0 : vu);
    put(7, orient, e, fwd ? h.uid : -h.uid);
    put(8, orient, e,
        orient == 0 ? dbg::STATUS_ALIGNED_FWD : dbg::STATUS_ALIGNED_RC);
  }
};

// This lane's share of the anchor scan row of the key (hi, lo) (S slot
// key-hi, S slot key-lo, then S x (uid, upos, ucanon)): adds the values
// of every matching slot to v, as the JAX masked row-sum does, and says
// whether one matched.  A lane reads its 4 slots' keys and their 12
// value words as five 16-byte vectors in one round trip; reading the
// values after the match would add a dependent trip to device memory.
__device__ __forceinline__ bool at_group_slots(const uint32_t* __restrict__ row,
                                               int S, uint32_t hi,
                                               uint32_t lo, uint32_t v[3]) {
  const int g = dbg::group_lane();
  bool m = false;
  if ((S & 3) == 0) {
    for (int q = g; 4 * q < S; q += dbg::GROUP) {
      const uint4 h = __ldg(reinterpret_cast<const uint4*>(row) + q);
      const uint4 l = __ldg(reinterpret_cast<const uint4*>(row + S) + q);
      const uint4* vp = reinterpret_cast<const uint4*>(row + 2 * S + 12 * q);
      const uint4 a = __ldg(vp), b = __ldg(vp + 1), c = __ldg(vp + 2);
      const uint32_t hs[4] = {h.x, h.y, h.z, h.w};
      const uint32_t ls[4] = {l.x, l.y, l.z, l.w};
      const uint32_t w[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                              b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (hs[j] == hi && ls[j] == lo) {
          m = true;
          v[0] += w[3 * j];
          v[1] += w[3 * j + 1];
          v[2] += w[3 * j + 2];
        }
    }
  } else {
    for (int s = g; s < S; s += dbg::GROUP)
      if (__ldg(row + s) == hi && __ldg(row + S + s) == lo) {
        m = true;
        for (int c = 0; c < 3; ++c) v[c] += __ldg(row + 2 * S + 3 * s + c);
      }
  }
  return m;
}

// The scan of one direction: its next position and its hits so far.
struct Scan {
  int c, n;
};

// One step of read `b`'s scan: each direction still short of E hits
// looks up its next chunk (forward: positions c, c+1, ...; RC: c, c-1,
// ...), both in the same round trip.  Lane groups 0-1 serve the forward
// scan and 2-3 the RC scan while both run, all four the one left; a group
// owns P positions of its direction's chunk (P = R on the scan layout,
// one lane-group probe each; 8 on the MPHF layout, a chain per lane).
// The hits are ranked in read order (from the end for RC) by ballot and
// popcount, the picked ones (the (n+1)-th .. E-th of the direction) are
// placed by the lanes that found them, and each direction's c and n move
// on.
template <bool kMphf>
__device__ void scan_step(const dbg::Index& ix, const Place& place,
                          const uint32_t* rwf, const uint32_t* rwr,
                          const uint32_t* nmw, int last, int R, Scan& fw,
                          Scan& rc, bool fw_on, bool rc_on) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int g = lane / dbg::GROUP;
  const int gl = dbg::group_lane();
  const int k = place.k;
  const bool both = fw_on && rc_on;
  const int P = kMphf ? dbg::GROUP : R;
  // group -> its direction and its index among that direction's groups
  auto orient_of = [&](int grp) { return both ? grp / 2 : (fw_on ? 0 : 1); };
  auto index_of = [&](int grp) { return both ? grp % 2 : grp; };
  const int orient = orient_of(g);
  const int idx = index_of(g) * P + gl;      // read order in the chunk
  const Scan& d = orient == 0 ? fw : rc;
  const int pos = orient == 0 ? d.c + idx : d.c - idx;
  const bool own = gl < P && pos >= 0 && pos <= last;
  uint64_t f = 0, r = 0, key = 0;
  if (own) {
    f = dbg::kmer_at(rwf, place.RWr, pos, k);
    r = dbg::rcb(f, k);
    key = f <= r ? f : r;
  }
  AnchorHit h{false, 0, 0, 0};
  if (kMphf) {
    // a per-lane MPHF chain: a 20-40 byte row has nothing to share
    if (own) {
      const uint32_t* arow = dbg::mphf_row(ix.am, 5, key);
      if (arow) {
        h.hit = true;
        h.uid = static_cast<int>(arow[2]);
        h.upos = static_cast<int>(arow[3]);
        h.ucan = static_cast<int>(arow[4]);
      }
    }
  } else {
    // lane j of a group owns the group's j-th position; the group probes
    // them in turn, each key hashed once by its owner
    const int S = ix.at_cols / 5;
    const uint32_t* row =
        own ? dbg::scan_row(ix.at, ix.at_nb, ix.at_cols, ix.at_seed, key)
            : ix.at;
#pragma unroll
    for (int j = 0; j < kMaxPerGroup; ++j) {
      if (j >= R) break;                          // R is warp-uniform
      const bool own_j = dbg::group_bcast(static_cast<int>(own), j);
      const uint64_t key_j = dbg::group_bcast(key, j);
      const uint32_t* row_j = dbg::group_bcast(row, j);
      uint32_t v[3] = {0, 0, 0};
      const bool m = own_j && at_group_slots(row_j, S, dbg::khi(key_j),
                                             dbg::klo(key_j), v);
      const bool found = dbg::group_any(m);
      v[0] = dbg::group_sum(v[0]);
      v[1] = dbg::group_sum(v[1]);
      v[2] = dbg::group_sum(v[2]);
      if (gl == j) {
        h.hit = found;
        h.uid = static_cast<int>(v[0]);
        h.upos = static_cast<int>(v[1]);
        h.ucan = static_cast<int>(v[2]);
      }
    }
    h.hit = h.hit && own;
  }
  // each direction's hits in chunk order: group grp's lanes 0..P-1 hold
  // its chunk indices index_of(grp)*P ..
  const unsigned ballot = __ballot_sync(dbg::FULL_WARP, h.hit);
  unsigned Mf = 0u, Mr = 0u;
#pragma unroll
  for (int grp = 0; grp < kGroupsPerWarp; ++grp) {
    const unsigned part = ((ballot >> (dbg::GROUP * grp)) & ((1u << P) - 1u))
                          << (index_of(grp) * P);
    if (orient_of(grp) == 0)
      Mf |= part;
    else
      Mr |= part;
  }
  if (h.hit) {
    const unsigned M = orient == 0 ? Mf : Mr;
    const int e = d.n + __popc(M & ((1u << idx) - 1u));
    if (e < place.E) {
      if (orient == 0)
        place(0, e, h, f <= r, pos, rwf, nmw);
      else
        place(1, e, h, r <= f, place.len - k - pos, rwr, nullptr);
    }
  }
  const int chunk = (both ? 2 : 4) * P;
  if (fw_on) {
    fw.n = min(place.E, fw.n + __popc(Mf));
    fw.c += chunk;
  }
  if (rc_on) {
    rc.n = min(place.E, rc.n + __popc(Mr));
    rc.c -= chunk;
  }
}

// one instantiation per anchor layout, each with its own registers
template <bool kMphf>
__global__ void __launch_bounds__(32 * kWarps)
    dog_anchors_kernel(const uint32_t* __restrict__ rows, int B, int RWr,
                       const int32_t* __restrict__ lens,
                       const __grid_constant__ dbg::Index ix, int k, int m,
                       int E, int64_t* __restrict__ planes,
                       int32_t* __restrict__ n) {
  const int b = static_cast<int>(blockIdx.x) * kWarps +
                static_cast<int>(threadIdx.x) / 32;
  if (b >= B) return;                         // whole warps only
  const int len = lens[b];
  const size_t plane = static_cast<size_t>(B) * RWr;
  const uint32_t* rwf = rows + static_cast<size_t>(b) * RWr;
  const uint32_t* rwr = rwf + plane;
  const uint32_t* nmw = rwf + 2 * plane;
  const Place place{planes, B, E, b, k, m, len, RWr, ix};
  const int last = len - k;   // valid anchor positions 0..last
  // forward anchors: the first E hits in read order; RC anchors: the RC
  // read's e-th anchor is the (e+1)-th hit from the END, at RC position
  // len-k-i, where the read k-mer is r
  Scan fw{0, 0}, rc{last, 0};
  for (int R = 1;; R = min(2 * R, kMaxPerGroup)) {
    // once the two scans have met, a scan whose rest the other one has
    // looked up without a hit has nothing left to find
    const bool met = fw.c > rc.c;
    const bool fw_on = fw.n < E && fw.c <= last && !(met && rc.n == 0);
    const bool rc_on = rc.n < E && rc.c >= 0 && !(met && fw.n == 0);
    if (!fw_on && !rc_on) break;
    scan_step<kMphf>(ix, place, rwf, rwr, nmw, last, R, fw, rc, fw_on,
                     rc_on);
  }
  if ((threadIdx.x & 31) == 0) {
    n[b] = fw.n;
    n[B + b] = rc.n;
  }
}

}  // namespace

extern "C" int dbg_dog_anchors(const void* rows, int B, int RWr,
                               const void* lens, const void* index, int k,
                               int m, int E, void* planes, void* n,
                               void* stream) {
  const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  const dbg::Index& ix = *static_cast<const dbg::Index*>(index);
  auto kernel = ix.al_mphf ? dog_anchors_kernel<true>
                           : dog_anchors_kernel<false>;
  kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), B, RWr,
      static_cast<const int32_t*>(lens), ix, k, m, E,
      static_cast<int64_t*>(planes), static_cast<int32_t*>(n));
  DBG_RETURN_LAUNCH_STATUS();
}

// threads per block of this file's kernels (build.kernel_resources gives
// ptxas's registers per kernel; with this, the warps per SM they allow)
extern "C" int dbg_dog_threads() { return 32 * kWarps; }
