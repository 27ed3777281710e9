// K5 dog_anchors: the anchor stage of dog mode (-G), one thread per read.
//
// Replaces, in dbgtpu/engine/dog.py: the k-mer scan and both branches
// of _anchor_lookup (:59, used at :195-231: the fused scan table, or
// for large keysets and the mphf layout the MPHF slot plus the
// stored-key verify in arows, mphf.cuh), the anchor pick
// (core.py:643 _first_k_hits and :656 _last_k_hits_rc with n_mer = k)
// and _dog_inits (:101), whose placement verify is one window compare
// (junction.cuh window_miss, core.py:703 _window_miss).
//
// Bound on the card: one random 5*S-word row read from the anchor table
// per scanned k-mer (under the MPHF layout a 20-byte level row and a
// 20-byte arows row), then one umeta row and one window compare per
// anchor.  The JAX version looks up every position of every read
// ([B, Lk] row gathers, chunked) and extracts the first / last E hits
// with masked rank sums; only those hits are used, so here a thread
// scans its read from the start until it has E forward anchors and from
// the end until it has E RC anchors, and stops: most reads hit within
// their first k-mers, so a read costs about 2E lookups instead of Lk.
//
// Output: int64 planes [9, 2, B, E] in walk.INIT_FIELDS order (rows
// e >= n are left as they are and never read) and the anchor counts
// n [2, B].
#include "junction.cuh"

namespace {

constexpr int kThreads = 128;

struct AnchorHit {
  bool hit;
  int uid, upos, ucan;
};

// canonical k-mer -> (uid, upos, ucanon).  MPHF layout: the arows row
// (key-hi, key-lo, uid, upos, ucanon) at the key's slot, verified.
// Scan layout: the fused anchor table, S slot key-hi, S slot key-lo,
// then S x (uid, upos, ucanon); values of every matching slot are
// summed, as the JAX masked row-sum does
__device__ __forceinline__ AnchorHit at_lookup(const dbg::Index& ix,
                                               uint64_t key) {
  AnchorHit h{false, 0, 0, 0};
  if (ix.al_mphf) {
    const uint32_t* arow = dbg::mphf_row(ix.am, 5, key);
    if (arow) {
      h.hit = true;
      h.uid = static_cast<int>(arow[2]);
      h.upos = static_cast<int>(arow[3]);
      h.ucan = static_cast<int>(arow[4]);
    }
    return h;
  }
  const int cols = ix.at_cols;
  const int S = cols / 5;
  const uint32_t hi = dbg::khi(key), lo = dbg::klo(key);
  const uint32_t b =
      dbg::mix32(hi ^ ix.at_seed, lo) & static_cast<uint32_t>(ix.at_nb - 1);
  const uint32_t* row = ix.at + static_cast<size_t>(b) * cols;
  uint32_t v[3] = {0, 0, 0};
  for (int s = 0; s < S; ++s) {
    if (row[s] == hi && row[S + s] == lo) {
      h.hit = true;
      for (int c = 0; c < 3; ++c) v[c] += row[2 * S + 3 * s + c];
    }
  }
  h.uid = static_cast<int>(v[0]);
  h.upos = static_cast<int>(v[1]);
  h.ucan = static_cast<int>(v[2]);
  return h;
}

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

__global__ void dog_anchors_kernel(const uint32_t* __restrict__ rows, int B,
                                   int RWr, const int32_t* __restrict__ lens,
                                   const __grid_constant__ dbg::Index ix,
                                   int k, int m, int E,
                                   int64_t* __restrict__ planes,
                                   int32_t* __restrict__ n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int len = lens[b];
  const size_t plane = static_cast<size_t>(B) * RWr;
  const uint32_t* rwf = rows + static_cast<size_t>(b) * RWr;
  const uint32_t* rwr = rwf + plane;
  const uint32_t* nmw = rwf + 2 * plane;
  const Place place{planes, B, E, b, k, m, len, RWr, ix};
  const int last = len - k;   // valid anchor positions 0..len-k
  // forward anchors: the first E hits in read order
  int nf = 0;
  for (int i = 0; i <= last && nf < E; ++i) {
    const uint64_t f = dbg::kmer_at(rwf, RWr, i, k);
    const uint64_t r = dbg::rcb(f, k);
    const bool le = f <= r;
    const AnchorHit h = at_lookup(ix, le ? f : r);
    if (h.hit) place(0, nf++, h, le, i, rwf, nmw);
  }
  // RC anchors: the RC read's e-th anchor is the (e+1)-th hit from the
  // END, at RC position len-k-i, where the read k-mer is r
  int nr = 0;
  for (int i = last; i >= 0 && nr < E; --i) {
    const uint64_t f = dbg::kmer_at(rwf, RWr, i, k);
    const uint64_t r = dbg::rcb(f, k);
    const AnchorHit h = at_lookup(ix, f <= r ? f : r);
    if (h.hit) place(1, nr++, h, r <= f, len - k - i, rwr, nullptr);
  }
  n[b] = nf;
  n[B + b] = nr;
}

}  // namespace

extern "C" int dbg_dog_anchors(const void* rows, int B, int RWr,
                               const void* lens, const void* index, int k,
                               int m, int E, void* planes, void* n,
                               void* stream) {
  dog_anchors_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), B, RWr,
      static_cast<const int32_t*>(lens),
      *static_cast<const dbg::Index*>(index), k, m, E,
      static_cast<int64_t*>(planes),
      static_cast<int32_t*>(n));
  DBG_RETURN_LAUNCH_STATUS();
}
