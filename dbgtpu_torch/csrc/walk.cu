// K3 greedy_walk: the greedy junction walk, one lane group per read,
// walking to completion, from one initial state per anchor.
//
// Replaces, in dbgtpu/engine/core.py: _run_walks (:1099: bookkeep :1163,
// junction :1242, final flush :1408-1411) with the junction probe of
// junction.cuh, and for the greedy entry _first_k_hits / _last_k_hits_rc
// (:643, :656).  Two entry points share the walk body:
//  - dbg_greedy_walk picks its anchors from K2's member masks (greedy
//    mode: LEFT at the anchor, budget m, nothing preloaded);
//  - dbg_walk_inits reads per-anchor inits precomputed by K5 (dog mode,
//    engine/dog.py; core.py:1112-1128 for their meaning).
//
// Bound on the card: each junction step is a chain of dependent random
// reads (the junction table row, then up to 4 umeta rows and their
// window words; junction.cuh), and a read's steps are serial, so the
// kernel waits on memory latency and needs many reads in flight.  The
// TPU design advanced the whole batch in lockstep with staged tail
// compaction so that row gathers stayed wide.  The first port ran one
// thread per read in blocks of 128: 8 warps per SM on a 32,768-read
// batch, each thread probing the 32 slots of a row with scalar loads and
// its candidates one after another, and rescanning the member masks byte
// by byte from the start at every anchor fetch.  Here a group of 8 lanes
// owns a read (4 reads per warp: 8,192 warps per batch; 64 registers, 32
// resident warps per SM): the group runs the junction probe of
// junction.cuh (the row's keys as 16-byte vectors, the 4 candidates and
// their windows side by side) and keeps the walk state replicated on its
// lanes, which all take the same branches.  The greedy entry counts a
// read's member bytes once as 16-byte vectors and finds each next anchor
// from a cursor by ballot (common.cuh group_first / group_last), one pass
// over each mask per read in all.  A group runs its own loop and leaves
// when its read is done; the shuffles name the group's lanes only.
//
// The per-read loop keeps the lockstep order of the JAX engine: one
// bookkeep, then one junction, per iteration, capped at max_iters
// iterations; then two more bookkeeps.  A read in DONE is a fixed point
// of both, so leaving the loop early changes nothing.
#include "junction.cuh"

namespace {

// one anchor's initial walk state (core._run_walks `env` entries)
struct Init {
  int ph0;
  uint64_t cur0;
  int pos0;
  uint64_t ra;       // right-walk restart (k-1)-mer
  int ra_pos, bud0, off0, r0, st0;
};

struct Walk {
  int len, k1, k, n_f, n_r;
  // state (core._run_walks `state`)
  int phase, status, orient, aidx;
  uint64_t a;        // anchor (k-1)-mer: restart point of the right walk
  int a_pos;
  uint64_t cur;      // current junction (k-1)-mer
  int pos, budget, offset, llen, rlen;
};

// greedy anchors, from cursors: next(0) is the next forward anchor (the
// first member1 hits, bug values), next(1) the next RC anchor (member2
// hits counted from the end, at RC position len-k1-i, rc-of-std values).
// Each call continues from the last one's position: `fnext` (the next
// forward position to look at) and `rnext` (one past the next RC
// position).  No index: a call gives the anchor after the last one.
struct GreedyAnchors {
  dbg::ByteRow m1, m2;
  const int64_t* bug;
  const int64_t* rcs;
  int len, k1, m;
  int fnext, rnext;

  __device__ Init next(int orient) {
    int i, apos;
    uint64_t val;
    if (orient == 0) {
      i = dbg::group_first(m1, fnext, dbg::group_mask());
      fnext = i + 1;
      val = static_cast<uint64_t>(bug[i]);
      apos = i;
    } else {
      i = dbg::group_last(m2, rnext, dbg::group_mask());
      rnext = i;
      val = static_cast<uint64_t>(rcs[i]);
      apos = len - k1 - i;
    }
    return Init{dbg::LEFT, val, apos, val, apos, m, 0, 0, 0};
  }
};

// precomputed inits: planes int64 [9, 2, B, E]
struct PlaneAnchors {
  const int64_t* planes;
  int B, E, b;

  __device__ int64_t at(int f, int orient, int aidx) const {
    return planes[((static_cast<size_t>(f) * 2 + orient) * B + b) * E + aidx];
  }
  __device__ Init get(int orient, int aidx) {
    return Init{static_cast<int>(at(0, orient, aidx)),
                static_cast<uint64_t>(at(1, orient, aidx)),
                static_cast<int>(at(2, orient, aidx)),
                static_cast<uint64_t>(at(3, orient, aidx)),
                static_cast<int>(at(4, orient, aidx)),
                static_cast<int>(at(5, orient, aidx)),
                static_cast<int>(at(6, orient, aidx)),
                static_cast<int>(at(7, orient, aidx)),
                static_cast<int>(at(8, orient, aidx))};
  }
};

// the anchor w.aidx of orientation w.orient.  bookkeep fetches each
// aidx of an orientation once, in order: aidx starts at 0 and grows by
// one only when the walk from the last anchor failed (junction) or the
// anchor was skipped, so the greedy anchors can come from their cursors.
__device__ Init fetch(GreedyAnchors& a, const Walk& w) {
  return a.next(w.orient);
}
__device__ Init fetch(PlaneAnchors& a, const Walk& w) {
  return a.get(w.orient, w.aidx);
}

// every lane of the read's group runs bookkeep with the same state;
// the group's lane 0 alone writes the output rows
template <class Anchors>
__device__ void bookkeep(Walk& w, Anchors& anchors, int32_t* rbuf) {
  if (w.phase == dbg::FETCH) {
    const int n_cur = w.orient == 0 ? w.n_f : w.n_r;
    if (w.aidx < n_cur) {
      const Init in = fetch(anchors, w);
      if (in.bud0 < 0) {
        // an anchor whose placement already failed: skip it
        w.aidx += 1;
      } else {
        if (in.ph0 == dbg::DONE) w.status = in.st0;
        w.phase = in.ph0;
        w.a = in.ra;
        w.a_pos = in.ra_pos;
        w.cur = in.cur0;
        w.pos = in.pos0;
        w.budget = in.bud0;
        w.llen = 0;
        w.rlen = in.r0 != 0 ? 1 : 0;
        if (in.r0 != 0 && dbg::group_lane() == 0) rbuf[0] = in.r0;
        w.offset = in.off0;
      }
    } else if (w.orient == 0) {
      if (w.n_f == 0) {
        w.status = dbg::STATUS_NO_OVERLAP_FWD;
        w.phase = dbg::DONE;
      } else {
        w.orient = 1;
        w.aidx = 0;
      }
    } else {
      w.status = w.n_r == 0 ? dbg::STATUS_RC_NO_OVERLAP : dbg::STATUS_FAILED;
      w.phase = dbg::DONE;
    }
  }
  // LEFT at the read start: offset 0, switch to the right walk
  if (w.phase == dbg::LEFT && w.pos == 0) {
    w.offset = 0;
    w.phase = dbg::RFIRST;
    w.cur = w.a;
    w.pos = w.a_pos;
  }
  // right walk with nothing left to map
  const int aligned =
      w.orient == 0 ? dbg::STATUS_ALIGNED_FWD : dbg::STATUS_ALIGNED_RC;
  if ((w.phase == dbg::RFIRST && w.len - w.pos - w.k1 == 0) ||
      (w.phase == dbg::RCONT && w.len - w.pos < w.k)) {
    w.status = aligned;
    w.phase = dbg::DONE;
  }
}

__device__ void junction(Walk& w, const dbg::Index& ix, const uint32_t* rwf,
                         const uint32_t* rwr, const uint32_t* nmw, int RWr,
                         int32_t* lbuf, int32_t* rbuf, int P) {
  const bool mL = w.phase == dbg::LEFT;
  const bool mRF = w.phase == dbg::RFIRST;
  if (!(mL || mRF || w.phase == dbg::RCONT)) return;
  // windowed compare against the orientation-selected read row; the
  // N-mask counts only for forward-oriented walks
  const unsigned mask = dbg::group_mask();
  const dbg::Candidate o = dbg::group_probe(
      ix, mL, mRF, w.cur, w.pos, w.len, w.k1, w.orient == 0 ? rwf : rwr,
      w.orient == 0 ? nmw : nullptr, RWr, mask);
  const int bc = dbg::group_argmin(o.miss, mask);
  const int best = dbg::group_bcast(o.miss, bc, mask);
  if (best > w.budget) {  // fail -> next anchor
    w.phase = dbg::FETCH;
    w.aidx += 1;
    return;
  }
  const int sid = dbg::group_bcast(o.sid, bc, mask);
  const bool ended =
      dbg::group_bcast(static_cast<int>(o.ended), bc, mask) != 0;
  const int ul = dbg::group_bcast(o.ul, bc, mask);
  const int ust = dbg::group_bcast(o.ust, bc, mask);
  const uint64_t nxt = dbg::group_bcast(mL ? o.nxt_l : o.nxt_r, bc, mask);
  if (dbg::group_lane() == 0) {
    if (mL)
      lbuf[min(max(w.llen, 0), P - 1)] = sid;
    else
      rbuf[min(max(w.rlen, 0), P - 1)] = sid;
  }
  if (mL)
    w.llen += 1;
  else
    w.rlen += 1;
  w.budget -= best;
  const int k1 = w.k1;
  if (mL) {
    if (ended) {  // LEFT ended: record offset, restart right at the anchor
      w.offset = ust;
      w.cur = w.a;
      w.pos = w.a_pos;
      w.phase = dbg::RFIRST;
    } else {
      w.pos -= ul - k1;
      w.cur = nxt;
    }
  } else if (ended) {  // RIGHT ended: aligned
    w.status = w.orient == 0 ? dbg::STATUS_ALIGNED_FWD : dbg::STATUS_ALIGNED_RC;
    w.phase = dbg::DONE;
  } else {
    w.pos += ul - k1;
    w.cur = nxt;
    w.phase = dbg::RCONT;
  }
}

struct Out {
  int32_t *status, *orient, *offset, *llen, *rlen, *lbuf, *rbuf;
};

// the walk body both entries share: bookkeep + junction per iteration,
// then the terminal flush
template <class Anchors>
__device__ void walk_read(Walk& w, Anchors& anchors, const dbg::Index& ix,
                          const uint32_t* rows, int B, int RWr, int b,
                          int max_iters, int P, const Out& out) {
  w.phase = dbg::FETCH;
  w.status = dbg::STATUS_PENDING;
  w.orient = 0;
  w.aidx = 0;
  w.a = 0;
  w.a_pos = 0;
  w.cur = 0;
  w.pos = 0;
  w.budget = 0;
  w.offset = 0;
  w.llen = 0;
  w.rlen = 0;
  const size_t plane = static_cast<size_t>(B) * RWr;
  const uint32_t* rwf = rows + static_cast<size_t>(b) * RWr;
  const uint32_t* rwr = rwf + plane;
  const uint32_t* nmw = rwf + 2 * plane;
  int32_t* lb = out.lbuf + static_cast<size_t>(b) * P;
  int32_t* rb = out.rbuf + static_cast<size_t>(b) * P;
  for (int it = 0; it < max_iters && w.phase != dbg::DONE; ++it) {
    bookkeep(w, anchors, rb);
    junction(w, ix, rwf, rwr, nmw, RWr, lb, rb, P);
  }
  bookkeep(w, anchors, rb);
  bookkeep(w, anchors, rb);
  if (dbg::group_lane() == 0) {
    out.status[b] = w.status;
    out.orient[b] = w.orient;
    out.offset[b] = w.offset;
    out.llen[b] = w.llen;
    out.rlen[b] = w.rlen;
  }
}

constexpr int kThreads = 128;   // 16 reads per block

__global__ void __launch_bounds__(kThreads) greedy_walk_kernel(
    const uint8_t* __restrict__ member1, const uint8_t* __restrict__ member2,
    const int64_t* __restrict__ bug, const int64_t* __restrict__ rcs,
    const int32_t* __restrict__ lens, const uint32_t* __restrict__ rows,
    const __grid_constant__ dbg::Index ix, int B, int Lk, int RWr, int k,
    int m, int E,
    int max_iters, int P, Out out) {
  const int b = dbg::read_index();
  if (b >= B) return;
  const size_t o = static_cast<size_t>(b) * Lk;
  Walk w;
  w.len = lens[b];
  w.k = k;
  w.k1 = k - 1;
  GreedyAnchors anchors{dbg::byte_row(member1 + o, Lk),
                        dbg::byte_row(member2 + o, Lk),
                        bug + o, rcs + o, w.len, w.k1, m, 0, Lk};
  w.n_f = min(dbg::group_count(anchors.m1, dbg::group_mask()), E);
  w.n_r = min(dbg::group_count(anchors.m2, dbg::group_mask()), E);
  walk_read(w, anchors, ix, rows, B, RWr, b, max_iters, P, out);
}

__global__ void __launch_bounds__(kThreads)
    walk_inits_kernel(const int64_t* __restrict__ planes,
                      const int32_t* __restrict__ n,
                      const int32_t* __restrict__ lens,
                      const uint32_t* __restrict__ rows,
                      const __grid_constant__ dbg::Index ix, int B, int RWr,
                      int k, int E, int max_iters, int P, Out out) {
  const int b = dbg::read_index();
  if (b >= B) return;
  Walk w;
  w.len = lens[b];
  w.k = k;
  w.k1 = k - 1;
  w.n_f = n[b];
  w.n_r = n[B + b];
  PlaneAnchors anchors{planes, B, E, b};
  walk_read(w, anchors, ix, rows, B, RWr, b, max_iters, P, out);
}

Out make_out(void* status, void* orient, void* offset, void* llen, void* rlen,
             void* lbuf, void* rbuf) {
  return Out{static_cast<int32_t*>(status), static_cast<int32_t*>(orient),
             static_cast<int32_t*>(offset), static_cast<int32_t*>(llen),
             static_cast<int32_t*>(rlen),   static_cast<int32_t*>(lbuf),
             static_cast<int32_t*>(rbuf)};
}

// blocks for B reads
unsigned blocks_for(int B) {
  const long long threads = static_cast<long long>(B) * dbg::GROUP;
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int dbg_greedy_walk(
    const void* member1, const void* member2, const void* bug,
    const void* rcs, const void* lens, const void* rows, int B, int Lk,
    int RWr, const void* index, int k, int m, int E, int max_iters, int P,
    void* status,
    void* orient, void* offset, void* llen, void* rlen, void* lbuf,
    void* rbuf, void* stream) {
  greedy_walk_kernel<<<blocks_for(B), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(member1),
      static_cast<const uint8_t*>(member2),
      static_cast<const int64_t*>(bug), static_cast<const int64_t*>(rcs),
      static_cast<const int32_t*>(lens), static_cast<const uint32_t*>(rows),
      *static_cast<const dbg::Index*>(index), B, Lk, RWr, k, m, E, max_iters,
      P,
      make_out(status, orient, offset, llen, rlen, lbuf, rbuf));
  DBG_RETURN_LAUNCH_STATUS();
}

extern "C" int dbg_walk_inits(
    const void* planes, const void* n, const void* lens, const void* rows,
    int B, int RWr, const void* index, int k, int E, int max_iters, int P,
    void* status,
    void* orient, void* offset, void* llen, void* rlen, void* lbuf,
    void* rbuf, void* stream) {
  walk_inits_kernel<<<blocks_for(B), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(planes), static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(lens), static_cast<const uint32_t*>(rows),
      *static_cast<const dbg::Index*>(index), B, RWr, k, E, max_iters, P,
      make_out(status, orient, offset, llen, rlen, lbuf, rbuf));
  DBG_RETURN_LAUNCH_STATUS();
}

// threads per block of this file's kernels (build.kernel_resources gives
// ptxas's registers per kernel; with this, the warps per SM they allow)
extern "C" int dbg_walk_threads() { return kThreads; }
