// K3 greedy_walk: the greedy junction walk, one thread per read, walking
// to completion, from one initial state per anchor.
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
// Bound on the card: dependent random row reads (st_fused row, or under
// the mphf layout a level row and a jrows row, then up to 4 umeta rows
// per junction step), i.e. memory latency; a read's
// steps are serial.  The TPU design advanced the whole batch in
// lockstep with staged tail compaction so that row gathers stayed
// wide; here each thread runs its own read's state machine to the end,
// so a read that finishes early frees its lane instead of idling in the
// lockstep loop, and no compaction pass is needed.  Latency is hidden
// by the many reads in flight (32k threads per batch).
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

// greedy anchors: the (aidx+1)-th forward anchor (first member1 hits,
// bug values), or the (aidx+1)-th RC anchor (member2 hits counted from
// the end, at RC position len-k1-i, rc-of-std values)
struct GreedyAnchors {
  const uint8_t* m1;
  const uint8_t* m2;
  const int64_t* bug;
  const int64_t* rcs;
  int Lk, len, k1, m;

  __device__ Init get(int orient, int aidx) const {
    uint64_t val = 0;
    int apos = 0;
    int seen = 0;
    if (orient == 0) {
      for (int i = 0; i < Lk; ++i) {
        if (m1[i] && seen++ == aidx) {
          val = static_cast<uint64_t>(bug[i]);
          apos = i;
          break;
        }
      }
    } else {
      for (int i = Lk - 1; i >= 0; --i) {
        if (m2[i] && seen++ == aidx) {
          val = static_cast<uint64_t>(rcs[i]);
          apos = len - k1 - i;
          break;
        }
      }
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
  __device__ Init get(int orient, int aidx) const {
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

template <class Anchors>
__device__ void bookkeep(Walk& w, const Anchors& anchors, int32_t* rbuf) {
  if (w.phase == dbg::FETCH) {
    const int n_cur = w.orient == 0 ? w.n_f : w.n_r;
    if (w.aidx < n_cur) {
      const Init in = anchors.get(w.orient, w.aidx);
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
        if (in.r0 != 0) rbuf[0] = in.r0;
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
  const dbg::Junction j =
      dbg::junction_lookup(ix, mL, mRF, w.cur, w.pos, w.len, w.k1);
  // windowed compare against the orientation-selected read row; the
  // N-mask counts only for forward-oriented walks
  const uint32_t* rrow = w.orient == 0 ? rwf : rwr;
  const uint32_t* nrow = w.orient == 0 ? nmw : nullptr;
  int best = 0x7fffffff;
  dbg::Candidate b{};
  for (int c = 0; c < 4; ++c) {
    const dbg::Candidate o = dbg::probe_candidate(ix, j, c, rrow, nrow, RWr);
    if (o.miss < best) {  // earliest index wins ties (jnp.argmin)
      best = o.miss;
      b = o;
    }
  }
  if (best > w.budget) {  // fail -> next anchor
    w.phase = dbg::FETCH;
    w.aidx += 1;
    return;
  }
  if (mL) {
    lbuf[min(max(w.llen, 0), P - 1)] = b.sid;
    w.llen += 1;
  } else {
    rbuf[min(max(w.rlen, 0), P - 1)] = b.sid;
    w.rlen += 1;
  }
  w.budget -= best;
  const int k1 = w.k1;
  if (mL) {
    if (b.ended) {  // LEFT ended: record offset, restart right at the anchor
      w.offset = b.ust;
      w.cur = w.a;
      w.pos = w.a_pos;
      w.phase = dbg::RFIRST;
    } else {
      w.pos -= b.ul - k1;
      w.cur = b.nxt_l;
    }
  } else if (b.ended) {  // RIGHT ended: aligned
    w.status = w.orient == 0 ? dbg::STATUS_ALIGNED_FWD : dbg::STATUS_ALIGNED_RC;
    w.phase = dbg::DONE;
  } else {
    w.pos += b.ul - k1;
    w.cur = b.nxt_r;
    w.phase = dbg::RCONT;
  }
}

struct Out {
  int32_t *status, *orient, *offset, *llen, *rlen, *lbuf, *rbuf;
};

// the walk body both entries share: bookkeep + junction per iteration,
// then the terminal flush
template <class Anchors>
__device__ void walk_read(Walk& w, const Anchors& anchors, const dbg::Index& ix,
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
  out.status[b] = w.status;
  out.orient[b] = w.orient;
  out.offset[b] = w.offset;
  out.llen[b] = w.llen;
  out.rlen[b] = w.rlen;
}

__global__ void greedy_walk_kernel(
    const uint8_t* __restrict__ member1, const uint8_t* __restrict__ member2,
    const int64_t* __restrict__ bug, const int64_t* __restrict__ rcs,
    const int32_t* __restrict__ lens, const uint32_t* __restrict__ rows,
    const __grid_constant__ dbg::Index ix, int B, int Lk, int RWr, int k,
    int m, int E,
    int max_iters, int P, Out out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t o = static_cast<size_t>(b) * Lk;
  Walk w;
  w.len = lens[b];
  w.k = k;
  w.k1 = k - 1;
  const GreedyAnchors anchors{member1 + o, member2 + o, bug + o, rcs + o,
                              Lk,          w.len,       w.k1,    m};
  int c1 = 0, c2 = 0;
  for (int i = 0; i < Lk; ++i) {
    c1 += anchors.m1[i];
    c2 += anchors.m2[i];
  }
  w.n_f = min(c1, E);
  w.n_r = min(c2, E);
  walk_read(w, anchors, ix, rows, B, RWr, b, max_iters, P, out);
}

__global__ void walk_inits_kernel(const int64_t* __restrict__ planes,
                                  const int32_t* __restrict__ n,
                                  const int32_t* __restrict__ lens,
                                  const uint32_t* __restrict__ rows,
                                  const __grid_constant__ dbg::Index ix,
                                  int B, int RWr, int k, int E,
                                  int max_iters, int P, Out out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Walk w;
  w.len = lens[b];
  w.k = k;
  w.k1 = k - 1;
  w.n_f = n[b];
  w.n_r = n[B + b];
  const PlaneAnchors anchors{planes, B, E, b};
  walk_read(w, anchors, ix, rows, B, RWr, b, max_iters, P, out);
}

Out make_out(void* status, void* orient, void* offset, void* llen, void* rlen,
             void* lbuf, void* rbuf) {
  return Out{static_cast<int32_t*>(status), static_cast<int32_t*>(orient),
             static_cast<int32_t*>(offset), static_cast<int32_t*>(llen),
             static_cast<int32_t*>(rlen),   static_cast<int32_t*>(lbuf),
             static_cast<int32_t*>(rbuf)};
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int dbg_greedy_walk(
    const void* member1, const void* member2, const void* bug,
    const void* rcs, const void* lens, const void* rows, int B, int Lk,
    int RWr, const void* index, int k, int m, int E, int max_iters, int P,
    void* status,
    void* orient, void* offset, void* llen, void* rlen, void* lbuf,
    void* rbuf, void* stream) {
  greedy_walk_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
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
  walk_inits_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(planes), static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(lens), static_cast<const uint32_t*>(rows),
      *static_cast<const dbg::Index*>(index), B, RWr, k, E, max_iters, P,
      make_out(status, orient, offset, llen, rlen, lbuf, rbuf));
  DBG_RETURN_LAUNCH_STATUS();
}
