// K3 greedy_walk: anchor pick plus the greedy junction walk, one thread
// per read, walking to completion.
//
// Replaces, in dbgtpu/engine/core.py: _first_k_hits / _last_k_hits_rc
// (:643, :656), the scan-layout branch of _junction_vals (:376),
// _junction_probe (:777), _window_miss (:703) and _run_walks (:1099:
// bookkeep :1163, junction :1242, final flush :1408-1411).
//
// Bound on the card: dependent random row reads (st_fused row, then up
// to 4 umeta rows per junction step), i.e. memory latency; a read's
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
#include "common.cuh"

namespace {

struct Walk {
  // loop constants of the read
  const uint8_t* m1;
  const uint8_t* m2;
  const int64_t* bug;
  const int64_t* rcs;
  int len, Lk, k1, k, m, n_f, n_r;
  // state (core._run_walks `state`)
  int phase, status, orient, aidx;
  uint64_t a;        // anchor (k-1)-mer: restart point of the right walk
  int a_pos;
  uint64_t cur;      // current junction (k-1)-mer
  int pos, budget, offset, llen, rlen;
};

// the (aidx+1)-th forward anchor (first member1 hits, bug values), or
// the (aidx+1)-th RC anchor (member2 hits counted from the end, at RC
// position len-k1-i, rc-of-std values)
__device__ void fetch_anchor(const Walk& w, uint64_t* val, int* apos) {
  if (w.orient == 0) {
    int seen = 0;
    for (int i = 0; i < w.Lk; ++i) {
      if (w.m1[i] && seen++ == w.aidx) {
        *val = static_cast<uint64_t>(w.bug[i]);
        *apos = i;
        return;
      }
    }
  } else {
    int seen = 0;
    for (int i = w.Lk - 1; i >= 0; --i) {
      if (w.m2[i] && seen++ == w.aidx) {
        *val = static_cast<uint64_t>(w.rcs[i]);
        *apos = w.len - w.k1 - i;
        return;
      }
    }
  }
}

__device__ void bookkeep(Walk& w) {
  if (w.phase == dbg::FETCH) {
    const int n_cur = w.orient == 0 ? w.n_f : w.n_r;
    if (w.aidx < n_cur) {
      if (w.m < 0) {
        // an anchor with a negative budget fails before it starts
        w.aidx += 1;
      } else {
        uint64_t val = 0;
        int apos = 0;
        fetch_anchor(w, &val, &apos);
        w.a = val;
        w.a_pos = apos;
        w.cur = val;
        w.pos = apos;
        w.budget = w.m;
        w.llen = 0;
        w.rlen = 0;
        w.offset = 0;
        w.phase = dbg::LEFT;
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

struct Index {
  const uint32_t* st;
  int st_nb, st_cols;
  uint32_t st_seed;
  const int32_t* umeta;
  int ucols;
  const uint32_t* pool;
  int pool_cols, n_chunks;
};

__device__ void junction(Walk& w, const Index& ix, const uint32_t* rwf,
                         const uint32_t* rwr, const uint32_t* nmw, int RWr,
                         int32_t* lbuf, int32_t* rbuf, int P) {
  const bool mL = w.phase == dbg::LEFT;
  const bool mRF = w.phase == dbg::RFIRST;
  if (!(mL || mRF || w.phase == dbg::RCONT)) return;
  const int k1 = w.k1;
  const uint64_t rc = dbg::rcb(w.cur, k1);
  const bool is_canon = w.cur <= rc;
  int32_t vals8[8];
  const bool found = dbg::st_lookup(ix.st, ix.st_nb, ix.st_cols, ix.st_seed,
                                    is_canon ? w.cur : rc, vals8);
  const bool use_right = mL ? is_canon : !is_canon;
  // windowed compare against the orientation-selected read row; the
  // N-mask counts only for forward-oriented walks
  const uint32_t* rrow = w.orient == 0 ? rwf : rwr;
  const uint32_t* nrow = w.orient == 0 ? nmw : nullptr;
  const int rem = mL ? w.pos : (mRF ? w.len - w.pos - k1 : w.len - w.pos);
  const int SW = (ix.ucols - dbg::META_COLS) / 2;

  int best = 0x7fffffff;
  bool b_end = false;
  int b_ul = 0, b_ust = 0, b_sid = 0;
  uint64_t b_nl = 0, b_nr = 0;
  for (int j = 0; j < 4; ++j) {
    const int cand = found ? vals8[(use_right ? 4 : 0) + j] : 0;
    int miss = dbg::BIG;
    const int32_t* meta = ix.umeta + static_cast<size_t>(cand > 0 ? cand : 0) *
                                         ix.ucols;
    const int uoffc = meta[0];
    const int ul = meta[1];
    const uint64_t beg = dbg::join(meta[2], meta[3]);
    const uint64_t end = dbg::join(meta[4], meta[5]);
    const bool is_fwd = (mL ? end : beg) == w.cur;
    const bool ended = (ul - k1) >= rem;
    const int ustart = (mL && ended) ? ul - rem - k1 : (mRF ? k1 : 0);
    if (cand > 0) {
      const int rstart =
          mL ? (ended ? 0 : w.pos - (ul - k1)) : (mRF ? w.pos + k1 : w.pos);
      const int win = ended ? rem : ((mL || mRF) ? ul - k1 : min(ul, rem));
      const uint32_t* src;
      int nsrc, s0;
      if (SW > 0) {
        // the unitig's packed bases ride in its own umeta row
        src = reinterpret_cast<const uint32_t*>(meta + dbg::META_COLS +
                                                (is_fwd ? 0 : SW));
        nsrc = SW;
        s0 = ustart;
      } else {
        // halo'd pool chunk row covering [ustart, ustart + win)
        const int g = uoffc + ustart;
        const int r = (g >> dbg::CHUNK_SHIFT) + (is_fwd ? 0 : ix.n_chunks);
        src = ix.pool + static_cast<size_t>(max(r, 0)) * ix.pool_cols;
        nsrc = ix.pool_cols;
        s0 = g & ((1 << dbg::CHUNK_SHIFT) - 1);
      }
      miss = 0;
      for (int t = 0; 16 * t < win; ++t) {
        const uint32_t x = dbg::word_at(src, nsrc, s0 + 16 * t) ^
                           dbg::word_at(rrow, RWr, rstart + 16 * t);
        uint32_t mm = (x | (x >> 1)) & dbg::LANE_LO;
        if (nrow) mm |= dbg::word_at(nrow, RWr, rstart + 16 * t);
        const int v = min(win - 16 * t, 16);
        const uint32_t lane =
            (v >= 16 ? 0xFFFFFFFFu : ((1u << (2 * v)) - 1u)) & dbg::LANE_LO;
        miss += __popc(mm & lane);
      }
    }
    if (miss < best) {  // earliest index wins ties (jnp.argmin)
      best = miss;
      b_end = ended;
      b_ul = ul;
      b_ust = ustart;
      b_sid = is_fwd ? cand : -cand;
      // follow-on junction k-mers: LEFT fwd -> begin, rc -> rc(end);
      // RIGHT fwd -> end, rc -> rc(begin)
      b_nl = is_fwd ? beg : dbg::join(meta[8], meta[9]);
      b_nr = is_fwd ? end : dbg::join(meta[6], meta[7]);
    }
  }
  if (best > w.budget) {  // fail -> next anchor
    w.phase = dbg::FETCH;
    w.aidx += 1;
    return;
  }
  if (mL) {
    lbuf[min(max(w.llen, 0), P - 1)] = b_sid;
    w.llen += 1;
  } else {
    rbuf[min(max(w.rlen, 0), P - 1)] = b_sid;
    w.rlen += 1;
  }
  w.budget -= best;
  if (mL) {
    if (b_end) {  // LEFT ended: record offset, restart right at the anchor
      w.offset = b_ust;
      w.cur = w.a;
      w.pos = w.a_pos;
      w.phase = dbg::RFIRST;
    } else {
      w.pos -= b_ul - k1;
      w.cur = b_nl;
    }
  } else if (b_end) {  // RIGHT ended: aligned
    w.status = w.orient == 0 ? dbg::STATUS_ALIGNED_FWD : dbg::STATUS_ALIGNED_RC;
    w.phase = dbg::DONE;
  } else {
    w.pos += b_ul - k1;
    w.cur = b_nr;
    w.phase = dbg::RCONT;
  }
}

__global__ void greedy_walk_kernel(
    const uint8_t* __restrict__ member1, const uint8_t* __restrict__ member2,
    const int64_t* __restrict__ bug, const int64_t* __restrict__ rcs,
    const int32_t* __restrict__ lens, const uint32_t* __restrict__ rows,
    Index ix, int B, int Lk, int RWr, int k, int m, int E, int max_iters,
    int P, int32_t* __restrict__ status, int32_t* __restrict__ orient,
    int32_t* __restrict__ offset, int32_t* __restrict__ llen,
    int32_t* __restrict__ rlen, int32_t* __restrict__ lbuf,
    int32_t* __restrict__ rbuf) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t o = static_cast<size_t>(b) * Lk;
  Walk w;
  w.m1 = member1 + o;
  w.m2 = member2 + o;
  w.bug = bug + o;
  w.rcs = rcs + o;
  w.len = lens[b];
  w.Lk = Lk;
  w.k = k;
  w.k1 = k - 1;
  w.m = m;
  int c1 = 0, c2 = 0;
  for (int i = 0; i < Lk; ++i) {
    c1 += w.m1[i];
    c2 += w.m2[i];
  }
  w.n_f = min(c1, E);
  w.n_r = min(c2, E);
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
  int32_t* lb = lbuf + static_cast<size_t>(b) * P;
  int32_t* rb = rbuf + static_cast<size_t>(b) * P;
  for (int it = 0; it < max_iters && w.phase != dbg::DONE; ++it) {
    bookkeep(w);
    junction(w, ix, rwf, rwr, nmw, RWr, lb, rb, P);
  }
  bookkeep(w);
  bookkeep(w);
  status[b] = w.status;
  orient[b] = w.orient;
  offset[b] = w.offset;
  llen[b] = w.llen;
  rlen[b] = w.rlen;
}

}  // namespace

extern "C" int dbg_greedy_walk(
    const void* member1, const void* member2, const void* bug,
    const void* rcs, const void* lens, const void* rows, int B, int Lk,
    int RWr, const void* st, int st_nb, int st_cols, unsigned st_seed,
    const void* umeta, int ucols, const void* pool, int pool_cols,
    int n_chunks, int k, int m, int E, int max_iters, int P, void* status,
    void* orient, void* offset, void* llen, void* rlen, void* lbuf,
    void* rbuf, void* stream) {
  Index ix;
  ix.st = static_cast<const uint32_t*>(st);
  ix.st_nb = st_nb;
  ix.st_cols = st_cols;
  ix.st_seed = st_seed;
  ix.umeta = static_cast<const int32_t*>(umeta);
  ix.ucols = ucols;
  ix.pool = static_cast<const uint32_t*>(pool);
  ix.pool_cols = pool_cols;
  ix.n_chunks = n_chunks;
  const int threads = 128;
  greedy_walk_kernel<<<(B + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(member1),
      static_cast<const uint8_t*>(member2),
      static_cast<const int64_t*>(bug), static_cast<const int64_t*>(rcs),
      static_cast<const int32_t*>(lens), static_cast<const uint32_t*>(rows),
      ix, B, Lk, RWr, k, m, E, max_iters, P, static_cast<int32_t*>(status),
      static_cast<int32_t*>(orient), static_cast<int32_t*>(offset),
      static_cast<int32_t*>(llen), static_cast<int32_t*>(rlen),
      static_cast<int32_t*>(lbuf), static_cast<int32_t*>(rbuf));
  DBG_RETURN_LAUNCH_STATUS();
}
