// K6 exhaustive_dfs: the branch-and-bound DFS of exhaustive mode (-b,
// -i), one thread per read, the search run to completion on an explicit
// stack.
//
// Replaces dbgtpu/engine/exhaustive.py align_batch_exhaustive (:83-475):
// bookkeepX (:195) and dfs_step (:261), with the junction probe of
// junction.cuh (core.py:777 _junction_probe, shared with K3).
//
// Bound on the card: the dependent row reads of the junction probes (a
// scan-table row and up to 4 umeta rows per populated frame), plus the
// stack traffic of deep searches.  The JAX version runs the batch in a
// lockstep while_loop (one populate, trial or pop per read per
// iteration) and compacts stragglers into a B/8 sub-batch after 48
// iterations, because the slowest read sets the loop's length; here each
// thread follows its own read's sequence of the same steps, in the same
// order, so neither is needed and the results are the same.
//
// The top frame lives in registers.  Spilled frames go to a scratch
// stack of int32 [D, 32, B] (D = L-k+3, the depth bound) that the
// wrapper allocates per batch: batch-minor, so the threads of a warp
// that sit at the same depth touch neighbouring words.  A frame is
// tci, tn, tacc, the sid chosen at that level, then 7 fields x 4
// candidates (sid, miss, ended, ust, npos, next k-mer hi and lo); only
// the tn valid candidates are written.  32 words x 4 B x D x B is 352 MB
// at L=112, k=31, B=32,768.  Local memory instead would be reserved for
// every resident thread at the largest D the kernel is compiled for.
// There is no iteration cap: each push consumes at least one base, so
// every search ends (dbgtpu runs it uncapped too).
#include "junction.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int FRAME = 32;   // exhaustive.FRAME_WORDS

// phases (exhaustive.py _FETCHX .. _DONEX)
constexpr int FETCHX = 0, LDFS = 1, RDFS = 2, LDONE = 3, RDONE = 4,
              LRDY = 5, DONEX = 6;

// frame word offsets
constexpr int F_CI = 0, F_N = 1, F_ACC = 2, F_CSID = 3, F_SID = 4,
              F_MISS = 8, F_END = 12, F_UST = 16, F_NPOS = 20, F_NHI = 24,
              F_NLO = 28;

struct Top {   // the top frame's candidates, compacted (valid ones first)
  int sid[4], miss[4], end[4], ust[4], npos[4];
  uint64_t nk[4];
};

__global__ void exhaustive_kernel(
    const uint8_t* __restrict__ inter, const int64_t* __restrict__ bug,
    const int32_t* __restrict__ lens, const uint32_t* __restrict__ rows,
    const __grid_constant__ dbg::Index ix, int B, int Lk, int RWr, int k,
    int m, int partial, int D,
    int32_t* __restrict__ stack, int32_t* __restrict__ status_o,
    int32_t* __restrict__ offset_o, int32_t* __restrict__ llen_o,
    int32_t* __restrict__ rlen_o, int32_t* __restrict__ lbuf,
    int32_t* __restrict__ rbuf) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int k1 = k - 1;
  const int len = lens[b];
  const uint32_t* rwf = rows + static_cast<size_t>(b) * RWr;
  const uint32_t* nmw = rwf + 2 * static_cast<size_t>(B) * RWr;
  const uint8_t* it = inter + static_cast<size_t>(b) * Lk;
  const int64_t* bg = bug + static_cast<size_t>(b) * Lk;
  int32_t* lb = lbuf + static_cast<size_t>(b) * D;
  int32_t* rb = rbuf + static_cast<size_t>(b) * D;
  auto slot = [&](int d, int f) -> int32_t& {
    return stack[(static_cast<size_t>(d) * FRAME + f) * B + b];
  };

  const int n_pos = len - k1 + 1;
  int phase = n_pos <= 0 ? DONEX : FETCHX;
  int status = n_pos <= 0 ? dbg::STATUS_NO_OVERLAP_FWD : 0;
  int a = 0, best = 0, bl = 0, bloff = 0, bllen = 0, brlen = 0, sp = 0;
  uint64_t ak = 0, tk = 0;
  int tpos = 0, tacc = 0, tci = 0, tn = 0;
  bool tpop = false;
  Top t;
  for (int c = 0; c < 4; ++c) {
    t.sid[c] = t.miss[c] = t.end[c] = t.ust[c] = t.npos[c] = 0;
    t.nk[c] = 0;
  }

  while (phase != DONEX) {
    // ---- bookkeepX ----
    if (phase == LDONE) {           // left stack exhausted
      if (best <= m) {
        bl = best;
        phase = LRDY;
      } else {
        a += 1;
        phase = FETCHX;
      }
    }
    if (phase == RDONE) {           // right stack exhausted
      if (best <= m - bl) {
        status = dbg::STATUS_ALIGNED_FWD;
        phase = DONEX;
      } else {
        a += 1;
        phase = FETCHX;
      }
    }
    if (phase == FETCHX) {          // advance to the next interesting anchor
      int nxt = dbg::BIG;
      for (int i = min(max(a, 0), Lk - 1); i < Lk; ++i) {
        if (it[i]) {
          nxt = i;
          break;
        }
      }
      if (nxt >= n_pos || a > len - k1) {
        status = dbg::STATUS_FAILED;
        phase = DONEX;
      } else {
        a = nxt;
        ak = static_cast<uint64_t>(bg[nxt]);
        best = m + 1;
        bllen = 0;
        bloff = 0;
        sp = 0;
        tk = ak;
        tpos = a;
        tacc = 0;
        tpop = true;
        phase = LDFS;
        if (a == 0) {   // anchor at the read start: the left walk is done
          bl = 0;
          phase = LRDY;
        }
      }
    }
    if (phase == LRDY) {            // left finished: start the right DFS
      brlen = 0;
      if (len - a - k1 == 0) {
        status = dbg::STATUS_ALIGNED_FWD;
        phase = DONEX;
      } else {
        best = m - bl + 1;
        sp = 0;
        tk = ak;
        tpos = a;
        tacc = 0;
        tpop = true;
        phase = RDFS;
      }
    }
    if (phase != LDFS && phase != RDFS) continue;

    // ---- dfs_step ----
    const bool mL = phase == LDFS;
    if (tpop) {
      // populate the top frame: one junction probe, valid candidates
      // compacted in candidate order
      const dbg::Junction j =
          dbg::junction_lookup(ix, mL, !mL, tk, tpos, len, k1);
      int n = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const dbg::Candidate o = dbg::probe_candidate(ix, j, c, rwf, nmw, RWr);
        if (!o.valid) continue;
#pragma unroll
        for (int s = 0; s <= c; ++s) {   // slot n, by register select
          if (s == n) {
            t.sid[s] = o.sid;
            t.miss[s] = o.miss;
            t.end[s] = o.ended;
            t.ust[s] = o.ust;
            t.npos[s] = mL ? tpos - (o.ul - k1) : tpos + (o.ul - k1);
            t.nk[s] = mL ? o.nxt_l : o.nxt_r;
          }
        }
        ++n;
      }
      tn = n;
      tci = 0;
      tpop = false;
      // -i: a right ROOT junction without candidates is accepted as is
      if (partial && !mL && sp == 0 && n == 0) best = 0;
    } else if (tci >= tn) {
      // pop: the stack underflows into LDONE / RDONE, or the parent frame
      // comes back into the registers
      sp -= 1;
      if (sp < 0) {
        phase = mL ? LDONE : RDONE;
      } else {
        const int d = min(sp, D - 1);
        tci = slot(d, F_CI);
        tn = slot(d, F_N);
        tacc = slot(d, F_ACC);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= tn) break;
          t.sid[c] = slot(d, F_SID + c);
          t.miss[c] = slot(d, F_MISS + c);
          t.end[c] = slot(d, F_END + c);
          t.ust[c] = slot(d, F_UST + c);
          t.npos[c] = slot(d, F_NPOS + c);
          t.nk[c] = dbg::join(slot(d, F_NHI + c), slot(d, F_NLO + c));
        }
      }
    } else {
      // one candidate trial
      const int ci = min(tci, 3);
      int c_sid = 0, c_miss = 0, c_end = 0, c_ust = 0, c_npos = 0;
      uint64_t c_nk = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {   // register select, no local memory
        if (c == ci) {
          c_sid = t.sid[c];
          c_miss = t.miss[c];
          c_end = t.end[c];
          c_ust = t.ust[c];
          c_npos = t.npos[c];
          c_nk = t.nk[c];
        }
      }
      const int total = tacc + c_miss;
      if (c_end && total < best) {
        // terminal candidate, strict improvement: snapshot the chain
        best = total;
        int32_t* dst = mL ? lb : rb;
        for (int d = 0; d < sp && d < D; ++d) dst[d] = slot(d, F_CSID);
        if (sp < D) dst[sp] = c_sid;
        if (mL) {
          bllen = sp + 1;
          bloff = c_ust;
        } else {
          brlen = sp + 1;
        }
      }
      tci += 1;   // a pop resumes after this candidate
      if (!c_end && total < best) {
        // viable non-terminal candidate: spill the top frame, descend
        const int d = min(max(sp, 0), D - 1);
        slot(d, F_CI) = tci;
        slot(d, F_N) = tn;
        slot(d, F_ACC) = tacc;
        slot(d, F_CSID) = c_sid;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= tn) break;
          slot(d, F_SID + c) = t.sid[c];
          slot(d, F_MISS + c) = t.miss[c];
          slot(d, F_END + c) = t.end[c];
          slot(d, F_UST + c) = t.ust[c];
          slot(d, F_NPOS + c) = t.npos[c];
          slot(d, F_NHI + c) = static_cast<int32_t>(dbg::khi(t.nk[c]));
          slot(d, F_NLO + c) = static_cast<int32_t>(dbg::klo(t.nk[c]));
        }
        sp += 1;
        tk = c_nk;
        tpos = c_npos;
        tacc = total;
        tpop = true;
      }
    }
  }
  status_o[b] = status;
  offset_o[b] = bloff;
  llen_o[b] = bllen;
  rlen_o[b] = brlen;
}

}  // namespace

extern "C" int dbg_exhaustive_dfs(
    const void* inter, const void* bug, const void* lens, const void* rows,
    int B, int Lk, int RWr, const void* index, int k, int m, int partial,
    int D, void* stack, void* status, void* offset, void* llen, void* rlen,
    void* lbuf, void* rbuf, void* stream) {
  exhaustive_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(inter), static_cast<const int64_t*>(bug),
      static_cast<const int32_t*>(lens), static_cast<const uint32_t*>(rows),
      *static_cast<const dbg::Index*>(index), B, Lk, RWr, k, m, partial, D,
      static_cast<int32_t*>(stack),
      static_cast<int32_t*>(status), static_cast<int32_t*>(offset),
      static_cast<int32_t*>(llen), static_cast<int32_t*>(rlen),
      static_cast<int32_t*>(lbuf), static_cast<int32_t*>(rbuf));
  DBG_RETURN_LAUNCH_STATUS();
}
