// K6 exhaustive_dfs: the branch-and-bound DFS of exhaustive mode (-b,
// -i), one lane group per read, the search run to completion on an
// explicit stack.
//
// Replaces dbgtpu/engine/exhaustive.py align_batch_exhaustive (:83-475):
// bookkeepX (:195) and dfs_step (:261), with the junction probe of
// junction.cuh (core.py:777 _junction_probe, shared with K3).
//
// Bound on the card: the dependent row reads of the junction probes (a
// junction table row and up to 4 umeta rows with their window words per
// populated frame; junction.cuh), plus the stack traffic of deep
// searches.  The JAX version runs the batch in a lockstep while_loop
// (one populate, trial or pop per read per iteration) and compacts
// stragglers into a B/8 sub-batch after 48 iterations, because the
// slowest read sets the loop's length; here each read follows its own
// sequence of the same steps, in the same order, so neither is needed
// and the results are the same.  The first port ran one thread per
// read (8 warps per SM on a 32,768-read batch), probed a row's 32 slots
// with scalar loads, evaluated the candidates one after another and
// scanned `inter` byte by byte.  Here a group of 8 lanes owns a read: the
// junction probe and its 4 candidates' windows run side by side
// (junction.cuh group_probe), the next interesting anchor comes from a
// ballot over 16-byte vectors of `inter` (common.cuh group_first), and
// lane g holds the top frame's compacted candidate g & 3 (lanes c and
// c + 4 the same one), so a trial takes its candidate by shuffle.  The
// scalar DFS state is replicated on the group's lanes, which all take
// the same branches; a group runs its own loop and leaves when its read
// is done.
//
// Frames below the top go to a scratch stack of int32 [B, D, 32]
// (D = L-k+3, the depth bound) that the wrapper allocates per batch:
// read-major, so a frame is 128 contiguous bytes that the group writes
// and reads as one 16-byte vector per lane.  Candidate slot c of a frame
// is 8 words, (sid, miss, ended, ust | npos, next k-mer hi, lo, X_c),
// with X = (tci, tn, tacc, the sid chosen at that level); lane g writes
// and reads back half g >> 2 of slot g & 3.  32 words x 4 B x D x B is
// 352 MB at L=112, k=31, B=32,768, as before: on chip, a frame per level
// would need 10.75 KB of shared memory per read at D = 84, which leaves
// room for a few reads per SM, and a shallow search touches only its
// first frames, which stay in L2.  There is no iteration cap: each push
// consumes at least one base, so every search ends (dbgtpu runs it
// uncapped too).
#include "junction.cuh"

namespace {

constexpr int kThreads = 128;   // 16 reads per block
constexpr int FRAME = 32;       // exhaustive.FRAME_WORDS

// phases (exhaustive.py _FETCHX .. _DONEX)
constexpr int FETCHX = 0, LDFS = 1, RDFS = 2, LDONE = 3, RDONE = 4,
              LRDY = 5, DONEX = 6;
constexpr int F_CSID = 8 * 3 + 7;   // X_3: the sid chosen at a level

__global__ void __launch_bounds__(kThreads) exhaustive_kernel(
    const uint8_t* __restrict__ inter, const int64_t* __restrict__ bug,
    const int32_t* __restrict__ lens, const uint32_t* __restrict__ rows,
    const __grid_constant__ dbg::Index ix, int B, int Lk, int RWr, int k,
    int m, int partial, int D,
    int32_t* __restrict__ stack, int32_t* __restrict__ status_o,
    int32_t* __restrict__ offset_o, int32_t* __restrict__ llen_o,
    int32_t* __restrict__ rlen_o, int32_t* __restrict__ lbuf,
    int32_t* __restrict__ rbuf) {
  const int b = dbg::read_index();
  if (b >= B) return;
  const unsigned mask = dbg::group_mask();
  const int g = dbg::group_lane();
  const int cs = g & 3;          // this lane's candidate slot
  const int half = g >> 2;       // and its half of the slot's words
  const int k1 = k - 1;
  const int len = lens[b];
  const uint32_t* rwf = rows + static_cast<size_t>(b) * RWr;
  const uint32_t* nmw = rwf + 2 * static_cast<size_t>(B) * RWr;
  const dbg::ByteRow it = dbg::byte_row(inter + static_cast<size_t>(b) * Lk,
                                        Lk);
  const int64_t* bg = bug + static_cast<size_t>(b) * Lk;
  int32_t* lb = lbuf + static_cast<size_t>(b) * D;
  int32_t* rb = rbuf + static_cast<size_t>(b) * D;
  int32_t* frames = stack + static_cast<size_t>(b) * D * FRAME;
  // this lane's 16-byte piece of frame d
  auto piece = [&](int d) {
    return reinterpret_cast<int4*>(frames + static_cast<size_t>(d) * FRAME +
                                   8 * cs + 4 * half);
  };

  const int n_pos = len - k1 + 1;
  int phase = n_pos <= 0 ? DONEX : FETCHX;
  int status = n_pos <= 0 ? dbg::STATUS_NO_OVERLAP_FWD : 0;
  int a = 0, best = 0, bl = 0, bloff = 0, bllen = 0, brlen = 0, sp = 0;
  uint64_t ak = 0, tk = 0;
  int tpos = 0, tacc = 0, tci = 0, tn = 0;
  bool tpop = false;
  // the top frame's compacted candidate slot cs (valid ones first)
  int t_sid = 0, t_miss = 0, t_end = 0, t_ust = 0, t_npos = 0;
  uint64_t t_nk = 0;

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
      // none: Lk, which is >= n_pos since len <= L
      const int nxt = dbg::group_first(it, min(max(a, 0), Lk - 1), mask);
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
      const dbg::Candidate o =
          dbg::group_probe(ix, mL, !mL, tk, tpos, len, k1, rwf, nmw, RWr,
                           mask);
      const unsigned valid = dbg::group_ballot(o.valid, mask) & 0xFu;
      const int n = __popc(valid);
      // slot cs takes the (cs+1)-th valid candidate
      unsigned rest = valid;
      for (int j = 0; j < cs; ++j) rest &= rest - 1u;   // drop cs of them
      const int src = cs < n ? __ffs(rest) - 1 : cs;
      t_sid = dbg::group_bcast(o.sid, src, mask);
      t_miss = dbg::group_bcast(o.miss, src, mask);
      t_end = dbg::group_bcast(static_cast<int>(o.ended), src, mask);
      t_ust = dbg::group_bcast(o.ust, src, mask);
      t_npos = tpos + dbg::group_bcast(mL ? k1 - o.ul : o.ul - k1, src, mask);
      t_nk = dbg::group_bcast(mL ? o.nxt_l : o.nxt_r, src, mask);
      tn = n;
      tci = 0;
      tpop = false;
      // -i: a right ROOT junction without candidates is accepted as is
      if (partial && !mL && sp == 0 && n == 0) best = 0;
    } else if (tci >= tn) {
      // pop: the stack underflows into LDONE / RDONE, or the parent frame
      // comes back: each lane reads its own piece and takes the other
      // half of its slot from lane g ^ 4
      sp -= 1;
      if (sp < 0) {
        phase = mL ? LDONE : RDONE;
      } else {
        const int4 mine = *piece(min(sp, D - 1));
        const int4 other{__shfl_xor_sync(mask, mine.x, 4),
                         __shfl_xor_sync(mask, mine.y, 4),
                         __shfl_xor_sync(mask, mine.z, 4),
                         __shfl_xor_sync(mask, mine.w, 4)};
        const int4& lo = half == 0 ? mine : other;
        const int4& hi = half == 0 ? other : mine;
        t_sid = lo.x;
        t_miss = lo.y;
        t_end = lo.z;
        t_ust = lo.w;
        t_npos = hi.x;
        t_nk = dbg::join(hi.y, hi.z);
        tci = dbg::group_bcast(hi.w, 0, mask);
        tn = dbg::group_bcast(hi.w, 1, mask);
        tacc = dbg::group_bcast(hi.w, 2, mask);
      }
    } else {
      // one candidate trial
      const int ci = min(tci, 3);
      const int c_sid = dbg::group_bcast(t_sid, ci, mask);
      const int c_miss = dbg::group_bcast(t_miss, ci, mask);
      const bool c_end = dbg::group_bcast(t_end, ci, mask) != 0;
      const int c_ust = dbg::group_bcast(t_ust, ci, mask);
      const int c_npos = dbg::group_bcast(t_npos, ci, mask);
      const uint64_t c_nk = dbg::group_bcast(t_nk, ci, mask);
      const int total = tacc + c_miss;
      if (c_end && total < best) {
        // terminal candidate, strict improvement: snapshot the chain
        // (the frames' chosen sids, written by lane 7; the barrier
        // orders those writes, and earlier snapshots, before these)
        best = total;
        int32_t* dst = mL ? lb : rb;
        __syncwarp(mask);
        for (int d = g; d < sp && d < D; d += dbg::GROUP)
          dst[d] = frames[static_cast<size_t>(d) * FRAME + F_CSID];
        if (g == 0 && sp < D) dst[sp] = c_sid;
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
        const int x = cs == 0 ? tci : cs == 1 ? tn : cs == 2 ? tacc : c_sid;
        *piece(min(max(sp, 0), D - 1)) =
            half == 0
                ? make_int4(t_sid, t_miss, t_end, t_ust)
                : make_int4(t_npos, static_cast<int>(dbg::khi(t_nk)),
                            static_cast<int>(dbg::klo(t_nk)), x);
        sp += 1;
        tk = c_nk;
        tpos = c_npos;
        tacc = total;
        tpop = true;
      }
    }
  }
  if (g == 0) {
    status_o[b] = status;
    offset_o[b] = bloff;
    llen_o[b] = bllen;
    rlen_o[b] = brlen;
  }
}

}  // namespace

extern "C" int dbg_exhaustive_dfs(
    const void* inter, const void* bug, const void* lens, const void* rows,
    int B, int Lk, int RWr, const void* index, int k, int m, int partial,
    int D, void* stack, void* status, void* offset, void* llen, void* rlen,
    void* lbuf, void* rbuf, void* stream) {
  const long long threads = static_cast<long long>(B) * dbg::GROUP;
  exhaustive_kernel<<<static_cast<unsigned>((threads + kThreads - 1) /
                                            kThreads),
                      kThreads, 0,
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

// threads per block of this file's kernels (build.kernel_resources gives
// ptxas's registers per kernel; with this, the warps per SM they allow)
extern "C" int dbg_exhaustive_threads() { return kThreads; }
