// K2 member: per-position junction membership of the anchor scan.
//
// Replaces, in dbgtpu/engine/core.py: _closure_member (:470), the exact
// per-position lookups _st_member_positions / _st_member (:438, :415)
// and the choice between them (:1033-1051).
//
// Two paths, chosen as the JAX engine chooses them for the whole batch:
//  (a) closure probes (no N in the batch and a probe table present):
//      position i is answered by the probe of canonical (k-1)-mer
//      p = min(W*(i/W)+1, Lk-1) into pt_rows, through the neighbour bits
//      of index/device.py:241-253 (key-hi stored inverted);
//  (b) exact lookups of rep1 (member1) and of the std canonical rep2
//      (member2) in the junction table: st_fused, or under the mphf
//      layout the MPHF slot plus the stored-key verify in jrows
//      (mphf.cuh mphf_row; core.py:434-435, 454-456).  The probe
//      table of path (a) is built under both layouts.
// A second mode serves exhaustive mode (-b): one mask, `inter`
// (dbgtpu/engine/exhaustive.py:118-152), in member1.  Path (a) is the
// same probe; path (b) looks up canonical(bug, rcb(bug)) — the bug scan
// against its own reverse complement, not greedy's rep1 — and position
// 0 is always set: every read tries its first anchor.
//
// Bound on the card: random bucket rows (a probe row is 384-512 bytes,
// a scan row's keys 256 of its 1280, an MPHF lookup a 20-byte level row
// and a 40-byte jrows row), each needed once per probe; the function's
// operations are a 32-slot compare per probe.  The probe table (12.6 MB
// on the survey) lives in L2, so the bytes that bound path (a) are L2
// bytes.  One thread per position read each probe row W times with
// 4-byte loads, hashed it W times and left the Lk/128 tail of every
// block idle.  Here:
//  (a) one thread per window of W positions, windows laid out flat over
//      B x ceil(Lk/W); a lane group of 8 threads (8 windows) probes its
//      8 rows in turn, each lane hashing its own window's k-mer once and
//      reading 16-byte key vectors (common.cuh group_slots), and each
//      thread then sets its window's W mask bytes from the summed
//      neighbour words.  Windows with no valid position are not probed;
//  (b) one thread per position, flat over B x Lk.  Scan layout: the
//      same lane-group probe of st_fused for `found` alone (no value
//      word is read), and rep2 is looked up only where it differs from
//      rep1 (reads without N); mphf layout: each thread runs its own
//      MPHF chain (a 20-40 byte row has nothing to share).
// Each path is its own kernel, with its own registers; threads take
// items in whole warps over a grid that fills the card once.  The
// batch's N flag lies on the device: with a probe table the entry point
// launches path (a), which leaves at once on a batch with N, and then
// path (b), which leaves at once when (a) ran.
//
// Under --shard-index the probe table and the scan table are cut over
// the cards of a mesh: paths (a) and (b) find a key's row through
// common.cuh pt_row / st_row, which read shard s's range through
// pt_shards[s] / st_shards[s] (dbgtpu's _closure_member and _st_member
// read them through _sharded_rows, core.py:498-503, :420-424).  Two ways
// to fill those pointers, chosen on the host before the launch
// (engine/member.py member_plan):
//   direct: the Index as uploaded, another card's range through its peer
//     pointer.  A peer read is not cached in this card's L2, so a remote
//     row crosses NVLink once per probe of it (about 28 times a survey
//     batch on 4 cards).  Taken with every range on this card, and where
//     the keys repeat too little for a stage to pay.
//   staged (dbg_member_staged, shard.cu): a stage pass first copies each
//     remote row that the batch's keys hit, once, into a stage on this
//     card, and K2 then runs on its own copy of the Index whose remote
//     pt_shards / st_shards point into the stage.  The kernels below do
//     not change: scan_row's arithmetic finds the stage row where it
//     found the remote one.  What they share with the stage pass is in
//     member.cuh (the batch's path, each window's probe position, each
//     position's keys), so that the pass marks exactly the rows they
//     read: a key it missed would read a stale stage row, not fail.
// The __ldg vector loads read peer memory and the stage as they read the
// local range; the chip run holds both paths on an index cut over real
// cards (and the staged one with ranges of one card staged as if remote,
// the stage's unmarked rows poisoned) equal to the plain version.
#include "member.cuh"
#include "mphf.cuh"

namespace {

constexpr int kThreads = 256;

using Args = dbg::MemberArgs;
using dbg::PosKeys;
using dbg::pos_keys;

// the path of the batch (member.cuh member_probes)
__device__ __forceinline__ bool probes(const dbg::Index& ix,
                                       const int32_t* has_n) {
  return dbg::member_probes(ix.pt_nb, has_n);
}

// Items t = 0 .. n-1 in whole warps: each warp takes 32 consecutive
// items at a time (lane i the i-th), so the group shuffles of an
// iteration see all 32 lanes, and the grid strides over the rest.
template <class F>
__device__ __forceinline__ void for_items(uint32_t n, F&& body) {
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const uint32_t warps = (gridDim.x * blockDim.x) >> 5;
  for (uint32_t base = 32u * warp; base < n; base += 32u * warps)
    body(base + lane, base + lane < n);
}

// (a) closure probes: item t is window t of the flat B x ceil(Lk/W)
__global__ void __launch_bounds__(kThreads)
    member_probe_kernel(const Args a, const __grid_constant__ dbg::Index ix,
                        const int32_t* __restrict__ has_n) {
  if (!probes(ix, has_n)) return;
  const int S = ix.pt_slots;
  const int W = dbg::probe_window(ix.pt_cols, S);
  const uint32_t nW = (a.Lk + W - 1) / W;
  for_items(a.B * nW, [&](uint32_t t, bool in_grid) {
    const dbg::Window win = dbg::probe_window_at(a, t, nW, W, in_grid);
    const int b = win.b, i0 = win.i0, p = win.p;
    const int last_valid = win.last_valid;
    const bool live = win.live;
    const size_t row0 = win.row0;
    uint32_t qhi = 0, qlo = 0;
    const uint32_t* row = ix.pt;
    if (live) {
      const uint64_t q = static_cast<uint64_t>(a.rep1[row0 + p]);
      qhi = dbg::khi(q);
      qlo = dbg::klo(q);
      row = dbg::pt_row(ix, q);
    }
    // the group's 8 probes in turn; lane j keeps probe j's neighbour words
    uint32_t w0 = 0, w1 = 0;
#pragma unroll
    for (int j = 0; j < dbg::GROUP; ++j) {
      const bool live_j = dbg::group_bcast(static_cast<int>(live), j);
      const uint32_t hi_j = dbg::group_bcast(qhi, j);
      const uint32_t lo_j = dbg::group_bcast(qlo, j);
      const uint32_t* row_j = dbg::group_bcast(row, j);
      uint32_t s0 = 0, s1 = 0;
      if (live_j)
        dbg::group_slots(row_j, S, hi_j, lo_j, ~0u, [&](int s) {
          s0 += __ldg(row_j + 2 * S + s);
          if (W == 4) s1 += __ldg(row_j + 3 * S + s);
        });
      s0 = dbg::group_sum(s0);
      s1 = dbg::group_sum(s1);
      if (dbg::group_lane() == j) {
        w0 = s0;
        w1 = s1;
      }
    }
    if (!in_grid) return;
    // the window's W positions take their bits (core._closure_member)
    const uint32_t onum = (live && a.le1[row0 + p]) ? 0u : 1u;
    const uint32_t* codes = a.rwf + static_cast<size_t>(b) * a.RWr;
    uint32_t fb = 0, c1 = 0, c2 = 0;
    if (live) {
      fb = dbg::base_at(codes, max(p - 1, 0));
      c1 = dbg::base_at(codes, min(p + a.k1, a.L - 1));
      c2 = dbg::base_at(codes, min(p + a.k1 + 1, a.L - 1));
    }
    const int i1 = min(i0 + W, a.Lk);
    for (int i = i0; i < i1; ++i) {
      const int d = i - p;
      uint32_t idx;
      if (d < 0) {                       // predecessor bit
        idx = 9u + 4u * onum + fb;
      } else if (d == 0) {               // self bit
        idx = 0u;
      } else if (d == 1) {               // one-step successor bit
        idx = 1u + 4u * onum + c1;
      } else {                           // two-step successor bit (W == 4)
        idx = 17u + 16u * onum + ((c1 << 2) | c2);
      }
      const uint32_t bit =
          idx < 32 ? (w0 >> idx) & 1u : (w1 >> (idx - 32)) & 1u;
      const bool m = live && i <= last_valid && bit;
      if (a.exhaustive) {
        a.member1[row0 + i] = (m || i == 0) ? 1 : 0;
      } else {
        a.member1[row0 + i] = m ? 1 : 0;
        a.member2[row0 + i] = m ? 1 : 0;
      }
    }
  });
}

__device__ __forceinline__ void put_members(const Args& a, uint32_t t,
                                            const PosKeys& pk, bool m1,
                                            bool m2) {
  if (a.exhaustive) {
    a.member1[t] = ((pk.valid && m1) || t % a.Lk == 0) ? 1 : 0;
    return;
  }
  a.member1[t] = (pk.valid && m1) ? 1 : 0;
  a.member2[t] = (pk.valid && (pk.need2 ? m2 : m1)) ? 1 : 0;
}

// (b), scan layout: item t is position t of the flat B x Lk; the lane
// group probes st_fused for its 8 positions' keys in turn (found only)
__global__ void __launch_bounds__(kThreads)
    member_scan_kernel(const Args a, const __grid_constant__ dbg::Index ix,
                       const int32_t* __restrict__ has_n) {
  if (probes(ix, has_n)) return;
  const int S = ix.st_cols / 10;
  for_items(a.B * a.Lk, [&](uint32_t t, bool in_grid) {
    const PosKeys pk = pos_keys(a, t, in_grid);
    bool m[2] = {false, false};
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const bool want = pass == 0 ? pk.valid : pk.need2;
      const uint64_t key = pass == 0 ? pk.key1 : pk.key2;
      const uint32_t* row = dbg::st_row(ix, key);
      // a pass no lane of the warp needs is skipped whole
      if (!__any_sync(dbg::FULL_WARP, want)) continue;
#pragma unroll
      for (int j = 0; j < dbg::GROUP; ++j) {
        const bool want_j = dbg::group_bcast(static_cast<int>(want), j);
        const uint64_t key_j = dbg::group_bcast(key, j);
        const uint32_t* row_j = dbg::group_bcast(row, j);
        bool hit = false;
        if (want_j)
          dbg::group_slots(row_j, S, dbg::khi(key_j), dbg::klo(key_j),
                                 0u, [&](int) { hit = true; });
        const bool found = dbg::group_any(hit);
        if (dbg::group_lane() == j) m[pass] = found;
      }
    }
    if (in_grid) put_members(a, t, pk, m[0], m[1]);
  });
}

// (b), mphf layout: a per-thread MPHF chain (a 20-40 byte row has
// nothing to share across a group), one thread per position
__global__ void __launch_bounds__(kThreads)
    member_mphf_kernel(const Args a, const __grid_constant__ dbg::Index ix,
                       const int32_t* __restrict__ has_n) {
  if (probes(ix, has_n)) return;
  const uint32_t n = a.B * a.Lk;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const PosKeys pk = pos_keys(a, t, true);
    const bool m1 = pk.valid && dbg::mphf_row(ix.jm, 10, pk.key1) != nullptr;
    const bool m2 = pk.need2 && dbg::mphf_row(ix.jm, 10, pk.key2) != nullptr;
    put_members(a, t, pk, m1, m2);
  }
}

// blocks for n items: one per kThreads items, at most as many as fill
// every SM of the current device once
unsigned grid_for(uint32_t n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const uint32_t want = (n + kThreads - 1) / kThreads;
  const uint32_t most = static_cast<uint32_t>(sms) * (2048 / kThreads);
  return want < 1 ? 1 : (want < most ? want : most);
}

}  // namespace

extern "C" int dbg_member(const void* rep1, const void* le1, const void* rep2,
                          const void* bug, int exhaustive, const void* rwf, int RWr, const void* lens, int B,
                          int L, int k1, const void* index,
                          const void* has_n, void* member1, void* member2,
                          void* stream) {
  const int Lk = L - k1 + 1;
  if (static_cast<long long>(B) * Lk >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = dbg::member_args(rep1, le1, rep2, bug, exhaustive, rwf,
                                  RWr, lens, B, L, k1, member1, member2);
  const dbg::Index& ix = *static_cast<const dbg::Index*>(index);
  const int32_t* hn = static_cast<const int32_t*>(has_n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t n_pos = static_cast<uint32_t>(B) * Lk;
  // path (a) when the batch turns out N-free, then path (b), which
  // leaves at once when (a) ran: the batch's N flag lies on the device
  if (ix.pt_nb > 0) {
    const int W = dbg::probe_window(ix.pt_cols, ix.pt_slots);
    member_probe_kernel<<<grid_for(B * ((Lk + W - 1) / W)), kThreads, 0,
                          st>>>(a, ix, hn);
  }
  if (ix.jl_mphf)
    member_mphf_kernel<<<grid_for(n_pos), kThreads, 0, st>>>(a, ix, hn);
  else
    member_scan_kernel<<<grid_for(n_pos), kThreads, 0, st>>>(a, ix, hn);
  DBG_RETURN_LAUNCH_STATUS();
}

// threads per block of this file's kernels (build.kernel_resources gives
// ptxas's registers per kernel; with this, the warps per SM they allow)
extern "C" int dbg_member_threads() { return kThreads; }
