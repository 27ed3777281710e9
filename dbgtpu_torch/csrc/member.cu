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
//      (mphf.cuh junction_vals; core.py:434-435, 454-456).  The probe
//      table of path (a) is built under both layouts.
// A second mode serves exhaustive mode (-b): one mask, `inter`
// (dbgtpu/engine/exhaustive.py:118-148), in member1.  Path (a) is the
// same probe; path (b) looks up canonical(bug, rcb(bug)) — the bug scan
// against its own reverse complement, not greedy's rep1 — and position
// 0 is always set: every read tries its first anchor.
//
// Bound on the card: random row reads (a probe row is 384-512 bytes,
// a scan row 1280, an MPHF lookup a 20-byte level row and a 40-byte
// jrows row), not bandwidth.  One thread per read position; in
// path (a) the W threads of a window read the same row, which L1 and
// L2 serve, so the row is fetched from device memory about once.
#include "mphf.cuh"

namespace {

__global__ void member_kernel(const int64_t* __restrict__ rep1,
                              const uint8_t* __restrict__ le1,
                              const int64_t* __restrict__ rep2,
                              const int64_t* __restrict__ bug, int exhaustive,
                              const uint32_t* __restrict__ rwf, int RWr,
                              const int32_t* __restrict__ lens, int L,
                              int k1, int Lk,
                              const __grid_constant__ dbg::Index ix,
                              const int32_t* __restrict__ has_n,
                              uint8_t* __restrict__ member1,
                              uint8_t* __restrict__ member2) {
  const int b = blockIdx.x;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= Lk) return;
  const size_t row0 = static_cast<size_t>(b) * Lk;
  const size_t o = row0 + i;
  const bool valid = i <= lens[b] - k1;
  const int pt_nb = ix.pt_nb, pt_cols = ix.pt_cols, S_pt = ix.pt_slots;
  if (pt_nb == 0 || *has_n) {
    if (exhaustive) {
      const uint64_t v = static_cast<uint64_t>(bug[o]);
      const uint64_t rv = dbg::rcb(v, k1);
      const bool m = dbg::junction_vals(ix, v <= rv ? v : rv, nullptr);
      member1[o] = ((valid && m) || i == 0) ? 1 : 0;
      return;
    }
    const bool m1 =
        dbg::junction_vals(ix, static_cast<uint64_t>(rep1[o]), nullptr);
    const bool m2 =
        dbg::junction_vals(ix, static_cast<uint64_t>(rep2[o]), nullptr);
    member1[o] = (valid && m1) ? 1 : 0;
    member2[o] = (valid && m2) ? 1 : 0;
    return;
  }
  const int W = pt_cols == 4 * S_pt ? 4 : 3;
  const int p = min(W * (i / W) + 1, Lk - 1);
  const int d = i - p;
  const uint64_t q = static_cast<uint64_t>(rep1[row0 + p]);
  const uint32_t qhi = dbg::khi(q), qlo = dbg::klo(q);
  const uint32_t bkt =
      dbg::mix32(qhi ^ ix.pt_seed, qlo) & static_cast<uint32_t>(pt_nb - 1);
  const uint32_t* row = ix.pt + static_cast<size_t>(bkt) * pt_cols;
  uint32_t w0 = 0, w1 = 0;
  for (int s = 0; s < S_pt; ++s) {
    if (row[s] == ~qhi && row[S_pt + s] == qlo) {
      w0 += row[2 * S_pt + s];
      if (W == 4) w1 += row[3 * S_pt + s];
    }
  }
  const uint32_t onum = le1[row0 + p] ? 0u : 1u;
  const uint32_t* codes = rwf + static_cast<size_t>(b) * RWr;
  uint32_t idx;
  if (d < 0) {                       // predecessor bit
    idx = 9u + 4u * onum + dbg::base_at(codes, max(p - 1, 0));
  } else if (d == 0) {               // self bit
    idx = 0u;
  } else {
    const uint32_t c1 = dbg::base_at(codes, min(p + k1, L - 1));
    if (d == 1) {                    // one-step successor bit
      idx = 1u + 4u * onum + c1;
    } else {                         // two-step successor bit (W == 4)
      const uint32_t c2 = dbg::base_at(codes, min(p + k1 + 1, L - 1));
      idx = 17u + 16u * onum + ((c1 << 2) | c2);
    }
  }
  const uint32_t bit = idx < 32 ? (w0 >> idx) & 1u : (w1 >> (idx - 32)) & 1u;
  if (exhaustive) {
    member1[o] = ((valid && bit) || i == 0) ? 1 : 0;
    return;
  }
  const uint8_t m = (valid && bit) ? 1 : 0;
  member1[o] = m;
  member2[o] = m;
}

}  // namespace

extern "C" int dbg_member(const void* rep1, const void* le1, const void* rep2,
                          const void* bug, int exhaustive, const void* rwf, int RWr, const void* lens, int B,
                          int L, int k1, const void* index,
                          const void* has_n, void* member1, void* member2,
                          void* stream) {
  const int Lk = L - k1 + 1;
  const int threads = 128;
  const dim3 grid(B, (Lk + threads - 1) / threads);
  member_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rep1), static_cast<const uint8_t*>(le1),
      static_cast<const int64_t*>(rep2), static_cast<const int64_t*>(bug),
      exhaustive, static_cast<const uint32_t*>(rwf),
      RWr, static_cast<const int32_t*>(lens), L, k1, Lk,
      *static_cast<const dbg::Index*>(index),
      static_cast<const int32_t*>(has_n), static_cast<uint8_t*>(member1),
      static_cast<uint8_t*>(member2));
  DBG_RETURN_LAUNCH_STATUS();
}
