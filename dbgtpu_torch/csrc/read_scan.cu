// K1 read_scan: per-read images and the anchor-scan k-mers.
//
// Replaces, in dbgtpu/engine/core.py: _unpack_words (:1428), _read_images
// (:683, with _pack_rows :62, _funnel :80, _roll_left :88), the packed
// (k-1)-mer scan _scan_kmer_pairs_words (:565) with rcb_pair
// (kmer32.py:74), the rolled-in-N "bug" scan _scan_kmer_pairs (:602,
// used at :988-994), the canonical choice pair_le (:1017-1019) and the
// batch-level has_n (:979).
//
// Bound on the card: it reads 2.25 bits and writes ~34 bytes per scan
// position (four int64 k-mer planes, a byte plane, the packed rows), so
// it is a store-bandwidth pass.  The TPU shapes (funnel classes, masked
// log-rolls, uint32 pairs) are gone: each thread builds one k-mer with a
// k-1 step shift loop over the packed words, which stay in L1, and one
// word of each packed row.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t nm_bit(const uint32_t* nb, int i) {
  return nb ? (nb[i >> 5] >> (i & 31)) & 1u : 0u;
}

__global__ void read_scan_kernel(const uint32_t* __restrict__ words, int Lw,
                                 const uint32_t* __restrict__ nmbits, int Lb,
                                 const int32_t* __restrict__ lens, int B,
                                 int L, int k1, int Lk, int RWr,
                                 uint32_t* __restrict__ rows,
                                 int64_t* __restrict__ bug,
                                 int64_t* __restrict__ rcs,
                                 int64_t* __restrict__ rep1,
                                 uint8_t* __restrict__ le1,
                                 int64_t* __restrict__ rep2,
                                 int32_t* __restrict__ has_n) {
  const int b = blockIdx.x;
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  const uint32_t* w = words + static_cast<size_t>(b) * Lw;
  const uint32_t* nb = Lb ? nmbits + static_cast<size_t>(b) * Lb : nullptr;

  if (t < RWr) {
    // word t of the forward, reverse-complement and N-mask rows; words
    // t >= Lw are the zero roll headroom of the JAX rows (RWr = 2Lw+1)
    uint32_t f = 0, r = 0, n = 0;
    if (t < Lw) {
      const int len = min(lens[b], L);
      for (int j = 0; j < 16; ++j) {
        const int i = 16 * t + j;
        if (i < L) {
          f |= dbg::base_at(w, i) << (2 * j);
          n |= nm_bit(nb, i) << (2 * j);
        }
        // RC('N') == 'A': N is code 3 in the packed words
        if (i < len) r |= (3u - dbg::base_at(w, len - 1 - i)) << (2 * j);
      }
    }
    const size_t o = static_cast<size_t>(b) * RWr + t;
    const size_t plane = static_cast<size_t>(B) * RWr;
    rows[o] = f;
    rows[plane + o] = r;
    rows[2 * plane + o] = n;
    if (n) atomicOr(has_n, 1);
  }

  if (t < Lk) {
    // std scan: N is code 3 throughout; bug scan: an N at read column
    // >= k1 rolls in as 0 (reference str2num vs nuc2int quirk)
    uint64_t sv = 0, bv = 0;
    for (int j = 0; j < k1; ++j) {
      const int i = t + j;
      const uint64_t c = dbg::base_at(w, i);
      sv = (sv << 2) | c;
      bv = (bv << 2) | ((i >= k1 && nm_bit(nb, i)) ? 0ull : c);
    }
    const uint64_t rv = dbg::rcb(sv, k1);
    const size_t o = static_cast<size_t>(b) * Lk + t;
    const bool le = bv <= rv;
    bug[o] = static_cast<int64_t>(bv);
    rcs[o] = static_cast<int64_t>(rv);
    rep1[o] = static_cast<int64_t>(le ? bv : rv);
    le1[o] = le ? 1 : 0;
    rep2[o] = static_cast<int64_t>(sv <= rv ? sv : rv);
  }
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int dbg_read_scan(const void* words, int Lw, const void* nmbits,
                             int Lb, const void* lens, int B, int L, int k1,
                             void* rows, void* bug, void* rcs, void* rep1,
                             void* le1, void* rep2, void* has_n,
                             void* stream) {
  const int Lk = L - k1 + 1;
  const int RWr = 2 * Lw + 1;
  const int span = Lk > RWr ? Lk : RWr;
  const dim3 grid(B, (span + kThreads - 1) / kThreads);
  read_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), Lw,
      static_cast<const uint32_t*>(nmbits), Lb,
      static_cast<const int32_t*>(lens), B, L, k1, Lk, RWr,
      static_cast<uint32_t*>(rows), static_cast<int64_t*>(bug),
      static_cast<int64_t*>(rcs), static_cast<int64_t*>(rep1),
      static_cast<uint8_t*>(le1), static_cast<int64_t*>(rep2),
      static_cast<int32_t*>(has_n));
  DBG_RETURN_LAUNCH_STATUS();
}

// threads per block of this file's kernels (build.kernel_resources gives
// ptxas's registers per kernel; with this, the warps per SM they allow)
extern "C" int dbg_read_scan_threads() { return kThreads; }
