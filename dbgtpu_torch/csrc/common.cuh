// Device helpers shared by the dbgtpu_torch kernels.
//
// k-mers are one uint64 each (a (k-1)-mer has at most 62 bits, k <= 32;
// the whole k-mers of dog mode fill all 64 at k = 32), first base in the
// highest occupied two bits.  Packed read and unitig
// rows hold 16 bases per uint32 word, base i at bits 2*(i%16) of word
// i/16 (dbgtpu.index.device.pack_words).  The constants below must
// match dbgtpu/constants.py and the walk phases of dbgtpu/engine/core.py.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dbg {

// per-read outcome codes (dbgtpu/constants.py)
constexpr int STATUS_PENDING = 0;
constexpr int STATUS_ALIGNED_FWD = 1;
constexpr int STATUS_ALIGNED_RC = 2;
constexpr int STATUS_NO_OVERLAP_FWD = 3;
constexpr int STATUS_RC_NO_OVERLAP = 4;
constexpr int STATUS_FAILED = 5;

// walk phases (dbgtpu/engine/core.py _FETCH .. _DONE)
constexpr int FETCH = 0;
constexpr int LEFT = 1;
constexpr int RFIRST = 2;
constexpr int RCONT = 3;
constexpr int DONE = 4;

constexpr int BIG = 1 << 30;        // miss of an invalid candidate
constexpr int CHUNK_SHIFT = 7;      // log2(index.device.CHUNK_BASES)
constexpr int META_COLS = 16;       // umeta metadata columns
constexpr uint32_t LANE_LO = 0x55555555u;

// murmur3-style finalizer (dbgtpu/engine/kmer32.py mix32)
__device__ __forceinline__ uint32_t mix32(uint32_t hi, uint32_t lo) {
  uint32_t h = lo ^ (hi * 0x9E3779B9u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// reverse the 32 two-bit groups of a 64-bit value
__device__ __forceinline__ uint64_t rev_groups(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) |
         ((x & 0x5555555555555555ull) << 1);
}

// reverse complement of an n-mer, 1 <= n <= 32 (kmer32.rcb_pair)
__device__ __forceinline__ uint64_t rcb(uint64_t v, int n) {
  return rev_groups(~v) >> (64 - 2 * n);
}

__device__ __forceinline__ uint32_t khi(uint64_t v) {
  return static_cast<uint32_t>(v >> 32);
}
__device__ __forceinline__ uint32_t klo(uint64_t v) {
  return static_cast<uint32_t>(v);
}
__device__ __forceinline__ uint64_t join(uint32_t hi, uint32_t lo) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// 2-bit base i of a packed row
__device__ __forceinline__ uint32_t base_at(const uint32_t* row, int i) {
  return (row[i >> 4] >> (2 * (i & 15))) & 3u;
}

// the 16 bases starting at base s of a packed row of n words, as one
// word; words past the row read as zero (the JAX engine pads with zeros)
__device__ __forceinline__ uint32_t word_at(const uint32_t* row, int n,
                                            int s) {
  const int i = s >> 4;
  const int sh = 2 * (s & 15);
  const uint32_t w0 = (i >= 0 && i < n) ? row[i] : 0u;
  if (sh == 0) return w0;
  const uint32_t w1 = (i + 1 >= 0 && i + 1 < n) ? row[i + 1] : 0u;
  return (w0 >> sh) | (w1 << (32 - sh));
}

// the n-mer (1 <= n <= 32) starting at base i of a packed row of nw
// words: the 64-bit little-endian window from base i, read in reverse
// two-bit groups (core._scan_kmer_pairs_words)
__device__ __forceinline__ uint64_t kmer_at(const uint32_t* row, int nw,
                                            int i, int n) {
  const uint64_t x = static_cast<uint64_t>(word_at(row, nw, i)) |
                     (static_cast<uint64_t>(word_at(row, nw, i + 16)) << 32);
  return rev_groups(x) >> (64 - 2 * n);
}

// second, independent hash of a k-mer pair (kmer32.py mix32b): the other
// bucket of the two-choice final table of an MPHF
__device__ __forceinline__ uint32_t mix32b(uint32_t hi, uint32_t lo) {
  return mix32(lo ^ 0x7FEB352Du, hi ^ 0x846CA68Bu);
}

// Static structure of one MPHF (engine/index.py MphfMeta): per level the
// hash seeds, the bit mask of the level's size and the offset of its
// first rank-group row; then the two-choice final table's bucket mask.
// Passed by value inside a kernel parameter.
constexpr int MPHF_MAX_LEVELS = 25;   // index/mphf.py build_mphf max_levels
struct MphfMeta {
  int32_t n_levels;
  int32_t has_final;
  uint32_t final_mask;                // final_nb - 1
  int32_t n_keys;                     // rows of the verify / value table
  uint32_t seed_hi[MPHF_MAX_LEVELS];
  uint32_t seed_lo[MPHF_MAX_LEVELS];
  uint32_t mask[MPHF_MAX_LEVELS];
  int32_t row_off[MPHF_MAX_LEVELS];
};

// One MPHF-backed table: fused rank-group rows [ng, 5], final table
// [nbf, 12] and the dense rows at each key's slot, which start with the
// stored key (hi, lo): jrows [n, 10] for junctions, arows [n, 5] for
// dog anchors.
struct Mphf {
  const uint32_t* rows;
  const uint32_t* frows;
  const uint32_t* vrows;
  MphfMeta meta;
};

// The most cards a sharded index is cut over (--shard-index with --mesh;
// dbgtpu's tests shard over 8 devices).
constexpr int MAX_SHARDS = 8;

// The device index tables, as engine/index.py IndexTensors.c_index lays
// them out (kernels/build.py IndexC mirrors this struct field by field).
// jl_mphf / al_mphf say which layout the junction table and the dog
// anchor table have; the two are independent.  Under --shard-index over
// n_shards > 1 cards, st and pt are cut into n_shards contiguous bucket
// ranges of st_nb and pt_nb rows each, shard s on card s: st_shards[s]
// and pt_shards[s] point at them (peer pointers for the other cards'),
// st and pt at this card's own.  With n_shards 1 the shard arrays are
// unused and st_nb, pt_nb count the whole tables.
struct Index {
  const uint32_t* st;      // fused junction scan table [st_nb, st_cols]
  const int32_t* umeta;    // [U+1, ucols] metadata (+ embedded sequence)
  const uint32_t* pool;    // [2*n_chunks, pool_cols] halo'd chunk rows
  const uint32_t* pt;      // closure-probe rows [pt_nb, pt_cols]
  const uint32_t* at;      // fused dog anchor scan table [at_nb, at_cols]
  int32_t st_nb, st_cols;
  uint32_t st_seed;
  int32_t ucols;
  int32_t pool_cols, n_chunks;
  int32_t pt_nb, pt_cols;
  uint32_t pt_seed;
  int32_t pt_slots;
  int32_t at_nb, at_cols;
  uint32_t at_seed;
  int32_t jl_mphf, al_mphf;
  Mphf jm;                 // junction MPHF, vrows = jrows [n, 10]
  Mphf am;                 // anchor MPHF, vrows = arows [n, 5]
  const uint32_t* st_shards[MAX_SHARDS];
  const uint32_t* pt_shards[MAX_SHARDS];
  int32_t n_shards;        // 1: the tables are whole
};

// ---- lane-group bucket probes (K2, K3, K5, K6) ----
//
// A fused scan row holds S slot key-hi words, then S slot key-lo words,
// then the slots' values.  A group of GROUP neighbouring lanes (aligned
// within its warp) compares one query against one row: lane g of the
// group reads the key-hi and key-lo words of slots 4q .. 4q+3 for
// q = g, g + GROUP, ... as one 16-byte vector each, so the group reads
// the row's keys in contiguous 128-byte pieces (S = 32: one vector of
// each per lane).  Rows whose slot count is not a multiple of 4 (the
// slot counts are tunable) are compared one slot per lane instead.  A
// query is hashed once, by the lane that owns it, or by every lane of a
// group that shares it; the group takes its row pointer and key by
// shuffle.  The shuffles and ballots of the group_* helpers name the
// lanes of `mask`: by default the whole warp, which must then reach each
// call together (K2 and K5 walk their items in whole warps); or
// group_mask(), the group's own 8 lanes (as a cooperative-groups tile of
// 8 does), so that the groups of a warp may follow their own control
// flow (K3 and K6 give each read a group that runs its own walk).  A
// mask that is not the constant full warp costs a warp sync per call
// (on an H100, K2's per-position branch ran 39% slower with group masks).
constexpr int GROUP = 8;
constexpr unsigned FULL_WARP = 0xFFFFFFFFu;

__device__ __forceinline__ int group_lane() {
  return static_cast<int>(threadIdx.x) & (GROUP - 1);
}

// the lanes of this lane's group, as a warp lane mask
__device__ __forceinline__ unsigned group_mask() {
  return 0xFFu << (threadIdx.x & 24u);
}

// calls hit(s) for each slot s of this lane's share of `row` whose key
// is (hi, lo); key-hi words are compared after XOR with `hi_xor` (~0 for
// the probe table, which stores them inverted).  Key-hi and key-lo are
// read together: reading key-lo only after a key-hi match saves bytes
// but adds a dependent load, and measured slower.
template <class F>
__device__ __forceinline__ void group_slots(const uint32_t* __restrict__ row,
                                            int S, uint32_t hi, uint32_t lo,
                                            uint32_t hi_xor, F&& hit) {
  const int g = group_lane();
  if ((S & 3) == 0) {
    for (int q = g; 4 * q < S; q += GROUP) {
      const uint4 h = __ldg(reinterpret_cast<const uint4*>(row) + q);
      const uint4 l = __ldg(reinterpret_cast<const uint4*>(row + S) + q);
      if ((h.x ^ hi_xor) == hi && l.x == lo) hit(4 * q);
      if ((h.y ^ hi_xor) == hi && l.y == lo) hit(4 * q + 1);
      if ((h.z ^ hi_xor) == hi && l.z == lo) hit(4 * q + 2);
      if ((h.w ^ hi_xor) == hi && l.w == lo) hit(4 * q + 3);
    }
  } else {
    for (int s = g; s < S; s += GROUP)
      if ((__ldg(row + s) ^ hi_xor) == hi && __ldg(row + S + s) == lo) hit(s);
  }
}

// the sum over the group's lanes (wraps mod 2^32, as the JAX row-sum)
__device__ __forceinline__ uint32_t group_sum(uint32_t v,
                                              unsigned mask = FULL_WARP) {
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// bit g set where p is true on lane g of the group
__device__ __forceinline__ unsigned group_ballot(bool p,
                                                 unsigned mask = FULL_WARP) {
  return (__ballot_sync(mask, p) >> (threadIdx.x & 24u)) & 0xFFu;
}

// true on every lane of the group when it is true on any
__device__ __forceinline__ bool group_any(bool p, unsigned mask = FULL_WARP) {
  return group_ballot(p, mask) != 0u;
}

// lane `src` of this lane's group's value of v (an integer or a pointer)
template <class T>
__device__ __forceinline__ T group_bcast(T v, int src,
                                         unsigned mask = FULL_WARP) {
  return __shfl_sync(mask, v, src, GROUP);
}
template <class T>
__device__ __forceinline__ const T* group_bcast(const T* v, int src,
                                                unsigned mask = FULL_WARP) {
  return reinterpret_cast<const T*>(__shfl_sync(
      mask, reinterpret_cast<unsigned long long>(v), src, GROUP));
}

// the fused scan row of `key` in a table of nb rows of `cols` words; or,
// with n_shards > 1, in a table of nb * n_shards rows cut into shards of
// nb rows (`shards`, an Index's st_shards or pt_shards): global bucket b
// lies in shard b / nb at row b - shard * nb (dbgtpu/engine/core.py
// :389-391, _sharded_rows).  The n_shards test reads a kernel parameter,
// so the unsharded path has no load more than before.
__device__ __forceinline__ const uint32_t* scan_row(
    const uint32_t* tbl, int nb, int cols, uint32_t seed, uint64_t key,
    const uint32_t* const* shards = nullptr, int n_shards = 1) {
  const uint32_t h = mix32(khi(key) ^ seed, klo(key));
  if (n_shards <= 1)
    return tbl + static_cast<size_t>(h & static_cast<uint32_t>(nb - 1)) * cols;
  const uint32_t b = h & (static_cast<uint32_t>(nb) * n_shards - 1u);
  const uint32_t s = b / static_cast<uint32_t>(nb);
  return shards[s] + static_cast<size_t>(b - s * nb) * cols;
}

// the row of `key` in the junction scan table and in the closure-probe
// table, whole or sharded (K2, K3)
__device__ __forceinline__ const uint32_t* st_row(const Index& ix,
                                                  uint64_t key) {
  return scan_row(ix.st, ix.st_nb, ix.st_cols, ix.st_seed, key, ix.st_shards,
                  ix.n_shards);
}
__device__ __forceinline__ const uint32_t* pt_row(const Index& ix,
                                                  uint64_t key) {
  return scan_row(ix.pt, ix.pt_nb, ix.pt_cols, ix.pt_seed, key, ix.pt_shards,
                  ix.n_shards);
}

// ---- lane-group scans of a byte mask row (K3's anchors, K6's FETCHX) ----
//
// A row of n bytes at any address (a read's row of a [B, Lk] mask) is
// read as the 16-byte aligned vectors that cover it, lane g of a group
// taking vectors q0 + g, q0 + g + GROUP, ...: 128 contiguous bytes per
// group step.  Bytes outside the row are masked off, and a vector is
// loaded only where it holds a byte of the row, so no load leaves the
// aligned 16 bytes around one.
struct ByteRow {
  const uint4* a;     // the row's first byte, rounded down to 16 bytes
  int off, n;         // the row's offset from a, its length
};

__device__ __forceinline__ ByteRow byte_row(const uint8_t* row, int n) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(row);
  return ByteRow{reinterpret_cast<const uint4*>(p & ~uintptr_t{15}),
                 static_cast<int>(p & 15u), n};
}

// bit j set where byte j of the word is not zero (j < 4)
__device__ __forceinline__ uint32_t nonzero4(uint32_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return ((w & 0x01010101u) * 0x10204080u) >> 28;
}

// the nonzero bytes of vector q that lie in row bytes [lo, hi): bit j is
// row byte 16 q - off + j
__device__ __forceinline__ uint32_t row_bits(const ByteRow& r, int q, int lo,
                                             int hi) {
  const int b0 = 16 * q - r.off;
  const int s = max(lo - b0, 0), e = min(hi - b0, 16);
  if (s >= e) return 0u;
  const uint4 v = __ldg(r.a + q);
  const uint32_t m = nonzero4(v.x) | (nonzero4(v.y) << 4) |
                     (nonzero4(v.z) << 8) | (nonzero4(v.w) << 12);
  return m & ((1u << e) - 1u) & ~((1u << s) - 1u);
}

// the first nonzero byte of the row at or after `from`, or n
__device__ __forceinline__ int group_first(const ByteRow& r, int from,
                                           unsigned mask) {
  from = max(from, 0);
  const int qe = (r.off + r.n - 1) >> 4;
  for (int q0 = (r.off + from) >> 4; q0 <= qe && from < r.n; q0 += GROUP) {
    const int q = q0 + group_lane();
    const uint32_t m = q <= qe ? row_bits(r, q, from, r.n) : 0u;
    const unsigned lanes = group_ballot(m != 0u, mask);
    if (lanes) {
      const int l = __ffs(lanes) - 1;
      return 16 * (q0 + l) - r.off + __ffs(group_bcast(m, l, mask)) - 1;
    }
  }
  return r.n;
}

// the last nonzero byte of the row before `to`, or -1
__device__ __forceinline__ int group_last(const ByteRow& r, int to,
                                          unsigned mask) {
  to = min(to, r.n);
  for (int q0 = (r.off + to - 1) >> 4; q0 >= 0 && to > 0; q0 -= GROUP) {
    const int q = q0 - group_lane();
    const uint32_t m = q >= 0 ? row_bits(r, q, 0, to) : 0u;
    const unsigned lanes = group_ballot(m != 0u, mask);
    if (lanes) {   // the lowest lane holds the highest vector
      const int l = __ffs(lanes) - 1;
      return 16 * (q0 - l) - r.off + 31 - __clz(group_bcast(m, l, mask));
    }
  }
  return -1;
}

// the number of nonzero bytes of the row
__device__ __forceinline__ int group_count(const ByteRow& r, unsigned mask) {
  const int qe = (r.off + r.n - 1) >> 4;
  uint32_t c = 0;
  for (int q = group_lane(); q <= qe; q += GROUP)
    c += __popc(row_bits(r, q, 0, r.n));
  return static_cast<int>(group_sum(c, mask));
}

// streaming multiprocessors of the current device (queried once per
// device): what K4 and K8 size their grids by
inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  return counts[dev];
}

}  // namespace dbg

// every entry point returns cudaGetLastError() right after its launch
#define DBG_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())
