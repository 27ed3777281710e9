// K9-K12: the four gather kernels of the member-stage experiments.
//
// They replace the Pallas kernels of scripts/exp_r5_pallas.py (`kern` :81,
// call :93; `kern_vmem` :122, call :138) and of
// scripts/archive/exp_pallas_gather.py (`kernel` :28, call :40; `kernel2`
// :70, call :81).  Tables are uint32 rows; every sum wraps mod 2^32.
//
//   K9  gather_rows      out[i*G+g, :] = tbl[idx[i]*G+g, :]
//   K10 gather_rowsum    out[c] = sum over t < CH of the sum of row
//                        tbl[idx[c*CH+t], :]
//   K11 gather_rows_sum  out[b] = REPS * sum_j sum_c tbl[idx[b, j], c]
//   K12 gather_take_sum  out[b] = REPS * sum_j tbl1[idx[b, j]]
//
// What the TPU versions were shaped by does not carry over.  There the
// grid ran in order on one core, scalar-prefetched indices drove a
// double-buffered row DMA (K9), and a 12.6 MB table sat whole in VMEM
// (K10-K12).  Here blocks run in any order on 132 SMs, a block has at
// most 227 KB of shared memory, and the 50 MB L2 is what holds a 12.6 MB
// table.  So: K9's threads read their own index; rows move as 16-byte
// vectors, neighbouring threads on neighbouring vectors of one row (a
// 96-byte row is 6 vectors, a 64-byte row 4).
//
// K10 is one launch of a persistent grid (its occupancy times the SMs,
// engine/gather.py rowsum_plan): the N rows are cut into equal
// contiguous ranges, one per warp, so no block waits in a second wave.
// A warp takes its range in tiles of 32 rows: it loads the tile's
// indices with one coalesced word per lane, hands them out by shuffle
// and issues the 16-byte vectors (or words) of every row of the tile,
// kBatch loads per lane, before it adds any of them; the next tile's
// indices load meanwhile.  224 chunks of 4,096 rows would leave most of
// the card idle, so a warp's range crosses chunk boundaries: a tile
// ends at a boundary, the warp sums each chunk's segment of its range
// by one warp reduction and adds it into out (zeroed by the C entry
// point) with one red.  Integer adds mod 2^32: any order gives the same
// bits.  Measured slower on an H100: tiles of 64 rows (two index
// windows, 12 vectors in flight per lane: 80 registers, 3 blocks per SM
// against 4); partial sums per segment in fixed slots, summed into out
// by the last block to finish behind a fence and an atomic ticket (its
// tail cost more than the memset).
//
// K11 and K12 do the gather REPS times, as the TPU bodies do (their
// fori_loop re-reads the table every round): a compiler barrier between
// the rounds keeps the loads from being merged, so the time is that of
// REPS gathers and the result REPS times one sum.  Gathered from L2 or
// HBM, every 4-byte take costs a 32-byte sector and every round costs the
// table's rows again; so both gather from shared memory only, around one
// plan (engine/gather.py gather_plan).  A table that fits a block's
// shared memory is staged whole by every block with one TMA bulk copy
// (the direct path).  A larger one is cut into slices of at most 64 KB:
// the indices are counted per slice, then scanned and scattered into
// slice-major entries of (b, slice-local row), 32 bits while b and the
// row fit together, else 64; each work item then stages its slice with
// TMA and gathers its entries.  Where a copy of out fits in shared memory
// beside two slice buffers and the slices get enough entries (`acc`), one
// block per SM adds its sums into that copy, stages the next slice while
// it gathers this one, and adds the copy into out at the end; else a few
// blocks per SM, one slice buffer each (one block's staging overlaps
// another's gathering), add each warp's sums per run of equal b into out.
// Global reds into the 128 KB out cost as much as the takes, which is
// what the copy saves.
//
// Bound on the card: K9 moves every row twice (read, write) and is bound
// by those bytes; K10 to K12 read idx once and touch at most the table,
// so their byte bound is small and what holds them is the L2 and
// shared-memory gather rate; K11's adds (one per word summed, REPS times)
// outweigh its bytes.  K9 does not range-check its indices: an index
// outside the table reads outside it.  K10, K11 and K12 take an index
// outside [0, NB) (a negative one too) as NB - 1, so a stray index gives
// that row's sum and every read and write stays inside the kernels'
// buffers.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t sum4(uint4 v) {
  return v.x + v.y + v.z + v.w;
}

// ---- K9: one thread per 16-byte vector (VEC) or per word of the output
template <bool VEC>
__global__ void gather_rows_kernel(const uint32_t* __restrict__ tbl,
                                   const int32_t* __restrict__ idx,
                                   long long total, int G, int W,
                                   uint32_t* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int per_row = VEC ? W / 4 : W;          // units per row
  const long long orow = t / per_row;
  const int u = static_cast<int>(t - orow * per_row);
  const long long i = orow / G;
  const int g = static_cast<int>(orow - i * G);
  const long long srow = static_cast<long long>(idx[i]) * G + g;
  if (VEC) {
    reinterpret_cast<uint4*>(out)[t] =
        reinterpret_cast<const uint4*>(tbl)[srow * per_row + u];
  } else {
    out[t] = tbl[srow * W + u];
  }
}

// ---- K10: one launch; warp w sums rows [N w / n_warps, N (w + 1) /
// n_warps) chunk segment by chunk segment into out
constexpr int kRowsumThreads = 256;
constexpr int kRowsumWarps = kRowsumThreads / 32;
// loads a lane issues before it adds: one tile of 32 rows of 96 bytes in
// 16-byte vectors (32 x 6 / 32), or 8 words
template <bool VEC>
struct RowsumUnit {
  static constexpr int kBatch = 6;
  using T = uint4;
  static __device__ __forceinline__ T zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ uint32_t sum(T v) { return sum4(v); }
};
template <>
struct RowsumUnit<false> {
  static constexpr int kBatch = 8;
  using T = uint32_t;
  static __device__ __forceinline__ T zero() { return 0u; }
  static __device__ __forceinline__ uint32_t sum(T v) { return v; }
};

// lane l's index of the tile at row t (row t + l below r1, taken into the
// table)
__device__ __forceinline__ uint32_t rowsum_window(
    const int32_t* __restrict__ idx, long long t, long long r1,
    uint32_t last_row) {
  const long long r = t + (threadIdx.x & 31);
  return r < r1 ? min(static_cast<uint32_t>(idx[r]), last_row) : 0u;
}

// upr = units (16-byte vectors, or words) per row
template <bool VEC>
__global__ void __launch_bounds__(kRowsumThreads)
    gather_rowsum_kernel(const uint32_t* __restrict__ tbl, uint32_t last_row,
                         const int32_t* __restrict__ idx, long long N, int CH,
                         int upr, int n_warps, uint32_t* __restrict__ out) {
  using U = RowsumUnit<VEC>;
  using T = typename U::T;
  constexpr int kB = U::kBatch;
  const unsigned full = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kRowsumWarps + (threadIdx.x >> 5);
  const T* units = reinterpret_cast<const T*>(tbl);
  if (w >= n_warps) return;
  const long long r0 = N * w / n_warps, r1 = N * (w + 1) / n_warps;
  // unit e = lane + 32 k of a tile is unit u of its row `row`; e + 32
  // moves them by (dq, dr)
  const int row0 = lane / upr, u0 = lane - row0 * upr;
  const int dq = 32 / upr, dr = 32 - dq * upr;
  long long c = r0 / CH;
  long long seg_end = min(r1, (c + 1) * CH);
  uint32_t x = rowsum_window(idx, r0, r1, last_row);
  uint32_t acc = 0;
  for (long long t = r0; t < r1;) {
    const int rows = static_cast<int>(min(seg_end - t, 32LL));
    // the next tile's indices, loaded while this tile's rows are in flight
    const uint32_t next = rowsum_window(idx, t + rows, r1, last_row);
    int row = row0, u = u0;
    for (int k0 = 0; k0 * 32 < rows * upr; k0 += kB) {
      T v[kB];
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const uint32_t r = __shfl_sync(full, x, row & 31);
        v[j] = row < rows ? units[static_cast<long long>(r) * upr + u]
                          : U::zero();
        row += dq;
        u += dr;
        if (u >= upr) {
          u -= upr;
          ++row;
        }
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) acc += U::sum(v[j]);
    }
    t += rows;
    x = next;
    if (t == seg_end) {                 // chunk c's segment is done
      const uint32_t s = __reduce_add_sync(full, acc);
      if (lane == 0 && s) atomicAdd(out + c, s);
      acc = 0;
      ++c;
      seg_end = min(r1, (c + 1) * CH);
    }
  }
}

// ---- K11 / K12: one slice-bucketed gather from shared memory
//
// The host plan (engine/gather.py gather_plan, field for field) cuts the
// table into P slices of S rows (K12: words).  P = 1 is the direct path:
// every block stages the whole table and takes a share of idx's rows.
// P > 1 is the bucketed path: (a) count the indices per slice; (b) scan
// the counts and scatter each index as one entry (b, slice-local row)
// into slice-major order; (c) every work item (a slice, or a share of
// one) stages its slice and gathers its entries from shared memory.
struct GatherPlan {
  int S;        // rows (K12: words) per slice
  int sbits;    // log2(S) on the bucketed path, 0 on the direct path
  int P;        // slices
  int share;    // work items per slice
  int grid;     // gather blocks (persistent over the P * share items)
  int threads;  // gather block size
  int entry64;  // entries of 64 bits: b << 32 | row
  int tiles;    // count / scatter blocks
  int tile;     // indices per count / scatter block
  int smem;     // dynamic shared memory of a gather block, bytes
  int scatter_smem;  // ... of a scatter block
  int buf_words;     // words of one slice buffer (the slice and 4 more)
  int acc;      // the gather sums per b in shared memory first
};

constexpr int kCountThreads = 1024;     // a count / scatter block
// a direct or `acc` gather block, and any other bucketed one
// (engine/gather.py GATHER_THREADS, SLICE_THREADS; the plan puts three
// of the latter on an SM)
constexpr int kGatherThreads = 1024;
constexpr int kSliceThreads = 256;
constexpr int kSliceBlocksPerSm = 3;
constexpr int kScatterPer = 16;         // most indices of such a thread
// entries a gather thread holds per chunk: K12 direct, K12 bucketed, K11
// (chosen by measurement on an H100)
constexpr int kChunkTake = 4;
constexpr int kChunkBucketTake = 2;
constexpr int kChunkRows = 8;
constexpr int kMaxDevices = 64;
constexpr uint32_t kNoRow = 0xFFFFFFFFu;
enum { kPassCount = 1, kPassScatter = 2, kPassGather = 4 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Stage the n words at src into buf (16-byte aligned, room for n + 3
// words) and return where word 0 lands.  Thread 0 moves the 16-byte
// aligned middle with one TMA bulk copy that completes on `bar`; threads
// 1..6 copy the at most 3 words before and after it.  The caller syncs
// the block before (buf is free) and waits on `bar`, then syncs, after.
__device__ __forceinline__ const uint32_t* stage_words(
    uint32_t* buf, const uint32_t* src, int n, uint64_t* bar) {
  const int k = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  uint32_t* dst = buf + k;               // dst and src agree mod 16 bytes
  const int head = min(n, (4 - k) & 3);
  const int body = ((n - head) >> 2) << 2;
  const int tail = n - head - body;
  if (threadIdx.x == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(body * 4) : "memory");
    if (body > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(dst + head)), "l"(src + head), "r"(body * 4),
             "r"(smem_addr(bar))
          : "memory");
  } else if (threadIdx.x <= head + tail) {
    const int t = threadIdx.x - 1;
    const int w = t < head ? t : head + body + (t - head);
    dst[w] = src[w];
  }
  return dst;
}

// out[b] += the sum of v over each run of equal b among the warp's lanes
// (one red per run; kNoRow lanes add nothing).  Integer adds mod 2^32:
// any order gives the same bits.
__device__ __forceinline__ void add_runs(uint32_t b, uint32_t v,
                                         uint32_t* out) {
  const unsigned full = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  uint32_t s = v;                                    // inclusive prefix
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t t = __shfl_up_sync(full, s, d);
    if (lane >= d) s += t;
  }
  const uint32_t prev = __shfl_up_sync(full, b, 1);
  const uint32_t next = __shfl_down_sync(full, b, 1);
  const unsigned heads = __ballot_sync(full, lane == 0 || prev != b);
  const int first = 31 - __clz(heads & (full >> (31 - lane)));
  const uint32_t before = __shfl_sync(full, s, first > 0 ? first - 1 : 0);
  const uint32_t run = first > 0 ? s - before : s;
  if ((lane == 31 || next != b) && b != kNoRow && run != 0)
    atomicAdd(out + b, run);
}

// (a) count: block t's histogram of its indices over the slices; rel[t,
// p] = where its entries start among slice p's (one atomic per slice).
// A thread loads its kScatterPer indices before anything else: latency,
// not bandwidth, is what these passes wait on.
__global__ void __launch_bounds__(kCountThreads)
    bucket_count_kernel(const int32_t* __restrict__ idx, long long N,
                        GatherPlan pl, int* gcount, int* __restrict__ rel) {
  const uint32_t last = static_cast<uint32_t>(pl.P - 1);  // NB - 1's slice
  extern __shared__ int hist[];
  const long long lo = static_cast<long long>(blockIdx.x) * pl.tile;
  const int n = static_cast<int>(min(N - lo, static_cast<long long>(pl.tile)));
  uint32_t p[kScatterPer];
#pragma unroll
  for (int j = 0; j < kScatterPer; ++j) {
    const int k = j * blockDim.x + threadIdx.x;
    p[j] = k < n ? min(static_cast<uint32_t>(idx[lo + k]) >> pl.sbits, last)
                 : kNoRow;
  }
  for (int q = threadIdx.x; q < pl.P; q += blockDim.x) hist[q] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kScatterPer; ++j)
    if (p[j] != kNoRow) atomicAdd(&hist[p[j]], 1);
  __syncthreads();
  int* mine = rel + static_cast<long long>(blockIdx.x) * pl.P;
  for (int q = threadIdx.x; q < pl.P; q += blockDim.x) {
    const int h = hist[q];
    mine[q] = h ? atomicAdd(&gcount[q], h) : 0;
  }
}

// out[p] (+)= in[0] + ... + in[p-1] for p < P (`add`: added to out),
// by the whole block; out in shared memory (it may be in); `copy`, when
// given, receives the sums themselves
__device__ void block_exclusive_scan(const int* in, int P, int* out,
                                     bool add, int* copy) {
  __shared__ int warp_total[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (P + blockDim.x - 1) / blockDim.x;
  const int p0 = threadIdx.x * per;
  const int p1 = min(P, p0 + per);
  int own = 0;
  for (int p = p0; p < p1; ++p) own += in[p];
  int incl = own;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (blockDim.x >> 5) ? warp_total[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += t;
    }
    warp_total[lane] = w;
  }
  __syncthreads();
  int run = incl - own + (warp ? warp_total[warp - 1] : 0);
  for (int p = p0; p < p1; ++p) {
    const int x = in[p];
    out[p] = add ? out[p] + run : run;
    if (copy) copy[p] = run;
    run += x;
  }
  __syncthreads();
}

// (b) scan and scatter: block t ranks its tile's indices per slice
// (shared-memory atomics: the tile's histogram), scans the slice counts
// (block 0 also writes them out as start[p], start[P] = N, for the
// gather), puts its entries in slice order in shared memory, and writes
// them out in runs of one slice: entry d of slice p's run lands at
// start[p] + rel[t, p] + (d - the run's start), so the stores coalesce.
// A thread keeps its kScatterPer indices and ranks in registers (so the
// count cannot share this launch: the registers of every tile at once
// would not fit the card).  Entries are stored and loaded with streaming
// hints (written once, read once): the L2 keeps idx and the table.  The
// blocks also zero out, which the gather adds into.  An index outside
// [0, NB) becomes NB - 1, in the slice the count gave it.
template <typename E>
__global__ void __launch_bounds__(kCountThreads)
    bucket_scatter_kernel(const int32_t* __restrict__ idx, long long N,
                          int NB, int J, GatherPlan pl,
                          const int* __restrict__ gcount,
                          const int* __restrict__ rel, int* __restrict__ start,
                          E* __restrict__ ent, uint32_t* __restrict__ out) {
  extern __shared__ uint4 scatter4[];
  for (long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       b < N / J; b += static_cast<long long>(gridDim.x) * blockDim.x)
    out[b] = 0;                         // the gather adds into it
  E* sorted = reinterpret_cast<E*>(scatter4);            // [tile]
  int* cur = reinterpret_cast<int*>(sorted + pl.tile);   // [P]
  int* first = cur + pl.P;                               // [P]
  uint16_t* slice = reinterpret_cast<uint16_t*>(first + pl.P);  // [tile]
  const long long lo = static_cast<long long>(blockIdx.x) * pl.tile;
  const int n = static_cast<int>(min(N - lo, static_cast<long long>(pl.tile)));
  uint32_t v[kScatterPer];
  int rank[kScatterPer];
#pragma unroll
  for (int j = 0; j < kScatterPer; ++j) {
    const int k = j * blockDim.x + threadIdx.x;
    v[j] = k < n ? min(static_cast<uint32_t>(idx[lo + k]),
                       static_cast<uint32_t>(NB - 1))
                 : kNoRow;
  }
  const int* mine = rel + static_cast<long long>(blockIdx.x) * pl.P;
  for (int p = threadIdx.x; p < pl.P; p += blockDim.x) {
    first[p] = 0;
    cur[p] = mine[p];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kScatterPer; ++j)
    if (v[j] != kNoRow) rank[j] = atomicAdd(&first[v[j] >> pl.sbits], 1);
  __syncthreads();
  block_exclusive_scan(gcount, pl.P, cur, true,
                       blockIdx.x == 0 ? start : nullptr);
  if (blockIdx.x == 0 && threadIdx.x == 0) start[pl.P] = static_cast<int>(N);
  block_exclusive_scan(first, pl.P, first, false, nullptr);
  const uint32_t mask = (1u << pl.sbits) - 1u;
#pragma unroll
  for (int j = 0; j < kScatterPer; ++j) {
    if (v[j] == kNoRow) continue;
    const int k = j * blockDim.x + threadIdx.x;
    const uint32_t p = v[j] >> pl.sbits;
    const uint32_t b =
        static_cast<uint32_t>(lo + k) / static_cast<uint32_t>(J);
    const int d = first[p] + rank[j];
    if (sizeof(E) == 8)
      sorted[d] = static_cast<E>((static_cast<uint64_t>(b) << 32) |
                                 (v[j] & mask));
    else
      sorted[d] = static_cast<E>((b << pl.sbits) | (v[j] & mask));
    slice[d] = static_cast<uint16_t>(p);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n; d += blockDim.x) {
    const int p = slice[d];
    __stcs(&ent[cur[p] + (d - first[p])], sorted[d]);
  }
}

// one row's words from the staged slice: K12 (MODE 0) one word; K11 a
// lane group of g lanes, lane u taking units u, u + g, ... of the row's
// upr words (MODE 1) or 16-byte vectors (MODE 2)
template <int MODE>
__device__ __forceinline__ uint32_t take_row(const uint32_t* tab,
                                             uint32_t row, int W, int upr,
                                             int u, int g) {
  if (MODE == 0) return tab[row];
  const uint32_t* r = tab + static_cast<size_t>(row) * W;
  uint32_t s = 0;
  for (int k = u; k < upr; k += g)
    s += MODE == 2 ? sum4(reinterpret_cast<const uint4*>(r)[k]) : r[k];
  return s;
}

// a warp's sums into out: one red for a warp whose lanes share b, else
// one per run
__device__ __forceinline__ void warp_add(uint32_t b, uint32_t v,
                                         uint32_t* out) {
  const unsigned full = 0xFFFFFFFFu;
  const uint32_t b0 = __shfl_sync(full, b, 0);
  if (__all_sync(full, b == b0)) {
    const uint32_t s = __reduce_add_sync(full, v);
    if ((threadIdx.x & 31) == 0 && b0 != kNoRow && s != 0)
      atomicAdd(out + b0, s);
  } else {
    add_runs(b, v, out);
  }
}

// (c) gather: block k takes the work items [items k / grid, items (k + 1)
// / grid) in turn.  ACC blocks have two slice buffers in shared memory:
// TMA stages item i + 1's slice into one while the block gathers item
// i's entries from the other; other blocks have one, and each item
// stages its own.  The entries go in
// chunks: lane group t of warp w holds C entries of the warp's window of
// C * epw consecutive ones, epw apart (the next chunk's are loaded during
// this one's rounds for K11), gathers their rows `reps` times from shared
// memory (a compiler barrier between rounds; no lane is predicated off:
// a lane past the end takes row 0 and adds it nowhere) and adds the sums
// of each run of equal b.  ACC: into a shared-memory copy of out
// (shared-memory atomics), added to out at the end with one coalesced red
// per word; else each warp's sums straight into out (warp_add).  DIRECT:
// one item per block, the entries are idx itself (b = e / J), and each
// block owns whole rows of out, which it zeroes (an index outside the
// table taken as NB - 1); on the bucketed path the scatter zeroed out.
// The reds path runs three blocks of kSliceThreads on an SM, so it may
// take a third of the SM's registers, not the 1024-thread share.
template <typename E, int MODE, bool DIRECT, bool ACC>
__global__ void __launch_bounds__(DIRECT || ACC ? kGatherThreads
                                                : kSliceThreads,
                                  DIRECT || ACC ? 1 : kSliceBlocksPerSm)
    gather_sum_kernel(const uint32_t* __restrict__ tbl, int NB, int W,
                      const int32_t* __restrict__ idx,
                      const E* __restrict__ ent, const int* __restrict__ start,
                      long long N, int J, int reps, int g_log, GatherPlan pl,
                      uint32_t* out) {
  extern __shared__ uint4 dyn4[];
  __shared__ uint64_t bars[2];
  const long long B = N / J;
  uint32_t* sums = reinterpret_cast<uint32_t*>(dyn4);       // ACC: [B]
  uint32_t* bufs = sums + (ACC ? (B + 3) / 4 * 4 : 0);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(&bars[k])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (ACC)
    for (long long b = threadIdx.x; b < B; b += blockDim.x) sums[b] = 0;
  const int g = 1 << g_log, u = threadIdx.x & (g - 1);
  constexpr int C =
      MODE == 0 ? (DIRECT ? kChunkTake : kChunkBucketTake) : kChunkRows;
  // K11 gains from loading the next chunk's entries during this one's
  // rounds; K12's takes are too short for the registers that costs
  constexpr bool kPrefetch = MODE != 0;
  const int per = blockDim.x >> g_log;            // entries per block step
  const long long step = static_cast<long long>(C) * per;
  // entry i of lane group t: e0 + i * stride
  const int epw = 32 >> g_log;                    // entries per warp step
  const int stride = epw;
  const long long t_off = static_cast<long long>(threadIdx.x >> 5) * C * epw +
                          ((threadIdx.x & 31) >> g_log);
  const int upr = MODE == 2 ? W >> 2 : W;
  const uint32_t uJ = static_cast<uint32_t>(J);
  const uint32_t dq = static_cast<uint32_t>(stride) / uJ;  // = dq J + dr
  const uint32_t dr = static_cast<uint32_t>(stride) - dq * uJ;
  const long long items = static_cast<long long>(pl.P) * pl.share;
  const int it_lo = static_cast<int>(items * blockIdx.x / gridDim.x);
  const int it_hi = static_cast<int>(items * (blockIdx.x + 1) / gridDim.x);
  auto stage = [&](int item, int slot) {
    const long long r0 = static_cast<long long>(item / pl.share) * pl.S;
    const int rows = static_cast<int>(pl.S < NB - r0 ? pl.S : NB - r0);
    stage_words(bufs + slot * pl.buf_words, tbl + r0 * W, rows * W,
                &bars[slot]);
  };
  // lane group t's entries of the chunk at `base` below `hi`
  auto load = [&](long long base, long long hi, uint32_t (&row)[C],
                  uint32_t (&b)[C]) {
    const long long e0 = base + t_off;
    uint32_t bq = 0, br = 0;              // DIRECT: e = bq J + br
    const uint32_t last_row = static_cast<uint32_t>(NB - 1);
    if (DIRECT) {
      bq = static_cast<uint32_t>(e0) / uJ;
      br = static_cast<uint32_t>(e0) - bq * uJ;
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const long long e = e0 + static_cast<long long>(i) * stride;
      row[i] = 0;
      b[i] = kNoRow;
      if (e < hi) {
        if (DIRECT) {
          row[i] = min(static_cast<uint32_t>(idx[e]), last_row);
          b[i] = bq;
        } else if (sizeof(E) == 8) {
          const uint64_t x = __ldcs(&ent[e]);
          row[i] = static_cast<uint32_t>(x);
          b[i] = static_cast<uint32_t>(x >> 32);
        } else {
          const uint32_t x = static_cast<uint32_t>(__ldcs(&ent[e]));
          row[i] = x & ((1u << pl.sbits) - 1u);
          b[i] = x >> pl.sbits;
        }
      }
      if (DIRECT) {
        bq += dq;
        br += dr;
        if (br >= uJ) {
          br -= uJ;
          ++bq;
        }
      }
    }
  };
  __syncthreads();
  constexpr bool two = ACC;     // two slice buffers: the next one staged early
  if (two && it_lo < it_hi) stage(it_lo, 0);
  for (int item = it_lo; item < it_hi; ++item) {
    const int k = item - it_lo;
    const int slot = two ? k & 1 : 0;
    const uint32_t parity = two ? (k >> 1) & 1 : k & 1;
    if (two && item + 1 < it_hi)
      stage(item + 1, slot ^ 1);          // that buffer is free
    else if (!two)
      stage(item, 0);
    const long long r0 = static_cast<long long>(item / pl.share) * pl.S;
    const uint32_t* tab = bufs + slot * pl.buf_words +
                          ((reinterpret_cast<uintptr_t>(tbl + r0 * W) >> 2) &
                           3);
    const int p = item / pl.share, q = item - p * pl.share;
    long long lo, hi;
    if (DIRECT) {
      const long long b_lo = B * q / pl.share, b_hi = B * (q + 1) / pl.share;
      for (long long b = b_lo + threadIdx.x; b < b_hi; b += blockDim.x)
        out[b] = 0;
      lo = b_lo * J;
      hi = b_hi * J;
    } else {
      const long long s0 = start[p], n = start[p + 1] - s0;
      lo = s0 + n * q / pl.share;
      hi = s0 + n * (q + 1) / pl.share;
    }
    uint32_t row[C], b[C];
    load(lo, hi, row, b);
    mbar_wait(&bars[slot], parity);
    __syncthreads();                      // the head and tail words too
    for (long long base = lo; base < hi; base += step) {
      if (!kPrefetch && base != lo) load(base, hi, row, b);
      uint32_t next_row[C], next_b[C];
      if (kPrefetch && base + step < hi)
        load(base + step, hi, next_row, next_b);
      uint32_t acc[C];
#pragma unroll
      for (int i = 0; i < C; ++i) acc[i] = 0;
#pragma unroll 2
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int i = 0; i < C; ++i)
          acc[i] += take_row<MODE>(tab, row[i], W, upr, u, g);
        asm volatile("" ::: "memory");  // the next round gathers again
      }
      // the sums of each run of equal b among the thread's entries, added
      // at the run's last entry
      uint32_t run = 0;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (ACC)
          for (int d = 1; d < g; d <<= 1)
            acc[i] += __shfl_xor_sync(0xFFFFFFFFu, acc[i], d);
        run += acc[i];
        const bool last = i == C - 1 || b[i + 1] != b[i];
        if (ACC) {
          if (last && u == 0 && b[i] != kNoRow) atomicAdd(&sums[b[i]], run);
        } else {
          warp_add(last ? b[i] : kNoRow, last ? run : 0u, out);
        }
        if (last) run = 0;
        if (kPrefetch) {
          row[i] = next_row[i];
          b[i] = next_b[i];
        }
      }
    }
    __syncthreads();                      // this buffer is free again
  }
  if (ACC) {
    for (long long b = threadIdx.x; b < B; b += blockDim.x)
      if (sums[b]) atomicAdd(out + b, sums[b]);
  }
}

inline bool vec_ok(const void* tbl, const void* out, int W) {
  return W % 4 == 0 && reinterpret_cast<uintptr_t>(tbl) % 16 == 0 &&
         (out == nullptr || reinterpret_cast<uintptr_t>(out) % 16 == 0);
}

}  // namespace

// out [n_idx * G, W] from tbl [NB, W] and idx [n_idx]
extern "C" int dbg_gather_rows(const void* tbl, const void* idx,
                               long long n_idx, int G, int W, void* out,
                               void* stream) {
  const bool vec = vec_ok(tbl, out, W);
  const long long total = n_idx * G * (vec ? W / 4 : W);
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  auto* t = static_cast<const uint32_t*>(tbl);
  auto* i = static_cast<const int32_t*>(idx);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    gather_rows_kernel<true><<<blocks, kThreads, 0, s>>>(t, i, total, G, W, o);
  else
    gather_rows_kernel<false><<<blocks, kThreads, 0, s>>>(t, i, total, G, W,
                                                         o);
  DBG_RETURN_LAUNCH_STATUS();
}

// K10: out [n_chunks] from idx [n_chunks * CH] and tbl [NB, W] in one
// launch of `blocks` blocks whose first n_warps warps take a range of
// rows each (engine/gather.py rowsum_plan), after a memset of out
extern "C" int dbg_gather_rowsum(const void* tbl, int NB, const void* idx,
                                 int n_chunks, int CH, int W, int blocks,
                                 int n_warps, void* out, void* stream) {
  const bool vec = vec_ok(tbl, nullptr, W);
  auto* t = static_cast<const uint32_t*>(tbl);
  auto* i = static_cast<const int32_t*>(idx);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const long long N = static_cast<long long>(n_chunks) * CH;
  const uint32_t last_row = static_cast<uint32_t>(NB - 1);
  if (n_warps < 1 || n_warps > blocks * kRowsumWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = static_cast<int>(
      cudaMemsetAsync(o, 0, static_cast<size_t>(n_chunks) * 4, s));
  if (err) return err;
  if (vec)
    gather_rowsum_kernel<true><<<blocks, kRowsumThreads, 0, s>>>(
        t, last_row, i, N, CH, W / 4, n_warps, o);
  else
    gather_rowsum_kernel<false><<<blocks, kRowsumThreads, 0, s>>>(
        t, last_row, i, N, CH, W, n_warps, o);
  DBG_RETURN_LAUNCH_STATUS();
}

// K10's resident blocks per SM (its occupancy at kRowsumThreads threads),
// for 16-byte vectors (vec) or words
extern "C" int dbg_gather_rowsum_occupancy(int vec) {
  int n = 0;
  const cudaError_t e =
      vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, gather_rowsum_kernel<true>, kRowsumThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, gather_rowsum_kernel<false>, kRowsumThreads, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

namespace {

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB it has
// to ask), asked once per kernel, device and size: the call costs host
// time on every launch.  `allowed` holds the size granted per device.
int allow_smem(const void* kernel, int bytes, int* allowed) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && allowed[dev] >= bytes) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return static_cast<int>(e);
}

template <typename E, int MODE, bool DIRECT, bool ACC>
int launch_gather_sum(const uint32_t* tbl, int NB, int W, const int32_t* idx,
                      const void* ent, const int* start, long long N, int J,
                      int reps, int g_log, const GatherPlan& pl,
                      uint32_t* out, cudaStream_t s) {
  auto kernel = gather_sum_kernel<E, MODE, DIRECT, ACC>;
  static int allowed[kMaxDevices];
  const int err = allow_smem(reinterpret_cast<const void*>(kernel), pl.smem,
                             allowed);
  if (err) return err;
  kernel<<<pl.grid, pl.threads, pl.smem, s>>>(
      tbl, NB, W, idx, static_cast<const E*>(ent), start, N, J, reps, g_log,
      pl, out);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int gather_sum_mode(const uint32_t* tbl, int NB, int W, const int32_t* idx,
                    const void* ent, const int* start, long long N, int J,
                    int reps, int g_log, const GatherPlan& pl, uint32_t* out,
                    cudaStream_t s) {
  if (pl.P == 1)
    return launch_gather_sum<uint32_t, MODE, true, false>(
        tbl, NB, W, idx, nullptr, nullptr, N, J, reps, g_log, pl, out, s);
  if (pl.entry64)     // B * S > 2^32: out has no room in shared memory
    return launch_gather_sum<unsigned long long, MODE, false, false>(
        tbl, NB, W, idx, ent, start, N, J, reps, g_log, pl, out, s);
  if (pl.acc)
    return launch_gather_sum<uint32_t, MODE, false, true>(
        tbl, NB, W, idx, ent, start, N, J, reps, g_log, pl, out, s);
  return launch_gather_sum<uint32_t, MODE, false, false>(
      tbl, NB, W, idx, ent, start, N, J, reps, g_log, pl, out, s);
}

// (a) and (b), the passes of `passes` among them
template <typename E>
int count_and_scatter(const int32_t* idx, long long N, int NB, int J,
                      const GatherPlan& pl, int* gcount, int* rel,
                      int* start, void* entries, uint32_t* out, int passes,
                      cudaStream_t s) {
  const int hist = pl.P * static_cast<int>(sizeof(int));
  int err = 0;
  if (passes & kPassCount) {
    static int allowed[kMaxDevices];
    if ((err = allow_smem(reinterpret_cast<const void*>(bucket_count_kernel),
                          hist, allowed)))
      return err;
    cudaMemsetAsync(gcount, 0, hist, s);
    bucket_count_kernel<<<pl.tiles, kCountThreads, hist, s>>>(idx, N, pl,
                                                              gcount, rel);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
  }
  if (passes & kPassScatter) {
    static int allowed[kMaxDevices];
    if ((err = allow_smem(
             reinterpret_cast<const void*>(bucket_scatter_kernel<E>),
             pl.scatter_smem, allowed)))
      return err;
    bucket_scatter_kernel<E><<<pl.tiles, kCountThreads, pl.scatter_smem, s>>>(
        idx, N, NB, J, pl, gcount, rel, start, static_cast<E*>(entries), out);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

// the passes of `passes` (kPass* bits) of K11 (W words a row) or K12
// (take: W = 1); counts: gcount [P], start [P + 1], rel [tiles * P]
int gather_sum(const void* tbl, int NB, int W, bool take, const void* idx,
               int B, int J, int reps, const GatherPlan& pl, void* counts,
               void* entries, int passes, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<const uint32_t*>(tbl);
  auto* i = static_cast<const int32_t*>(idx);
  auto* o = static_cast<uint32_t*>(out);
  const long long N = static_cast<long long>(B) * J;
  int* gcount = static_cast<int*>(counts);
  int* start = gcount + pl.P;
  int* rel = start + pl.P + 1;
  if (N > 0 && pl.P > 1) {
    const int err =
        pl.entry64
            ? count_and_scatter<unsigned long long>(i, N, NB, J, pl, gcount,
                                                    rel, start, entries, o,
                                                    passes, s)
            : count_and_scatter<uint32_t>(i, N, NB, J, pl, gcount, rel,
                                          start, entries, o, passes, s);
    if (err) return err;
  }
  if (!(passes & kPassGather)) return 0;
  if (N == 0) {   // else the scatter or the direct gather zeroes out
    cudaMemsetAsync(o, 0, static_cast<size_t>(B) * sizeof(uint32_t), s);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = !take && vec_ok(tbl, nullptr, W);
  const int upr = take ? 1 : vec ? W / 4 : W;
  int g_log = 0;
  while ((1 << g_log) < upr && g_log < 5) ++g_log;
  if (take)
    return gather_sum_mode<0>(t, NB, 1, i, entries, start, N, J, reps, 0, pl,
                              o, s);
  if (vec)
    return gather_sum_mode<2>(t, NB, W, i, entries, start, N, J, reps, g_log,
                              pl, o, s);
  return gather_sum_mode<1>(t, NB, W, i, entries, start, N, J, reps, g_log,
                            pl, o, s);
}

}  // namespace

// K11: out [B] from idx [B, J] and tbl [NB, W] under `plan` (scratch
// `counts` and `entries` as the plan sizes them; none on the direct path);
// `passes` selects the passes run (7: all; one bit times one pass)
extern "C" int dbg_gather_rows_sum(const void* tbl, int NB, const void* idx,
                                   int B, int J, int W, int reps,
                                   const void* plan, void* counts,
                                   void* entries, int passes, void* out,
                                   void* stream) {
  return gather_sum(tbl, NB, W, false, idx, B, J, reps,
                    *static_cast<const GatherPlan*>(plan), counts, entries,
                    passes, out, stream);
}

// K12: out [B] from idx [B, J] and tbl1 [NB], as K11 with rows of a word
extern "C" int dbg_gather_take_sum(const void* tbl1, int NB, const void* idx,
                                   int B, int J, int reps, const void* plan,
                                   void* counts, void* entries, int passes,
                                   void* out, void* stream) {
  return gather_sum(tbl1, NB, 1, true, idx, B, J, reps,
                    *static_cast<const GatherPlan*>(plan), counts, entries,
                    passes, out, stream);
}

extern "C" int dbg_sizeof_gather_plan() { return sizeof(GatherPlan); }
