// K8 compact_result: the compact layout of a batch's result rows, so the
// host fetches the populated path slots only.
//
// Replaces dbgtpu/engine/core.py _compact_result (:1529) as used by
// align_batches_packed_compact (:1572).  fused [B, 2 + pmax] (int16 or
// int32) -> meta [B, 2] (status, true plen) and flat [B * pmax]:
//   counts  = min(plen, pmax) for status 1 or 2, else 0;
//   rows are ordered by count descending, stable by row index;
//   column j holds slot j of the first n_j = #(count > j) rows of that
//   order; the columns lie back to back; the tail is zero.
// The host rebuilds the order from the counts alone, so the stable order
// is part of the format.
//
// The JAX version sorts with a unique key and places the columns with a
// sum of dynamic rolls, because a scatter runs near-scalar on the TPU.
// Counts lie in [0, pmax], so here a counting sort gives the order, in
// one cooperative launch: a persistent grid of co-resident blocks (as
// many as the occupancy allows, at most 4 per SM and one per 256 rows),
// each owning a contiguous run of tiles of TR rows (TR = 256, fewer where
// a tile of wide rows would not fit in shared memory), and one grid-wide
// barrier.  Each block
//   1. stages each of its tiles in shared memory with 16-byte loads (last
//      tile first, so that its first tile is still staged after the
//      barrier), takes the rows' counts there and sums its per-count
//      histogram; ranks each row of the first tile among the tile's rows
//      of its count (match-any ballot in the warp, a per-warp table
//      across the tile's warps) and orders that tile by count in shared
//      memory, all before the barrier;
//   2. writes its histogram to scratch (hist[c][block]) and waits at the
//      barrier;
//   3. reads every block's histogram (coalesced, from L2) for the total
//      per count and the rows of each count in earlier blocks; one warp
//      scans the rank at which each count starts (larger counts first)
//      and the column offsets (warp shuffles, no block barrier); the
//      block zeroes its share of the tail;
//   4. per tile, in order (the later ones staged and ordered again):
//      scatters slot by slot, column after column, so that neighbouring
//      lanes write neighbouring ranks of a run of equal counts, and
//      copies the meta columns with coalesced stores.
//
// Bound on the card: bytes.  fused is read once from memory (a block
// whose run holds more than one tile reads the others again from L2),
// meta and flat are written once; the histograms are (pmax + 1) ints per
// block.  What is left is the launch, the barrier and a few dependent
// trips to L2.  fused and flat must be 16-byte aligned.
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 256;          // rows per tile at most; rows per block
                                    // at least (the scratch's unit)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 4;
constexpr size_t kMaxSmem = 232448; // 227 KB, the most a block can have

// shared memory of a block: the staged tile, then the int tables
__host__ __device__ inline size_t tile_bytes(int TR, int pmax, int tsize) {
  return (static_cast<size_t>(TR) * (pmax + 2) * tsize + 15) / 16 * 16;
}
inline size_t smem_bytes(int TR, int pmax, int tsize) {
  return tile_bytes(TR, pmax, tsize) +
         sizeof(int) * (static_cast<size_t>(kWarps + 7) * (pmax + 1) +
                        2 * TR + 2);
}

template <typename T>
__device__ __forceinline__ int row_count(const T* row, int pmax) {
  const int status = static_cast<int>(row[0]);
  const int plen = static_cast<int>(row[1]);
  return (status == dbg::STATUS_ALIGNED_FWD || status == dbg::STATUS_ALIGNED_RC)
             ? min(plen, pmax)
             : 0;
}

// run by the 32 lanes of one warp: exclusive prefix sums of a[0, n) in
// place, from the end when `rev` (then a[i] = sum of a[k] for k > i),
// each lane taking a segment of ceil(n / 32); every lane gets the total
__device__ int warp_scan(int* a, int n, bool rev) {
  const int lane = threadIdx.x & 31;
  const int seg = (n + 31) / 32;
  const int lo = min(n, lane * seg), hi = min(n, lo + seg);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[rev ? n - 1 - i : i];
  int x = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(dbg::FULL_WARP, x, d);
    if (lane >= d) x += y;
  }
  const int total = __shfl_sync(dbg::FULL_WARP, x, 31);
  int run = x - s;
  for (int i = lo; i < hi; ++i) {
    int& r = a[rev ? n - 1 - i : i];
    const int v = r;
    r = run;
    run += v;
  }
  __syncwarp();
  return total;
}

// run by one warp: the rows per count h[0, pmax] become, in place, the
// rows of a larger count, and col[j] = sum of h[j'] for j' < j (the
// rows holding slot j' in count order), the start of column j; returns
// the slots of all columns
__device__ int warp_order(int* h, int* col, int pmax) {
  warp_scan(h, pmax + 1, true);
  for (int j = threadIdx.x & 31; j < pmax; j += 32) col[j] = h[j];
  __syncwarp();
  return warp_scan(col, pmax, false);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(const T* __restrict__ fused, int B, int pmax, int TR,
                   int n_tiles, int tpb, int32_t* __restrict__ hist,
                   T* __restrict__ meta, T* __restrict__ flat) {
  extern __shared__ int4 smem4[];
  const int cols = pmax + 2, NC = pmax + 1;
  T* tile = reinterpret_cast<T*>(smem4);
  int* wc = reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) +
                                   tile_bytes(TR, pmax, sizeof(T)));
  int* th = wc + kWarps * NC;       // rows of the tile per count
  int* run = th + NC;               // the block's rows per count so far
  int* ls = run + NC;               // the tile's rows of a larger count
  int* lcol = ls + NC;              // the tile's column offsets
  int* gs = lcol + NC;              // all rows of a larger count
  int* gb = gs + NC;                // global rank of a count's first row
                                    // of this block
  int* coff = gb + NC;              // start of column j in flat
  int* cnt = coff + NC;             // [TR] count per tile row
  int* perm = cnt + TR;             // [TR] tile rows by count, stable
  int* sums = perm + TR;            // [2] populated slots; the tile's
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x, G = gridDim.x;
  const int t_begin = g * tpb, t_end = min(n_tiles, t_begin + tpb);

  auto stage = [&](int t) {
    __syncthreads();                // the last tile's readers are done
    const size_t e0 = static_cast<size_t>(t) * TR * cols;
    const int ne = min(TR, B - t * TR) * cols;
    const int nv = ne * static_cast<int>(sizeof(T)) / 16;
    const int4* src = reinterpret_cast<const int4*>(fused + e0);
    for (int i = tid; i < nv; i += kThreads) smem4[i] = src[i];
    for (int e = nv * (16 / static_cast<int>(sizeof(T))) + tid; e < ne;
         e += kThreads)
      tile[e] = fused[e0 + e];
  };
  // counts of the staged tile's nr rows into cnt and th; gives the
  // thread's row count (NC past the tile) and its rank among the tile's
  // rows of that count.  Each warp clears and fills its own row of wc.
  auto analyze = [&](int nr, int& c_r, int& irank) {
    for (int c = lane; c < NC; c += 32) wc[warp * NC + c] = 0;
    __syncthreads();                // the tile is staged
    c_r = tid < nr ? row_count(tile + static_cast<size_t>(tid) * cols, pmax)
                   : NC;
    const unsigned same = __match_any_sync(dbg::FULL_WARP, c_r);
    const int before = __popc(same & ((1u << lane) - 1u));
    if (tid < nr && before == 0) wc[warp * NC + c_r] = __popc(same);
    if (tid < TR) cnt[tid] = c_r;
    __syncthreads();
    for (int c = tid; c < NC; c += kThreads) {
      int r = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int v = wc[w * NC + c];
        wc[w * NC + c] = r;
        r += v;
      }
      th[c] = r;
    }
    __syncthreads();
    irank = tid < nr ? wc[warp * NC + c_r] + before : 0;
  };
  // the analyzed tile in count order: perm, and its column offsets
  auto order = [&](int nr, int c_r, int irank) {
    if (warp == 0) {
      for (int c = lane; c < NC; c += 32) ls[c] = th[c];
      __syncwarp();
      const int W = warp_order(ls, lcol, pmax);
      if (lane == 0) sums[1] = W;
    }
    __syncthreads();
    if (tid < nr) perm[ls[c_r] + irank] = tid;
  };

  // 1. the block's histogram, last tile first; the first tile, still
  // staged, is put in order before the barrier
  int c_r, irank;
  for (int c = tid; c < NC; c += kThreads) run[c] = 0;
  for (int t = t_end - 1; t >= t_begin; --t) {
    stage(t);
    analyze(min(TR, B - t * TR), c_r, irank);
    for (int c = tid; c < NC; c += kThreads) run[c] += th[c];
  }
  order(min(TR, B - t_begin * TR), c_r, irank);
  // 2. publish the histogram; wait for every block's
  for (int c = tid; c < NC; c += kThreads)
    hist[static_cast<size_t>(c) * G + g] = run[c];
  cg::this_grid().sync();
  // 3. totals and earlier blocks' rows per count, count starts, columns
  for (int c = warp; c < NC; c += kWarps) {
    int tot = 0, bef = 0;
    for (int h = lane; h < G; h += 32) {
      const int v = __ldcg(hist + static_cast<size_t>(c) * G + h);
      tot += v;
      bef += h < g ? v : 0;
    }
    tot = __reduce_add_sync(dbg::FULL_WARP, tot);
    bef = __reduce_add_sync(dbg::FULL_WARP, bef);
    if (lane == 0) {
      gs[c] = tot;
      gb[c] = bef;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int populated = warp_order(gs, coff, pmax);
    for (int c = lane; c < NC; c += 32) gb[c] += gs[c];
    if (lane == 0) sums[0] = populated;
  }
  for (int c = tid; c < NC; c += kThreads) run[c] = 0;
  __syncthreads();
  // the tail of flat, [populated, B * pmax), in 16-byte stores where
  // aligned; the grid's threads share it
  {
    constexpr int V = 16 / sizeof(T);
    const size_t n = static_cast<size_t>(B) * pmax;
    const size_t s = static_cast<size_t>(sums[0]);
    const size_t up = (s + V - 1) / V * V;
    const size_t a = up < n ? up : n, e = n / V * V;
    const size_t gt = static_cast<size_t>(g) * kThreads + tid;
    const size_t gsz = static_cast<size_t>(G) * kThreads;
    for (size_t i = s + gt; i < a; i += gsz) flat[i] = 0;
    for (size_t i = a / V + gt; i < e / V; i += gsz)
      reinterpret_cast<int4*>(flat)[i] = make_int4(0, 0, 0, 0);
    for (size_t i = (a > e ? a : e) + gt; i < n; i += gsz) flat[i] = 0;
  }
  // 4. scatter each tile, in order (the first is still staged and in
  // order)
  for (int t = t_begin; t < t_end; ++t) {
    const int r0 = t * TR, nr = min(TR, B - r0);
    if (t != t_begin) {
      stage(t);
      analyze(nr, c_r, irank);
      order(nr, c_r, irank);
    }
    __syncthreads();                // perm
    // work item w = position p of column j: slot j of the tile's p-th
    // row in count order, at global rank gb[c] + run[c] + p - ls[c]
    const int W = sums[1];
    for (int w = tid; w < W; w += kThreads) {
      int lo = 0, hi = pmax - 1;    // the last column starting <= w
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (lcol[mid] <= w) lo = mid; else hi = mid - 1;
      }
      const int p = w - lcol[lo];
      const int row = perm[p];
      const int c = cnt[row];
      flat[static_cast<size_t>(coff[lo]) + gb[c] + run[c] - ls[c] + p] =
          tile[static_cast<size_t>(row) * cols + 2 + lo];
    }
    T* m = meta + 2 * static_cast<size_t>(r0);
    for (int i = tid; i < 2 * nr; i += kThreads)
      m[i] = tile[static_cast<size_t>(i >> 1) * cols + (i & 1)];
    __syncthreads();
    for (int c = tid; c < NC; c += kThreads) run[c] += th[c];
  }
}

template <typename T>
int launch(const void* fused, int B, int pmax, void* scratch, void* meta,
           void* flat, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(fused) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(flat) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int ts = static_cast<int>(sizeof(T));
  int TR = kTile;
  while (TR > 8 && smem_bytes(TR, pmax, ts) > kMaxSmem) TR -= 8;
  const size_t smem = smem_bytes(TR, pmax, ts);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(&compact_kernel<T>);
  int dev = 0;
  cudaGetDevice(&dev);
  // per device: the shared memory the kernel may take, and the
  // occupancy at the last size asked for
  static size_t smem_set[64] = {0}, occ_smem[64] = {0};
  static int occ_of[64] = {0};
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int err;
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
    smem_set[dev] = smem;
  }
  if (occ_smem[dev] != smem || occ_of[dev] == 0) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ_of[dev], compact_kernel<T>, kThreads, smem));
    if (err) return err;
    occ_smem[dev] = smem;
  }
  if (occ_of[dev] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_tiles = (B + TR - 1) / TR;
  // at most one block per kTile rows: hist [pmax + 1, grid] then fits the
  // scratch of dbg_compact_result
  const int cap = std::min(std::min(occ_of[dev], kMaxBlocksPerSm) *
                               dbg::sm_count(),
                           (B + kTile - 1) / kTile);
  int grid = std::min(n_tiles, cap);
  const int tpb = (n_tiles + grid - 1) / grid;
  grid = (n_tiles + tpb - 1) / tpb;
  const T* f = static_cast<const T*>(fused);
  int32_t* hist = static_cast<int32_t*>(scratch);
  T* mt = static_cast<T*>(meta);
  T* fl = static_cast<T*>(flat);
  void* args[] = {&f, &B, &pmax, &TR, const_cast<int*>(&n_tiles),
                  const_cast<int*>(&tpb), &hist, &mt, &fl};
  err = static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, smem, stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: int32 [(pmax + 1) * (ceil(B / 256) + 1)] (this kernel uses
// (pmax + 1) * grid of it, grid <= ceil(B / 256)); no initial value
extern "C" int dbg_compact_result(const void* fused, int B, int pmax,
                                  int is_i16, void* scratch, void* meta,
                                  void* flat, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_i16 ? launch<int16_t>(fused, B, pmax, scratch, meta, flat, s)
                : launch<int32_t>(fused, B, pmax, scratch, meta, flat, s);
}

extern "C" int dbg_compact_tile() { return kTile; }

// threads per block of this file's kernel
extern "C" int dbg_compact_threads() { return kThreads; }
