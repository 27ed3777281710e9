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
// Counts lie in [0, pmax], so here a counting sort gives the order:
//   pass 1 (tiles of 256 rows): per-tile histogram of the counts;
//   pass 2 (one block): per count, the exclusive prefix over the tiles,
//     the rank at which each count starts (rows of larger counts come
//     first), the column offsets col_off[j] = sum of n_j' for j' < j and
//     the populated length;
//   pass 3 (tiles again): a row's rank = start of its count + rows of
//     the same count in earlier tiles + rows of the same count earlier in
//     its tile (match-any ballot within the warp, a small shared table
//     across the tile's warps); the thread scatters slot j of its row to
//     flat[col_off[j] + rank], copies the row's meta, and the grid zeroes
//     the tail.
//
// Bound on the card: bytes.  fused is read twice (its first two columns
// in pass 1, the whole row in pass 3), meta and flat are written once;
// the row reads are strided by thread (one 64-byte row each at pmax 30),
// the scatter is contiguous where neighbouring rows share a count.
#include "common.cuh"

namespace {

constexpr int kTile = 256;              // rows per block, passes 1 and 3
constexpr int kWarps = kTile / 32;

template <typename T>
__device__ __forceinline__ int row_count(const T* __restrict__ fused,
                                         int cols, int pmax, int r) {
  const int status = static_cast<int>(fused[static_cast<size_t>(r) * cols]);
  const int plen = static_cast<int>(fused[static_cast<size_t>(r) * cols + 1]);
  return (status == dbg::STATUS_ALIGNED_FWD || status == dbg::STATUS_ALIGNED_RC)
             ? min(plen, pmax)
             : 0;
}

// pass 1: hist[c * n_tiles + tile] = rows of the tile with count c
template <typename T>
__global__ void compact_hist_kernel(const T* __restrict__ fused, int B,
                                    int pmax, int n_tiles,
                                    int32_t* __restrict__ hist) {
  extern __shared__ int32_t sh[];       // [pmax + 1]
  for (int c = threadIdx.x; c <= pmax; c += blockDim.x) sh[c] = 0;
  __syncthreads();
  const int r = blockIdx.x * kTile + threadIdx.x;
  if (r < B) atomicAdd(&sh[row_count(fused, pmax + 2, pmax, r)], 1);
  __syncthreads();
  for (int c = threadIdx.x; c <= pmax; c += blockDim.x)
    hist[static_cast<size_t>(c) * n_tiles + blockIdx.x] = sh[c];
}

// pass 2: hist becomes, per count, the rank of the first row of each
// tile with that count; col_off[j] the start of column j in flat;
// col_off[pmax] the populated length
__global__ void compact_scan_kernel(int pmax, int n_tiles,
                                    int32_t* __restrict__ hist,
                                    int32_t* __restrict__ col_off) {
  extern __shared__ int32_t total[];    // [pmax + 1] rows per count
  for (int c = threadIdx.x; c <= pmax; c += blockDim.x) {
    int32_t* h = hist + static_cast<size_t>(c) * n_tiles;
    int run = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int v = h[t];
      h[t] = run;
      run += v;
    }
    total[c] = run;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // start[c] = rows with a larger count; n_j = rows with count > j
    int above = 0;
    for (int c = pmax; c >= 0; --c) {
      const int t = total[c];
      total[c] = above;                 // now start[c]
      above += t;
    }
    int off = 0;
    for (int j = 0; j < pmax; ++j) {
      col_off[j] = off;
      off += total[j];                  // start[j] == n_j
    }
    col_off[pmax] = off;
  }
  __syncthreads();
  for (int c = threadIdx.x; c <= pmax; c += blockDim.x) {
    int32_t* h = hist + static_cast<size_t>(c) * n_tiles;
    const int s = total[c];
    for (int t = 0; t < n_tiles; ++t) h[t] += s;
  }
}

// pass 3: rank, scatter, meta, zero tail
template <typename T>
__global__ void compact_scatter_kernel(const T* __restrict__ fused, int B,
                                       int pmax, int n_tiles,
                                       const int32_t* __restrict__ hist,
                                       const int32_t* __restrict__ col_off,
                                       T* __restrict__ meta,
                                       T* __restrict__ flat) {
  extern __shared__ int32_t wc[];       // [kWarps][pmax + 1] rows per count
  const int C = pmax + 1;
  for (int i = threadIdx.x; i < kWarps * C; i += blockDim.x) wc[i] = 0;
  __syncthreads();
  const int cols = pmax + 2;
  const int r = blockIdx.x * kTile + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool live = r < B;
  // rows past B take count pmax + 1, which no live row has
  const int c = live ? row_count(fused, cols, pmax, r) : C;
  const unsigned same = __match_any_sync(0xFFFFFFFFu, c);
  const int before = __popc(same & ((1u << lane) - 1u));
  if (live && before == 0) wc[warp * C + c] = __popc(same);
  __syncthreads();
  if (live) {
    int rank = hist[static_cast<size_t>(c) * n_tiles + blockIdx.x] + before;
    for (int w = 0; w < warp; ++w) rank += wc[w * C + c];
    const T* row = fused + static_cast<size_t>(r) * cols;
    meta[2 * static_cast<size_t>(r)] = row[0];
    meta[2 * static_cast<size_t>(r) + 1] = row[1];
    for (int j = 0; j < c; ++j)
      flat[static_cast<size_t>(col_off[j]) + rank] = row[2 + j];
  }
  // zero tail of flat: [populated length, B * pmax)
  const size_t n_flat = static_cast<size_t>(B) * pmax;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(col_off[pmax]) +
                  static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_flat; i += stride)
    flat[i] = 0;
}

template <typename T>
int launch(const void* fused, int B, int pmax, void* scratch, void* meta,
           void* flat, cudaStream_t stream) {
  const int n_tiles = (B + kTile - 1) / kTile;
  const int C = pmax + 1;
  int32_t* hist = static_cast<int32_t*>(scratch);           // [C, n_tiles]
  int32_t* col_off = hist + static_cast<size_t>(C) * n_tiles;   // [C]
  const T* f = static_cast<const T*>(fused);
  compact_hist_kernel<T><<<n_tiles, kTile, C * sizeof(int32_t), stream>>>(
      f, B, pmax, n_tiles, hist);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  compact_scan_kernel<<<1, 256, C * sizeof(int32_t), stream>>>(
      pmax, n_tiles, hist, col_off);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  compact_scatter_kernel<T>
      <<<n_tiles, kTile, kWarps * C * sizeof(int32_t), stream>>>(
          f, B, pmax, n_tiles, hist, col_off, static_cast<T*>(meta),
          static_cast<T*>(flat));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: int32 [(pmax + 1) * (ceil(B / 256) + 1)]
extern "C" int dbg_compact_result(const void* fused, int B, int pmax,
                                  int is_i16, void* scratch, void* meta,
                                  void* flat, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_i16 ? launch<int16_t>(fused, B, pmax, scratch, meta, flat, s)
                : launch<int32_t>(fused, B, pmax, scratch, meta, flat, s);
}

extern "C" int dbg_compact_tile() { return kTile; }
