// K4 pack_paths: the fused per-read result rows.
//
// Replaces, in dbgtpu/engine/core.py: pack_paths (:864) and the fused
// output of align_batch_packed (:1517-1526).  Row b is
// [status, true plen, offset, reversed left ids, right ids], zero-padded
// to C = 2 + pmax columns, with plen = 1 + llen + rlen reported unclamped
// so the host can recompute rows whose path does not fit.
//
// Design.  The output is one flat run of B * C elements, cut into tiles
// of R rows (R a multiple of 8, chosen on the host so that a tile is
// about one 16-byte chunk per thread: R = 256 * V / C rounded down to a
// multiple of 8, at least 8), and each tile into 16-byte chunks of V
// consecutive elements (V = 8 int16 or 4 int32 slots).  A block stages
// its tile's row headers (status, offset, llen, plen) in shared memory
// with one coalesced read per field and row, then each thread builds one
// chunk in registers (the chunk may run across a row's end; the header
// is re-read from shared memory only there) and writes it with one
// 16-byte store; the ragged end of the batch is stored element by
// element.  Every lane is live: at pmax = 30 a tile of int16 rows is 64
// rows = 256 chunks for 256 threads.  R * C * sizeof(T) is a multiple of
// 16, so every tile starts 16-byte aligned (the output must be).  The
// grid is min(tiles, 8 blocks per SM); blocks loop over tiles.
//
// Bound on the card: bytes (about 2 MB of int16 stores and the walks'
// headers and used slots per 32,768-read batch, 0.0008 ms); what is
// left is the launch and one round trip to the walk buffers (L2).  The
// TPU version's flip + masked log-roll alignment is replaced by direct
// indexing.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;     // 2048 resident threads per SM

// element c of row b, given its header h = (status, offset, llen, plen)
__device__ __forceinline__ int pack_value(const int4 h, int c, size_t rb,
                                          int P,
                                          const int32_t* __restrict__ lbuf,
                                          const int32_t* __restrict__ rbuf) {
  if (c == 0) return h.x;
  if (c == 1) return h.w;
  const int j = c - 2;              // path slot
  if (j >= h.w || j >= P) return 0;
  if (j == 0) return h.y;
  if (j <= h.z) return lbuf[rb + (h.z - j)];
  return rbuf[rb + (j - h.z - 1)];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pack_paths_kernel(const int32_t* __restrict__ status,
                      const int32_t* __restrict__ offset,
                      const int32_t* __restrict__ llen,
                      const int32_t* __restrict__ rlen,
                      const int32_t* __restrict__ lbuf,
                      const int32_t* __restrict__ rbuf, int B, int P,
                      int pmax, int R, int n_tiles, T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ int4 hdr[];     // [R] (status, offset, llen, plen)
  const int C = pmax + 2;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * R;
    const int nr = min(R, B - r0);
    __syncthreads();                // the last tile's readers are done
    for (int i = threadIdx.x; i < nr; i += blockDim.x) {
      const int b = r0 + i;
      const int ll = llen[b];
      hdr[i] = make_int4(status[b], offset[b], ll, 1 + ll + rlen[b]);
    }
    __syncthreads();
    const int n_elem = nr * C;
    T* tout = out + static_cast<size_t>(r0) * C;
    for (int e0 = threadIdx.x * V; e0 < n_elem; e0 += blockDim.x * V) {
      int row = e0 / C;
      int c = e0 - row * C;
      int4 h = hdr[row];
      size_t rb = static_cast<size_t>(r0 + row) * P;
      union {
        int4 v;
        T s[V];
      } chunk;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        chunk.s[v] = static_cast<T>(
            row < nr ? pack_value(h, c, rb, P, lbuf, rbuf) : 0);
        if (++c == C) {
          c = 0;
          if (++row < nr) {
            h = hdr[row];
            rb += P;
          }
        }
      }
      if (e0 + V <= n_elem) {
        *reinterpret_cast<int4*>(tout + e0) = chunk.v;
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (e0 + v < n_elem) tout[e0 + v] = chunk.s[v];
      }
    }
  }
}

// rows per tile: about one 16-byte chunk of the tile per thread
int rows_per_tile(int pmax, int out_int16) {
  const int V = out_int16 ? 8 : 4;
  return std::max(8, (kThreads * V / (pmax + 2)) / 8 * 8);
}

}  // namespace

extern "C" int dbg_pack_paths(const void* status, const void* offset,
                              const void* llen, const void* rlen,
                              const void* lbuf, const void* rbuf, int B,
                              int P, int pmax, int out_int16, void* out,
                              void* stream) {
  if (B <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int R = rows_per_tile(pmax, out_int16);
  const int n_tiles = (B + R - 1) / R;
  const int grid = std::min(n_tiles, kBlocksPerSm * dbg::sm_count());
  const size_t smem = static_cast<size_t>(R) * sizeof(int4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const int32_t*>(status);
  const auto* of = static_cast<const int32_t*>(offset);
  const auto* ll = static_cast<const int32_t*>(llen);
  const auto* rl = static_cast<const int32_t*>(rlen);
  const auto* lb = static_cast<const int32_t*>(lbuf);
  const auto* rb = static_cast<const int32_t*>(rbuf);
  if (out_int16)
    pack_paths_kernel<int16_t><<<grid, kThreads, smem, s>>>(
        st, of, ll, rl, lb, rb, B, P, pmax, R, n_tiles,
        static_cast<int16_t*>(out));
  else
    pack_paths_kernel<int32_t><<<grid, kThreads, smem, s>>>(
        st, of, ll, rl, lb, rb, B, P, pmax, R, n_tiles,
        static_cast<int32_t*>(out));
  DBG_RETURN_LAUNCH_STATUS();
}

// threads per block of this file's kernels (build.kernel_resources gives
// ptxas's registers per kernel; with this, the warps per SM they allow)
extern "C" int dbg_pack_threads() { return kThreads; }

// message of a status returned by any entry point above
extern "C" const char* dbg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
