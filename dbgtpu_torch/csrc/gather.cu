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
// table.  So: each thread reads its own index; rows move as 16-byte
// vectors, neighbouring threads on neighbouring vectors of one row (a
// 96-byte row is 6 vectors, a 64-byte row 4); K10 splits a chunk over
// several blocks (224 chunks alone would leave most of the card idle) and
// finishes with a second pass over the partial sums (integer adds: any
// order gives the same bits); K11 gives a warp to each index row and
// reduces with shuffles; K12 stages its 128 KB table once per persistent
// block in dynamic shared memory and gathers from there (a table too
// large for a block is read through L2 instead).
//
// K11 and K12 do the gather REPS times, as the TPU bodies do (their
// fori_loop re-reads the table every round): a compiler barrier between
// the rounds keeps the loads from being merged, so the time is that of
// REPS gathers and the result REPS times one sum.
//
// Bound on the card: K9 moves every row twice (read, write) and is bound
// by those bytes; K10 to K12 read idx once and touch at most the table
// (L2-resident at the experiments' sizes), so their byte bound is small
// and what holds them is the L2 and shared-memory gather rate; K11's
// adds (one per word summed, REPS times) outweigh its bytes.  Indices
// are not range-checked: an index outside the table reads outside it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTakeThreads = 1024;     // K12: one block per SM

__device__ __forceinline__ uint32_t sum4(uint4 v) {
  return v.x + v.y + v.z + v.w;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  return v;
}

// sum of `v` over the block, valid in thread 0; sh holds one word per warp
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* sh) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < n_warps) ? sh[threadIdx.x] : 0u;
  if (warp == 0) v = warp_sum(v);
  return v;
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

// ---- K10 pass 1: block (c, s) sums rows [s*sub, (s+1)*sub) of chunk c
template <bool VEC>
__global__ void gather_rowsum_kernel(const uint32_t* __restrict__ tbl,
                                     const int32_t* __restrict__ idx,
                                     int CH, int sub, int W,
                                     uint32_t* __restrict__ part) {
  __shared__ uint32_t sh[32];
  const int c = blockIdx.x, s = blockIdx.y;
  const int t0 = s * sub;
  const int n = min(sub, CH - t0);              // rows of this block
  const int32_t* my = idx + static_cast<long long>(c) * CH + t0;
  const int per_row = VEC ? W / 4 : W;
  uint32_t acc = 0;
  for (int e = threadIdx.x; e < n * per_row; e += blockDim.x) {
    const int t = e / per_row, u = e - t * per_row;
    const long long row = my[t];
    if (VEC) {
      acc += sum4(reinterpret_cast<const uint4*>(tbl)[row * per_row + u]);
    } else {
      acc += tbl[row * W + u];
    }
  }
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0)
    part[static_cast<long long>(c) * gridDim.y + s] = acc;
}

// ---- K10 pass 2: out[c] = sum of the chunk's `split` partial sums
__global__ void gather_rowsum_finish_kernel(const uint32_t* __restrict__ part,
                                            int n_chunks, int split,
                                            uint32_t* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  uint32_t acc = 0;
  for (int s = 0; s < split; ++s)
    acc += part[static_cast<long long>(c) * split + s];
  out[c] = acc;
}

// ---- K11: one warp per index row, lanes over (j, vector or word)
template <bool VEC>
__global__ void gather_rows_sum_kernel(const uint32_t* tbl,
                                       const int32_t* __restrict__ idx,
                                       int B, int J, int W, int reps,
                                       uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  const int32_t* my = idx + static_cast<long long>(b) * J;
  const int per_row = VEC ? W / 4 : W;
  uint32_t acc = 0;
  for (int r = 0; r < reps; ++r) {
    for (int e = lane; e < J * per_row; e += 32) {
      const int j = e / per_row, u = e - j * per_row;
      const long long row = my[j];
      if (VEC) {
        acc += sum4(reinterpret_cast<const uint4*>(tbl)[row * per_row + u]);
      } else {
        acc += tbl[row * W + u];
      }
    }
    asm volatile("" ::: "memory");    // the next round reads the table again
  }
  acc = warp_sum(acc);
  if (lane == 0) out[b] = acc;
}

// ---- K12: persistent blocks; SMEM stages tbl1 in dynamic shared memory
template <bool SMEM>
__global__ void gather_take_sum_kernel(const uint32_t* tbl1, int NB,
                                       const int32_t* __restrict__ idx,
                                       int B, int J, int reps,
                                       uint32_t* __restrict__ out) {
  extern __shared__ uint4 staged4[];
  const uint32_t* src = tbl1;
  if (SMEM) {
    uint32_t* staged = reinterpret_cast<uint32_t*>(staged4);
    const int n4 = NB / 4;
    for (int v = threadIdx.x; v < n4; v += blockDim.x)
      staged4[v] = reinterpret_cast<const uint4*>(tbl1)[v];
    for (int w = 4 * n4 + threadIdx.x; w < NB; w += blockDim.x)
      staged[w] = tbl1[w];
    __syncthreads();
    src = staged;
  }
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int b = blockIdx.x * warps + (threadIdx.x >> 5); b < B;
       b += gridDim.x * warps) {
    const int32_t* my = idx + static_cast<long long>(b) * J;
    uint32_t acc = 0;
    for (int r = 0; r < reps; ++r) {
      for (int j = lane; j < J; j += 32) acc += src[my[j]];
      asm volatile("" ::: "memory");  // the next round gathers again
    }
    acc = warp_sum(acc);
    if (lane == 0) out[b] = acc;
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

// out [n_chunks] from idx [n_chunks * CH]; `split` blocks share a chunk and
// write part [n_chunks * split] (unused when split == 1)
extern "C" int dbg_gather_rowsum(const void* tbl, const void* idx,
                                 int n_chunks, int CH, int W, int split,
                                 void* part, void* out, void* stream) {
  const bool vec = vec_ok(tbl, nullptr, W);
  auto* t = static_cast<const uint32_t*>(tbl);
  auto* i = static_cast<const int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  auto* dst = static_cast<uint32_t*>(split == 1 ? out : part);
  const int sub = (CH + split - 1) / split;
  const dim3 grid(n_chunks, split);
  if (vec)
    gather_rowsum_kernel<true><<<grid, kThreads, 0, s>>>(t, i, CH, sub, W,
                                                         dst);
  else
    gather_rowsum_kernel<false><<<grid, kThreads, 0, s>>>(t, i, CH, sub, W,
                                                          dst);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || split == 1) return err;
  gather_rowsum_finish_kernel<<<(n_chunks + kThreads - 1) / kThreads, kThreads,
                                0, s>>>(static_cast<const uint32_t*>(part),
                                        n_chunks, split,
                                        static_cast<uint32_t*>(out));
  DBG_RETURN_LAUNCH_STATUS();
}

// out [B] from idx [B, J] and tbl [NB, W]
extern "C" int dbg_gather_rows_sum(const void* tbl, const void* idx, int B,
                                   int J, int W, int reps, void* out,
                                   void* stream) {
  const bool vec = vec_ok(tbl, nullptr, W);
  const int warps = kThreads / 32;
  const unsigned blocks = static_cast<unsigned>((B + warps - 1) / warps);
  auto* t = static_cast<const uint32_t*>(tbl);
  auto* i = static_cast<const int32_t*>(idx);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    gather_rows_sum_kernel<true><<<blocks, kThreads, 0, s>>>(t, i, B, J, W,
                                                            reps, o);
  else
    gather_rows_sum_kernel<false><<<blocks, kThreads, 0, s>>>(t, i, B, J, W,
                                                             reps, o);
  DBG_RETURN_LAUNCH_STATUS();
}

// out [B] from idx [B, J] and tbl1 [NB]; `n_blocks` persistent blocks
// (the wrapper passes the card's SM count); the table is staged in shared
// memory when `smem_limit` (the most dynamic shared memory a block may
// ask for on this card) holds it
extern "C" int dbg_gather_take_sum(const void* tbl1, int NB, const void* idx,
                                   int B, int J, int reps, int n_blocks,
                                   int smem_limit, void* out, void* stream) {
  auto* t = static_cast<const uint32_t*>(tbl1);
  auto* i = static_cast<const int32_t*>(idx);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const long long bytes = static_cast<long long>(NB) * 4;
  const int warps = kTakeThreads / 32;
  const int blocks = max(1, min(n_blocks, (B + warps - 1) / warps));
  if (bytes <= smem_limit && reinterpret_cast<uintptr_t>(tbl1) % 16 == 0) {
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          gather_take_sum_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    gather_take_sum_kernel<true>
        <<<blocks, kTakeThreads, static_cast<size_t>(bytes), s>>>(
            t, NB, i, B, J, reps, o);
  } else {
    gather_take_sum_kernel<false>
        <<<blocks, kTakeThreads, 0, s>>>(t, NB, i, B, J, reps, o);
  }
  DBG_RETURN_LAUNCH_STATUS();
}
