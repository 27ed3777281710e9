// K4 pack_paths: the fused per-read result rows.
//
// Replaces, in dbgtpu/engine/core.py: pack_paths (:864) and the fused
// output of align_batch_packed (:1517-1526).  Row b is
// [status, true plen, offset, reversed left ids, right ids], zero-padded
// to 2 + pmax columns, with plen = 1 + llen + rlen reported unclamped so
// the host can recompute rows whose path does not fit.
//
// Bound on the card: a small gather-and-store pass (one thread per
// output element reads at most one buffer entry); the TPU version's
// flip + masked log-roll alignment is replaced by direct indexing.
#include "common.cuh"

namespace {

template <typename T>
__global__ void pack_paths_kernel(const int32_t* __restrict__ status,
                                  const int32_t* __restrict__ offset,
                                  const int32_t* __restrict__ llen,
                                  const int32_t* __restrict__ rlen,
                                  const int32_t* __restrict__ lbuf,
                                  const int32_t* __restrict__ rbuf, int P,
                                  int pmax, T* __restrict__ out) {
  const int b = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= pmax + 2) return;
  const int ll = llen[b];
  const int plen = 1 + ll + rlen[b];
  int v;
  if (c == 0) {
    v = status[b];
  } else if (c == 1) {
    v = plen;
  } else {
    const int j = c - 2;  // path slot
    if (j >= plen || j >= P) {
      v = 0;
    } else if (j == 0) {
      v = offset[b];
    } else if (j <= ll) {
      v = lbuf[static_cast<size_t>(b) * P + (ll - j)];
    } else {
      v = rbuf[static_cast<size_t>(b) * P + (j - ll - 1)];
    }
  }
  out[static_cast<size_t>(b) * (pmax + 2) + c] = static_cast<T>(v);
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int dbg_pack_paths(const void* status, const void* offset,
                              const void* llen, const void* rlen,
                              const void* lbuf, const void* rbuf, int B,
                              int P, int pmax, int out_int16, void* out,
                              void* stream) {
  const dim3 grid(B, (pmax + 2 + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const int32_t*>(status);
  const auto* of = static_cast<const int32_t*>(offset);
  const auto* ll = static_cast<const int32_t*>(llen);
  const auto* rl = static_cast<const int32_t*>(rlen);
  const auto* lb = static_cast<const int32_t*>(lbuf);
  const auto* rb = static_cast<const int32_t*>(rbuf);
  if (out_int16)
    pack_paths_kernel<int16_t><<<grid, kThreads, 0, s>>>(
        st, of, ll, rl, lb, rb, P, pmax, static_cast<int16_t*>(out));
  else
    pack_paths_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        st, of, ll, rl, lb, rb, P, pmax, static_cast<int32_t*>(out));
  DBG_RETURN_LAUNCH_STATUS();
}

// threads per block of this file's kernels (build.kernel_resources gives
// ptxas's registers per kernel; with this, the warps per SM they allow)
extern "C" int dbg_pack_threads() { return kThreads; }

// message of a status returned by any entry point above
extern "C" const char* dbg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
