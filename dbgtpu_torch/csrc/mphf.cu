// K7 mphf_slots: the MPHF lookup as a standalone kernel, one thread per
// query, any query count.
//
// Replaces dbgtpu/engine/core.py _mphf_slot_arrays (:293) and
// index/mphf.py device_lookup (:248) as a function of its own; the
// mapping kernels (K2, K3, K5, K6) call the same device function,
// mphf.cuh mphf_slot, inline.
//
// Bound on the card: one random 20-byte rank-group row per level a query
// visits (one, for nearly every key of the build set), so memory
// latency and 32-byte sectors, not bandwidth: a query moves 8 bytes in,
// 4 out and at least one sector of the level rows.
#include "mphf.cuh"

namespace {

__global__ void mphf_slots_kernel(const uint32_t* __restrict__ rows,
                                  const uint32_t* __restrict__ frows,
                                  const __grid_constant__ dbg::MphfMeta meta,
                                  const int64_t* __restrict__ keys,
                                  long long n, int32_t* __restrict__ slots) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t key = static_cast<uint64_t>(keys[i]);
  slots[i] = dbg::mphf_slot(rows, frows, meta, dbg::khi(key), dbg::klo(key));
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int dbg_mphf_slots(const void* rows, const void* frows,
                              const void* meta, const void* keys,
                              long long n, void* slots, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  mphf_slots_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(frows),
      *static_cast<const dbg::MphfMeta*>(meta),
      static_cast<const int64_t*>(keys), n, static_cast<int32_t*>(slots));
  DBG_RETURN_LAUNCH_STATUS();
}

// sizes of the structs the Python binding mirrors (kernels/build.py)
extern "C" int dbg_sizeof_index() {
  return static_cast<int>(sizeof(dbg::Index));
}
extern "C" int dbg_sizeof_mphf_meta() {
  return static_cast<int>(sizeof(dbg::MphfMeta));
}

// threads per block of this file's kernels (build.kernel_resources gives
// ptxas's registers per kernel; with this, the warps per SM they allow)
extern "C" int dbg_mphf_threads() { return kThreads; }
