// K7 mphf_slots: the MPHF lookup as a standalone kernel, any query
// count; and the check of an MPHF-backed table at upload in one launch.
//
// Replaces dbgtpu/engine/core.py _mphf_slot_arrays (:293) and
// index/mphf.py device_lookup (:248) as a function of its own; the
// mapping kernels (K2, K3, K5, K6) call the same device function,
// mphf.cuh mphf_slot, inline.
//
// Bound on the card: one random 20-byte rank-group row per level a query
// visits (one, for nearly every key of the build set), so memory latency
// and 32-byte sectors, not bandwidth: a query moves 8 bytes in, 4 out
// and at least one sector of the level rows.  A thread takes Q keys and
// issues all their key loads, then all their level-0 row loads, before
// it tests any bit (mphf.cuh's address and test steps); a key whose
// level-0 bit is clear goes on alone from level 1.  engine/mphf.py
// mphf_plan picks Q from the key count and the SMs: 2 where the threads
// still fill the card, else 1; Q = 4 (48 registers) measured slower than
// 2 and is kept for that comparison.  The plan also sizes the blocks so
// that a small table spreads over every SM.
//
// The check mode (its own kernel, the same lookup) reads each stored key
// in place, from the first two words of its row of `vrows` (row stride
// `cols` words), looks it up and counts the keys that come back at
// another slot than their row into one device word: one launch and a
// 4-byte read per table, where a lookup of every key needs the keys
// built, the slots written and compared.
#include "mphf.cuh"

namespace {

// the most threads a block of this file's kernels has (mphf_plan halves
// it, to 64, for small tables)
constexpr int kThreads = 256;

// slot[q] of the keys (hi[q], lo[q]): the level-0 probes of all Q keys,
// their row words loaded together, then the tests
template <int Q>
__device__ __forceinline__ void slots_of(const uint32_t* __restrict__ rows,
                                         const uint32_t* __restrict__ frows,
                                         const dbg::MphfMeta& mt,
                                         const uint32_t (&hi)[Q],
                                         const uint32_t (&lo)[Q],
                                         int (&slot)[Q]) {
  if (mt.n_levels == 0) {                 // the final table alone
#pragma unroll
    for (int q = 0; q < Q; ++q)
      slot[q] = dbg::mphf_final(frows, mt, hi[q], lo[q]);
    return;
  }
  dbg::MphfProbe p[Q];
  uint32_t word[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) p[q] = dbg::mphf_probe(rows, mt, 0, hi[q], lo[q]);
#pragma unroll
  for (int q = 0; q < Q; ++q) word[q] = p[q].row[1 + p[q].wsel];
#pragma unroll
  for (int q = 0; q < Q; ++q)
    slot[q] = dbg::mphf_hit(p[q], word[q])
                  ? dbg::mphf_rank(p[q], word[q])
                  : dbg::mphf_slot_from(rows, frows, mt, hi[q], lo[q], 1);
}

// key q of a thread: index (block * Q + q) * blockDim + thread, so that
// each of the Q loads of a warp is coalesced; a thread past the end
// repeats the last key and stores nothing
template <int Q>
__device__ __forceinline__ long long key_index(int q) {
  return (static_cast<long long>(blockIdx.x) * Q + q) * blockDim.x +
         threadIdx.x;
}

template <int Q>
__global__ void mphf_slots_kernel(const uint32_t* __restrict__ rows,
                                  const uint32_t* __restrict__ frows,
                                  const __grid_constant__ dbg::MphfMeta meta,
                                  const int64_t* __restrict__ keys,
                                  long long n, int32_t* __restrict__ slots) {
  uint32_t hi[Q], lo[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const long long i = key_index<Q>(q);
    const uint64_t key = static_cast<uint64_t>(keys[i < n ? i : n - 1]);
    hi[q] = dbg::khi(key);
    lo[q] = dbg::klo(key);
  }
  int slot[Q];
  slots_of<Q>(rows, frows, meta, hi, lo, slot);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const long long i = key_index<Q>(q);
    if (i < n) slots[i] = slot[q];
  }
}

// the check mode: the same lookup of the keys stored in rows i of vrows
template <int Q>
__global__ void mphf_check_kernel(const uint32_t* __restrict__ rows,
                                  const uint32_t* __restrict__ frows,
                                  const __grid_constant__ dbg::MphfMeta meta,
                                  const uint32_t* __restrict__ vrows, int cols,
                                  long long n, unsigned* __restrict__ bad) {
  uint32_t hi[Q], lo[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const long long i = key_index<Q>(q);
    const uint32_t* r = vrows + (i < n ? i : n - 1) * cols;
    hi[q] = r[0];
    lo[q] = r[1];
  }
  int slot[Q];
  slots_of<Q>(rows, frows, meta, hi, lo, slot);
  unsigned wrong = 0;                     // every lane takes part below
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const long long i = key_index<Q>(q);
    wrong += (i < n && slot[q] != i) ? 1u : 0u;
  }
  const unsigned count = __reduce_add_sync(0xFFFFFFFFu, wrong);
  if ((threadIdx.x & 31) == 0 && count) atomicAdd(bad, count);
}

// blocks of `threads` for n keys at Q a thread; false: no such kernel
bool grid_of(long long n, int per_thread, int threads, unsigned* blocks) {
  if ((per_thread != 1 && per_thread != 2 && per_thread != 4) ||
      threads < 32 || threads > kThreads || threads % 32)
    return false;
  const long long per_block = static_cast<long long>(per_thread) * threads;
  *blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  return true;
}

__global__ void empty_kernel() {}

}  // namespace

// slots [n] of keys [n] (int64), n > 0, `per_thread` keys a thread (1,
// 2 or 4) in blocks of `threads` (engine/mphf.py mphf_plan)
extern "C" int dbg_mphf_slots(const void* rows, const void* frows,
                              const void* meta, const void* keys,
                              long long n, int per_thread, int threads,
                              void* slots, void* stream) {
  unsigned blocks = 0;
  if (!grid_of(n, per_thread, threads, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const uint32_t*>(rows);
  auto f = static_cast<const uint32_t*>(frows);
  const auto& m = *static_cast<const dbg::MphfMeta*>(meta);
  auto k = static_cast<const int64_t*>(keys);
  auto o = static_cast<int32_t*>(slots);
  if (per_thread == 1)
    mphf_slots_kernel<1><<<blocks, threads, 0, s>>>(r, f, m, k, n, o);
  else if (per_thread == 2)
    mphf_slots_kernel<2><<<blocks, threads, 0, s>>>(r, f, m, k, n, o);
  else
    mphf_slots_kernel<4><<<blocks, threads, 0, s>>>(r, f, m, k, n, o);
  DBG_RETURN_LAUNCH_STATUS();
}

// bad [1] = the stored keys of vrows [n, cols] (key hi, key lo first)
// that the MPHF sends to another slot than their row; n > 0; the plan as
// dbg_mphf_slots's
extern "C" int dbg_mphf_check(const void* rows, const void* frows,
                              const void* meta, const void* vrows, int cols,
                              long long n, int per_thread, int threads,
                              void* bad, void* stream) {
  unsigned blocks = 0;
  if (!grid_of(n, per_thread, threads, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int err = static_cast<int>(cudaMemsetAsync(bad, 0, sizeof(int), s));
  if (err) return err;
  auto r = static_cast<const uint32_t*>(rows);
  auto f = static_cast<const uint32_t*>(frows);
  const auto& m = *static_cast<const dbg::MphfMeta*>(meta);
  auto v = static_cast<const uint32_t*>(vrows);
  auto b = static_cast<unsigned*>(bad);
  if (per_thread == 1)
    mphf_check_kernel<1><<<blocks, threads, 0, s>>>(r, f, m, v, cols, n, b);
  else if (per_thread == 2)
    mphf_check_kernel<2><<<blocks, threads, 0, s>>>(r, f, m, v, cols, n, b);
  else
    mphf_check_kernel<4><<<blocks, threads, 0, s>>>(r, f, m, v, cols, n, b);
  DBG_RETURN_LAUNCH_STATUS();
}

// a kernel that does nothing, in one block of one warp: the timers'
// launch floor (kernels/measure.py launch_floor_ms)
extern "C" int dbg_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  DBG_RETURN_LAUNCH_STATUS();
}

// sizes of the structs the Python binding mirrors (kernels/build.py)
extern "C" int dbg_sizeof_index() {
  return static_cast<int>(sizeof(dbg::Index));
}
extern "C" int dbg_sizeof_mphf_meta() {
  return static_cast<int>(sizeof(dbg::MphfMeta));
}

// the most threads per block of this file's kernels (build.kernel_resources
// gives ptxas's registers per kernel; with this, the warps per SM they
// allow)
extern "C" int dbg_mphf_threads() { return kThreads; }
