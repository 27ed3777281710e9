// K13 sharded_rows: the row gather from a table cut into bucket ranges
// over the cards of a mesh (--shard-index).
//
// Replaces dbgtpu/engine/core.py _sharded_rows (:351): there each device
// all-gathers the query bucket ids (:365), answers the ids that lie in
// its own range of nb_local rows with zeros elsewhere, and the rows come
// back by psum_scatter (:370).  Its function: row b of the global
// [nb_local * D, W] table for each global bucket id b, zeros for an id
// outside it.
//
// Why peer reads, not a collective.  The hopper-kernels guide maps a
// TPU's remote copies to NCCL collectives outside the kernel.  Here the
// lookups happen inside K2 and inside K3's walk, which runs each read to
// completion in one launch and whose junction lookups depend on the data
// (the next key is known only after the last row is read).  A collective
// between lookups would cut K3 back into lockstep steps.  So the cards
// read each other's shards from inside the kernels, through peer
// pointers over NVLink (engine/shard.py enable_peer_access), and K2 and
// K3 take the same path through common.cuh scan_row.  This kernel is
// that path on its own: the check of every sharded table at upload
// (engine/shard.py check_sharded_table), and the yardstick of the peer
// reads in chip_smoke.py.  The rows are read with __ldg (the
// non-coherent path), as K2 and K3 read them: the tables are read-only
// while a kernel runs, and the chip run holds the rows read through peer
// pointers equal to the plain version's.
//
// Bound on the card: Q * W * 4 bytes read and the same written; the share
// read from other cards crosses NVLink at 450 GB/s each way.  One thread
// moves one 16-byte vector of a row (W a multiple of 4; else one word),
// neighbouring threads the neighbouring vectors of a row, so a warp's
// loads of one row are contiguous; a thread loads its id, which the
// threads of a row share through L1.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// D shard pointers of nb_local rows of cols words each
struct ShardTable {
  const uint32_t* shards[dbg::MAX_SHARDS];
  int32_t n_shards;
  int32_t nb_local;
  int32_t cols;
};

template <class V>
__global__ void __launch_bounds__(kThreads)
    sharded_rows_kernel(const __grid_constant__ ShardTable t,
                        const int32_t* __restrict__ ids, long long Q,
                        V* __restrict__ out) {
  const int per_row = t.cols * static_cast<int>(sizeof(uint32_t)) /
                      static_cast<int>(sizeof(V));
  const long long n = Q * per_row;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += stride) {
    const long long q = i / per_row;
    const int v = static_cast<int>(i - q * per_row);
    const int32_t b = __ldg(ids + q);
    V x{};
    if (b >= 0 && b < t.nb_local * t.n_shards) {
      const int s = b / t.nb_local;
      const V* row = reinterpret_cast<const V*>(
          t.shards[s] + static_cast<size_t>(b - s * t.nb_local) * t.cols);
      x = __ldg(row + v);
    }
    out[i] = x;
  }
}

}  // namespace

// out [Q, cols] (uint32) = the rows of global bucket ids [Q] (int32) in
// the table `table` (a ShardTable) describes, zeros for an id outside it;
// Q > 0.  16-byte vectors where cols is a multiple of 4 and every shard
// and out are 16-byte aligned, else words.
extern "C" int dbg_sharded_rows(const void* table, const void* ids,
                                long long Q, void* out, void* stream) {
  const ShardTable& t = *static_cast<const ShardTable*>(table);
  if (t.n_shards < 1 || t.n_shards > dbg::MAX_SHARDS || t.nb_local < 1 ||
      t.cols < 1 || Q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  bool vec = t.cols % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int s = 0; s < t.n_shards; ++s)
    vec = vec && reinterpret_cast<uintptr_t>(t.shards[s]) % 16 == 0;
  const long long n = Q * (vec ? t.cols / 4 : t.cols);
  long long blocks = (n + kThreads - 1) / kThreads;
  const int sms = dbg::sm_count();
  const long long most =
      static_cast<long long>(sms > 0 ? sms : 1) * (2048 / kThreads);
  if (blocks > most) blocks = most;
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const int32_t*>(ids);
  if (vec)
    sharded_rows_kernel<uint4><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(t, b, Q, static_cast<uint4*>(out));
  else
    sharded_rows_kernel<uint32_t><<<static_cast<unsigned>(blocks), kThreads,
                                    0, s>>>(t, b, Q,
                                            static_cast<uint32_t*>(out));
  DBG_RETURN_LAUNCH_STATUS();
}

// let card `dev` read card `peer`'s memory.  An access that is already
// enabled (PyTorch enables pairs for its own copies) is an expected
// answer: the error it leaves is cleared here, so the next launch's check
// does not report it.  The calling thread's current card is restored.
extern "C" int dbg_enable_peer_access(int dev, int peer) {
  int prev = 0;
  cudaGetDevice(&prev);
  int err = static_cast<int>(cudaSetDevice(dev));
  if (err == 0) {
    err = static_cast<int>(cudaDeviceEnablePeerAccess(peer, 0));
    if (err == static_cast<int>(cudaErrorPeerAccessAlreadyEnabled)) {
      cudaGetLastError();
      err = 0;
    }
  }
  cudaSetDevice(prev);
  return err;
}

extern "C" int dbg_sizeof_shard_table() {
  return static_cast<int>(sizeof(ShardTable));
}

// threads per block of this file's kernel (build.kernel_resources gives
// ptxas's registers; with this, the warps per SM they allow)
extern "C" int dbg_shard_threads() { return kThreads; }
