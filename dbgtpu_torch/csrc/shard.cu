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
// pointers over NVLink (engine/shard.py enable_peer_access): K2 and K3
// read each row they look up where it lies, one lookup at a time
// (common.cuh scan_row).  This kernel answers a whole set of ids at once,
// so it need not: a peer read is not cached in the reading card's L2,
// and the survey batch's 917,504 probe keys would read each remote row
// some 224 times over NVLink.  It is the check of every sharded table at
// upload (engine/shard.py check_sharded_table) and the yardstick of the
// sharded gather in chip_smoke.py.
//
// Bound on the card: the ids read once, Q * W * 4 bytes of out written
// once, and the table's rows read once; the rows on other cards cross
// NVLink at 450 GB/s, each once.  So out's local write bounds a set of
// ids larger than the table.  Two paths, chosen on the host before the
// launch (engine/shard.py shard_plan, ShardPlan below):
//   direct: one launch, every row read where it lies.  Taken when every
//     shard is on this card, or when the ids cannot repeat much (Q at or
//     below the table's rows, the upload check among them): staging
//     would only add local traffic there.
//   staged: the rows of the shards on other cards cross NVLink at most
//     once per call and are staged in this card's memory (flags and
//     stage, scratch of the caller), in three passes:
//     (a) mark: a thread per id sets its row's flag (read first, so the
//         ~224 ids of a row do not all store to one address);
//     (b) pull: a warp per flagged row copies it from its owner into the
//         stage with 16-byte loads, whole 128-byte lines;
//     (c) write: each id's row from the local shard or from the stage
//         into out.
//     Local ids never pass through the stage.  The passes run as a
//     memset of the flags and one cooperative launch with two grid-wide
//     barriers between them (a few percent faster on the card than
//     three plain launches, PERF.md "PR 13").
// The write pass (write_rows) is the same loop on both paths, the staged
// one with a second source.  A warp takes a contiguous range of ids, 32
// at a time: a lane loads one id and finds its row, and the 32 rows, one
// contiguous run of out, are copied with each lane holding kUnroll
// 16-byte loads in flight before it stores them, neighbouring lanes on
// neighbouring vectors (a warp holding one row load at a time left
// 96-word rows latency-bound).  Its grid is what the SMs hold at once,
// since the ranges are fixed by it.  Where a thread per vector of out
// fits that one wave on the direct path (the upload check's few ids), a
// thread per vector copies it instead (vector_kernel): latency sets the
// pace there, and the shorter kernel has less of it.  out is written
// with streaming stores, so that the 1.2 GB of a batch's rows do not push
// the stage and the local shard (a few MB, read again and again) out of
// L2.
// Shard rows are read with __ldg (the non-coherent path), as K2 and K3
// read them: the tables are read-only while a kernel runs.  Flags and
// stage, written in the same call, are read through L2 (__ldcg).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 2048 / kThreads;
constexpr int kUnroll = 4;  // vectors a lane of the write pass has in flight

// D shard pointers of nb_local rows of cols words each
struct ShardTable {
  const uint32_t* shards[dbg::MAX_SHARDS];
  int32_t n_shards;
  int32_t nb_local;
  int32_t cols;
};

// the host's plan (engine/shard.py ShardPlan, field for field)
struct ShardPlan {
  int32_t staged;       // 0: the direct path
  int32_t remote_rows;  // stage rows: nb_local for each staged shard
  int32_t n_remote;     // staged shards
  // shard s's first stage row, or -1: its rows are read where they lie
  int32_t stage_base[dbg::MAX_SHARDS];
  int32_t remote[dbg::MAX_SHARDS];  // the staged shards, in stage order
};

// one call's arguments, built once per launch by the wrapper
// (engine/shard.py sharded_rows_launch; kernels/build.py ShardArgsC): a
// launch from Python then converts one pointer, not eight arguments
struct ShardArgs {
  ShardTable table;
  ShardPlan plan;
  const int32_t* ids;
  long long Q;
  void* flags;   // uint32 [remote_rows] on the staged path, else unused
  void* stage;   // uint32 [remote_rows, cols] on the staged path
  void* out;
  void* stream;
};

template <class V>
__device__ __forceinline__ int vectors_per_row(const ShardTable& t) {
  return t.cols * static_cast<int>(sizeof(uint32_t)) /
         static_cast<int>(sizeof(V));
}

// id b's row for the write pass: its address, bit 0 set for a stage row
// (read through L2), 0 for an id outside the table (zeros)
template <class V>
__device__ __forceinline__ unsigned long long row_of(const ShardTable& t,
                                                     const ShardPlan& p,
                                                     int32_t b,
                                                     const V* stage) {
  if (b < 0 || b >= t.nb_local * t.n_shards) return 0;
  const int s = b / t.nb_local;
  const int local = b - s * t.nb_local;
  const int base = p.staged ? p.stage_base[s] : -1;
  if (base < 0)
    return reinterpret_cast<unsigned long long>(
        t.shards[s] + static_cast<size_t>(local) * t.cols);
  return reinterpret_cast<unsigned long long>(
             stage + static_cast<size_t>(base + local) *
                         vectors_per_row<V>(t)) |
         1ull;
}

template <class V>
__device__ __forceinline__ V load_row(unsigned long long row, int v) {
  const V* src = reinterpret_cast<const V*>(row & ~1ull) + v;
  return (row & 1) ? __ldcg(src) : __ldg(src);
}

// (a) a thread per id, grid-stride from `first` by `stride`
__device__ void mark_ids(const ShardTable& t, const ShardPlan& p,
                         const int32_t* __restrict__ ids, long long Q,
                         uint32_t* flags, long long first,
                         long long stride) {
  for (long long q = first; q < Q; q += stride) {
    const int32_t b = __ldg(ids + q);
    if (b < 0 || b >= t.nb_local * t.n_shards) continue;
    const int s = b / t.nb_local;
    const int base = p.stage_base[s];
    if (base < 0) continue;
    uint32_t* f = flags + base + (b - s * t.nb_local);
    if (__ldcg(f) == 0) *f = 1;
  }
}

// (b) a warp per flagged stage row, from warp `first` by `stride`
template <class V>
__device__ void pull_rows(const ShardTable& t, const ShardPlan& p,
                          const uint32_t* flags, V* stage, long long first,
                          long long stride, int lane) {
  const int per_row = vectors_per_row<V>(t);
  for (long long r = first; r < p.remote_rows; r += stride) {
    if (__ldcg(flags + r) == 0) continue;
    const int o = static_cast<int>(r / t.nb_local);
    const V* src = reinterpret_cast<const V*>(
        t.shards[p.remote[o]] +
        static_cast<size_t>(r - static_cast<long long>(o) * t.nb_local) *
            t.cols);
    V* dst = stage + static_cast<size_t>(r) * per_row;
    for (int v = lane; v < per_row; v += 32) dst[v] = __ldg(src + v);
  }
}

// (c) warp w copies the rows of its range of ids into out: `per` ids,
// one more for the first `extra` warps (the grid's split of Q, made on
// the host), 32 ids at a time: lane l loads id l of the chunk and finds
// its row (shfl'd to the lanes that copy it); the chunk's rows are one
// contiguous run of n * per_row vectors of out, which the lanes copy
// kUnroll vectors each at a time, loads first, then stores
template <class V>
__device__ void write_rows(const ShardTable& t, const ShardPlan& p,
                           const int32_t* __restrict__ ids, long long Q,
                           const V* stage, V* __restrict__ out, long long w,
                           long long per, int extra, int lane) {
  const int per_row = vectors_per_row<V>(t);
  // the lane's first vector (row, column) in a chunk, and 32 vectors on
  const int j_lane = lane / per_row, v_lane = lane % per_row;
  const int j_step = 32 / per_row, v_step = 32 % per_row;
  const long long lo = w * per + (w < extra ? w : extra);
  const long long hi = lo + per + (w < extra ? 1 : 0);
  for (long long q0 = lo; q0 < hi; q0 += 32) {
    const int n = static_cast<int>(hi - q0 < 32 ? hi - q0 : 32);
    const unsigned long long row =
        lane < n ? row_of(t, p, __ldg(ids + q0 + lane), stage) : 0;
    const int total = n * per_row;
    V* dst = out + static_cast<size_t>(q0) * per_row;
    int j = j_lane, v = v_lane;
    for (int i0 = 0; i0 < total; i0 += 32 * kUnroll) {
      V x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned long long r = __shfl_sync(0xffffffffu, row, j & 31);
        x[u] = V{};
        if (i0 + u * 32 + lane < total && r != 0) x[u] = load_row<V>(r, v);
        v += v_step;
        j += j_step;
        if (v >= per_row) {
          v -= per_row;
          ++j;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + u * 32 + lane < total) __stcs(dst + i0 + u * 32 + lane, x[u]);
    }
  }
}

__device__ __forceinline__ long long global_warp() {
  return (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) /
         32;
}

__device__ __forceinline__ long long grid_warps() {
  return static_cast<long long>(gridDim.x) * kWarps;
}

// the direct path's write pass (its plan stages no shard)
template <class V>
__global__ void __launch_bounds__(kThreads)
    write_kernel(const __grid_constant__ ShardTable t,
                 const __grid_constant__ ShardPlan p,
                 const int32_t* __restrict__ ids, long long Q,
                 const V* stage, V* __restrict__ out, long long per,
                 int extra) {
  write_rows(t, p, ids, Q, stage, out, global_warp(), per, extra,
             threadIdx.x % 32);
}

// the direct path where a thread per vector of out fits one wave (the
// upload check's few ids): latency sets the pace there, and the shortest
// kernel, with the fewest parameters, has the least of it
template <class V>
__global__ void __launch_bounds__(kThreads)
    vector_kernel(const __grid_constant__ ShardTable t,
                  const int32_t* __restrict__ ids, int n,
                  V* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int per_row = vectors_per_row<V>(t);
  const int q = i / per_row;
  const int32_t b = __ldg(ids + q);
  V x{};
  if (b >= 0 && b < t.nb_local * t.n_shards) {
    const int s = b / t.nb_local;
    x = __ldg(reinterpret_cast<const V*>(
                  t.shards[s] + static_cast<size_t>(b - s * t.nb_local) *
                                    t.cols) +
              (i - q * per_row));
  }
  out[i] = x;
}

// the three passes in one cooperative launch (flags zeroed before it)
template <class V>
__global__ void __launch_bounds__(kThreads)
    staged_kernel(const __grid_constant__ ShardTable t,
                  const __grid_constant__ ShardPlan p,
                  const int32_t* __restrict__ ids, long long Q,
                  uint32_t* flags, V* stage, V* __restrict__ out,
                  long long per, int extra) {
  cg::grid_group grid = cg::this_grid();
  mark_ids(t, p, ids, Q, flags,
           static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
           static_cast<long long>(gridDim.x) * blockDim.x);
  grid.sync();
  pull_rows(t, p, flags, stage, global_warp(), grid_warps(),
            threadIdx.x % 32);
  grid.sync();
  write_rows(t, p, ids, Q, stage, out, global_warp(), per, extra,
             threadIdx.x % 32);
}

// the card's SMs, and the blocks a SM holds of each kernel of kKernels
// (write and staged_kernel, words and vectors), at most kMaxBlocksPerSm:
// asked once per card
constexpr int kKernels = 4;
struct Card {
  int sms = 0;
  int resident[kKernels] = {};
};

int card_of(Card** card) {
  static Card cards[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  *card = &cards[dev];
  if (cards[dev].sms == 0)
    return static_cast<int>(cudaDeviceGetAttribute(
        &cards[dev].sms, cudaDevAttrMultiProcessorCount, dev));
  return 0;
}

// blocks of `kernel` (`which` of kKernels) the card holds at once: the
// write pass and the cooperative launch take ranges of ids fixed by the
// grid, so their grids are one wave.  Negative: an error.
int resident(Card* card, const void* kernel, int which) {
  int& n = card->resident[which];
  if (n == 0) {
    const int err = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                      0));
    if (err) return -err;
  }
  if (n < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return (n < kMaxBlocksPerSm ? n : kMaxBlocksPerSm) * card->sms;
}

// blocks for `units` threads' worth of work, at most `most`
unsigned blocks_for(long long units, long long most) {
  const long long need = (units + kThreads - 1) / kThreads;
  return static_cast<unsigned>(need < 1 ? 1 : (need < most ? need : most));
}

template <class V>
int launch(const ShardTable& t, const ShardPlan& p, const int32_t* ids,
           long long Q, uint32_t* flags, V* stage, V* out, cudaStream_t s) {
  const int vec = sizeof(V) == 16;
  Card* card = nullptr;
  int err = card_of(&card);
  if (err) return err;
  const void* kernel =
      p.staged ? reinterpret_cast<const void*>(&staged_kernel<V>)
               : reinterpret_cast<const void*>(&write_kernel<V>);
  const int most = resident(card, kernel, 2 * p.staged + vec);
  if (most < 0) return -most;
  // the write pass: a warp per id at most, in one wave
  const unsigned grid = p.staged ? most : blocks_for(Q * 32, most);
  long long per = Q / (static_cast<long long>(grid) * kWarps);
  int extra = static_cast<int>(Q - per * grid * kWarps);
  if (p.staged) {
    if (p.remote_rows > 0) {
      err = static_cast<int>(cudaMemsetAsync(
          flags, 0, static_cast<size_t>(p.remote_rows) * sizeof(uint32_t),
          s));
      if (err) return err;
    }
    void* args[] = {const_cast<ShardTable*>(&t), const_cast<ShardPlan*>(&p),
                    &ids, &Q, &flags, &stage, &out, &per, &extra};
    err = static_cast<int>(cudaLaunchCooperativeKernel(
        kernel, dim3(grid), dim3(kThreads), args, 0, s));
    if (err) return err;
    DBG_RETURN_LAUNCH_STATUS();
  }
  const long long n = Q * (t.cols * 4 / static_cast<int>(sizeof(V)));
  if (n <= static_cast<long long>(most) * kThreads)
    vector_kernel<V><<<blocks_for(n, most), kThreads, 0, s>>>(
        t, ids, static_cast<int>(n), out);
  else
    write_kernel<V><<<grid, kThreads, 0, s>>>(t, p, ids, Q, nullptr, out,
                                              per, extra);
  DBG_RETURN_LAUNCH_STATUS();
}

// the plan fits the table: stage rows inside [0, remote_rows), none on
// the direct path, each staged shard listed where its rows start
bool plan_fits(const ShardTable& t, const ShardPlan& p) {
  if ((p.staged != 0 && p.staged != 1) || p.remote_rows < 0 ||
      p.n_remote < 0 || p.n_remote > t.n_shards ||
      static_cast<long long>(p.n_remote) * t.nb_local != p.remote_rows ||
      (!p.staged && p.n_remote != 0))
    return false;
  int seen = 0;
  for (int s = 0; s < t.n_shards; ++s) {
    const int base = p.stage_base[s];
    if (base < 0) continue;
    const int o = base / t.nb_local;
    if (base % t.nb_local != 0 || o >= p.n_remote || p.remote[o] != s)
      return false;
    ++seen;
  }
  return seen == p.n_remote;
}

}  // namespace

// out [Q, cols] (uint32) = the rows of global bucket ids [Q] (int32) in
// the table `table` describes, zeros for an id outside it, by the path
// `plan` takes; Q > 0 (args: a ShardArgs).  On the staged path with
// remote_rows > 0, flags (zeroed here) and stage are scratch, else
// unused.  16-byte vectors where cols is a multiple of 4 and every
// shard, the stage and out are 16-byte aligned, else words.
extern "C" int dbg_sharded_rows(const void* args) {
  const ShardArgs& a = *static_cast<const ShardArgs*>(args);
  const ShardTable& t = a.table;
  const ShardPlan& p = a.plan;
  if (t.n_shards < 1 || t.n_shards > dbg::MAX_SHARDS || t.nb_local < 1 ||
      t.cols < 1 || a.Q < 1 || !plan_fits(t, p) ||
      (p.remote_rows > 0 && (a.flags == nullptr || a.stage == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  bool vec = t.cols % 4 == 0 &&
             reinterpret_cast<uintptr_t>(a.out) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(a.stage) % 16 == 0;
  for (int s = 0; s < t.n_shards; ++s)
    vec = vec && reinterpret_cast<uintptr_t>(t.shards[s]) % 16 == 0;
  auto s = static_cast<cudaStream_t>(a.stream);
  auto f = static_cast<uint32_t*>(a.flags);
  if (vec)
    return launch<uint4>(t, p, a.ids, a.Q, f, static_cast<uint4*>(a.stage),
                         static_cast<uint4*>(a.out), s);
  return launch<uint32_t>(t, p, a.ids, a.Q, f,
                          static_cast<uint32_t*>(a.stage),
                          static_cast<uint32_t*>(a.out), s);
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

extern "C" int dbg_sizeof_shard_args() {
  return static_cast<int>(sizeof(ShardArgs));
}

// threads per block of this file's kernels (build.kernel_resources gives
// ptxas's registers; with this, the warps per SM they allow)
extern "C" int dbg_shard_threads() { return kThreads; }
