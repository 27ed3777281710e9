// K2 member's arguments and the keys it looks up, shared by its kernels
// (member.cu) and by the stage pass of its staged path (shard.cu), which
// must mark exactly the rows that K2 will read: one definition of which
// path a batch takes, which window is probed at which position, and which
// keys a position looks up.
#pragma once

#include "common.cuh"

namespace dbg {

struct MemberArgs {
  const int64_t* rep1;
  const uint8_t* le1;
  const int64_t* rep2;
  const int64_t* bug;
  int exhaustive;
  const uint32_t* rwf;
  int RWr;
  const int32_t* lens;
  int B, L, k1, Lk;
  uint8_t* member1;
  uint8_t* member2;
};

inline MemberArgs member_args(const void* rep1, const void* le1,
                              const void* rep2, const void* bug,
                              int exhaustive, const void* rwf, int RWr,
                              const void* lens, int B, int L, int k1,
                              void* member1, void* member2) {
  return MemberArgs{static_cast<const int64_t*>(rep1),
                    static_cast<const uint8_t*>(le1),
                    static_cast<const int64_t*>(rep2),
                    static_cast<const int64_t*>(bug),
                    exhaustive,
                    static_cast<const uint32_t*>(rwf),
                    RWr,
                    static_cast<const int32_t*>(lens),
                    B, L, k1, L - k1 + 1,
                    static_cast<uint8_t*>(member1),
                    static_cast<uint8_t*>(member2)};
}

// the path of the batch, read on the device: (a) closure probes unless
// the batch holds an N or there is no probe table (pt_nb rows)
__device__ __forceinline__ bool member_probes(int pt_nb,
                                              const int32_t* has_n) {
  return pt_nb > 0 && *has_n == 0;
}

// positions a closure probe answers: 4 where a probe row holds a second
// neighbour word array, else 3 (core._closure_member)
__host__ __device__ __forceinline__ int probe_window(int pt_cols,
                                                     int pt_slots) {
  return pt_cols == 4 * pt_slots ? 4 : 3;
}

// (a) window t of the flat B x nW: read b, its first position i0, the
// probed position p = min(i0 + 1, Lk - 1) (row0 + p in the [B, Lk]
// planes), and whether it covers a valid position (i0 <= last_valid)
struct Window {
  int b, i0, p, last_valid;
  size_t row0;
  bool live;
};

__device__ __forceinline__ Window probe_window_at(const MemberArgs& a,
                                                  uint32_t t, uint32_t nW,
                                                  int W, bool in_grid) {
  Window w;
  w.b = in_grid ? static_cast<int>(t / nW) : 0;
  w.i0 = in_grid ? W * static_cast<int>(t - w.b * nW) : 0;
  w.last_valid = a.lens[w.b] - a.k1;     // positions i <= last_valid
  w.live = in_grid && w.i0 <= w.last_valid;
  w.p = min(w.i0 + 1, a.Lk - 1);
  w.row0 = static_cast<size_t>(w.b) * a.Lk;
  return w;
}

// (b) the keys of position t: rep1 / rep2, or in exhaustive mode
// canonical(bug, rcb(bug)); valid = i <= len - k1
struct PosKeys {
  bool valid, need2;
  uint64_t key1, key2;
};

__device__ __forceinline__ PosKeys pos_keys(const MemberArgs& a, uint32_t t,
                                            bool in_grid) {
  PosKeys pk{false, false, 0, 0};
  if (!in_grid) return pk;
  const int b = static_cast<int>(t / a.Lk);
  const int i = static_cast<int>(t - b * static_cast<uint32_t>(a.Lk));
  pk.valid = i <= a.lens[b] - a.k1;
  if (!pk.valid) return pk;
  if (a.exhaustive) {
    const uint64_t v = static_cast<uint64_t>(a.bug[t]);
    const uint64_t rv = rcb(v, a.k1);
    pk.key1 = v <= rv ? v : rv;
  } else {
    pk.key1 = static_cast<uint64_t>(a.rep1[t]);
    pk.key2 = static_cast<uint64_t>(a.rep2[t]);
    // rep2 differs from rep1 only where the bug scan rolled an N in
    pk.need2 = pk.key2 != pk.key1;
  }
  return pk;
}

}  // namespace dbg
