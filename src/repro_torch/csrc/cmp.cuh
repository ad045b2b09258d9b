// Padded-key compares for one warp working on one query.
//
// The parity-critical compare helpers of the descent, shared by every CUDA
// kernel that walks the tree (the reference shares `_cmp3` and `_prefix_cmp`
// in repro/kernels/fused_descent/kernel.py the same way). A warp holds its
// query key striped over its lanes: lane t keeps bytes t, t+32, t+64, ...
// Lanes compare one 32-byte stripe at a time and a ballot finds the first
// byte that differs, so a full-key compare costs ceil(L/32) loads per lane
// and no shared memory.
#pragma once

#include <cstdint>

namespace fbt {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxStripes = 8;  // keys of at most 256 bytes

struct WarpKey {
  uint8_t b[kMaxStripes];  // b[k] = byte 32*k + lane, 0 past the key width
  int stripes;             // ceil(L / 32)
};

__device__ __forceinline__ WarpKey load_warp_key(const uint8_t* __restrict__ row,
                                                 int L, int lane) {
  WarpKey q;
  q.stripes = (L + 31) / 32;
#pragma unroll
  for (int k = 0; k < kMaxStripes; ++k) {
    const int pos = 32 * k + lane;
    q.b[k] = (k < q.stripes && pos < L) ? row[pos] : 0;
  }
  return q;
}

// (row - query) at the first byte below `nbytes` where they differ, 0 when
// the first `nbytes` bytes agree. Warp-uniform result.
__device__ __forceinline__ int first_diff(const uint8_t* __restrict__ row,
                                          const WarpKey& q, int nbytes,
                                          int lane) {
#pragma unroll
  for (int k = 0; k < kMaxStripes; ++k) {
    if (k >= q.stripes || 32 * k >= nbytes) break;
    const int pos = 32 * k + lane;
    const int d = pos < nbytes ? int(row[pos]) - int(q.b[k]) : 0;
    const unsigned hit = __ballot_sync(kFullMask, d != 0);
    if (hit) return __shfl_sync(kFullMask, d, __ffs(hit) - 1);
  }
  return 0;
}

__device__ __forceinline__ int sign(int x) { return (x > 0) - (x < 0); }

// 3-way compare of a key-pool row against the query over all L bytes, with
// the length tie-break: sign(row - query), as repro.core.keys.compare_padded.
__device__ __forceinline__ int cmp3_row_query(const uint8_t* __restrict__ row,
                                              int row_len, const WarpKey& q,
                                              int q_len, int L, int lane) {
  const int d = first_diff(row, q, L, lane);
  return d != 0 ? sign(d) : sign(row_len - q_len);
}

// 3-way compare of two padded keys by ONE thread (no warp cooperation):
// sign(a - b) at the first of the L bytes where they differ, else the
// length tie-break — the same order as cmp3_row_query and
// repro.core.keys.compare_padded, for kernels whose lanes each own keys.
__device__ __forceinline__ int cmp3_bytes(const uint8_t* a, int a_len,
                                          const uint8_t* b, int b_len, int L) {
  for (int i = 0; i < L; ++i) {
    const int d = int(a[i]) - int(b[i]);
    if (d != 0) return sign(d);
  }
  return sign(a_len - b_len);
}

// 3-way compare of the query against a node's prefix over its first `plen`
// bytes only: sign(query - prefix), 0 when they agree (`_prefix_cmp`).
__device__ __forceinline__ int prefix_cmp(const uint8_t* __restrict__ prefix,
                                          int plen, const WarpKey& q,
                                          int lane) {
  return -sign(first_diff(prefix, q, plen, lane));
}

}  // namespace fbt
