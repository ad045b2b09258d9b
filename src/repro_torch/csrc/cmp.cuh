// Padded-key compares for one warp working on one query.
//
// The parity-critical compare helpers of the descent, shared by every CUDA
// kernel that walks the tree (the reference shares `_cmp3` and `_prefix_cmp`
// in repro/kernels/fused_descent/kernel.py the same way). A warp holds a
// key striped over its lanes: lane t keeps bytes t, t+32, t+64, ..., one
// register a stripe. Lanes compare one 32-byte stripe at a time and a
// ballot finds the first byte that differs, so a full-key compare costs
// ceil(L/32) loads per lane and no shared memory. A row is loaded whole
// (every stripe at once) before it is compared, so its loads are one round
// trip, and a row can be loaded before it is known to be needed.
//
// S, the number of stripes a key holds, is a template parameter: the
// kernels are built for S = 1 to 4 (keys of at most 32 S bytes: S = 1 for
// the YCSB and integer keys, 3 for 72-byte URLs) and S = 8 (up to 256
// bytes), so a key costs the registers and loads of its width, not of the
// widest key (PERF.md §6 times the URL build at S = 3 against S = 4 and 8).
#pragma once

#include <cstdint>

namespace fbt {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxStripes = 8;  // keys of at most 256 bytes

// Stripes of a key of width L as the kernels are built: ceil(L / 32) up to
// 4, else kMaxStripes.
__host__ __device__ constexpr int stripes_for(int L) {
  return L <= 128 ? (L + 31) / 32 : kMaxStripes;
}

// v[k] for a k known only at run time (k < N), by masks: neither an indexed
// read nor a select of two reads, which the compiler turns into one, so
// the array stays in registers instead of moving to local memory.
template <int N, class T>
__device__ __forceinline__ T pick(const T (&v)[N], int k) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    T x = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) x |= v[j] & (T(0) - T(k == j));
    return x;
  }
}

template <int S>
struct WarpKey {
  uint32_t b[S];  // b[k] = byte 32k + lane of the row, 0 past the key width
};

// Every stripe of a row of width L (L <= 32 * S) at once: the loads are
// issued before any is used.
template <int S>
__device__ __forceinline__ WarpKey<S> load_warp_key(
    const uint8_t* __restrict__ row, int L, int lane) {
  WarpKey<S> q;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int pos = 32 * k + lane;
    q.b[k] = pos < L ? row[pos] : 0;
  }
  return q;
}

// (row - query) at the first byte below `nbytes` where they differ, 0 when
// the first `nbytes` bytes agree. Warp-uniform result.
template <int S>
__device__ __forceinline__ int first_diff(const WarpKey<S>& row,
                                          const WarpKey<S>& q, int nbytes,
                                          int lane) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (32 * k >= nbytes) break;
    const int d = 32 * k + lane < nbytes ? int(row.b[k]) - int(q.b[k]) : 0;
    const unsigned hit = __ballot_sync(kFullMask, d != 0);
    if (hit) return __shfl_sync(kFullMask, d, __ffs(hit) - 1);
  }
  return 0;
}

__device__ __forceinline__ int sign(int x) { return (x > 0) - (x < 0); }

// 3-way compare of a key row against the query over all L bytes, with the
// length tie-break: sign(row - query), as repro.core.keys.compare_padded.
template <int S>
__device__ __forceinline__ int cmp3_keys(const WarpKey<S>& row, int row_len,
                                         const WarpKey<S>& q, int q_len, int L,
                                         int lane) {
  const int d = first_diff(row, q, L, lane);
  return d != 0 ? sign(d) : sign(row_len - q_len);
}

// The same for a key-pool row still in memory (loaded here).
template <int S>
__device__ __forceinline__ int cmp3_row_query(const uint8_t* __restrict__ row,
                                              int row_len, const WarpKey<S>& q,
                                              int q_len, int L, int lane) {
  return cmp3_keys(load_warp_key<S>(row, L, lane), row_len, q, q_len, L,
                   lane);
}

// 3-way compare of the query against a node's prefix over its first `plen`
// bytes only: sign(query - prefix), 0 when they agree (`_prefix_cmp`).
template <int S>
__device__ __forceinline__ int prefix_cmp(const WarpKey<S>& prefix, int plen,
                                          const WarpKey<S>& q, int lane) {
  return -sign(first_diff(prefix, q, plen, lane));
}

// Byte `p` of the striped key (0 at p >= L): a shuffle from its lane.
// `p` is warp-uniform.
template <int S>
__device__ __forceinline__ int key_byte(const WarpKey<S>& q, int p, int L) {
  const int v = __shfl_sync(kFullMask, pick(q.b, p >> 5), p & 31);
  return p < L ? v : 0;
}

}  // namespace fbt
