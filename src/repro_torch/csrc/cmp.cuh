// Padded-key compares for one warp, or one lane group, working on one query.
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
//
// The same compares for a query served by a lane group of G < 32 lanes
// (GroupKey, below) hold a row as words spread over the group's lanes.
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

// ---- lane groups: G lanes a query (K1, fused_descent.cu).
//
// A group holds a row as words: the row padded to 32 S bytes is 8 S
// little-endian words (byte 0, the lowest address, in the low bits of
// word 0), kWords = ceil(8 S / G) of them a lane, so lane j of the group
// holds bytes [4 kWords j, 4 kWords (j + 1)) and lanes past the row hold
// zeros. A compare finds each lane's first differing byte in its own words
// and a ballot over the group's lanes the first lane that has one; the
// result is the same on every lane of the group. `j` is the lane in the
// group and `gmask` the group's lanes (slots.cuh::group_lanes), the only
// lanes a group's ballots and shuffles name.
template <int S, int G>
struct GroupKey {
  static_assert(G >= 1 && G < 32 && (32 % G) == 0, "G must divide 32");
  static constexpr int kWords = (8 * S + G - 1) / G;
  uint32_t w[kWords];
};

// The widest load every row of a table of rows of width L at `base` allows:
// 16, 8 or 4 bytes when both L and the base are multiples of it, else 1
// (byte loads).
__host__ __device__ inline int row_vec(int L, const void* base) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  for (int v = 16; v >= 4; v >>= 1)
    if (L % v == 0 && p % v == 0) return v;
  return 1;
}

// Lane j's words of a row of width L, in loads of `vec` bytes (row_vec of
// the row's table, or less): each load lies wholly inside the row or wholly
// past it (zeros), as L is a multiple of vec.
template <int S, int G>
__device__ __forceinline__ GroupKey<S, G> load_group_key(
    const uint8_t* __restrict__ row, int L, int j, int vec) {
  constexpr int KW = GroupKey<S, G>::kWords, KB = 4 * KW;
  GroupKey<S, G> k;
  const int at = KB * j;  // the lane's first byte
  if (KB % 16 == 0 && vec >= 16) {
#pragma unroll
    for (int c = 0; c < KB / 16; ++c) {
      const int off = at + 16 * c;
      const uint4 x = off < L ? __ldg(reinterpret_cast<const uint4*>(row + off))
                              : make_uint4(0, 0, 0, 0);
      k.w[4 * c] = x.x, k.w[4 * c + 1] = x.y, k.w[4 * c + 2] = x.z,
      k.w[4 * c + 3] = x.w;
    }
  } else if (KB % 8 == 0 && vec >= 8) {
#pragma unroll
    for (int c = 0; c < KB / 8; ++c) {
      const int off = at + 8 * c;
      const uint2 x = off < L ? __ldg(reinterpret_cast<const uint2*>(row + off))
                              : make_uint2(0, 0);
      k.w[2 * c] = x.x, k.w[2 * c + 1] = x.y;
    }
  } else if (vec >= 4) {
#pragma unroll
    for (int c = 0; c < KW; ++c) {
      const int off = at + 4 * c;
      k.w[c] = off < L ? __ldg(reinterpret_cast<const uint32_t*>(row + off)) : 0u;
    }
  } else {
#pragma unroll
    for (int c = 0; c < KW; ++c) {
      uint32_t x = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pos = at + 4 * c + i;
        x |= uint32_t(pos < L ? row[pos] : 0) << (8 * i);
      }
      k.w[c] = x;
    }
  }
  return k;
}

// (row - query) at the first byte below `nbytes` where they differ, 0 when
// the first `nbytes` bytes agree. Group-uniform result.
template <int S, int G>
__device__ __forceinline__ int first_diff(const GroupKey<S, G>& row,
                                          const GroupKey<S, G>& q, int nbytes,
                                          int j, unsigned gmask) {
  constexpr int KW = GroupKey<S, G>::kWords;
  int d = 0;
#pragma unroll
  for (int k = KW - 1; k >= 0; --k) {  // the lowest word that differs wins
    const int n = nbytes - 4 * (KW * j + k);  // its bytes below nbytes
    const uint32_t x = (row.w[k] ^ q.w[k]) &
                       (n >= 4 ? ~0u : (1u << (8 * max(n, 0))) - 1u);
    if (x != 0u) {
      const int sh = (__ffs(static_cast<int>(x)) - 1) & ~7;
      d = int((row.w[k] >> sh) & 0xffu) - int((q.w[k] >> sh) & 0xffu);
    }
  }
  const unsigned hit = __ballot_sync(gmask, d != 0) & gmask;
  return hit ? __shfl_sync(gmask, d, __ffs(static_cast<int>(hit)) - 1) : 0;
}

template <int S, int G>
__device__ __forceinline__ int cmp3_keys(const GroupKey<S, G>& row,
                                         int row_len, const GroupKey<S, G>& q,
                                         int q_len, int L, int j,
                                         unsigned gmask) {
  const int d = first_diff(row, q, L, j, gmask);
  return d != 0 ? sign(d) : sign(row_len - q_len);
}

template <int S, int G>
__device__ __forceinline__ int prefix_cmp(const GroupKey<S, G>& prefix,
                                          int plen, const GroupKey<S, G>& q,
                                          int j, unsigned gmask) {
  return -sign(first_diff(prefix, q, plen, j, gmask));
}

// Byte `p` of the key (0 at p >= L): its word shuffled from the lane that
// holds it. `p` is group-uniform.
template <int S, int G>
__device__ __forceinline__ int key_byte(const GroupKey<S, G>& q, int p, int L,
                                        unsigned gmask) {
  constexpr int KW = GroupKey<S, G>::kWords;
  const int word = p >> 2;
  const uint32_t v = __shfl_sync(gmask, pick(q.w, word % KW), word / KW, G);
  return p < L ? int((v >> (8 * (p & 3))) & 0xffu) : 0;
}

}  // namespace fbt
