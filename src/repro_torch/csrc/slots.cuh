// Slot masks of a node or a leaf (NS slots as NS/64 64-bit words) and the
// two ways a kernel fills them.
//
// The paper compares 64 anchor bytes with one AVX-512 instruction and reads
// the result as a 64-bit mask (compare_equal / compare_less + TZCNT). A warp
// (K2: lane t owns slots t, t+32, ...) fills the mask with ballots. A lane
// group (K1, K3, K4: G = NS / W lanes a query, lane j owns the W bytes of
// slots [W j, W j + W) as one vector) compares four bytes an instruction in
// a 32-bit word (byte-SIMD, below), packs its bits and gathers the group's
// bits with G shuffles. The first set bit (__ffsll) and the popcount
// (__popcll) are the TZCNT and the count.
#pragma once

#include <cstdint>
#include <type_traits>

#include "cmp.cuh"

namespace fbt {

template <int NS>
struct SlotMask {
  static constexpr int kWords = NS / 64;
  unsigned long long w[kWords];
};

template <int NS>
__device__ __forceinline__ int mask_first(const SlotMask<NS>& m) {
#pragma unroll
  for (int i = 0; i < SlotMask<NS>::kWords; ++i)
    if (m.w[i]) return 64 * i + __ffsll(static_cast<long long>(m.w[i])) - 1;
  return NS;
}

template <int NS>
__device__ __forceinline__ int mask_last(const SlotMask<NS>& m) {
#pragma unroll
  for (int i = SlotMask<NS>::kWords - 1; i >= 0; --i)
    if (m.w[i]) return 64 * i + 63 - __clzll(static_cast<long long>(m.w[i]));
  return -1;
}

// The slots whose lane flag is set (v[k]: slot 32k + lane), by ballots.
template <int NS>
__device__ __forceinline__ SlotMask<NS> ballot_mask(const bool (&v)[NS / 32]) {
  SlotMask<NS> m;
#pragma unroll
  for (int i = 0; i < SlotMask<NS>::kWords; ++i)
    m.w[i] = static_cast<unsigned long long>(__ballot_sync(kFullMask, v[2 * i])) |
             (static_cast<unsigned long long>(__ballot_sync(kFullMask, v[2 * i + 1]))
              << 32);
  return m;
}

// Clear slot s of the mask.
template <int NS>
__device__ __forceinline__ void clear_slot(SlotMask<NS>& m, int s) {
#pragma unroll
  for (int i = 0; i < SlotMask<NS>::kWords; ++i)  // no indexed store
    m.w[i] &= ~(static_cast<unsigned long long>((s >> 6) == i) << (s & 63));
}

// ---- byte-SIMD: four byte compares in one 32-bit word. Each returns 0x80
// in every byte where the compare holds and 0 elsewhere; no carry or borrow
// crosses a byte.

// a != 0, per byte: bit 7 of (a & 0x7f) + 0x7f is set iff the low 7 bits are
// not all 0, and a's own bit 7 covers the rest.
__device__ __forceinline__ uint32_t nonzero_hi(uint32_t a) {
  return (((a & 0x7f7f7f7fu) + 0x7f7f7f7fu) | a) & 0x80808080u;
}

__device__ __forceinline__ uint32_t eq_hi(uint32_t a, uint32_t b) {
  return ~nonzero_hi(a ^ b) & 0x80808080u;
}

// a < b, unsigned, per byte: (a | 0x80) - (b & 0x7f) never borrows, and its
// bit 7 says a's low 7 bits >= b's; the top bits decide where they differ.
__device__ __forceinline__ uint32_t ltu_hi(uint32_t a, uint32_t b) {
  const uint32_t d = (a | 0x80808080u) - (b & 0x7f7f7f7fu);
  return ((~a & b) | (~(a ^ b) & ~d)) & 0x80808080u;
}

// The four byte flags of `x` (bit 7 of each byte) as bits 0-3, byte 0 (the
// lowest address) at bit 0: one multiply moves bit 8k + 7 to bit 28 + k.
__device__ __forceinline__ uint32_t gather_hi4(uint32_t x) {
  return ((x & 0x80808080u) * 0x00204081u) >> 28;
}

// ---- lane groups: G lanes a query, a whole number of groups a warp.

// The lanes of this lane's group, for the group's shuffles: a group's
// lanes take the same branches, so a mask naming only them is valid when
// other groups of the warp have left or resolved in another round.
template <int G>
__device__ __forceinline__ unsigned group_lanes(int lane) {
  static_assert(G >= 1 && G <= 32 && (32 % G) == 0, "G must divide 32");
  return G == 32 ? kFullMask : ((1u << G) - 1u) << (lane & ~(G - 1));
}

// NB bytes at p as NB / 4 little-endian words, in the widest loads NB
// allows (16-byte vectors, else 8, else 4 bytes); p is aligned to that
// width.
template <int NB>
__device__ __forceinline__ void load_words(const void* __restrict__ p,
                                           uint32_t (&v)[NB / 4]) {
  static_assert(NB >= 4 && NB % 4 == 0, "whole 32-bit words");
  if constexpr (NB % 16 == 0) {
#pragma unroll
    for (int c = 0; c < NB / 16; ++c) {
      const uint4 x = __ldg(static_cast<const uint4*>(p) + c);
      v[4 * c] = x.x, v[4 * c + 1] = x.y, v[4 * c + 2] = x.z,
      v[4 * c + 3] = x.w;
    }
  } else if constexpr (NB % 8 == 0) {
#pragma unroll
    for (int c = 0; c < NB / 8; ++c) {
      const uint2 x = __ldg(static_cast<const uint2*>(p) + c);
      v[2 * c] = x.x, v[2 * c + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < NB / 4; ++c)
      v[c] = __ldg(static_cast<const uint32_t*>(p) + c);
  }
}

// A lane's packed flags: two sets of W bits, in one 32-bit word up to W =
// 16, else in a 64-bit one.
template <int W>
using Packed =
    std::conditional_t<(2 * W <= 32), uint32_t, unsigned long long>;

// Two NS-slot masks of a lane group from each lane's packed bits: lane j's
// `mine` holds the flags of its slots [W j, W j + W) at bits [0, W) (into
// `lo`) and [W, 2W) (into `hi`). G = NS / W shuffles; every lane of the
// group ends with the same masks.
template <int NS, int W>
__device__ __forceinline__ void gather_group_masks(Packed<W> mine,
                                                   unsigned gmask,
                                                   SlotMask<NS>& lo,
                                                   SlotMask<NS>& hi) {
  constexpr int G = NS / W;
  static_assert(W <= 32 && NS % W == 0, "a lane's flags fit one word");
  constexpr Packed<W> kLow = (Packed<W>(1) << W) - 1;
#pragma unroll
  for (int i = 0; i < SlotMask<NS>::kWords; ++i) lo.w[i] = hi.w[i] = 0ull;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const Packed<W> x = __shfl_sync(gmask, mine, k, G);
    const int s = W * k;  // lane k's first slot
    lo.w[s / 64] |= static_cast<unsigned long long>(x & kLow) << (s % 64);
    hi.w[s / 64] |= static_cast<unsigned long long>(x >> W) << (s % 64);
  }
}

}  // namespace fbt
