// Feature-comparison rounds (paper Fig. 6 l.7-19) for one warp and one node.
//
// The CUDA twin of repro/kernels/feature_branch/kernel.py::
// feature_compare_rounds and of its plain torch version
// repro_torch/kernels/feature_branch/ref.py. It is defined once here so that
// every kernel that resolves a level shares it.
//
// The paper compares 64 anchor bytes with one AVX-512 instruction and reads
// the result as a 64-bit mask (compare_equal / compare_less + TZCNT). Here a
// warp plays the vector unit: lane t owns slots t, t+32, ... and two ballots
// per 32 slots give the equal and less-than masks as 64-bit words; the first
// set bit (__ffsll) and the popcount (__popcll) are the TZCNT and the count
// of smaller anchors.
#pragma once

#include <cstdint>

#include "cmp.cuh"

namespace fbt {

struct RoundsOut {
  int idx;        // resolved child index (valid where resolved)
  bool resolved;  // decided without the suffix binary search
  int run_lo;     // surviving equal run [run_lo, run_hi] for the fallback
  int run_hi;
  int rounds;     // feature rows consumed (0 when STATS is off)
};

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

// Rounds over a node's feature block `feats` ([fs, NS] bytes, row = one
// feature byte of every anchor). The query's byte for round `fid` is
// q[qbase + fid], or 0 when qbase + fid >= qlim. The prefix (pcmp) and
// trivial-node (knum <= 1) overrides are folded in, in the reference's
// order, so !resolved is exactly the set billed for the binary search.
template <int NS, bool STATS>
__device__ __forceinline__ RoundsOut feature_compare_rounds(
    const uint8_t* __restrict__ feats, int fs, const uint8_t* __restrict__ q,
    int qbase, int qlim, int knum, int pcmp, int lane) {
  static_assert(NS % 64 == 0, "NS must be a multiple of 64");
  constexpr int kWords = SlotMask<NS>::kWords;
  RoundsOut out{0, true, 0, 0, 0};
  if (knum <= 1) {  // trivial node: idx 0, rounds 0; the run is {0} or empty
    out.run_lo = knum == 1 ? 0 : NS;
    out.run_hi = knum == 1 ? 0 : -1;
    return out;
  }
  const int kmax = knum - 1;
  SlotMask<NS> eq;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int bits = min(max(knum - 64 * i, 0), 64);
    eq.w[i] = bits >= 64 ? ~0ull : ((1ull << bits) - 1ull);
  }
  bool resolved = false;
  for (int fid = 0; fid < fs; ++fid) {
    const uint8_t qv = (qbase + fid < qlim) ? q[qbase + fid] : 0;
    SlotMask<NS> m, less;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const uint8_t f0 = feats[fid * NS + 64 * i + lane];
      const uint8_t f1 = feats[fid * NS + 64 * i + 32 + lane];
      const unsigned long long e =
          static_cast<unsigned long long>(__ballot_sync(kFullMask, f0 == qv)) |
          (static_cast<unsigned long long>(__ballot_sync(kFullMask, f1 == qv)) << 32);
      const unsigned long long l =
          static_cast<unsigned long long>(__ballot_sync(kFullMask, f0 < qv)) |
          (static_cast<unsigned long long>(__ballot_sync(kFullMask, f1 < qv)) << 32);
      m.w[i] = e & eq.w[i];
      less.w[i] = l & eq.w[i];
    }
    bool none_eq = true;
    int cnt_less = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      none_eq = none_eq && m.w[i] == 0ull;
      cnt_less += __popcll(less.w[i]);
    }
    if (STATS) out.rounds += 1;
    if (none_eq) {  // resolved this round; eq stays frozen from here on
      out.idx = min(max(mask_first<NS>(eq) + cnt_less - 1, 0), kmax);
      resolved = true;
      break;
    }
    eq = m;
  }
  out.run_lo = mask_first<NS>(eq);
  out.run_hi = mask_last<NS>(eq);
  if (pcmp < 0) out.idx = 0;
  if (pcmp > 0) out.idx = kmax;
  out.resolved = resolved || pcmp != 0;
  return out;
}

}  // namespace fbt
