// Feature-comparison rounds (paper Fig. 6 l.7-19) for one warp and one node.
//
// The CUDA twin of repro/kernels/feature_branch/kernel.py::
// feature_compare_rounds and of its plain torch version
// repro_torch/kernels/feature_branch/ref.py. It is defined once here
// (rounds_over) so that every kernel that resolves a level shares it: K3
// reads each row as its round comes, the descents of K1 and K2 hand it the
// rows they loaded with the rest of the level.
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

// A feature row as one lane holds it: f[k] is the feature byte of slot
// 32k + lane.
template <int NS>
__device__ __forceinline__ void load_feature_row(
    const uint8_t* __restrict__ row, int lane, uint32_t (&f)[NS / 32]) {
#pragma unroll
  for (int k = 0; k < NS / 32; ++k) f[k] = row[32 * k + lane];
}

// The rounds over a node's feature rows: `row_at(fid, f)` puts row fid in
// f (as load_feature_row) and `q_at(fid)` gives the query's byte for that
// round. The
// prefix (pcmp) and trivial-node (knum <= 1) overrides are folded in, in the
// reference's order, so !resolved is exactly the set billed for the binary
// search. A caller may hand rows already loaded (the descent loads a
// level's rows together) or load each as the rounds reach it (K3).
template <int NS, bool STATS, class RowAt, class QAt>
__device__ __forceinline__ RoundsOut rounds_over(RowAt row_at, QAt q_at,
                                                 int fs, int knum, int pcmp) {
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
    const int qv = q_at(fid);
    uint32_t f[NS / 32];
    row_at(fid, f);
    SlotMask<NS> m, less;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const int f0 = f[2 * i];      // slot 64i + lane
      const int f1 = f[2 * i + 1];  // slot 64i + 32 + lane
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

// Rounds over a node's feature block `feats` ([fs, NS] bytes, row = one
// feature byte of every anchor), each row read as its round comes. The
// query's byte for round `fid` is q[qbase + fid], or 0 when qbase + fid >=
// qlim.
template <int NS, bool STATS>
__device__ __forceinline__ RoundsOut feature_compare_rounds(
    const uint8_t* __restrict__ feats, int fs, const uint8_t* __restrict__ q,
    int qbase, int qlim, int knum, int pcmp, int lane) {
  return rounds_over<NS, STATS>(
      [&](int fid, uint32_t (&f)[NS / 32]) {
        load_feature_row<NS>(feats + fid * NS, lane, f);
      },
      [&](int fid) { return qbase + fid < qlim ? int(q[qbase + fid]) : 0; },
      fs, knum, pcmp);
}

}  // namespace fbt
