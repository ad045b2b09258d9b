// Feature-comparison rounds (paper Fig. 6 l.7-19) for one node and one
// query.
//
// The CUDA twin of repro/kernels/feature_branch/kernel.py::
// feature_compare_rounds and of its plain torch version
// repro_torch/kernels/feature_branch/ref.py. The round loop is defined once
// here (rounds_over) so that every kernel that resolves a level shares
// it; what differs between kernels is only how many lanes serve a query
// and so how a round's equal and less-than masks are formed (slots.cuh):
// ballots over a warp (K2's descent, which hands it the rows it loaded
// with the rest of the level), or byte-SIMD compares gathered by shuffles
// inside a lane group (K3, which loads a node's block in one trip, and
// K1's descent, which loads a level's first row with the rest of the
// level).
#pragma once

#include <cstdint>

#include "slots.cuh"

namespace fbt {

struct RoundsOut {
  int idx;        // resolved child index (valid where resolved)
  bool resolved;  // decided without the suffix binary search
  int run_lo;     // surviving equal run [run_lo, run_hi] for the fallback
  int run_hi;
  int rounds;     // feature rows consumed (0 when STATS is off)
};

// A feature row as one lane holds it: f[k] is the feature byte of slot
// 32k + lane.
template <int NS>
__device__ __forceinline__ void load_feature_row(
    const uint8_t* __restrict__ row, int lane, uint32_t (&f)[NS / 32]) {
#pragma unroll
  for (int k = 0; k < NS / 32; ++k) f[k] = row[32 * k + lane];
}

// The same row as lane j of a group of G lanes holds it: the W = NS / G
// bytes of slots [W j, W j + W) as W / 4 little-endian words (the rows of
// a node's block are NS-aligned, so the loads are W-aligned).
template <int NS, int G>
__device__ __forceinline__ void load_group_feature_row(
    const uint8_t* __restrict__ row, int j, uint32_t (&f)[NS / G / 4]) {
  load_words<NS / G>(row + (NS / G) * j, f);
}

// A round's masks for a lane group: `v` is the lane's W bytes of the row
// (byte k, lowest address first, is slot W j + k; little-endian words), qv
// the query's byte. Four bytes a compare, then one shuffle a lane of the
// group (gather_group_masks).
template <int NS, int W>
__device__ __forceinline__ void group_row_masks(const uint32_t (&v)[W / 4],
                                                int qv, unsigned gmask,
                                                SlotMask<NS>& e,
                                                SlotMask<NS>& l) {
  const uint32_t q4 = static_cast<uint32_t>(qv) * 0x01010101u;
  Packed<W> eb = 0, lb = 0;
#pragma unroll
  for (int w = 0; w < W / 4; ++w) {
    eb |= Packed<W>(gather_hi4(eq_hi(v[w], q4))) << (4 * w);
    lb |= Packed<W>(gather_hi4(ltu_hi(v[w], q4))) << (4 * w);
  }
  gather_group_masks<NS, W>(eb | (lb << W), gmask, e, l);
}

// The rounds over a node's feature rows, for a query served by G lanes:
// `row_at(fid, f)` puts the lanes' part of row fid in f and `q_at(fid)`
// gives the query's byte for that round. The prefix (pcmp) and
// trivial-node (knum <= 1) overrides are folded in, in the reference's
// order, so !resolved is exactly the set billed for the binary search. A
// caller may hand rows already loaded (the descent loads a level's rows
// together; K3 a node's block) or load them as the rounds reach them.
// - G = 32, a warp a query (K2's descent): f[k] is the byte of slot
//   32k + lane (load_feature_row); the masks are ballots.
// - G < 32, a group of G lanes a query (K3, K1's descent; `gmask` names
//   the group's lanes): lane j's f holds the W = NS / G bytes of slots [W j, W j + W)
//   as W / 4 little-endian words; the masks are byte-SIMD compares
//   gathered by shuffles inside the group (group_row_masks).
template <int NS, bool STATS, int G = 32, int UNROLL = (G == 32 ? 1 : 8),
          class RowAt, class QAt>
__device__ __forceinline__ RoundsOut rounds_over(RowAt row_at, QAt q_at,
                                                 int fs, int knum, int pcmp,
                                                 unsigned gmask = kFullMask) {
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
  // A warp a query: not unrolled, as the compiler leaves this loop without
  // the pragma (K2's code is the same either way). A lane group: unrolled
  // by default, so a caller's rows in registers are picked by constants
  // when fs is one (K3, PERF.md §6); K1, whose rows beyond the first load
  // as the rounds reach them, asks for UNROLL 1 (faster, and a quarter
  // less to compile).
#pragma unroll (UNROLL)
  for (int fid = 0; fid < fs; ++fid) {
    const int qv = q_at(fid);
    SlotMask<NS> m, less;
    if constexpr (G == 32) {
      uint32_t f[NS / 32];
      row_at(fid, f);
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
    } else {
      constexpr int W = NS / G;
      uint32_t f[W / 4];
      row_at(fid, f);
      SlotMask<NS> e, l;
      group_row_masks<NS, W>(f, qv, gmask, e, l);
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        m.w[i] = e.w[i] & eq.w[i];
        less.w[i] = l.w[i] & eq.w[i];
      }
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
