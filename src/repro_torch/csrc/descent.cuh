// Root-to-leaf descent and blink sibling hop for one warp and one query,
// shared by every kernel that walks the tree: the fused descent (K1,
// fused_descent.cu) and the fused range scan (K2, fused_scan.cu). The
// reference shares `descend_levels` and `sibling_hop` of
// repro/kernels/fused_descent/kernel.py between its two kernels the same
// way, so both resolve bit-identical start leaves.
#pragma once

#include <cstdint>

#include "cmp.cuh"
#include "feature_rounds.cuh"

namespace fbt {

constexpr int kSiblingHops = 2;  // repro.core.branch._SIBLING_HOPS

// What a descent reads: the stacked inner levels, the key pool and the
// leaves' high keys and sibling links.
struct TreeView {
  // stacked inner levels, [n_levels, C, ...]
  const int32_t* knum;
  const int32_t* plen;
  const uint8_t* prefix;    // [NL, C, L]
  const uint8_t* features;  // [NL, C, fs, NS]
  const int32_t* children;  // [NL, C, NS]
  const int32_t* anchors;   // [NL, C, NS]
  // key pool
  const uint8_t* key_bytes;  // [KC, L]
  const int32_t* key_lens;   // [KC]
  // leaves, [LC]
  const int32_t* leaf_high;
  const int32_t* leaf_next;
  int L, n_levels, C, fs, LC;
};

// Counters of one query's descent (summed over the levels).
struct DescentCounters {
  int feat_rounds = 0, suffix_bs = 0, key_compares = 0, lines_touched = 0;
};

// Row index of node `id` in a table of `rows` rows; -1 names the last row
// (the scratch row), as Python indexing does in the plain version.
__device__ __forceinline__ int64_t row_of(int id, int rows) {
  return id < 0 ? int64_t(id) + rows : int64_t(id);
}

// Descend every inner level from the root; returns the leaf id. Writes the
// node id at each level to path[l] when PATH (lane 0), and accumulates the
// counters when STATS. Both are template flags, so a kernel that needs
// neither carries no test for them in the level loop.
template <int NS, bool STATS, bool PATH>
__device__ __forceinline__ int descend_levels(
    const TreeView& t, const uint8_t* __restrict__ qrow, int qlen,
    const WarpKey& q, int lane, int32_t* path, DescentCounters& c) {
  const int L = t.L;
  const uint8_t* __restrict__ key_bytes = t.key_bytes;
  const int32_t* __restrict__ key_lens = t.key_lens;
  constexpr int kLinesPerRow = NS / 64 > 1 ? NS / 64 : 1;
  const int kw_lines = (qlen + 63) / 64;
  int nid = 0;  // root = node 0 of level 0
  for (int l = 0; l < t.n_levels; ++l) {
    if (PATH && lane == 0) path[l] = nid;
    const int64_t row = int64_t(l) * t.C + row_of(nid, t.C);
    const int kn = t.knum[row];
    int idx = 0;
    if (kn > 1) {
      const int kmax = kn - 1;
      const int pl = t.plen[row];
      const int pcmp = prefix_cmp(t.prefix + row * L, pl, q, lane);
      bool need_bs = false;
      RoundsOut r{0, true, 0, -1, 0};
      if (!STATS && pcmp != 0) {
        idx = pcmp < 0 ? 0 : kmax;  // the prefix decides; rounds not billed
      } else {
        r = feature_compare_rounds<NS, STATS>(
            t.features + row * t.fs * NS, t.fs, qrow, pl, L, kn, pcmp, lane);
        idx = r.idx;
        need_bs = !r.resolved;
      }
      int kcl = 0;
      if (need_bs) {  // suffix binary search over the surviving run
        const int32_t* __restrict__ anch = t.anchors + row * NS;
        int lo = r.run_lo, hi = r.run_hi + 1;
        while (lo < hi) {
          const int mid = min(max((lo + hi) >> 1, 0), NS - 1);
          const int aid = max(anch[mid], 0);
          const int c3 = cmp3_row_query(key_bytes + int64_t(aid) * L,
                                        key_lens[aid], q, qlen, L, lane);
          if (c3 <= 0) lo = mid + 1; else hi = mid;
          ++kcl;
        }
        idx = min(max(lo - 1, 0), kmax);
      }
      if (STATS) {
        c.feat_rounds += r.rounds;
        c.suffix_bs += need_bs;
        c.key_compares += kcl;
        c.lines_touched += 1 + r.rounds * kLinesPerRow + kcl * (1 + kw_lines) + 1;
      }
    }
    nid = t.children[row * NS + idx];
  }
  return nid;
}

// Blink sibling hop: move right while query >= high key, at most
// kSiblingHops times. Returns the leaf id; `hops` counts the moves.
__device__ __forceinline__ int sibling_hop(const TreeView& t, int nid,
                                           const WarpKey& q, int qlen,
                                           int lane, int& hops) {
  for (int h = 0; h < kSiblingHops; ++h) {
    const int64_t lr = row_of(nid, t.LC);
    const int hk = t.leaf_high[lr];
    const int nx = t.leaf_next[lr];
    if (hk < 0 || nx < 0) continue;
    const int c = -cmp3_row_query(t.key_bytes + int64_t(hk) * t.L,
                                  t.key_lens[hk], q, qlen, t.L, lane);
    if (c >= 0) {
      nid = nx;
      ++hops;
    }
  }
  return nid;
}

}  // namespace fbt
