// Root-to-leaf descent and blink sibling hop for one warp and one query,
// shared by every kernel that walks the tree: the fused descent (K1,
// fused_descent.cu) and the fused range scan (K2, fused_scan.cu). The
// reference shares `descend_levels` and `sibling_hop` of
// repro/kernels/fused_descent/kernel.py between its two kernels the same
// way, so both resolve bit-identical start leaves.
//
// A descent is a chain of dependent loads: a level's row is known only when
// the level above has picked its child. So each level issues its loads
// together, as soon as the node id is known (load_node: knum, plen, the
// prefix row and the first feature row; every address inside [NL, C, ...]
// is valid, so loading a row the level will not need is safe), and only
// then computes on them from registers: the prefix compare and the first
// feature round. Where the load-as-you-go level waited on knum, then plen,
// then the prefix, then the first row, it waits once. Later feature rows
// (a round that did not resolve), the child id (known only once idx is)
// and the suffix binary search (rare) still load as they go; loading every
// feature row or the whole children row with the level was measured
// slower (PERF.md §6: the extra rows cost more issue and cache
// bandwidth than the round trips they save). The counters are logical
// (rounds the reference consumes, modeled lines), so loading more rows
// changes none of them.
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

// Element s (warp-uniform) of a row a warp holds striped (lane t has
// elements t, t+32, ...): the lane's register picked, then a shuffle.
template <int N, class T>
__device__ __forceinline__ T striped_at(const T (&v)[N], int s) {
  return __shfl_sync(kFullMask, pick(v, s >> 5), s & 31);
}

// One inner node as the warp holds it after one round of loads.
template <int NS, int S>
struct NodeRow {
  int knum, plen;
  WarpKey<S> prefix;
  uint32_t feat0[NS / 32];  // feature row 0
};

template <int NS, int S>
__device__ __forceinline__ NodeRow<NS, S> load_node(const TreeView& t,
                                                    int64_t row, int lane) {
  NodeRow<NS, S> n;
  n.knum = t.knum[row];
  n.plen = t.plen[row];
  n.prefix = load_warp_key<S>(t.prefix + row * t.L, t.L, lane);
  load_feature_row<NS>(t.features + row * t.fs * NS, lane, n.feat0);
  return n;
}

// One query of a descent: its key and length, its path row (PATH), its
// counters (STATS) and the node it is at.
template <int S>
struct Walker {
  WarpKey<S> q;
  int qlen;
  int32_t* path;
  DescentCounters c;
  int nid;
};

// The child index one node gives the query, its level's loads in `n`;
// accumulates the counters when STATS.
template <int NS, int S, bool STATS>
__device__ __forceinline__ int resolve_level(const TreeView& t,
                                             const NodeRow<NS, S>& n,
                                             int64_t row, const WarpKey<S>& q,
                                             int qlen, int lane,
                                             DescentCounters& c) {
  if (n.knum <= 1) return 0;
  const int L = t.L;
  constexpr int kLinesPerRow = NS / 64 > 1 ? NS / 64 : 1;
  const int kn = n.knum, kmax = kn - 1, pl = n.plen;
  const int pcmp = prefix_cmp(n.prefix, pl, q, lane);
  int idx;
  bool need_bs = false;
  RoundsOut r{0, true, 0, -1, 0};
  if (!STATS && pcmp != 0) {
    idx = pcmp < 0 ? 0 : kmax;  // the prefix decides; rounds not billed
  } else {
    const uint8_t* __restrict__ f = t.features + row * t.fs * NS;
    r = rounds_over<NS, STATS>(
        [&](int fid, uint32_t (&fr)[NS / 32]) {
          if (fid == 0) {
#pragma unroll
            for (int k = 0; k < NS / 32; ++k) fr[k] = n.feat0[k];
          } else {
            load_feature_row<NS>(f + fid * NS, lane, fr);
          }
        },
        [&](int fid) { return key_byte(q, pl + fid, L); }, t.fs, kn, pcmp);
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
      const int c3 = cmp3_row_query(t.key_bytes + int64_t(aid) * L,
                                    t.key_lens[aid], q, qlen, L, lane);
      if (c3 <= 0) lo = mid + 1; else hi = mid;
      ++kcl;
    }
    idx = min(max(lo - 1, 0), kmax);
  }
  if (STATS) {
    c.feat_rounds += r.rounds;
    c.suffix_bs += need_bs;
    c.key_compares += kcl;
    c.lines_touched += 1 + r.rounds * kLinesPerRow +
                       kcl * (1 + (qlen + 63) / 64) + 1;
  }
  return idx;
}

// Descend every inner level from the root; the walker ends at its leaf
// (w.nid). Writes the node id at each level to w.path[l] when PATH (lane
// 0), and accumulates w.c when STATS. Both are template flags, so a kernel
// that needs neither carries no test for them in the level loop.
template <int NS, int S, bool STATS, bool PATH>
__device__ __forceinline__ void descend_levels(const TreeView& t,
                                               Walker<S>& w, int lane) {
  w.nid = 0;  // root = node 0 of level 0
  for (int l = 0; l < t.n_levels; ++l) {
    if (PATH && lane == 0) w.path[l] = w.nid;
    const int64_t row = int64_t(l) * t.C + row_of(w.nid, t.C);
    const NodeRow<NS, S> n = load_node<NS, S>(t, row, lane);
    const int idx =
        resolve_level<NS, S, STATS>(t, n, row, w.q, w.qlen, lane, w.c);
    w.nid = t.children[row * NS + idx];
  }
}

// A key-pool row and its length, loaded together (one round trip).
template <int S>
struct KeyRow {
  WarpKey<S> b;
  int len;
};

template <int S>
__device__ __forceinline__ KeyRow<S> load_key(const TreeView& t, int kd,
                                              int lane) {
  return {load_warp_key<S>(t.key_bytes + int64_t(kd) * t.L, t.L, lane),
          t.key_lens[kd]};
}

// The high key's row of a loaded leaf row `r` (with `high` and `next`),
// loaded only where the hop could move (zeros elsewhere).
template <int S, class Row>
__device__ __forceinline__ KeyRow<S> high_row(const TreeView& t, const Row& r,
                                              int lane) {
  KeyRow<S> h{};
  if (r.high >= 0 && r.next >= 0) h = load_key<S>(t, r.high, lane);
  return h;
}

// Blink sibling hop: move right while query >= high key, at most
// kSiblingHops times, over a leaf row the caller has already loaded (`r`)
// and its high key's row (`hrow`, high_row), so the caller's other loads
// ride in the same round trips; `load(id)` loads another leaf's row when
// the query moves. Returns the leaf id; `hops` counts the moves. A leaf
// that does not move the query once never will (the same leaf gives the
// same answer), so the loop stops there.
template <int S, class Row, class Load>
__device__ __forceinline__ int sibling_hop(const TreeView& t, int nid, Row& r,
                                           KeyRow<S> hrow, Load load,
                                           const WarpKey<S>& q, int qlen,
                                           int lane, int& hops) {
  for (int h = 0; h < kSiblingHops; ++h) {
    if (r.high < 0 || r.next < 0) break;
    if (cmp3_keys(hrow.b, hrow.len, q, qlen, t.L, lane) > 0)
      break;  // high key > query: the query stays
    nid = r.next;
    ++hops;
    r = load(nid);
    hrow = high_row<S>(t, r, lane);
  }
  return nid;
}

}  // namespace fbt
