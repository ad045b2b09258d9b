// Root-to-leaf descent and blink sibling hop for one query, shared by every
// kernel that walks the tree: for one warp a query (the fused range scan,
// K2, fused_scan.cu) and for a lane group of G lanes a query (the fused
// descent, K1, fused_descent.cu; below), the two with the same loop,
// compare order and counters. The reference shares `descend_levels` and
// `sibling_hop` of repro/kernels/fused_descent/kernel.py between its two
// kernels the same way, so both resolve bit-identical start leaves.
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

// ---- lane groups: the same descent and hop for a query served by G < 32
// lanes (K1, fused_descent.cu; K2 runs the warp's above). A key row is a
// GroupKey (cmp.cuh), a feature row W = NS / G bytes a lane
// (load_group_feature_row), and every loop and branch is group-uniform, so
// the ballots and shuffles name the group's lanes alone (`gmask`) and a
// group that resolves early or has left never holds up the others of its
// warp. A scalar the group needs (knum, plen, a child or anchor id, a key
// length) is loaded by every lane of the group from one address: one
// sector a group, as one lane's load would be, with no shuffle on the
// chain of dependent loads. `vec` is the widest load the key-row tables
// allow (row_vec).

// A lane's place in its group of G lanes.
template <int G>
struct Lanes {
  int j;          // lane in the group
  unsigned mask;  // the group's lanes (group_lanes<G>)
};

template <int NS, int S, int G>
struct GroupNodeRow {
  int knum, plen;
  GroupKey<S, G> prefix;
  uint32_t feat0[NS / G / 4];  // feature row 0
};

template <int NS, int S, int G>
__device__ __forceinline__ GroupNodeRow<NS, S, G> load_group_node(
    const TreeView& t, int64_t row, const Lanes<G>& g, int vec) {
  GroupNodeRow<NS, S, G> n;
  n.knum = t.knum[row];
  n.plen = t.plen[row];
  n.prefix = load_group_key<S, G>(t.prefix + row * t.L, t.L, g.j, vec);
  load_group_feature_row<NS, G>(t.features + row * t.fs * NS, g.j, n.feat0);
  return n;
}

template <int S, int G>
struct GroupWalker {
  GroupKey<S, G> q;
  int qlen;
  int32_t* path;
  DescentCounters c;
  int nid;
};

template <int S, int G>
struct GroupKeyRow {
  GroupKey<S, G> b;
  int len;
};

template <int S, int G>
__device__ __forceinline__ GroupKeyRow<S, G> load_group_keyrow(
    const TreeView& t, int kd, const Lanes<G>& g, int vec) {
  return {load_group_key<S, G>(t.key_bytes + int64_t(kd) * t.L, t.L, g.j,
                               vec),
          t.key_lens[kd]};
}

// resolve_level for a lane group.
template <int NS, int S, int G, bool STATS>
__device__ __forceinline__ int resolve_group_level(
    const TreeView& t, const GroupNodeRow<NS, S, G>& n, int64_t row,
    const GroupKey<S, G>& q, int qlen, const Lanes<G>& g, int vec,
    DescentCounters& c) {
  if (n.knum <= 1) return 0;
  const int L = t.L;
  constexpr int kLinesPerRow = NS / 64 > 1 ? NS / 64 : 1;
  const int kn = n.knum, kmax = kn - 1, pl = n.plen;
  const int pcmp = prefix_cmp(n.prefix, pl, q, g.j, g.mask);
  int idx;
  bool need_bs = false;
  RoundsOut r{0, true, 0, -1, 0};
  if (!STATS && pcmp != 0) {
    idx = pcmp < 0 ? 0 : kmax;  // the prefix decides; rounds not billed
  } else {
    const uint8_t* __restrict__ f = t.features + row * t.fs * NS;
    r = rounds_over<NS, STATS, G, 1>(
        [&](int fid, uint32_t (&fr)[NS / G / 4]) {
          if (fid == 0) {
#pragma unroll
            for (int k = 0; k < NS / G / 4; ++k) fr[k] = n.feat0[k];
          } else {
            load_group_feature_row<NS, G>(f + fid * NS, g.j, fr);
          }
        },
        [&](int fid) { return key_byte(q, pl + fid, L, g.mask); }, t.fs, kn,
        pcmp, g.mask);
    idx = r.idx;
    need_bs = !r.resolved;
  }
  int kcl = 0;
  if (need_bs) {  // suffix binary search over the surviving run
    const int32_t* __restrict__ anch = t.anchors + row * NS;
    int lo = r.run_lo, hi = r.run_hi + 1;
    while (lo < hi) {
      const int mid = min(max((lo + hi) >> 1, 0), NS - 1);
      const GroupKeyRow<S, G> k =
          load_group_keyrow<S, G>(t, max(anch[mid], 0), g, vec);
      const int c3 = cmp3_keys(k.b, k.len, q, qlen, L, g.j, g.mask);
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

// descend_levels for a lane group; lane 0 of the group writes the path.
template <int NS, int S, int G, bool STATS>
__device__ __forceinline__ void descend_group_levels(const TreeView& t,
                                                     GroupWalker<S, G>& w,
                                                     const Lanes<G>& g,
                                                     int vec) {
  w.nid = 0;  // root = node 0 of level 0
  for (int l = 0; l < t.n_levels; ++l) {
    if (g.j == 0) w.path[l] = w.nid;
    const int64_t row = int64_t(l) * t.C + row_of(w.nid, t.C);
    const GroupNodeRow<NS, S, G> n = load_group_node<NS, S, G>(t, row, g, vec);
    const int idx = resolve_group_level<NS, S, G, STATS>(t, n, row, w.q,
                                                         w.qlen, g, vec, w.c);
    w.nid = t.children[row * NS + idx];
  }
}

// high_row for a lane group.
template <int S, int G, class Row>
__device__ __forceinline__ GroupKeyRow<S, G> group_high_row(
    const TreeView& t, const Row& r, const Lanes<G>& g, int vec) {
  GroupKeyRow<S, G> h{};
  if (r.high >= 0 && r.next >= 0) h = load_group_keyrow<S, G>(t, r.high, g, vec);
  return h;
}

// sibling_hop for a lane group.
template <int S, int G, class Row, class Load>
__device__ __forceinline__ int group_sibling_hop(
    const TreeView& t, int nid, Row& r, GroupKeyRow<S, G> hrow, Load load,
    const GroupKey<S, G>& q, int qlen, const Lanes<G>& g, int vec, int& hops) {
  for (int h = 0; h < kSiblingHops; ++h) {
    if (r.high < 0 || r.next < 0) break;
    if (cmp3_keys(hrow.b, hrow.len, q, qlen, t.L, g.j, g.mask) > 0)
      break;  // high key > query: the query stays
    nid = r.next;
    ++hops;
    r = load(nid);
    hrow = group_high_row<S, G>(t, r, g, vec);
  }
  return nid;
}

}  // namespace fbt
