// Fused whole-descent kernel for Hopper (sm_90a): the root-to-leaf descent,
// the blink sibling hop and the hashtag leaf probe of a batch of point
// lookups in one launch.
//
// Replaces repro/kernels/fused_descent/kernel.py::_kernel (launched there by
// fused_descent_kernel through one pallas_call), with the same outputs bit
// for bit: leaf, path, found, slot, val and, with STATS, the six counters.
//
// What bounds it: each query is a chain of dependent gathers (node row ->
// child id -> next node row -> ... -> leaf row -> key row) with a few byte
// compares in between, so the kernel is bound by gather latency and the
// number of queries in flight, not by bytes or arithmetic. The loops are
// data dependent: the binary-search width and the number of candidates to
// verify change from query to query. The TPU version ran every query of a
// tile in lockstep over [tile, ns] blocks.
//
// Here a lane group of G lanes owns one query and a warp serves 32 / G
// queries (lanes_for picks G for each (NS, S) from timed turns, PERF.md §6).
// The group holds a key row (the query, a node's prefix, a key-pool row, a
// high key) as words spread over its lanes, loaded in the widest aligned
// vectors the rows allow (cmp.cuh::GroupKey), and a feature or leaf row
// NS / G slots a lane. A compare is byte-SIMD inside each lane's words and
// one ballot over the group for the first differing byte; a feature round
// is the rounds_over loop K3 runs (byte-SIMD masks gathered by shuffles);
// the probe's candidates are K4's compare. One warp instruction so serves
// 32 / G queries, and at the same registers 32 / G times as many queries
// are in flight as when a warp owned a query (K2's shape, which timed
// slower here at every (NS, S)). Every loop is group-uniform and every
// ballot and shuffle names only the group's lanes, so a group that needs a
// long search or many candidates delays only its own warp, and a group
// that has resolved or left never holds up the others. Warps of a block
// are independent; there is no shared memory and no block-level barrier.
//
// The chain is cut: each level issues its loads before it computes on them
// (descent.cuh: knum, plen, the prefix row and the first feature row
// together); after the descent the leaf's row (high key, link, tags,
// occupancy, key ids) is one round, and the high key's row (the hop check)
// and the first candidate's key row and value (the probe) are the next,
// together. Counted from the code for ycsb-10M (6 levels, 1.84 feature
// rounds a level, 0.25 suffix compares a lookup): a query waited on ~43
// dependent loads (~5.8 a level, ~8 for the hop and the probe) and now
// waits on ~20 (~2.8 a level, 2 after). A key of at most 32 S bytes is S
// stripes (S = 1 to 4, else 8; cmp.cuh), 8 S words over a group's lanes.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "attrs.cuh"
#include "cmp.cuh"
#include "descent.cuh"

namespace fbt {

constexpr int kWarpsPerBlock = 8;

// Lanes a query G of the build for (NS, S), 32 / G queries a warp: the
// fastest of G = 2 to 16 and of one warp a query (the body before lane
// groups) in timed turns for each (NS, S) (PERF.md §6, tools/tree_bench.py).
__host__ __device__ constexpr int lanes_for(int NS, int S) {
  return NS == 64 ? (S <= 2 ? 2 : 4) : (S <= 3 ? 4 : 8);
}

// Resident blocks a SM the build for (NS, S) asks for without counters
// (__launch_bounds__; 1 asks for none): the kernel is latency bound, so
// queries in flight matter more than the registers the compiler would
// like, up to where spills cost more than the queries gain. Timed with
// lanes_for in the same turns; at ns=128 a cap makes ptxas spill.
__host__ __device__ constexpr int min_blocks(int NS, int S) {
  return NS == 64 ? (S <= 3 ? 4 : 3) : 1;
}

struct DescentArgs {
  const uint8_t* qb;  // [B, L]
  const int32_t* ql;  // [B]
  TreeView t;         // inner levels, key pool, leaf high keys and links
  // leaf rows, [LC, NS]
  const uint8_t* leaf_tags;
  const uint8_t* leaf_occ;
  const int32_t* leaf_keyid;
  const int32_t* leaf_val;
  // outputs, [B] unless noted
  int32_t* leaf;
  int32_t* path;  // [B, NL]
  uint8_t* found;
  int32_t* slot;
  int32_t* val;
  int32_t* stats;  // [6, B]: feat_rounds, suffix_bs, key_compares,
                   //         lines_touched, sibling_hops, tag_candidates
  int B;
  int vec;  // the widest load of a key row qb, prefix and key_bytes allow
};

__device__ __forceinline__ uint32_t fnv1a_tag(const uint8_t* __restrict__ q,
                                              int len, int L) {
  uint32_t h = 0x811C9DC5u;
  for (int i = 0; i < L && i < len; ++i) h = (h ^ q[i]) * 0x01000193u;
  h = (h ^ (h >> 16)) & 0xFFFFu;
  return (h ^ (h >> 8)) & 0xFFu;
}

// ---- the group body: G lanes a query, 32 / G queries a warp.

// A leaf as a group holds it after one round of loads: its high key and
// link, and for the probe the W = NS / G slots [W j, W j + W) of lane j:
// their tags and occupancy as W / 4 little-endian words, their key ids.
template <int NS, int G, bool PROBE>
struct GroupLeafRow {
  static constexpr int W = NS / G;
  int64_t row;
  int high, next;
  uint32_t tags[PROBE ? W / 4 : 1], occ[PROBE ? W / 4 : 1];
  uint32_t kid[PROBE ? W : 1];
};

template <int NS, int G, bool PROBE>
__device__ __forceinline__ GroupLeafRow<NS, G, PROBE> load_group_leaf(
    const DescentArgs& a, int nid, int j) {
  constexpr int W = NS / G;
  GroupLeafRow<NS, G, PROBE> r;
  r.row = row_of(nid, a.t.LC);
  r.high = a.t.leaf_high[r.row];
  r.next = a.t.leaf_next[r.row];
  if constexpr (PROBE) {
    const int64_t at = r.row * NS + W * j;
    load_words<W>(a.leaf_tags + at, r.tags);
    load_words<W>(a.leaf_occ + at, r.occ);
    load_words<4 * W>(a.leaf_keyid + at, r.kid);
  }
  return r;
}

// Key id of slot s (group-uniform): the holding lane's, shuffled.
template <int NS, int G>
__device__ __forceinline__ int group_kid(const GroupLeafRow<NS, G, true>& r,
                                         int s, unsigned gmask) {
  constexpr int W = NS / G;
  return static_cast<int>(
      __shfl_sync(gmask, pick(r.kid, s % W), s / W, G));
}

// The probe's candidates: occupied slots whose tag is the query's, four
// slots a compare, the group's flags gathered by shuffles (as K4 does).
template <int NS, int G>
__device__ __forceinline__ SlotMask<NS> group_candidates(
    const GroupLeafRow<NS, G, true>& r, uint32_t tag, unsigned gmask) {
  constexpr int W = NS / G;
  const uint32_t q4 = tag * 0x01010101u;
  Packed<W> bits = 0;
#pragma unroll
  for (int w = 0; w < W / 4; ++w)
    bits |= Packed<W>(gather_hi4(eq_hi(r.tags[w], q4) & nonzero_hi(r.occ[w])))
            << (4 * w);
  SlotMask<NS> m, none;
  gather_group_masks<NS, W>(bits, gmask, m, none);
  return m;
}

template <int NS, int S, int G>
struct GroupProbe {
  SlotMask<NS> cand;
  int first, val;
  GroupKeyRow<S, G> row;
};

template <int NS, int S, int G>
__device__ __forceinline__ GroupProbe<NS, S, G> group_first_candidate(
    const DescentArgs& a, const GroupLeafRow<NS, G, true>& r, uint32_t tag,
    const Lanes<G>& g) {
  GroupProbe<NS, S, G> p;
  p.cand = group_candidates<NS, G>(r, tag, g.mask);
  p.first = mask_first<NS>(p.cand);
  if (p.first < NS) {
    p.row = load_group_keyrow<S, G>(
        a.t, max(group_kid<NS, G>(r, p.first, g.mask), 0), g, a.vec);
    p.val = a.leaf_val[r.row * NS + p.first];
  }
  return p;
}

// One query for each group. After the descent the leaf's row (high key,
// link, tags, occupancy, key ids) is one round of loads; the high key's
// row (the hop check) and the first candidate's key row and value (the
// probe) are the next, issued together; only a hop that moves (rare:
// `sibling_hops`) or a candidate that is not the key (rare: a tag
// collision) costs another.
template <int NS, int S, int G, bool STATS, bool SIBLING, bool PROBE>
__device__ __forceinline__ void group_body(const DescentArgs& a) {
  const int lane = threadIdx.x & 31;
  const Lanes<G> g{lane & (G - 1), group_lanes<G>(lane)};
  const int64_t b64 =
      (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  if (b64 >= a.B) return;  // the whole group leaves together
  const int b = static_cast<int>(b64);

  const int L = a.t.L;
  const uint8_t* __restrict__ qrow = a.qb + int64_t(b) * L;
  GroupWalker<S, G> wk;
  wk.qlen = a.ql[b];
  wk.q = load_group_key<S, G>(qrow, L, g.j, a.vec);
  wk.path = a.path + int64_t(b) * a.t.n_levels;
  const GroupKey<S, G>& q = wk.q;
  const int qlen = wk.qlen;

  // ---- descent over the stacked levels ----
  descend_group_levels<NS, S, G, STATS>(a.t, wk, g, a.vec);

  // ---- the leaf's row, then the hop check beside the first candidate ----
  GroupLeafRow<NS, G, PROBE> r = load_group_leaf<NS, G, PROBE>(a, wk.nid, g.j);
  const uint32_t tag = PROBE ? fnv1a_tag(qrow, qlen, L) : 0;
  GroupProbe<NS, S, G> pr;
  if constexpr (PROBE) pr = group_first_candidate<NS, S, G>(a, r, tag, g);
  int nid = wk.nid, hops = 0;
  if constexpr (SIBLING) {
    nid = group_sibling_hop(
        a.t, nid, r, group_high_row<S, G>(a.t, r, g, a.vec),
        [&](int id) { return load_group_leaf<NS, G, PROBE>(a, id, g.j); }, q,
        qlen, g, a.vec, hops);
    if constexpr (PROBE) {
      if (hops > 0) pr = group_first_candidate<NS, S, G>(a, r, tag, g);
    }
  }
  if (g.j == 0) a.leaf[b] = nid;

  // ---- hashtag probe: candidates in slot order, the first match wins ----
  int n_cand = 0;
  if constexpr (PROBE) {
#pragma unroll
    for (int i = 0; i < SlotMask<NS>::kWords; ++i)
      n_cand += __popcll(pr.cand.w[i]);
    bool hit = false;
    int slot = 0;
    for (int s = pr.first; s < NS;) {
      if (cmp3_keys(pr.row.b, pr.row.len, q, qlen, L, g.j, g.mask) == 0) {
        hit = true;
        slot = s;
        break;
      }
      clear_slot<NS>(pr.cand, s);
      s = mask_first<NS>(pr.cand);
      if (s < NS)
        pr.row = load_group_keyrow<S, G>(
            a.t, max(group_kid<NS, G>(r, s, g.mask), 0), g, a.vec);
    }
    if (g.j == 0) {
      a.found[b] = hit;
      a.slot[b] = slot;
      a.val[b] = !hit ? 0
                      : slot == pr.first ? pr.val
                                         : a.leaf_val[r.row * NS + slot];
    }
  }

  if (STATS && g.j == 0) {
    const int64_t B = a.B;
    a.stats[0 * B + b] = wk.c.feat_rounds;
    a.stats[1 * B + b] = wk.c.suffix_bs;
    a.stats[2 * B + b] = wk.c.key_compares;
    a.stats[3 * B + b] = wk.c.lines_touched;
    a.stats[4 * B + b] = hops;
    if (PROBE) a.stats[5 * B + b] = n_cand;
  }
}

// The kernel: the group body at the build's lanes a query, at the
// resident blocks a SM of min_blocks (none asked for with counters, which
// only the checks run).
template <int NS, int S, bool STATS, bool SIBLING, bool PROBE>
__global__ void __launch_bounds__(32 * kWarpsPerBlock,
                                  STATS ? 1 : min_blocks(NS, S))
fused_descent(const DescentArgs a) {
  group_body<NS, S, lanes_for(NS, S), STATS, SIBLING, PROBE>(a);
}

// The instantiation for the runtime flags (nullptr for an ns the kernel is
// not built for).
template <int NS, int S, bool ST, bool SI>
const void* kernel_p(bool probe) {
  return probe ? reinterpret_cast<const void*>(fused_descent<NS, S, ST, SI, true>)
               : reinterpret_cast<const void*>(fused_descent<NS, S, ST, SI, false>);
}

template <int NS, int S, bool ST>
const void* kernel_sp(bool sibling, bool probe) {
  return sibling ? kernel_p<NS, S, ST, true>(probe)
                 : kernel_p<NS, S, ST, false>(probe);
}

template <int NS, int S>
const void* kernel_ssp(bool stats, bool sibling, bool probe) {
  return stats ? kernel_sp<NS, S, true>(sibling, probe)
               : kernel_sp<NS, S, false>(sibling, probe);
}

template <int NS>
const void* kernel_lssp(int L, bool stats, bool sibling, bool probe) {
  switch (stripes_for(L)) {
    case 1: return kernel_ssp<NS, 1>(stats, sibling, probe);
    case 2: return kernel_ssp<NS, 2>(stats, sibling, probe);
    case 3: return kernel_ssp<NS, 3>(stats, sibling, probe);
    case 4: return kernel_ssp<NS, 4>(stats, sibling, probe);
    default: return kernel_ssp<NS, kMaxStripes>(stats, sibling, probe);
  }
}

inline const void* kernel_for(int ns, int L, bool stats, bool sibling,
                              bool probe) {
  if (ns == 64) return kernel_lssp<64>(L, stats, sibling, probe);
  if (ns == 128) return kernel_lssp<128>(L, stats, sibling, probe);
  return nullptr;
}

}  // namespace fbt

// Plain C entry, bound with ctypes. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an ns the kernel is not built for). The
// caller allocates every output and keeps the inputs alive; a is copied
// into the launch's parameters before cudaLaunchKernel returns.
extern "C" int fbt_fused_descent(
    const void* qb, const void* ql, const void* knum, const void* plen,
    const void* prefix, const void* features, const void* children,
    const void* anchors, const void* key_bytes, const void* key_lens,
    const void* leaf_high, const void* leaf_next, const void* leaf_tags,
    const void* leaf_occ, const void* leaf_keyid, const void* leaf_val,
    void* out_leaf, void* out_path, void* out_found, void* out_slot,
    void* out_val, void* out_stats, int B, int L, int n_levels, int C, int fs,
    int ns, int LC, int stats, int sibling, int probe, void* stream) {
  fbt::DescentArgs a;
  a.qb = static_cast<const uint8_t*>(qb);
  a.ql = static_cast<const int32_t*>(ql);
  a.t.knum = static_cast<const int32_t*>(knum);
  a.t.plen = static_cast<const int32_t*>(plen);
  a.t.prefix = static_cast<const uint8_t*>(prefix);
  a.t.features = static_cast<const uint8_t*>(features);
  a.t.children = static_cast<const int32_t*>(children);
  a.t.anchors = static_cast<const int32_t*>(anchors);
  a.t.key_bytes = static_cast<const uint8_t*>(key_bytes);
  a.t.key_lens = static_cast<const int32_t*>(key_lens);
  a.t.leaf_high = static_cast<const int32_t*>(leaf_high);
  a.t.leaf_next = static_cast<const int32_t*>(leaf_next);
  a.leaf_tags = static_cast<const uint8_t*>(leaf_tags);
  a.leaf_occ = static_cast<const uint8_t*>(leaf_occ);
  a.leaf_keyid = static_cast<const int32_t*>(leaf_keyid);
  a.leaf_val = static_cast<const int32_t*>(leaf_val);
  a.leaf = static_cast<int32_t*>(out_leaf);
  a.path = static_cast<int32_t*>(out_path);
  a.found = static_cast<uint8_t*>(out_found);
  a.slot = static_cast<int32_t*>(out_slot);
  a.val = static_cast<int32_t*>(out_val);
  a.stats = static_cast<int32_t*>(out_stats);
  a.B = B;
  a.t.L = L;
  a.t.n_levels = n_levels;
  a.t.C = C;
  a.t.fs = fs;
  a.t.LC = LC;
  a.vec = std::min({fbt::row_vec(L, qb), fbt::row_vec(L, prefix),
                    fbt::row_vec(L, key_bytes)});
  const void* fn = fbt::kernel_for(ns, L, stats, sibling, probe);
  if (fn == nullptr) return cudaErrorInvalidValue;
  void* args[] = {&a};
  const int64_t threads =
      int64_t(B) * fbt::lanes_for(ns, fbt::stripes_for(L));
  const int block = 32 * fbt::kWarpsPerBlock;
  const int blocks = static_cast<int>((threads + block - 1) / block);
  cudaLaunchKernel(fn, dim3(blocks), dim3(block), args, 0,
                   static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// The key stripes S of the build a launch at key width L runs (cmp.cuh).
extern "C" int fbt_fused_descent_stripes(int L) { return fbt::stripes_for(L); }

// The lanes a query G of the build a launch at (ns, L) runs (lanes_for;
// 32 / G queries a warp), or 0 for an ns the kernel is not built for.
extern "C" int fbt_fused_descent_lanes(int ns, int L) {
  if (ns != 64 && ns != 128) return 0;
  return fbt::lanes_for(ns, fbt::stripes_for(L));
}

// What the instantiation a launch at (ns, L, stats, sibling, probe) takes
// asks of the card: out = {registers, local bytes, static shared bytes,
// dynamic shared bytes, blocks per SM} (attrs.cuh), plus out[5] = threads a
// block.
extern "C" int fbt_fused_descent_attrs(int ns, int L, int stats, int sibling,
                                       int probe, int* out) {
  const void* fn = fbt::kernel_for(ns, L, stats, sibling, probe);
  if (fn == nullptr) return cudaErrorInvalidValue;
  out[5] = 32 * fbt::kWarpsPerBlock;
  return fbt::kernel_attrs(fn, 32 * fbt::kWarpsPerBlock, 0, out);
}
