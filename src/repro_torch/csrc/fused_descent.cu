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
// tile in lockstep over [tile, ns] blocks. Here one warp owns one query: the
// 32 lanes share the byte compares of a node (ballots over the anchors,
// stripes of the key), and every loop is warp-uniform, so a query that
// needs a long search or many candidates delays only its own warp. Warps of
// a block are independent; there is no shared memory and no block-level
// barrier.
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
// stripes (S = 1 to 4, else 8; cmp.cuh), so the ycsb instantiation carries
// one register and one load a row where the widest carries eight.
#include <cuda_runtime.h>

#include <cstdint>

#include "attrs.cuh"
#include "cmp.cuh"
#include "descent.cuh"

namespace fbt {

constexpr int kWarpsPerBlock = 8;
constexpr int kMinBlocks64 = 6;  // resident blocks a SM asked for at ns=64
constexpr int kMinBlocksWide = 5;  // the same for keys over 32 bytes (S > 1)

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
};

__device__ __forceinline__ uint32_t fnv1a_tag(const uint8_t* __restrict__ q,
                                              int len, int L) {
  uint32_t h = 0x811C9DC5u;
  for (int i = 0; i < L && i < len; ++i) h = (h ^ q[i]) * 0x01000193u;
  h = (h ^ (h >> 16)) & 0xFFFFu;
  return (h ^ (h >> 8)) & 0xFFu;
}

// A leaf as the warp holds it after one round of loads: its high key and
// link, and for the probe its tags, occupancy and key ids (element k:
// slot 32k + lane).
template <int NS, bool PROBE>
struct LeafRow {
  int64_t row;
  int high, next;
  uint32_t tags[PROBE ? NS / 32 : 1], occ[PROBE ? NS / 32 : 1];
  int32_t kid[PROBE ? NS / 32 : 1];
};

template <int NS, bool PROBE>
__device__ __forceinline__ LeafRow<NS, PROBE> load_leaf(const DescentArgs& a,
                                                        int nid, int lane) {
  LeafRow<NS, PROBE> r;
  r.row = row_of(nid, a.t.LC);
  r.high = a.t.leaf_high[r.row];
  r.next = a.t.leaf_next[r.row];
  if constexpr (PROBE) {
#pragma unroll
    for (int k = 0; k < NS / 32; ++k) {
      const int64_t at = r.row * NS + 32 * k + lane;
      r.tags[k] = a.leaf_tags[at];
      r.occ[k] = a.leaf_occ[at];
      r.kid[k] = a.leaf_keyid[at];
    }
  }
  return r;
}

// The probe's candidates in a leaf: occupied slots whose tag is the
// query's, as a slot mask.
template <int NS>
__device__ __forceinline__ SlotMask<NS> candidates(const LeafRow<NS, true>& r,
                                                   uint32_t tag) {
  bool c[NS / 32];
#pragma unroll
  for (int k = 0; k < NS / 32; ++k) c[k] = r.occ[k] != 0 && r.tags[k] == tag;
  return ballot_mask<NS>(c);
}

// The probe's candidates in a leaf, the first one's key row and its value,
// loaded as soon as the leaf's row is in.
template <int NS, int S>
struct Probe {
  SlotMask<NS> cand;
  int first, val;
  KeyRow<S> row;
};

template <int NS, int S>
__device__ __forceinline__ Probe<NS, S> first_candidate(
    const DescentArgs& a, const LeafRow<NS, true>& r, uint32_t tag, int lane) {
  Probe<NS, S> p;
  p.cand = candidates<NS>(r, tag);
  p.first = mask_first<NS>(p.cand);
  if (p.first < NS) {
    p.row = load_key<S>(a.t, max(striped_at(r.kid, p.first), 0), lane);
    p.val = a.leaf_val[r.row * NS + p.first];
  }
  return p;
}

// At ns=64 without counters, ask for kMinBlocks64 resident blocks per SM
// (kMinBlocksWide for keys over 32 bytes, whose stripes take registers:
// at 6 blocks their build spills): the kernel is latency bound, so warps
// in flight matter more than the registers the compiler would like. At
// ns=128 a cap makes ptxas spill, so it is not asked for.
//
// After the descent the leaf's row (high key, link, tags, occupancy, key
// ids) is one round of loads; the high key's row (the hop check) and the
// first candidate's key row and value (the probe) are the next, issued
// together; only a hop that moves (rare: `sibling_hops`) or a candidate
// that is not the key (rare: a tag collision) costs another. Two queries a
// warp, interleaved so that one's loads fly while the other resolves, was
// measured slower at every register cap (PERF.md §6).
template <int NS, int S, bool STATS, bool SIBLING, bool PROBE>
__global__ void __launch_bounds__(32 * kWarpsPerBlock,
                                  (NS == 64 && !STATS)
                                      ? (S == 1 ? kMinBlocks64 : kMinBlocksWide)
                                      : 1)
fused_descent(const DescentArgs a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= a.B) return;  // the whole warp leaves together

  const int L = a.t.L;
  const uint8_t* __restrict__ qrow = a.qb + int64_t(b) * L;
  Walker<S> wk;
  wk.qlen = a.ql[b];
  wk.q = load_warp_key<S>(qrow, L, lane);
  wk.path = a.path + int64_t(b) * a.t.n_levels;
  const WarpKey<S>& q = wk.q;
  const int qlen = wk.qlen;

  // ---- descent over the stacked levels ----
  descend_levels<NS, S, STATS, true>(a.t, wk, lane);

  // ---- the leaf's row, then the hop check beside the first candidate ----
  LeafRow<NS, PROBE> r = load_leaf<NS, PROBE>(a, wk.nid, lane);
  const uint32_t tag = PROBE ? fnv1a_tag(qrow, qlen, L) : 0;
  Probe<NS, S> pr;
  if constexpr (PROBE) pr = first_candidate<NS, S>(a, r, tag, lane);
  int nid = wk.nid, hops = 0;
  if constexpr (SIBLING) {
    nid = sibling_hop(a.t, nid, r, high_row<S>(a.t, r, lane),
                      [&](int id) { return load_leaf<NS, PROBE>(a, id, lane); },
                      q, qlen, lane, hops);
    if constexpr (PROBE) {
      if (hops > 0) pr = first_candidate<NS, S>(a, r, tag, lane);  // moved
    }
  }
  if (lane == 0) a.leaf[b] = nid;

  // ---- hashtag probe: candidates in slot order, the first match wins ----
  int n_cand = 0;
  if constexpr (PROBE) {
#pragma unroll
    for (int i = 0; i < SlotMask<NS>::kWords; ++i)
      n_cand += __popcll(pr.cand.w[i]);
    bool hit = false;
    int slot = 0;
    for (int s = pr.first; s < NS;) {
      if (cmp3_keys(pr.row.b, pr.row.len, q, qlen, L, lane) == 0) {
        hit = true;
        slot = s;
        break;
      }
      clear_slot<NS>(pr.cand, s);
      s = mask_first<NS>(pr.cand);
      if (s < NS) pr.row = load_key<S>(a.t, max(striped_at(r.kid, s), 0), lane);
    }
    if (lane == 0) {
      a.found[b] = hit;
      a.slot[b] = slot;
      a.val[b] = !hit ? 0
                      : slot == pr.first ? pr.val
                                         : a.leaf_val[r.row * NS + slot];
    }
  }

  if (STATS && lane == 0) {
    const int64_t B = a.B;
    a.stats[0 * B + b] = wk.c.feat_rounds;
    a.stats[1 * B + b] = wk.c.suffix_bs;
    a.stats[2 * B + b] = wk.c.key_compares;
    a.stats[3 * B + b] = wk.c.lines_touched;
    a.stats[4 * B + b] = hops;
    if (PROBE) a.stats[5 * B + b] = n_cand;
  }
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
  const void* fn = fbt::kernel_for(ns, L, stats, sibling, probe);
  if (fn == nullptr) return cudaErrorInvalidValue;
  void* args[] = {&a};
  const int blocks = (B + fbt::kWarpsPerBlock - 1) / fbt::kWarpsPerBlock;
  cudaLaunchKernel(fn, dim3(blocks), dim3(32 * fbt::kWarpsPerBlock), args, 0,
                   static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// The key stripes S of the build a launch at key width L runs (cmp.cuh).
extern "C" int fbt_fused_descent_stripes(int L) { return fbt::stripes_for(L); }

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
