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
// bytes of the rows it touches, not by arithmetic. The loops are data
// dependent: the binary-search width and the number of candidates to verify
// change from query to query. The TPU version ran every query of a tile in
// lockstep over [tile, ns] blocks. Here one warp owns one query: the 32
// lanes share the byte compares of a node (ballots over the anchors, stripes
// of the key), and every loop is warp-uniform, so a query that needs a long
// search or many candidates delays only its own warp. Warps of a block are
// independent; there is no shared memory and no block-level barrier.
#include <cuda_runtime.h>

#include <cstdint>

#include "cmp.cuh"
#include "descent.cuh"

namespace fbt {

constexpr int kWarpsPerBlock = 8;

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

// At ns=64 without counters, ask for 6 resident blocks per SM (at most 40
// registers a thread): the descent is latency bound, and left alone ptxas
// gives the shared descent of descent.cuh 48 registers, so only 5 blocks
// fit. At ns=128 the same cap makes ptxas spill, so it is not asked for.
template <int NS, bool STATS, bool SIBLING, bool PROBE>
__global__ void __launch_bounds__(32 * kWarpsPerBlock,
                                  (NS == 64 && !STATS) ? 6 : 1)
fused_descent(const DescentArgs a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= a.B) return;  // the whole warp leaves together

  const int L = a.t.L;
  const uint8_t* __restrict__ qrow = a.qb + int64_t(b) * L;
  const int qlen = a.ql[b];
  const WarpKey q = load_warp_key(qrow, L, lane);

  // ---- descent over the stacked levels ----
  DescentCounters c;
  int nid = descend_levels<NS, STATS, true>(
      a.t, qrow, qlen, q, lane, a.path + int64_t(b) * a.t.n_levels, c);

  // ---- blink sibling hop: move right while query >= high key ----
  int hops = 0;
  if (SIBLING) nid = sibling_hop(a.t, nid, q, qlen, lane, hops);
  if (lane == 0) a.leaf[b] = nid;

  // ---- hashtag probe with candidate-by-candidate full-key verify ----
  int n_cand = 0;
  if (PROBE) {
    const int64_t lr = row_of(nid, a.t.LC);
    const uint8_t* __restrict__ tags = a.leaf_tags + lr * NS;
    const uint8_t* __restrict__ occ = a.leaf_occ + lr * NS;
    const uint32_t tag = fnv1a_tag(qrow, qlen, L);
    SlotMask<NS> cand;
#pragma unroll
    for (int i = 0; i < SlotMask<NS>::kWords; ++i) {
      const int s0 = 64 * i + lane, s1 = s0 + 32;
      const bool c0 = occ[s0] != 0 && tags[s0] == tag;
      const bool c1 = occ[s1] != 0 && tags[s1] == tag;
      cand.w[i] = static_cast<unsigned long long>(__ballot_sync(kFullMask, c0)) |
                  (static_cast<unsigned long long>(__ballot_sync(kFullMask, c1)) << 32);
      n_cand += __popcll(cand.w[i]);
    }
    bool hit = false;
    int slot = 0;
    for (int i = 0; i < SlotMask<NS>::kWords && !hit; ++i) {
      unsigned long long w = cand.w[i];
      while (w && !hit) {  // candidates in slot order; the first match wins
        const int s = 64 * i + __ffsll(static_cast<long long>(w)) - 1;
        w &= w - 1;
        const int kd = max(a.leaf_keyid[lr * NS + s], 0);
        if (cmp3_row_query(a.t.key_bytes + int64_t(kd) * L, a.t.key_lens[kd],
                           q, qlen, L, lane) == 0) {
          hit = true;
          slot = s;
        }
      }
    }
    if (lane == 0) {
      a.found[b] = hit;
      a.slot[b] = slot;
      a.val[b] = hit ? a.leaf_val[lr * NS + slot] : 0;
    }
  }

  if (STATS && lane == 0) {
    const int64_t B = a.B;
    a.stats[0 * B + b] = c.feat_rounds;
    a.stats[1 * B + b] = c.suffix_bs;
    a.stats[2 * B + b] = c.key_compares;
    a.stats[3 * B + b] = c.lines_touched;
    a.stats[4 * B + b] = hops;
    if (PROBE) a.stats[5 * B + b] = n_cand;
  }
}

template <int NS, bool STATS, bool SIBLING, bool PROBE>
cudaError_t launch(const DescentArgs& a, cudaStream_t stream) {
  const int blocks = (a.B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_descent<NS, STATS, SIBLING, PROBE>
      <<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int NS, bool STATS, bool SIBLING>
cudaError_t launch_probe(const DescentArgs& a, bool probe, cudaStream_t s) {
  return probe ? launch<NS, STATS, SIBLING, true>(a, s)
               : launch<NS, STATS, SIBLING, false>(a, s);
}

template <int NS, bool STATS>
cudaError_t launch_sibling(const DescentArgs& a, bool sibling, bool probe,
                           cudaStream_t s) {
  return sibling ? launch_probe<NS, STATS, true>(a, probe, s)
                 : launch_probe<NS, STATS, false>(a, probe, s);
}

template <int NS>
cudaError_t launch_stats(const DescentArgs& a, bool stats, bool sibling,
                         bool probe, cudaStream_t s) {
  return stats ? launch_sibling<NS, true>(a, sibling, probe, s)
               : launch_sibling<NS, false>(a, sibling, probe, s);
}

}  // namespace fbt

// Plain C entry, bound with ctypes. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an ns the kernel is not built for). The
// caller allocates every output and keeps the inputs alive.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ns == 64) return fbt::launch_stats<64>(a, stats, sibling, probe, s);
  if (ns == 128) return fbt::launch_stats<128>(a, stats, sibling, probe, s);
  return cudaErrorInvalidValue;
}
