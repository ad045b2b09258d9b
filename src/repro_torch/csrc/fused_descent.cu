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
#include "feature_rounds.cuh"

namespace fbt {

constexpr int kWarpsPerBlock = 8;
constexpr int kSiblingHops = 2;  // repro.core.branch._SIBLING_HOPS

struct DescentArgs {
  const uint8_t* qb;  // [B, L]
  const int32_t* ql;  // [B]
  // stacked inner levels, [NL, C, ...]
  const int32_t* knum;
  const int32_t* plen;
  const uint8_t* prefix;    // [NL, C, L]
  const uint8_t* features;  // [NL, C, fs, NS]
  const int32_t* children;  // [NL, C, NS]
  const int32_t* anchors;   // [NL, C, NS]
  // key pool
  const uint8_t* key_bytes;  // [KC, L]
  const int32_t* key_lens;   // [KC]
  // leaves, [LC] / [LC, NS]
  const int32_t* leaf_high;
  const int32_t* leaf_next;
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
  int B, L, n_levels, C, fs, LC;
};

// Row index of node `id` in a table of `rows` rows; -1 names the last row
// (the scratch row), as Python indexing does in the plain version.
__device__ __forceinline__ int64_t row_of(int id, int rows) {
  return id < 0 ? int64_t(id) + rows : int64_t(id);
}

__device__ __forceinline__ uint32_t fnv1a_tag(const uint8_t* __restrict__ q,
                                              int len, int L) {
  uint32_t h = 0x811C9DC5u;
  for (int i = 0; i < L && i < len; ++i) h = (h ^ q[i]) * 0x01000193u;
  h = (h ^ (h >> 16)) & 0xFFFFu;
  return (h ^ (h >> 8)) & 0xFFu;
}

template <int NS, bool STATS, bool SIBLING, bool PROBE>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fused_descent(const DescentArgs a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= a.B) return;  // the whole warp leaves together

  const int L = a.L;
  const uint8_t* __restrict__ qrow = a.qb + int64_t(b) * L;
  const int qlen = a.ql[b];
  const WarpKey q = load_warp_key(qrow, L, lane);
  const uint8_t* __restrict__ key_bytes = a.key_bytes;
  const int32_t* __restrict__ key_lens = a.key_lens;
  constexpr int kLinesPerRow = NS / 64 > 1 ? NS / 64 : 1;
  const int kw_lines = (qlen + 63) / 64;
  int fr = 0, sb = 0, kc = 0, li = 0;

  // ---- descent over the stacked levels ----
  int nid = 0;  // root = node 0 of level 0
  for (int l = 0; l < a.n_levels; ++l) {
    if (lane == 0) a.path[int64_t(b) * a.n_levels + l] = nid;
    const int64_t row = int64_t(l) * a.C + row_of(nid, a.C);
    const int kn = a.knum[row];
    int idx = 0;
    if (kn > 1) {
      const int kmax = kn - 1;
      const int pl = a.plen[row];
      const int pcmp = prefix_cmp(a.prefix + row * L, pl, q, lane);
      bool need_bs = false;
      RoundsOut r{0, true, 0, -1, 0};
      if (!STATS && pcmp != 0) {
        idx = pcmp < 0 ? 0 : kmax;  // the prefix decides; rounds not billed
      } else {
        r = feature_compare_rounds<NS, STATS>(
            a.features + row * a.fs * NS, a.fs, qrow, pl, L, kn, pcmp, lane);
        idx = r.idx;
        need_bs = !r.resolved;
      }
      int kcl = 0;
      if (need_bs) {  // suffix binary search over the surviving run
        const int32_t* __restrict__ anch = a.anchors + row * NS;
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
        fr += r.rounds;
        sb += need_bs;
        kc += kcl;
        li += 1 + r.rounds * kLinesPerRow + kcl * (1 + kw_lines) + 1;
      }
    }
    nid = a.children[row * NS + idx];
  }

  // ---- blink sibling hop: move right while query >= high key ----
  int hops = 0;
  if (SIBLING) {
    for (int h = 0; h < kSiblingHops; ++h) {
      const int64_t lr = row_of(nid, a.LC);
      const int hk = a.leaf_high[lr];
      const int nx = a.leaf_next[lr];
      if (hk < 0 || nx < 0) continue;
      const int c = -cmp3_row_query(key_bytes + int64_t(hk) * L, key_lens[hk],
                                    q, qlen, L, lane);
      if (c >= 0) {
        nid = nx;
        ++hops;
      }
    }
  }
  if (lane == 0) a.leaf[b] = nid;

  // ---- hashtag probe with candidate-by-candidate full-key verify ----
  int n_cand = 0;
  if (PROBE) {
    const int64_t lr = row_of(nid, a.LC);
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
        if (cmp3_row_query(key_bytes + int64_t(kd) * L, key_lens[kd], q, qlen,
                           L, lane) == 0) {
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
    a.stats[0 * B + b] = fr;
    a.stats[1 * B + b] = sb;
    a.stats[2 * B + b] = kc;
    a.stats[3 * B + b] = li;
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
  a.knum = static_cast<const int32_t*>(knum);
  a.plen = static_cast<const int32_t*>(plen);
  a.prefix = static_cast<const uint8_t*>(prefix);
  a.features = static_cast<const uint8_t*>(features);
  a.children = static_cast<const int32_t*>(children);
  a.anchors = static_cast<const int32_t*>(anchors);
  a.key_bytes = static_cast<const uint8_t*>(key_bytes);
  a.key_lens = static_cast<const int32_t*>(key_lens);
  a.leaf_high = static_cast<const int32_t*>(leaf_high);
  a.leaf_next = static_cast<const int32_t*>(leaf_next);
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
  a.L = L;
  a.n_levels = n_levels;
  a.C = C;
  a.fs = fs;
  a.LC = LC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ns == 64) return fbt::launch_stats<64>(a, stats, sibling, probe, s);
  if (ns == 128) return fbt::launch_stats<128>(a, stats, sibling, probe, s);
  return cudaErrorInvalidValue;
}
