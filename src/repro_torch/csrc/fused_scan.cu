// Fused range-scan kernel for Hopper (sm_90a): the root-to-leaf descent,
// the blink sibling hop and the leaf-chain walk of a batch of range scans
// in one launch (the YCSB-E hot path).
//
// Replaces repro/kernels/fused_scan/kernel.py::_kernel (launched there by
// fused_scan_kernel through one pallas_call), with the same outputs bit for
// bit: out_kid and out_val [B, max_items] (EMPTY and 0 past `emitted`),
// emitted [B] and, with STATS, rearranged [B] (dirty leaves visited).
//
// What bounds it: latency, then instructions. A scan reads a few leaf rows
// (key ids, values, occupancy: 9 bytes a slot) and, where it must compare
// or sort, the key rows those slots point to, and writes 8 bytes per
// emitted pair. Each hop depends on the last (leaf -> next leaf) and the
// key rows are gathers through the key ids, so a scan is a chain of
// dependent loads; ranking a dirty leaf is the only real arithmetic. The
// design:
// - one warp per query; the descent and the sibling hop are the shared
//   device functions of descent.cuh, run stats-free (a scan returns no
//   branch counters); the start leaf's row is loaded beside its high key
//   and link, before the hop check;
// - lane t owns slots t, t+32, ...; the emit set of a leaf is a ballot
//   mask, so an ordered leaf ranks a slot by the popcount of the emitted
//   slots below it and touches no key bytes past hop 0;
// - the next leaf comes off the rank's critical path: `leaf_next` is read
//   with the leaf's row, and the next leaf's row (key ids, values,
//   occupancy, ordered flag, link) is loaded before the current leaf is
//   ranked, so its loads are in flight during the rank. A scan that stops
//   at max_items has read one row too many and writes nothing for it;
// - hop 0 and dirty leaves stage the occupied keys as order-preserving
//   packed words in shared memory, [W][NS] 64-bit words a warp with
//   W = ceil(L / 8): bytes 8w..8w+7 big-endian, 0 past the key width (the
//   order of core/keys.py::pack_words_t; two 32-bit words make one 64-bit
//   word), so unsigned word order is byte order. A key sits at its compact
//   index c (its slot's rank among the occupied slots), word w at
//   w * NS + c: lanes reading their own keys read distinct consecutive
//   words (no bank conflict), and all lanes reading one key's word read
//   one address (a broadcast). A lane reads its own words from there too:
//   holding them in registers took the kernel to 80 registers and 3
//   blocks a SM, and the rank below reads few of them;
// - a dirty leaf ranks each emitted key by counting the emitted keys below
//   it (the reference's _rank_among), word by word over the words that are
//   not common to every key of the leaf, then the length tie-break; no
//   loop leaves early for one lane. The count exploits what a dirty leaf
//   is: sorted until an insert took a free slot, so a few ascending runs in
//   slot order (one compare a key finds them). Within its own run a key's
//   count is its place; over another run it is a binary search of that
//   run's compact range, the same number of steps for every lane
//   (rank_by_runs). That is ns/32 x (1 + sum of log2 run lengths)
//   compares a lane against ns/32 x n for rank-by-count over n emitted
//   keys, and it degrades to rank-by-count when no order is left. Not a
//   warp-wide bitonic sort: that costs log^2(ns) stages of compare and
//   exchange with their word shuffles whatever the order, and moves the
//   payload; a rank is the output column itself. Tree keys are unique, so
//   the ranks are the stable sort's order;
// - hop 0 filters key >= query over the same words (the query's words
//   packed once into shared memory, read as a broadcast), through the
//   rank's own compare (words_less);
// - a pair goes straight to out[b, emitted + rank]: destinations in a row
//   are unique, so the TPU kernel's one-hot _merge_emit is not needed;
// - read-only: no sorted leaf is written back and leaf_ordered is never
//   set, as in the reference;
// - no query padding: the warps past the batch leave at once.
#include <cuda_runtime.h>

#include <cstdint>

#include "attrs.cuh"
#include "cmp.cuh"
#include "descent.cuh"

namespace fbt {

constexpr int kMaxWarpsPerBlock = 8;
constexpr int kSmemBudget = 48 * 1024;  // per block, without an opt-in
constexpr int kMinBlocks64 = 4;  // resident blocks a SM asked for at ns=64

struct ScanArgs {
  const uint8_t* qb;  // [B, L]
  const int32_t* ql;  // [B]
  TreeView t;         // inner levels, key pool, leaf high keys and links
  // leaf rows, [LC, NS] / [LC]
  const int32_t* leaf_keyid;
  const int32_t* leaf_val;
  const uint8_t* leaf_occ;
  const uint8_t* leaf_ordered;
  // outputs
  int32_t* out_kid;     // [B, max_items]
  int32_t* out_val;     // [B, max_items]
  int32_t* emitted;     // [B]
  int32_t* rearranged;  // [B], written only with STATS
  int B, max_items;
  int warp_smem;  // bytes of shared memory per warp
  bool wide;      // L % 8 == 0 and the key pool 8-byte aligned
};

__host__ __device__ constexpr int key_words(int L) { return (L + 7) >> 3; }

// Shared memory of one warp: the staged keys' words [W][NS] u64, the
// query's words [W] u64 and the staged keys' lengths [NS] i32.
__host__ __device__ constexpr int warp_smem_bytes(int ns, int L) {
  return (8 * key_words(L) * (ns + 1) + 4 * ns + 15) & ~15;
}

// Byte-reverse a 64-bit word: 8 key bytes assembled little-endian become
// the big-endian word whose unsigned order is the bytes' order.
__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  const uint32_t lo = static_cast<uint32_t>(x);
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  return (static_cast<uint64_t>(__byte_perm(lo, 0, 0x0123)) << 32) |
         __byte_perm(hi, 0, 0x0123);
}

// Word w of a key row: bytes 8w .. 8w+7 big-endian, 0 past the key width L.
// `wide`: every word is whole and aligned, so it is one 8-byte load.
__device__ __forceinline__ uint64_t key_word(const uint8_t* __restrict__ row,
                                             int w, int L, bool wide) {
  uint64_t x = 0;
  if (wide) {
    x = __ldg(reinterpret_cast<const unsigned long long*>(row) + w);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * w + j;
      x |= static_cast<uint64_t>(p < L ? row[p] : 0) << (8 * j);
    }
  }
  return bswap64(x);
}

// Number of set slots below slot s (0 <= s <= NS): an ordered leaf's
// emission rank, and a slot's compact index among the occupied slots.
template <int NS>
__device__ __forceinline__ int popc_below(const SlotMask<NS>& m, int s) {
  int r = 0;
#pragma unroll
  for (int i = 0; i < SlotMask<NS>::kWords; ++i) {
    const int b = s - 64 * i;
    r += b >= 64 ? __popcll(m.w[i])
                 : (b > 0 ? __popcll(m.w[i] & ((1ull << b) - 1)) : 0);
  }
  return r;
}

// One leaf's row, as its lanes hold it: lane t has slots t, t+32, ...
template <int NS>
struct LeafRow {
  int32_t kid[NS / 32], val[NS / 32];
  bool occ[NS / 32];
  bool ordered;
  int high, next;
};

// Issue every load of leaf `id`'s row at once; none depends on another.
template <int NS>
__device__ __forceinline__ LeafRow<NS> load_leaf(const ScanArgs& a, int id,
                                                 int lane) {
  LeafRow<NS> r;
  const int64_t lr = row_of(id, a.t.LC);
#pragma unroll
  for (int k = 0; k < NS / 32; ++k) {
    const int64_t at = lr * NS + 32 * k + lane;
    r.kid[k] = a.leaf_keyid[at];
    r.val[k] = a.leaf_val[at];
    r.occ[k] = a.leaf_occ[at] != 0;
  }
  r.ordered = a.leaf_ordered[lr] != 0;
  r.high = a.t.leaf_high[lr];
  r.next = a.t.leaf_next[lr];
  return r;
}

// Stage the occupied keys of a leaf by compact index (the slot's rank
// among the occupied slots, c[k]): each lane packs the words of its own
// slots into words[w * NS + c] and their lengths into lens[c] (and `len`).
// The loads of a lane's slots are issued together, 4 words at a time.
template <int NS>
__device__ __forceinline__ void stage_keys(const ScanArgs& a,
                                           const LeafRow<NS>& r,
                                           const int (&c)[NS / 32], int W,
                                           uint64_t* words, int32_t* lens,
                                           int (&len)[NS / 32]) {
  constexpr int kPerLane = NS / 32;
  const int L = a.t.L;
  const uint8_t* row[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int kd = max(r.kid[k], 0);
    row[k] = a.t.key_bytes + int64_t(kd) * L;
    len[k] = r.occ[k] ? a.t.key_lens[kd] : 0;
  }
  for (int w0 = 0; w0 < W; w0 += 4) {
    uint64_t x[kPerLane][4];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[k][j] = (r.occ[k] && w0 + j < W) ? key_word(row[k], w0 + j, L, a.wide)
                                           : 0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r.occ[k] && w0 + j < W) words[(w0 + j) * NS + c[k]] = x[k][j];
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k)
    if (r.occ[k]) lens[c[k]] = len[k];
}

// Leading words shared by every staged key: a compare of two staged keys
// may start after them. Warp-uniform.
template <int NS>
__device__ __forceinline__ int common_words(const uint64_t* words,
                                            const bool (&occ)[NS / 32],
                                            const int (&c)[NS / 32], int W) {
  int w = 0;
  for (; w < W; ++w) {
    const uint64_t ref = words[w * NS];  // broadcast: compact index 0
    bool diff = false;
#pragma unroll
    for (int k = 0; k < NS / 32; ++k)
      diff |= occ[k] && words[w * NS + c[k]] != ref;
    if (__any_sync(kFullMask, diff)) break;
  }
  return w;
}

// Key x < key y, each given as packed words at a stride (a staged key at
// NS, the query's words at 1) and a length: word by word over words
// w0 .. W-1 (those before w0 are equal), then the length tie-break. The
// loop bound is the same for every lane. The one compare of the scan.
__device__ __forceinline__ bool words_less(const uint64_t* x, int xs, int xl,
                                           const uint64_t* y, int ys, int yl,
                                           int w0, int W) {
  bool lt = false, eq = true;
  for (int w = w0; w < W; ++w) {
    const uint64_t a = x[w * xs], b = y[w * ys];
    lt = lt || (eq && a < b);
    eq = eq && a == b;
  }
  return lt || (eq && xl < yl);
}

// Staged key i < staged key j (compact indices).
template <int NS>
__device__ __forceinline__ bool key_less(const uint64_t* words,
                                         const int32_t* lens, int i, int j,
                                         int w0, int W) {
  return words_less(words + i, NS, lens[i], words + j, NS, lens[j], w0, W);
}

// rank[k] = number of emitted keys below this lane's emitted key k.
//
// A dirty leaf is mostly sorted: it was ordered until an insert took a free
// slot (or a split rebuilt it), so in slot order its keys form a few
// ascending runs. One compare per key finds the runs (a key not above the
// previous occupied key starts one); in compact order each run is a range
// of indices. A key's count over its own run is its place in the run; over
// another run it is a binary search of the range, ceil(log2(n + 1)) steps
// for a run of n keys, the same count for every lane. So the leaf costs
// ~ns/32 x (1 + sum over runs of log2 n) compares a lane, not
// ns/32 x (n emitted); with one run per key (no order left) it is
// rank-by-count again. At hop 0 only keys >= the query are emitted; in an
// ascending run they are a suffix, and the keys before it (all below any
// emitted key) are taken off each count.
template <int NS>
__device__ __forceinline__ void rank_by_runs(
    const SlotMask<NS>& occm, const SlotMask<NS>& emm, const uint64_t* words,
    const int32_t* lens, const bool (&occ)[NS / 32], const bool (&em)[NS / 32],
    const int (&c)[NS / 32], int w0, int W, int lane, int (&rank)[NS / 32]) {
  constexpr int kPerLane = NS / 32;
  bool st[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    st[k] = occ[k] && (c[k] == 0 ||
                       !key_less<NS>(words, lens, c[k] - 1, c[k], w0, W));
    rank[k] = 0;
  }
  SlotMask<NS> runs = ballot_mask<NS>(st);
  for (int s0 = mask_first<NS>(runs); s0 < NS;) {  // every run; warp-uniform
    clear_slot<NS>(runs, s0);
    const int s1 = mask_first<NS>(runs);  // the next run's first slot, or NS
    const int cs = popc_below<NS>(occm, s0);
    const int n = popc_below<NS>(occm, s1) - cs;
    const int ne = n - (popc_below<NS>(emm, s1) - popc_below<NS>(emm, s0));
    const int steps = 32 - __clz(n);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int s = 32 * k + lane;
      const bool own = s >= s0 && s < s1;
      int lo = cs, hi = cs + n;
      for (int it = 0; it < steps; ++it) {
        const int mid = (lo + hi) >> 1;
        if (em[k] && !own && lo < hi) {
          if (key_less<NS>(words, lens, mid, c[k], w0, W)) lo = mid + 1;
          else hi = mid;
        }
      }
      rank[k] += (own ? c[k] : lo) - cs - ne;
    }
    s0 = s1;
  }
}

template <int NS, int S, bool STATS>
__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock,
                                  NS == 64 ? kMinBlocks64 : 1)
fused_scan(const ScanArgs a) {
  constexpr int kPerLane = NS / 32;  // slots a lane owns: lane, lane+32, ...
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= a.B) return;  // the whole warp leaves together

  extern __shared__ __align__(16) uint8_t smem[];
  const int L = a.t.L;
  const int W = key_words(L);
  uint64_t* words = reinterpret_cast<uint64_t*>(smem + warp * a.warp_smem);
  uint64_t* qw = words + W * NS;
  int32_t* lens = reinterpret_cast<int32_t*>(qw + W);

  const uint8_t* __restrict__ qrow = a.qb + int64_t(b) * L;
  Walker<S> wk;
  wk.qlen = a.ql[b];
  wk.q = load_warp_key<S>(qrow, L, lane);
  for (int w = lane; w < W; w += 32) qw[w] = key_word(qrow, w, L, false);
  const WarpKey<S>& q = wk.q;
  const int qlen = wk.qlen;

  // ---- descent + sibling hop to the start leaf (stats-free) ----
  descend_levels<NS, S, false, false>(a.t, wk, lane);
  int cur = wk.nid;
  LeafRow<NS> r = load_leaf<NS>(a, cur, lane);
  int hops = 0;
  cur = sibling_hop(a.t, cur, r, high_row<S>(a.t, r, lane),
                    [&](int id) { return load_leaf<NS>(a, id, lane); }, q,
                    qlen, lane, hops);

  // ---- chain walk: hop 0 filters key >= query, later hops emit all ----
  const int M = a.max_items;
  int32_t* __restrict__ out_kid = a.out_kid + int64_t(b) * M;
  int32_t* __restrict__ out_val = a.out_val + int64_t(b) * M;
  int emitted = 0, rearr = 0;
  for (int hop = 0;; ++hop) {
    const bool dirty = !r.ordered;
    // the next leaf's row, in flight while this one is ranked
    LeafRow<NS> nr;
    if (r.next >= 0) nr = load_leaf<NS>(a, r.next, lane);

    bool em[kPerLane];
    int len[kPerLane], c[kPerLane];
    const SlotMask<NS> occm = ballot_mask<NS>(r.occ);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      em[k] = r.occ[k];
      c[k] = popc_below<NS>(occm, 32 * k + lane);
    }
    if (hop == 0 || dirty) {  // warp-uniform
      __syncwarp();  // every lane is done with the last leaf's words
      stage_keys<NS>(a, r, c, W, words, lens, len);
      __syncwarp();
    }
    if (hop == 0) {  // emit key >= query
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)  // qw: a broadcast
        em[k] = r.occ[k] &&
                !words_less(words + c[k], NS, len[k], qw, 1, qlen, 0, W);
    }
    const SlotMask<NS> emm = ballot_mask<NS>(em);
    int n_emit = 0;
#pragma unroll
    for (int i = 0; i < SlotMask<NS>::kWords; ++i) n_emit += __popcll(emm.w[i]);
    int rank[kPerLane];
    if (dirty) {
      const int w0 = common_words<NS>(words, r.occ, c, W);
      rank_by_runs<NS>(occm, emm, words, lens, r.occ, em, c, w0, W, lane, rank);
    } else {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k)
        rank[k] = popc_below<NS>(emm, 32 * k + lane);
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int p = emitted + rank[k];
      if (em[k] && p < M) {
        out_kid[p] = r.kid[k];
        out_val[p] = r.val[k];
      }
    }
    emitted = min(emitted + n_emit, M);
    if (STATS) rearr += dirty;
    if (r.next < 0 || emitted >= M) break;
    r = nr;
  }
  for (int p = emitted + lane; p < M; p += 32) {
    out_kid[p] = -1;  // EMPTY
    out_val[p] = 0;
  }
  if (lane == 0) {
    a.emitted[b] = emitted;
    if (STATS) a.rearranged[b] = rearr;
  }
}

inline int warps_per_block(int warp_smem) {
  const int w = kSmemBudget / warp_smem;
  return w < 1 ? 1 : (w > kMaxWarpsPerBlock ? kMaxWarpsPerBlock : w);
}

// The instantiation for (ns, L, stats); nullptr for an ns the kernel is not
// built for.
template <int NS, int S>
const void* kernel_s(bool stats) {
  return stats ? reinterpret_cast<const void*>(fused_scan<NS, S, true>)
               : reinterpret_cast<const void*>(fused_scan<NS, S, false>);
}

template <int NS>
const void* kernel_ls(int L, bool stats) {
  switch (stripes_for(L)) {
    case 1: return kernel_s<NS, 1>(stats);
    case 2: return kernel_s<NS, 2>(stats);
    case 3: return kernel_s<NS, 3>(stats);
    case 4: return kernel_s<NS, 4>(stats);
    default: return kernel_s<NS, kMaxStripes>(stats);
  }
}

inline const void* kernel_for(int ns, int L, bool stats) {
  if (ns == 64) return kernel_ls<64>(L, stats);
  if (ns == 128) return kernel_ls<128>(L, stats);
  return nullptr;
}

}  // namespace fbt

// Plain C entry, bound with ctypes. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an ns the kernel is not built for or a
// key width whose rows do not fit the shared-memory budget). The caller
// allocates every output and keeps the inputs alive; a is copied into the
// launch's parameters before cudaLaunchKernel returns.
extern "C" int fbt_fused_scan(
    const void* qb, const void* ql, const void* knum, const void* plen,
    const void* prefix, const void* features, const void* children,
    const void* anchors, const void* key_bytes, const void* key_lens,
    const void* leaf_high, const void* leaf_next, const void* leaf_keyid,
    const void* leaf_val, const void* leaf_occ, const void* leaf_ordered,
    void* out_kid, void* out_val, void* out_emitted, void* out_rearranged,
    int B, int L, int n_levels, int C, int fs, int ns, int LC, int max_items,
    int stats, void* stream) {
  fbt::ScanArgs a;
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
  a.t.L = L;
  a.t.n_levels = n_levels;
  a.t.C = C;
  a.t.fs = fs;
  a.t.LC = LC;
  a.leaf_keyid = static_cast<const int32_t*>(leaf_keyid);
  a.leaf_val = static_cast<const int32_t*>(leaf_val);
  a.leaf_occ = static_cast<const uint8_t*>(leaf_occ);
  a.leaf_ordered = static_cast<const uint8_t*>(leaf_ordered);
  a.out_kid = static_cast<int32_t*>(out_kid);
  a.out_val = static_cast<int32_t*>(out_val);
  a.emitted = static_cast<int32_t*>(out_emitted);
  a.rearranged = static_cast<int32_t*>(out_rearranged);
  a.B = B;
  a.max_items = max_items;
  a.warp_smem = fbt::warp_smem_bytes(ns, L);
  a.wide = L % 8 == 0 && reinterpret_cast<uintptr_t>(key_bytes) % 8 == 0;
  const void* fn = fbt::kernel_for(ns, L, stats);
  if (a.warp_smem > fbt::kSmemBudget || fn == nullptr)
    return cudaErrorInvalidValue;
  const int wpb = fbt::warps_per_block(a.warp_smem);
  void* args[] = {&a};
  cudaLaunchKernel(fn, dim3((B + wpb - 1) / wpb), dim3(32 * wpb), args,
                   wpb * a.warp_smem, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// What the instantiation a launch at (ns, L, stats) takes asks of the
// card: out = {registers, local bytes, static shared bytes, dynamic shared
// bytes, blocks per SM} (attrs.cuh), plus out[5] = threads a block.
extern "C" int fbt_fused_scan_attrs(int ns, int L, int stats, int* out) {
  const int ws = fbt::warp_smem_bytes(ns, L);
  const void* fn = fbt::kernel_for(ns, L, stats);
  if (ws > fbt::kSmemBudget || fn == nullptr) return cudaErrorInvalidValue;
  const int wpb = fbt::warps_per_block(ws);
  out[5] = 32 * wpb;
  return fbt::kernel_attrs(fn, 32 * wpb, wpb * ws, out);
}
