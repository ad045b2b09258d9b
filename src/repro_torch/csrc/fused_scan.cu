// Fused range-scan kernel for Hopper (sm_90a): the root-to-leaf descent,
// the blink sibling hop and the leaf-chain walk of a batch of range scans
// in one launch (the YCSB-E hot path).
//
// Replaces repro/kernels/fused_scan/kernel.py::_kernel (launched there by
// fused_scan_kernel through one pallas_call), with the same outputs bit for
// bit: out_kid and out_val [B, max_items] (EMPTY and 0 past `emitted`),
// emitted [B] and, with STATS, rearranged [B] (dirty leaves visited).
//
// What bounds it: bytes. A scan reads a few leaf rows (key ids, values,
// occupancy: 9 bytes a slot) and, where it must compare or sort, the key
// rows those slots point to, and writes 8 bytes per emitted pair; the
// arithmetic is a few byte compares per key. Each hop depends on the last
// (leaf -> next leaf), and the key rows are gathers through the key ids, so
// in practice it is latency bound, as the descent is. The design:
// - one warp per query, as in the fused descent; the descent and the
//   sibling hop are the shared device functions of descent.cuh, run
//   stats-free (a scan returns no branch counters);
// - lane t owns slots t, t+32, ...; the emit set of a leaf is a ballot
//   mask, so an ordered leaf ranks a slot by the popcount of the emitted
//   slots below it and touches no key bytes past hop 0;
// - hop 0 and dirty leaves (leaf_ordered clear) stage the occupied key rows
//   of the leaf in shared memory (ns * L bytes per warp) with coalesced
//   loads; a dirty leaf ranks each emitted key by counting the emitted keys
//   below it (the reference's _rank_among, bytes first, length tie-break;
//   tree keys are unique, so this is the stable sort's order);
// - a pair goes straight to out[b, emitted + rank]: destinations in a row
//   are unique, so the TPU kernel's one-hot _merge_emit is not needed;
// - no query padding: the warps past the batch leave at once.
// Several queries per warp and cp.async of the next leaf are left to a
// later change.
#include <cuda_runtime.h>

#include <cstdint>

#include "cmp.cuh"
#include "descent.cuh"

namespace fbt {

constexpr int kMaxWarpsPerBlock = 8;
constexpr int kSmemBudget = 48 * 1024;  // per block, without an opt-in

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
};

// Shared memory of one warp: key ids [NS] i32, key lengths [NS] i32, the
// query [L rounded up to 4] and the key rows [NS, L] of the current leaf.
__host__ __device__ constexpr int warp_smem_bytes(int ns, int L) {
  return (8 * ns + ((L + 3) & ~3) + ns * L + 15) & ~15;
}

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

// The mask word holding slot s (no dynamic register indexing).
template <int NS>
__device__ __forceinline__ unsigned long long word_of(const SlotMask<NS>& m,
                                                      int s) {
  unsigned long long w = m.w[0];
#pragma unroll
  for (int i = 1; i < SlotMask<NS>::kWords; ++i)
    if ((s >> 6) == i) w = m.w[i];
  return w;
}

// Number of set slots below slot s: an ordered leaf's emission rank.
template <int NS>
__device__ __forceinline__ int popc_below(const SlotMask<NS>& m, int s) {
  int r = 0;
#pragma unroll
  for (int i = 0; i < SlotMask<NS>::kWords; ++i)
    if (i < (s >> 6)) r += __popcll(m.w[i]);
  return r + __popcll(word_of<NS>(m, s) & ((1ull << (s & 63)) - 1));
}

// Number of emitted keys below key s: a dirty leaf's emission rank.
template <int NS>
__device__ __forceinline__ int rank_among(const SlotMask<NS>& emit,
                                          const uint8_t* rows,
                                          const int32_t* lens, int s, int L) {
  const uint8_t* ks = rows + s * L;
  const int ls = lens[s];
  int r = 0;
#pragma unroll
  for (int i = 0; i < SlotMask<NS>::kWords; ++i) {
    unsigned long long w = emit.w[i];
    while (w) {
      const int j = 64 * i + __ffsll(static_cast<long long>(w)) - 1;
      w &= w - 1;
      r += cmp3_bytes(rows + j * L, lens[j], ks, ls, L) < 0;
    }
  }
  return r;
}

// Copy the key rows of the occupied slots into shared memory, 4 bytes a
// lane when the key width allows it; neighbouring lanes read neighbouring
// bytes of a row.
template <int NS>
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ key_bytes,
                                           int L, const int32_t* kids,
                                           const SlotMask<NS>& occ,
                                           uint8_t* rows, int lane) {
  if ((L & 3) == 0 && (reinterpret_cast<uintptr_t>(key_bytes) & 3) == 0) {
    const int W = L >> 2;
    const uint32_t* __restrict__ src = reinterpret_cast<const uint32_t*>(key_bytes);
    uint32_t* dst = reinterpret_cast<uint32_t*>(rows);
    for (int u = lane; u < NS * W; u += 32) {
      const int s = u / W;
      if ((word_of<NS>(occ, s) >> (s & 63)) & 1)
        dst[u] = src[int64_t(kids[s]) * W + (u - s * W)];
    }
  } else {
    for (int u = lane; u < NS * L; u += 32) {
      const int s = u / L;
      if ((word_of<NS>(occ, s) >> (s & 63)) & 1)
        rows[u] = key_bytes[int64_t(kids[s]) * L + (u - s * L)];
    }
  }
}

template <int NS, bool STATS>
__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock)
fused_scan(const ScanArgs a) {
  constexpr int kPerLane = NS / 32;  // slots a lane owns: lane, lane+32, ...
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= a.B) return;  // the whole warp leaves together

  extern __shared__ __align__(16) uint8_t smem[];
  const int L = a.t.L;
  int32_t* kids = reinterpret_cast<int32_t*>(smem + warp * a.warp_smem);
  int32_t* lens = kids + NS;
  uint8_t* qs = reinterpret_cast<uint8_t*>(lens + NS);
  uint8_t* rows = qs + ((L + 3) & ~3);

  const uint8_t* __restrict__ qrow = a.qb + int64_t(b) * L;
  const int qlen = a.ql[b];
  const WarpKey q = load_warp_key(qrow, L, lane);
  for (int i = lane; i < L; i += 32) qs[i] = qrow[i];

  // ---- descent + sibling hop to the start leaf (stats-free) ----
  DescentCounters unused;
  int cur = descend_levels<NS, false, false>(a.t, qrow, qlen, q, lane,
                                             nullptr, unused);
  int hops = 0;
  cur = sibling_hop(a.t, cur, q, qlen, lane, hops);

  // ---- chain walk: hop 0 filters key >= query, later hops emit all ----
  const int M = a.max_items;
  int32_t* __restrict__ out_kid = a.out_kid + int64_t(b) * M;
  int32_t* __restrict__ out_val = a.out_val + int64_t(b) * M;
  int emitted = 0, rearr = 0;
  for (int hop = 0;; ++hop) {
    const int64_t lr = row_of(cur, a.t.LC);
    const bool dirty = a.leaf_ordered[lr] == 0;
    int32_t kid[kPerLane], val[kPerLane];
    bool occ[kPerLane], em[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int64_t at = lr * NS + 32 * k + lane;
      kid[k] = a.leaf_keyid[at];
      val[k] = a.leaf_val[at];
      occ[k] = a.leaf_occ[at] != 0;
    }
    const bool keys = hop == 0 || dirty;  // warp-uniform
    if (keys) {
      __syncwarp();  // every lane is done with the last leaf's rows
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        if (occ[k]) {
          const int kd = max(kid[k], 0);
          kids[32 * k + lane] = kd;
          lens[32 * k + lane] = a.t.key_lens[kd];
        }
      }
      __syncwarp();
      stage_rows<NS>(a.t.key_bytes, L, kids, ballot_mask<NS>(occ), rows, lane);
      __syncwarp();
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int s = 32 * k + lane;
      em[k] = occ[k] &&
              (hop > 0 || cmp3_bytes(rows + s * L, lens[s], qs, qlen, L) >= 0);
    }
    const SlotMask<NS> emm = ballot_mask<NS>(em);
    int n_emit = 0;
#pragma unroll
    for (int i = 0; i < SlotMask<NS>::kWords; ++i) n_emit += __popcll(emm.w[i]);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (!em[k]) continue;
      const int s = 32 * k + lane;
      const int p = emitted + (dirty ? rank_among<NS>(emm, rows, lens, s, L)
                                     : popc_below<NS>(emm, s));
      if (p < M) {
        out_kid[p] = kid[k];
        out_val[p] = val[k];
      }
    }
    emitted = min(emitted + n_emit, M);
    if (STATS) rearr += dirty;
    const int nx = a.t.leaf_next[lr];
    if (nx < 0 || emitted >= M) break;
    cur = nx;
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

template <int NS, bool STATS>
cudaError_t launch(const ScanArgs& a, cudaStream_t stream) {
  const int wpb = max(1, min(kMaxWarpsPerBlock, kSmemBudget / a.warp_smem));
  const int blocks = (a.B + wpb - 1) / wpb;
  fused_scan<NS, STATS><<<blocks, 32 * wpb, wpb * a.warp_smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NS>
cudaError_t launch_stats(const ScanArgs& a, bool stats, cudaStream_t s) {
  return stats ? launch<NS, true>(a, s) : launch<NS, false>(a, s);
}

}  // namespace fbt

// Plain C entry, bound with ctypes. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an ns the kernel is not built for or a
// key width whose rows do not fit the shared-memory budget). The caller
// allocates every output and keeps the inputs alive.
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
  if (a.warp_smem > fbt::kSmemBudget) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ns == 64) return fbt::launch_stats<64>(a, stats, s);
  if (ns == 128) return fbt::launch_stats<128>(a, stats, s);
  return cudaErrorInvalidValue;
}
