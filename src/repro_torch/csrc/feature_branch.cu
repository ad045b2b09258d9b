// Per-level feature-comparison kernel for Hopper (sm_90a): the feature
// rounds of one inner level for a batch of queries, each at its own node.
//
// Replaces repro/kernels/feature_branch/kernel.py::feature_branch_kernel
// (one pallas_call over query tiles, body _kernel), with the same outputs
// bit for bit: idx, resolved, run_lo, run_hi and, with STATS, rounds, each
// [B] int32 (the reference's [B, 1]).
//
// Inputs are the rows the caller gathered for each query
// (kernels/feature_branch/ops.py::branch_level_cuda): the node's feature
// block feats [B, fs, NS] u8, the query's bytes after the node's prefix
// qfeat [B, fs] u8 (0 past the key width), knum [B] and the prefix compare
// pcmp [B]. The prefix compare, the gathers and the suffix binary search
// stay outside, as in the reference.
//
// What bounds it: bytes. A query consumes one feature row (NS bytes) per
// round it takes and writes 16 or 20 bytes; the work per row is two byte
// compares per slot. What held the first body (a warp a query, one byte a
// lane, each row loaded when the round before failed to resolve) was
// latency: 65,536 warps ran in ~8 waves, each waiting 1 + ~1.8 dependent
// trips. The design (PERF.md §6 times the alternatives in turns):
// - a group of G = NS / kLaneBytes lanes a query (2 at NS 64, 4 at NS
//   128), so a warp serves 32 / G queries and a batch of 65,536 fits in
//   one wave (16- and 8-byte lanes measured slower);
// - one trip for what every query needs: knum, pcmp, the fs query bytes
//   and row 0 of the node's contiguous [fs, NS] block (kLaneBytes a lane,
//   16-byte vector loads, aligned because fs NS is a multiple of 64 and
//   the wrapper refuses an unaligned base); rows 1 .. fs - 1 together in a
//   second trip, only when round 0 does not resolve (loading the whole
//   block up front measured no faster: level at a full level, level or
//   slower at a trivial one); rows past kRegRows load as their round
//   comes;
// - the rounds then run from registers through the shared loop of
//   feature_rounds.cuh (rounds_over at G lanes a query, as K1 runs it
//   inside its descent; K2 at a warp a query), with byte-SIMD compares and
//   the group's masks gathered by shuffles (group_row_masks). The round
//   order, the early exit, the overrides and the rounds count are the
//   shared loop's.
// Any B: the groups past the batch leave at once; no padding to a tile.
#include <cuda_runtime.h>

#include <cstdint>

#include "attrs.cuh"
#include "feature_rounds.cuh"

namespace fbt {

constexpr int kBranchThreads = 256;
constexpr int kLaneBytes = 32;  // bytes of a row one lane holds (2 uint4)
constexpr int kRegRows = 8;     // rows held in registers

struct BranchArgs {
  const uint8_t* feats;  // [B, fs, NS]
  const uint8_t* qfeat;  // [B, fs]
  const int32_t* knum;   // [B]
  const int32_t* pcmp;   // [B]
  int32_t* idx;          // [B] outputs
  int32_t* resolved;
  int32_t* run_lo;
  int32_t* run_hi;
  int32_t* rounds;  // written only with STATS
  int B, fs;
};

// The lane's W bytes at p (16-byte aligned) as W / 4 little-endian words,
// in 16-byte vectors.
template <int W>
__device__ __forceinline__ void load_lane_bytes(const uint8_t* __restrict__ p,
                                                uint32_t (&v)[W / 4]) {
  static_assert(W % 16 == 0, "a lane holds whole 16-byte vectors of a row");
#pragma unroll
  for (int c = 0; c < W / 16; ++c) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + c);
    v[4 * c] = x.x, v[4 * c + 1] = x.y, v[4 * c + 2] = x.z,
    v[4 * c + 3] = x.w;
  }
}

// FS > 0: a build for fs == FS, whose round loop has a constant trip count
// (the compiler unrolls it, so a round's row is a register, not a pick).
// FS = 0: any other fs, rows 0 .. kRegRows - 1 in registers, later rows
// loaded as their round comes. A row is picked from the registers by mask,
// never by an indexed register array (which would live in local memory).
template <int NS, bool STATS, int FS>
__global__ void __launch_bounds__(kBranchThreads)
feature_branch(const BranchArgs a) {
  constexpr int W = kLaneBytes, G = NS / W, V = W / 4;
  constexpr int R = FS > 0 ? FS : kRegRows;
  const int lane = threadIdx.x & 31;
  const int j = lane & (G - 1);  // lane in the group
  const unsigned gmask = group_lanes<G>(lane);
  const int64_t b =
      (int64_t(blockIdx.x) * kBranchThreads + threadIdx.x) / G;
  if (b >= a.B) return;  // the whole group leaves together
  const int fs = FS > 0 ? FS : a.fs;
  const uint8_t* __restrict__ blk = a.feats + b * fs * NS + W * j;
  const uint8_t* __restrict__ q = a.qfeat + b * fs;

  // one trip: the node's scalars, the query's bytes and row 0
  const int knum = __ldg(a.knum + b), pcmp = __ldg(a.pcmp + b);
  uint32_t rows[R][V];
  int qv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    qv[r] = r < fs ? int(__ldg(q + r)) : 0;
#pragma unroll
    for (int w = 0; w < V; ++w) rows[r][w] = 0;
  }
  if (fs > 0) load_lane_bytes<W>(blk, rows[0]);

  const RoundsOut out = rounds_over<NS, STATS, G>(
      [&](int fid, uint32_t (&v)[V]) {
        if (fid == 1) {  // round 0 did not resolve: the other rows, together
#pragma unroll
          for (int r = 1; r < R; ++r)
            if (r < fs) load_lane_bytes<W>(blk + r * NS, rows[r]);
        }
        if (FS > 0 || fid < R) {
#pragma unroll
          for (int w = 0; w < V; ++w) {
            uint32_t x = 0;
#pragma unroll
            for (int r = 0; r < R; ++r) x |= rows[r][w] & (0u - (fid == r));
            v[w] = x;
          }
        } else {
          load_lane_bytes<W>(blk + fid * NS, v);
        }
      },
      [&](int fid) {
        return FS > 0 || fid < R ? pick(qv, fid) : int(__ldg(q + fid));
      },
      fs, knum, pcmp, gmask);
  if (j == 0) {
    a.idx[b] = out.idx;
    a.resolved[b] = out.resolved ? 1 : 0;
    a.run_lo[b] = out.run_lo;
    a.run_hi[b] = out.run_hi;
    if (STATS) a.rounds[b] = out.rounds;
  }
}

template <int NS, bool STATS>
const void* kernel_for_fs(int fs) {
  switch (fs) {
    case 1: return reinterpret_cast<const void*>(&feature_branch<NS, STATS, 1>);
    case 2: return reinterpret_cast<const void*>(&feature_branch<NS, STATS, 2>);
    case 4: return reinterpret_cast<const void*>(&feature_branch<NS, STATS, 4>);
    case 8: return reinterpret_cast<const void*>(&feature_branch<NS, STATS, 8>);
    default: return reinterpret_cast<const void*>(&feature_branch<NS, STATS, 0>);
  }
}

// The instantiation a launch at (ns, fs, stats) takes, or nullptr.
inline const void* kernel_for(int ns, int fs, int stats) {
  if (fs < 0) return nullptr;
  if (ns == 64) return stats ? kernel_for_fs<64, true>(fs) : kernel_for_fs<64, false>(fs);
  if (ns == 128) return stats ? kernel_for_fs<128, true>(fs) : kernel_for_fs<128, false>(fs);
  return nullptr;
}

}  // namespace fbt

// Plain C entry, bound with ctypes. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an ns or fs the kernel is not built
// for). The caller allocates every output, keeps the inputs alive and
// hands a 16-byte aligned feats.
extern "C" int fbt_feature_branch(const void* feats, const void* qfeat,
                                  const void* knum, const void* pcmp,
                                  void* idx, void* resolved, void* run_lo,
                                  void* run_hi, void* rounds, int B, int fs,
                                  int ns, int stats, void* stream) {
  fbt::BranchArgs a;
  a.feats = static_cast<const uint8_t*>(feats);
  a.qfeat = static_cast<const uint8_t*>(qfeat);
  a.knum = static_cast<const int32_t*>(knum);
  a.pcmp = static_cast<const int32_t*>(pcmp);
  a.idx = static_cast<int32_t*>(idx);
  a.resolved = static_cast<int32_t*>(resolved);
  a.run_lo = static_cast<int32_t*>(run_lo);
  a.run_hi = static_cast<int32_t*>(run_hi);
  a.rounds = static_cast<int32_t*>(rounds);
  a.B = B;
  a.fs = fs;
  const void* fn = fbt::kernel_for(ns, fs, stats);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const int64_t threads = int64_t(B) * (ns / fbt::kLaneBytes);
  const int blocks = static_cast<int>(
      (threads + fbt::kBranchThreads - 1) / fbt::kBranchThreads);
  void* args[] = {&a};
  cudaLaunchKernel(fn, dim3(blocks), dim3(fbt::kBranchThreads), args, 0,
                   static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// Lanes a query of the build for `ns` (32 / lanes = queries a warp).
extern "C" int fbt_feature_branch_lanes(int ns) { return ns / fbt::kLaneBytes; }

// What the instantiation a launch at (ns, fs, stats) takes asks of the
// card: out = {registers, local bytes, static shared bytes, dynamic shared
// bytes, blocks per SM} (attrs.cuh), plus out[5] = threads a block.
extern "C" int fbt_feature_branch_attrs(int ns, int fs, int stats, int* out) {
  const void* fn = fbt::kernel_for(ns, fs, stats);
  if (fn == nullptr) return cudaErrorInvalidValue;
  out[5] = fbt::kBranchThreads;
  return fbt::kernel_attrs(fn, fbt::kBranchThreads, 0, out);
}
