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
// What bounds it: bytes. A query reads one feature row (NS bytes) per round
// it takes and writes 16 or 20 bytes; the work per row is two byte compares
// per slot. The design: one warp per query, running the shared round loop
// of feature_rounds.cuh (K1 and K2 run the same loop inside their descent):
// lane t owns slots t, t+32, ..., the equal and less-than masks are ballots,
// and the loop stops at the round that resolves the branch, so a resolved
// query reads no further rows. Any B: the warps past the batch leave at
// once; no padding to a tile.
#include <cuda_runtime.h>

#include <cstdint>

#include "feature_rounds.cuh"

namespace fbt {

constexpr int kBranchWarps = 8;

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

template <int NS, bool STATS>
__global__ void __launch_bounds__(32 * kBranchWarps)
feature_branch(const BranchArgs a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kBranchWarps + (threadIdx.x >> 5);
  if (b >= a.B) return;  // the whole warp leaves together
  const RoundsOut r = feature_compare_rounds<NS, STATS>(
      a.feats + int64_t(b) * a.fs * NS, a.fs, a.qfeat + int64_t(b) * a.fs,
      0, a.fs, a.knum[b], a.pcmp[b], lane);
  if (lane == 0) {
    a.idx[b] = r.idx;
    a.resolved[b] = r.resolved ? 1 : 0;
    a.run_lo[b] = r.run_lo;
    a.run_hi[b] = r.run_hi;
    if (STATS) a.rounds[b] = r.rounds;
  }
}

template <int NS, bool STATS>
cudaError_t launch_branch(const BranchArgs& a, cudaStream_t stream) {
  const int blocks = (a.B + kBranchWarps - 1) / kBranchWarps;
  feature_branch<NS, STATS><<<blocks, 32 * kBranchWarps, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace fbt

// Plain C entry, bound with ctypes. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an ns the kernel is not built for). The
// caller allocates every output and keeps the inputs alive.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ns == 64)
    return stats ? fbt::launch_branch<64, true>(a, s)
                 : fbt::launch_branch<64, false>(a, s);
  if (ns == 128)
    return stats ? fbt::launch_branch<128, true>(a, s)
                 : fbt::launch_branch<128, false>(a, s);
  return cudaErrorInvalidValue;
}
