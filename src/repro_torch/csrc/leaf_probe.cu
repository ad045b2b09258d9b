// Hashtag leaf-filter kernel for Hopper (sm_90a): for a batch of queries,
// each with the tag and occupancy rows of its leaf, the candidate slots
// (tags == qtag) & occ, the first candidate and the number of candidates.
//
// Replaces repro/kernels/leaf_probe/kernel.py::leaf_probe_kernel (one
// pallas_call over query tiles, body _kernel), with the same outputs bit
// for bit: cand [B, NS] u8 (0/1), first [B] int32 (NS when there is no
// candidate) and count [B] int32 (the reference's [B, 1]). The full-key
// verification of the candidates stays outside, as in the reference
// (core/leaf.py::verify_candidates).
//
// What bounds it: bytes. It reads 2 bytes a slot and writes 1, with one
// compare per slot. The design: one warp per query, lane t owns slots t,
// t+32, ...; the candidate set is a ballot mask (the paper's AVX-512
// compare mask), `first` is __ffsll of it and `count` its __popcll (the
// TZCNT and POPCNT of the paper's probe). Any B, no padding.
#include <cuda_runtime.h>

#include <cstdint>

namespace fbt {

constexpr int kProbeWarps = 8;
constexpr unsigned kProbeMask = 0xffffffffu;

struct ProbeArgs {
  const uint8_t* tags;  // [B, NS]
  const uint8_t* occ;   // [B, NS] bool (one byte, 0 or 1)
  const uint8_t* qtag;  // [B]
  uint8_t* cand;        // [B, NS] outputs
  int32_t* first;       // [B]
  int32_t* count;       // [B]
  int B;
};

template <int NS>
__global__ void __launch_bounds__(32 * kProbeWarps)
leaf_probe(const ProbeArgs a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kProbeWarps + (threadIdx.x >> 5);
  if (b >= a.B) return;  // the whole warp leaves together
  const int64_t row = int64_t(b) * NS;
  const uint8_t qt = a.qtag[b];
  int first = NS, count = 0;
#pragma unroll
  for (int i = NS / 64 - 1; i >= 0; --i) {  // high words first: first = lowest
    const int s0 = 64 * i + lane, s1 = s0 + 32;
    const bool c0 = a.occ[row + s0] != 0 && a.tags[row + s0] == qt;
    const bool c1 = a.occ[row + s1] != 0 && a.tags[row + s1] == qt;
    a.cand[row + s0] = c0 ? 1 : 0;
    a.cand[row + s1] = c1 ? 1 : 0;
    const unsigned long long m =
        static_cast<unsigned long long>(__ballot_sync(kProbeMask, c0)) |
        (static_cast<unsigned long long>(__ballot_sync(kProbeMask, c1)) << 32);
    if (m) first = 64 * i + __ffsll(static_cast<long long>(m)) - 1;
    count += __popcll(m);
  }
  if (lane == 0) {
    a.first[b] = first;
    a.count[b] = count;
  }
}

template <int NS>
cudaError_t launch_probe(const ProbeArgs& a, cudaStream_t stream) {
  const int blocks = (a.B + kProbeWarps - 1) / kProbeWarps;
  leaf_probe<NS><<<blocks, 32 * kProbeWarps, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace fbt

// Plain C entry, bound with ctypes. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an ns the kernel is not built for). The
// caller allocates every output and keeps the inputs alive.
extern "C" int fbt_leaf_probe(const void* tags, const void* occ,
                              const void* qtag, void* cand, void* first,
                              void* count, int B, int ns, void* stream) {
  fbt::ProbeArgs a;
  a.tags = static_cast<const uint8_t*>(tags);
  a.occ = static_cast<const uint8_t*>(occ);
  a.qtag = static_cast<const uint8_t*>(qtag);
  a.cand = static_cast<uint8_t*>(cand);
  a.first = static_cast<int32_t*>(first);
  a.count = static_cast<int32_t*>(count);
  a.B = B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ns == 64) return fbt::launch_probe<64>(a, s);
  if (ns == 128) return fbt::launch_probe<128>(a, s);
  return cudaErrorInvalidValue;
}
