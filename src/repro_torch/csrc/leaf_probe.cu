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
// compare per slot: a streaming pass. The first body (a warp a query, one
// byte a lane, ~8 waves) ran at a third of the copy rate. The design: a
// group of G = NS / 16 lanes a query (8 queries a warp at NS 64, 4 at NS
// 128, ~1 wave at a batch of 65,536; 32-byte lanes measured slower, PERF.md
// §6); lane j loads the 16 tag and 16
// occupancy bytes of slots [16 j, 16 j + 16) as one vector each, compares
// them four bytes an instruction (slots.cuh: tag equal and occ nonzero),
// stores its 16 cand bytes as one vector, and packs its 16 flags; the
// group's mask comes from G shuffles (gather_group_masks), `first` is its
// lowest set bit (__ffsll, the paper's TZCNT) and `count` its popcount.
// Any B, no padding; tags, occ and cand are 16-byte aligned (the wrapper
// refuses others; a row is NS bytes, a multiple of 16).
#include <cuda_runtime.h>

#include <cstdint>

#include "attrs.cuh"
#include "slots.cuh"

namespace fbt {

constexpr int kProbeThreads = 256;
constexpr int kProbeLaneBytes = 16;  // slots a lane holds (uint4s a row)

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
__global__ void __launch_bounds__(kProbeThreads)
leaf_probe(const ProbeArgs a) {
  constexpr int W = kProbeLaneBytes, G = NS / W;
  const int lane = threadIdx.x & 31;
  const int j = lane & (G - 1);  // lane in the group
  const unsigned gmask = group_lanes<G>(lane);
  const int64_t b = (int64_t(blockIdx.x) * kProbeThreads + threadIdx.x) / G;
  if (b >= a.B) return;  // the whole group leaves together
  const int64_t off = b * NS + W * j;
  const uint32_t q4 = static_cast<uint32_t>(__ldg(a.qtag + b)) * 0x01010101u;
  uint4 t[W / 16], o[W / 16];
#pragma unroll
  for (int c = 0; c < W / 16; ++c) {
    t[c] = __ldg(reinterpret_cast<const uint4*>(a.tags + off) + c);
    o[c] = __ldg(reinterpret_cast<const uint4*>(a.occ + off) + c);
  }
  Packed<W> bits = 0;
#pragma unroll
  for (int c = 0; c < W / 16; ++c) {
    const uint32_t tw[4] = {t[c].x, t[c].y, t[c].z, t[c].w};
    const uint32_t ow[4] = {o[c].x, o[c].y, o[c].z, o[c].w};
    uint32_t cw[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t hi = eq_hi(tw[w], q4) & nonzero_hi(ow[w]);
      cw[w] = hi >> 7;  // 1 in each candidate byte
      bits |= Packed<W>(gather_hi4(hi)) << (16 * c + 4 * w);
    }
    reinterpret_cast<uint4*>(a.cand + off)[c] =
        make_uint4(cw[0], cw[1], cw[2], cw[3]);
  }
  SlotMask<NS> m, none;
  gather_group_masks<NS, W>(bits, gmask, m, none);
  if (j == 0) {
    int count = 0;
#pragma unroll
    for (int i = 0; i < SlotMask<NS>::kWords; ++i) count += __popcll(m.w[i]);
    a.first[b] = mask_first<NS>(m);
    a.count[b] = count;
  }
}

template <int NS>
const void* kernel_for_ns() {
  return reinterpret_cast<const void*>(&leaf_probe<NS>);
}

// The instantiation a launch at ns takes, or nullptr.
inline const void* kernel_for(int ns) {
  if (ns == 64) return kernel_for_ns<64>();
  if (ns == 128) return kernel_for_ns<128>();
  return nullptr;
}

}  // namespace fbt

// Plain C entry, bound with ctypes. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an ns the kernel is not built for). The
// caller allocates every output, keeps the inputs alive and hands 16-byte
// aligned tags, occ and cand.
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
  const void* fn = fbt::kernel_for(ns);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const int64_t threads = int64_t(B) * (ns / fbt::kProbeLaneBytes);
  const int blocks = static_cast<int>(
      (threads + fbt::kProbeThreads - 1) / fbt::kProbeThreads);
  void* args[] = {&a};
  cudaLaunchKernel(fn, dim3(blocks), dim3(fbt::kProbeThreads), args, 0,
                   static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// Lanes a query of the build for `ns` (32 / lanes = queries a warp).
extern "C" int fbt_leaf_probe_lanes(int ns) { return ns / fbt::kProbeLaneBytes; }

// What the instantiation a launch at ns takes asks of the card: out =
// {registers, local bytes, static shared bytes, dynamic shared bytes, blocks
// per SM} (attrs.cuh), plus out[5] = threads a block.
extern "C" int fbt_leaf_probe_attrs(int ns, int* out) {
  const void* fn = fbt::kernel_for(ns);
  if (fn == nullptr) return cudaErrorInvalidValue;
  out[5] = fbt::kProbeThreads;
  return fbt::kernel_attrs(fn, fbt::kProbeThreads, 0, out);
}
