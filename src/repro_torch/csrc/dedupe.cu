// Last-lane-wins dedupe of a write batch for Hopper (sm_90a): for each lane
// of a batch of B keys, whether no later lane holds the same key, and the
// number of lanes that lose.
//
// Replaces no TPU kernel. The JAX package resolves a write batch's
// duplicates with jnp.lexsort (repro/core/batch_ops.py::dedupe_last_wins),
// and the port's plain version chains stable sorts the same way
// (kernels/dedupe/ref.py): one argsort of the lengths and one a 4-byte word
// of the key, each with its gathers, ~234 launches and ~8 passes over the
// key batch for 4,194,304 lanes of 24 bytes. The write path uses none of
// that order, only the winners and their count, so this kernel was added
// for the write path's device time. Same outputs bit for bit: winners [B]
// bool (a lane wins when no later lane has the same L bytes and the same
// length) and conflicts, an int32 scalar, B - sum(winners).
//
// Design: a table of int32 lanes in device memory, its capacity a power of
// two of at least 2B (load <= 0.5 when every lane is distinct; 32 MB at
// 4,194,304 lanes, inside the 50 MB L2), probed linearly. Three launches:
//   fill     the table to -1, conflicts and the probe counter to 0;
//   insert   a thread a lane: hash the row (8-byte words where the width
//            and the base allow, else bytes) with its length; at an empty
//            entry CAS -1 -> lane; at an occupied one compare the full key
//            with the stored lane's (every lane an entry ever holds has the
//            entry's key) and if equal atomicMax the lane in, else probe on.
//            The lane's entry goes to entry[lane];
//   resolve  winners[i] = table[entry[i]] == i; each block counts its losers
//            and adds them into conflicts once.
// The full compare decides equality, so a hash collision costs a probe step
// and never an answer.
//
// What bounds it: bytes. The least it moves is the key batch read once and
// the winners written once, B (L + 5) bytes (0.036 ms at 3.35 TB/s for
// 4,194,304 lanes of 24 bytes). Beyond that it writes and reads the entry
// array (8 B), fills the table (4 cap bytes, in the L2), and reads a row
// again, at random in a batch twice the L2's size, for each occupied entry
// a lane meets: every duplicate lane's compare, 2.3M of ycsb-a's 4.2M lanes.
//
// Hot keys: under YCSB's scrambled zipfian the hottest key is ~4% of a
// batch, ~160k lanes on one entry. Threads take the lanes from the last
// down, so the first lane of a key to arrive is near its highest, and the
// later ones find a higher lane in place and skip the atomic: taken in
// lane order, the three passes took 1.9x as long (0.509 against 0.273 ms
// on ycsb-a's update batch; PERF.md §6). An entry is read with a plain
// load, which the SM's L1 may serve stale: a stale entry is -1 (the CAS
// then returns the truth) or a lower lane of the same key (an entry never
// changes key and only grows), so a stale read costs an atomic at most,
// never an answer. Measured and left out: grouping a warp's lanes of one
// hash (__match_any_sync) so that one lane probes for them (0.269 ms
// without, 0.273 with: the hottest key is ~1.3 lanes of a warp), and
// reading the entries past the L1 (__ldcg, 0.273).
#include <cuda_runtime.h>

#include <cstdint>

#include "attrs.cuh"

namespace fbt {

constexpr int kDedupeThreads = 256;
constexpr int kDedupeMaxBlocks = 2048;  // grid of the grid-stride passes
constexpr int32_t kNoLane = -1;

struct DedupeArgs {
  const uint8_t* qb;  // [B, L]
  const int32_t* ql;  // [B]
  int32_t* table;     // [cap], a power of two >= B
  int32_t* entry;     // [B] scratch: each lane's entry
  uint8_t* winners;   // [B] bool
  int32_t* conflicts;               // scalar
  unsigned long long* probes;       // scalar, or nullptr: not counted
  int64_t B;
  int64_t cap;
  int L;
};

__device__ __forceinline__ uint64_t fold(uint64_t h, uint64_t w) {
  h = (h ^ w) * 0x9E3779B97F4A7C15ull;
  return h ^ (h >> 32);
}

__device__ __forceinline__ uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xFF51AFD7ED558CCDull;
  k ^= k >> 33;
  k *= 0xC4CEB9FE1A85EC53ull;
  return k ^ (k >> 33);
}

// A row read as words of T: 8 or 1 bytes.
template <typename T>
__device__ __forceinline__ uint64_t fold_in(uint64_t h, T w) {
  return fold(h, static_cast<uint64_t>(w));
}

template <typename T>
__device__ __forceinline__ const T* row(const DedupeArgs& a, int32_t lane) {
  return reinterpret_cast<const T*>(a.qb + int64_t(lane) * a.L);
}

// Lanes x and y hold the same key: all L bytes and the length.
template <typename T>
__device__ __forceinline__ bool same_key(const DedupeArgs& a, int32_t x,
                                         int32_t y, int n) {
  if (a.ql[x] != a.ql[y]) return false;
  const T* rx = row<T>(a, x);
  const T* ry = row<T>(a, y);
  for (int k = 0; k < n; ++k)
    if (rx[k] != ry[k]) return false;
  return true;
}

// The block's sum of v, in thread 0. Every thread of the block calls it.
__device__ __forceinline__ unsigned long long block_sum(unsigned long long v) {
  __shared__ unsigned long long part[kDedupeThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  if (threadIdx.x == 0)
#pragma unroll
    for (int w = 0; w < kDedupeThreads / 32; ++w) v += part[w];
  return v;
}

__global__ void __launch_bounds__(kDedupeThreads)
dedupe_fill(const DedupeArgs a) {
  int4* t = reinterpret_cast<int4*>(a.table);
  const int64_t n4 = a.cap / 4;
  const int4 none = make_int4(kNoLane, kNoLane, kNoLane, kNoLane);
  for (int64_t i = int64_t(blockIdx.x) * kDedupeThreads + threadIdx.x; i < n4;
       i += int64_t(gridDim.x) * kDedupeThreads)
    t[i] = none;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.conflicts = 0;
    if (a.probes != nullptr) *a.probes = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kDedupeThreads)
dedupe_insert(const DedupeArgs a) {
  const int64_t t = int64_t(blockIdx.x) * kDedupeThreads + threadIdx.x;
  const uint32_t mask = static_cast<uint32_t>(a.cap - 1);
  unsigned long long stepped = 0;  // probe steps past the home entry
  if (t < a.B) {
    const int32_t lane = static_cast<int32_t>(a.B - 1 - t);  // last lane first
    const int n = a.L / static_cast<int>(sizeof(T));
    const T* r = row<T>(a, lane);
    uint64_t h = 0x243F6A8885A308D3ull;
    for (int k = 0; k < n; ++k) h = fold_in<T>(h, r[k]);
    h = fmix64(fold(h, static_cast<uint32_t>(a.ql[lane])));
    uint32_t s = static_cast<uint32_t>(h) & mask;
    for (;;) {
      int32_t v = a.table[s];
      if (v == kNoLane) {
        v = atomicCAS(a.table + s, kNoLane, lane);
        if (v == kNoLane) break;
      }
      if (same_key<T>(a, lane, v, n)) {
        if (v < lane) atomicMax(a.table + s, lane);
        break;
      }
      s = (s + 1) & mask;
      ++stepped;
    }
    a.entry[lane] = static_cast<int32_t>(s);
  }
  if (a.probes != nullptr) {
    const unsigned long long total = block_sum(stepped);
    if (threadIdx.x == 0 && total != 0) atomicAdd(a.probes, total);
  }
}

__global__ void __launch_bounds__(kDedupeThreads)
dedupe_resolve(const DedupeArgs a) {
  unsigned long long lost = 0;
  for (int64_t i = int64_t(blockIdx.x) * kDedupeThreads + threadIdx.x;
       i < a.B; i += int64_t(gridDim.x) * kDedupeThreads) {
    const bool win = a.table[a.entry[i]] == static_cast<int32_t>(i);
    a.winners[i] = win;
    lost += !win;
  }
  const unsigned long long total = block_sum(lost);
  if (threadIdx.x == 0 && total != 0)
    atomicAdd(a.conflicts, static_cast<int32_t>(total));
}

// The insert pass's instantiation for words of `word` bytes, or nullptr.
inline const void* insert_kernel_for(int word) {
  switch (word) {
    case 8:
      return reinterpret_cast<const void*>(&dedupe_insert<unsigned long long>);
    case 1: return reinterpret_cast<const void*>(&dedupe_insert<uint8_t>);
    default: return nullptr;
  }
}

inline int blocks_for(int64_t n, int64_t cap_blocks) {
  const int64_t b = (n + kDedupeThreads - 1) / kDedupeThreads;
  return static_cast<int>(b < 1 ? 1 : (b < cap_blocks ? b : cap_blocks));
}

}  // namespace fbt

// Plain C entry, bound with ctypes: the three launches on `stream`. Returns
// the first cudaGetLastError() that is not cudaSuccess
// (cudaErrorInvalidValue for a word size the kernel is not built for). The
// caller allocates table [cap] (16-byte aligned, cap a power of two >= B and
// >= 4), entry [B], winners [B] and the scalars, keeps the inputs alive, and
// hands a qb whose base and row width are multiples of `word`. `probes` may
// be null.
extern "C" int fbt_dedupe(const void* qb, const void* ql, void* table,
                          void* entry, void* winners, void* conflicts,
                          void* probes, long long B, int L, long long cap,
                          int word, void* stream) {
  fbt::DedupeArgs a;
  a.qb = static_cast<const uint8_t*>(qb);
  a.ql = static_cast<const int32_t*>(ql);
  a.table = static_cast<int32_t*>(table);
  a.entry = static_cast<int32_t*>(entry);
  a.winners = static_cast<uint8_t*>(winners);
  a.conflicts = static_cast<int32_t*>(conflicts);
  a.probes = static_cast<unsigned long long*>(probes);
  a.B = B;
  a.cap = cap;
  a.L = L;
  const void* insert = fbt::insert_kernel_for(word);
  if (insert == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&a};
  const dim3 threads(fbt::kDedupeThreads);
  cudaLaunchKernel(reinterpret_cast<const void*>(&fbt::dedupe_fill),
                   dim3(fbt::blocks_for(cap / 4, fbt::kDedupeMaxBlocks)),
                   threads, args, 0, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchKernel(insert, dim3(fbt::blocks_for(B, INT32_MAX)), threads, args,
                   0, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchKernel(reinterpret_cast<const void*>(&fbt::dedupe_resolve),
                   dim3(fbt::blocks_for(B, fbt::kDedupeMaxBlocks)), threads,
                   args, 0, s);
  return cudaGetLastError();
}

// What the insert pass at `word` asks of the card: out = {registers, local
// bytes, static shared bytes, dynamic shared bytes, blocks per SM}
// (attrs.cuh), plus out[5] = threads a block.
extern "C" int fbt_dedupe_attrs(int word, int* out) {
  const void* fn = fbt::insert_kernel_for(word);
  if (fn == nullptr) return cudaErrorInvalidValue;
  out[5] = fbt::kDedupeThreads;
  return fbt::kernel_attrs(fn, fbt::kDedupeThreads, 0, out);
}
