// FlashAttention forward for Hopper (sm_90a): out = softmax(q kᵀ · scale,
// masked) v, one query row at a time, without the [S, T] logits in device
// memory.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (one pallas_call over (batch·heads, q blocks, kv blocks), body _kernel)
// and computes what its body computes: s = (q·kᵀ)·scale in float32; the
// mask kidx < kv_len and, when causal, kidx <= qidx, narrowed by the window
// (kidx > qidx - window) or widened by the prefix (kidx < prefix_len), q and
// k positions both from 0; a running max, sum and accumulator in float32;
// p rounded to v's type before the p·v product (p.astype(v.dtype)); the
// output acc / max(l, 1e-20) in q's type, so a row with no valid key is 0.
// Two things the TPU wrapper did go: kv is not repeated for GQA (query head
// h reads kv head h / n_rep, h in the (kv head, rep) order of ops.py), and S
// and T are not padded (the kernel masks its ragged edges). Every tensor is
// addressed through (batch, head, row) strides, so the caller's [B, S, H, d]
// layout is read and written in place.
//
// What bounds it: operations. At the served shape (S = T = 3072, 32 heads,
// head dim 128, causal) the two products are 77 GFLOP against 57 MB of
// q, k, v and out, 1,400 operations a byte, so the tensor cores' rate is
// the wall, and on Hopper only wgmma reaches it. Beside it the softmax's
// exp2 (one a score on the 16-a-clock special-function units) costs half
// the products' time, so it has to run while the tensor cores work.
//
// bf16 (the served path) follows FlashAttention-3's forward. The grid is
// persistent, one block an SM, and walks items of 128 query rows of one
// head, heaviest causal items first. A block is three warpgroups.
// - The producer warpgroup gives up its registers (setmaxnreg) and one of
//   its threads issues TMA loads: q into one of two buffers (one at q/k
//   head dims above 128, below), then each live
//   128-key tile of k and of v (64 at (256, 256)) into a ring of two stages, with a full and
//   an empty mbarrier for each buffer. The tensor maps are 4-D over the
//   caller's tensors, (dim, row, head, batch) with the caller's strides,
//   the kv head coordinate h / n_rep; boxes are 64 columns (128 bytes,
//   128-byte swizzle) by 128 rows (a k or v box of the (256, 256) build 64
//   rows), and TMA fills rows past S or T and columns past the head dim
//   with zeros, which pads head dims below 64, 128, 192 or 256 inside
//   shared memory.
// - Each consumer warpgroup (setmaxnreg 240) owns 64 of the item's rows.
//   s = q kᵀ is wgmma m64n128k16 with q and k K-major in shared memory;
//   the mask and the online softmax run on the float32 accumulator in
//   registers; p is rounded to bf16 pairs in place, which is the A-operand
//   layout of the next wgmma (the accumulator of an n8 column pair and the
//   A fragment of a k16 step hold the same (row, column) pairs), and
//   o += p v is wgmma m64nDk16 with A from registers and v read as a
//   transposed (MN-major) B operand. The p·v of tile i - 1 is issued with
//   the q kᵀ of tile i and runs while tile i's softmax does, and the two
//   warpgroups take turns to issue (named barriers), so one's softmax runs
//   beside the other's products. Keys past kv_len or T are masked like any
//   other (a zero key scores 0, not -inf).
// - Tiles the mask rules out for the item are never loaded; tiles it keeps
//   whole for a warp's 16 rows skip the per-score test, and the others
//   test each key against the row's bounds, computed once a tile.
// The body is built for q/k and v head dims padded to (DQK, DV) = (64, 64),
// (128, 128), (192, 128) or (256, 256); (192, 128) is MLA's (DeepSeek-V3:
// q/k 128 + 64 rotary, v 128), (256, 256) PaliGemma's. At (192, 128) two q
// buffers and two stages of k and v would need 263,264 bytes of shared
// memory, above the 232,448 a block may have, so that build keeps one q
// buffer (214,112 bytes): the next item's q loads once every warp is done
// with the last q kᵀ of the item before, while its last p·v runs. The
// accumulators are those of (128, 128): s and o 64 x 128 float32 a consumer
// warpgroup; q kᵀ takes 12 k16 steps, not 8. At (256, 256) a 128-key k and
// v tile is 128 KB, and beside a 64 KB q tile two stages of them would need
// 320 KB; o is 64 x 256 float32 a consumer warpgroup, 128 registers a
// thread. That build takes tiles of 64 keys (BK, a template parameter of
// the body): one q buffer and two stages of 32 KB k and 32 KB v tiles,
// 197,728 bytes; s is 64 x 64 (32 registers a thread, q kᵀ as 16 steps of
// m64n64k16) and o += p v one m64n256k16 a 16-key step, 4 a tile.
// In float32 (the reference's tests) 256 threads run scalar FMAs from shared
// memory, 64 query rows a block, q/k and v head dims up to 256 (215,296
// bytes of shared memory at 256).
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

namespace fbt {
namespace fa {

constexpr int kBQ = 64;        // float32: query rows a block
constexpr int kBK = 64;        // float32: keys a tile
constexpr int kDQkMax = 256;   // largest q/k head dim the kernel takes
constexpr int kDVMax = 256;    // largest v head dim the kernel takes
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

struct Args {
  const void* q;  // element (b, h, s, d) at b*q_sb + h*q_sh + s*q_ss + d
  const void* k;  // element (b, kh, t, d) likewise, kh = h / n_rep
  const void* v;
  void* o;        // element (b, h, s, d) at b*o_sb + h*o_sh + s*o_ss + d
  int B, H, n_rep, S, T, hd, hv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_ss;
  int kv_len, causal, window, prefix_len;
  float scale;
};

// the mask of one (query, key) pair, as the float32 body tests it
__device__ __forceinline__ bool key_valid(const Args& a, int qi, int kj) {
  if (kj >= a.kv_len) return false;
  if (!a.causal) return true;
  bool m = kj <= qi;
  if (a.window) m = m && (kj > qi - a.window);
  if (a.prefix_len) m = m || (kj < a.prefix_len);
  return m;
}

// True unless the mask rules out every (query, key) pair of the tile:
// queries [q0, q_last], keys [k0, k_last] (k_last < kv_len).
__device__ __forceinline__ bool tile_live(const Args& a, int q0, int q_last,
                                          int k0, int k_last) {
  if (!a.causal) return true;
  if (a.prefix_len && k0 < a.prefix_len) return true;
  if (k0 > q_last) return false;                          // all in the future
  if (a.window && k_last <= q0 - a.window) return false;  // all left of it
  return true;
}

// The first tile of bk keys from kt on that is live for queries
// [q0, q_last]; n_kt when there is none. The producer and the consumers
// walk the same tiles through it.
__device__ __forceinline__ int next_live(const Args& a, int q0, int q_last,
                                         int kt, int n_kt, int bk) {
  for (; kt < n_kt; ++kt)
    if (tile_live(a, q0, q_last, kt * bk, min(kt * bk + bk, a.kv_len) - 1))
      break;
  return kt;
}

// ================================================================== bf16

constexpr int kWBQ = 128;      // query rows a block: 64 a consumer warpgroup
constexpr int kWBK = 128;      // keys a tile (64 in the (256, 256) build)
constexpr int kStages = 2;     // k/v tiles in the ring
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kBox = 64;       // bf16 columns of one 128-byte swizzled row
constexpr long long kHangCycles = 1ll << 33;  // ~4 s: a lost phase traps

// q/k head dims padded (with zeros, by TMA) to DQK and v's to DV, (DQK, DV)
// in {(64, 64), (128, 128), (192, 128), (256, 256)}; BK keys a k/v tile
template <int DQK, int DV, int BK>
struct Smem {
  static constexpr int kQBufs = DQK > 128 ? 1 : 2;  // q buffers
  static constexpr int kQ = kWBQ * DQK * 2;  // q tile: DQK / 64 boxes of 128 rows
  static constexpr int kK = BK * DQK * 2;    // one k tile
  static constexpr int kV = BK * DV * 2;     // one v tile
  // 1024 bytes of slack to align the tiles (the 128-byte swizzle repeats
  // every 1024 bytes), q, the k ring, the v ring, then the mbarriers
  static constexpr int kBytes =
      1024 + kQBufs * kQ + kStages * (kK + kV) + 8 * (4 + 4 * kStages);
  // the q buffer of item round r, and the phase parity of its r-th use
  static __device__ __forceinline__ int qbuf(int r) {
    return kQBufs == 2 ? (r & 1) : 0;
  }
  static __device__ __forceinline__ uint32_t qlap(int r) {
    return kQBufs == 2 ? ((r >> 1) & 1) : (r & 1);
  }
};

// The mbarriers after the tiles: for each of two q buffers (the second
// unused where there is one) full and empty, then for each stage k full, v full, k empty, v empty. A full
// barrier completes when the producer's expected bytes have landed; an
// empty one when each of the 8 consumer warps has arrived. k and v have
// barriers of their own because a warpgroup is done with k_i before it is
// done with v_(i-1).
struct Bars {
  uint32_t base;
  __device__ uint32_t q_full(int i) const { return base + 16 * i; }
  __device__ uint32_t q_empty(int i) const { return base + 8 + 16 * i; }
  __device__ uint32_t k_full(int s) const { return base + 32 + 32 * s; }
  __device__ uint32_t v_full(int s) const { return base + 40 + 32 * s; }
  __device__ uint32_t k_empty(int s) const { return base + 48 + 32 * s; }
  __device__ uint32_t v_empty(int s) const { return base + 56 + 32 * s; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// arrive once and expect `bytes` more of TMA on the barrier's phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// kHangCycles traps (a launch failure the caller sees) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin == 0)
      t0 = clock64();
    else if (clock64() - t0 > kHangCycles)
      __trap();
  }
}

// one box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory, completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a tile with 128-byte swizzle (layout type 1, bits
// 62-63): start address >> 4 (bits 0-13), leading byte offset >> 4 (16-29),
// stride byte offset >> 4 (32-45), base offset 0 (every tile is 1024-byte
// aligned; a k16 step inside a swizzled row moves the start by 32 bytes).
__device__ __forceinline__ uint64_t sw128(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are in flight
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pin a register at this point of the program: wgmma reads and writes its
// operands asynchronously, so no access may move across the wait.
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

#define FBT_F8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, float32) = a · bᵀ (+ d when acc): a 64 x 16 and b 128 x 16
// bf16, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FBT_F8(0), FBT_F8(8), FBT_F8(16), FBT_F8(24), FBT_F8(32), FBT_F8(40),
        FBT_F8(48), FBT_F8(56)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 128) += a · b: a 64 x 16 bf16 from registers (four pairs a
// thread), b 16 x 128 bf16 MN-major in shared memory (transposed operand)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "1;\n}\n"
      : FBT_F8(0), FBT_F8(8), FBT_F8(16), FBT_F8(24), FBT_F8(32), FBT_F8(40),
        FBT_F8(48), FBT_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// the same with d 64 x 64
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FBT_F8(0), FBT_F8(8), FBT_F8(16), FBT_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x 64, float32) = a · bᵀ (+ d when acc): a 64 x 16 and b 64 x 16
// bf16, both K-major in shared memory (the (256, 256) build's q kᵀ)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FBT_F8(0), FBT_F8(8), FBT_F8(16), FBT_F8(24)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 256) += a · b: a 64 x 16 bf16 from registers, b 16 x 256 bf16
// MN-major in shared memory (the (256, 256) build's p·v)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, "
      "p, 1, 1, 1;\n}\n"
      : FBT_F8(0), FBT_F8(8), FBT_F8(16), FBT_F8(24), FBT_F8(32), FBT_F8(40),
        FBT_F8(48), FBT_F8(56), FBT_F8(64), FBT_F8(72), FBT_F8(80),
        FBT_F8(88), FBT_F8(96), FBT_F8(104), FBT_F8(112), FBT_F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

#undef FBT_F8

template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&o)[DV / 2], const uint32_t* p,
                                         uint64_t b) {
  if constexpr (DV == 256)
    wgmma_rs_n256(o, p, b);
  else if constexpr (DV == 128)
    wgmma_rs_n128(o, p, b);
  else
    wgmma_rs_n64(o, p, b);
}

// s = a · bᵀ over a tile of BK keys (s 64 x BK float32)
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 2], uint64_t a,
                                         uint64_t b, int acc) {
  if constexpr (BK == 128)
    wgmma_ss_n128(s, a, b, acc);
  else
    wgmma_ss_n64(s, a, b, acc);
}

// 2^x, one MUFU op (ex2.approx, relative error ~2^-22; ftz: results below
// 2^-126 become 0, far below the bf16 rounding of p that follows)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// o += p v over one k/v stage: 16 keys a step, p's pairs of keys
// 16kk + [0, 16) the A fragment of step kk, v read transposed (its 64-column
// boxes BK·128 bytes apart)
template <int DV, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2],
                                         const uint32_t (&p)[BK / 4],
                                         uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_pv<DV>(o, p + 4 * kk, sw128(vb + kk * 16 * 128, BK * 128, 1024));
  wg_commit();
}

// s = q kᵀ for one k stage: 64 rows x BK keys, DQK / 16 steps of k16, q
// and k K-major
template <int DQK, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t qa,
                                         uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk)
    wgmma_qk<BK>(
        s, sw128(qa + (kk >> 2) * kWBQ * 128 + (kk & 3) * 32, 16, 1024),
        sw128(kb + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16, 1024), kk > 0);
  wg_commit();
}

// The online softmax of one tile on the s accumulator of this thread's rows
// qr and qr + 8 (keys k0 + 8j + 2 t4 + c at s[4j + 2r + c]). It runs in
// base 2 on s·scale·log2 e, one exp2 a score: exp(x - m) = exp2(x·log2 e -
// m·log2 e). Masked scores become -inf (p exactly 0); a tile the mask keeps
// whole for the warp's 16 rows from rq0 skips the test, on a branch of its
// own (evaluated with predicates, the test would cost more than the rest of
// the softmax), and the others test each key against its row's bounds (a
// general per-pair test, inlined 64 times, doubled the kernel's code and
// registers). For scale > 0 the row max is taken on the raw scores and
// scaled once, and each p is one FFMA and one exp2; a negative scale scales
// every score first. Leaves p in s and the factor the accumulator must be
// scaled by in corr. BK keys a tile.
template <int BK>
__device__ __forceinline__ void softmax_tile(const Args& a, float (&s)[BK / 2],
                                             float (&m_r)[2], float (&l_r)[2],
                                             float (&corr)[2], int k0, int rq0,
                                             int qr, int t4, float scale2) {
  const int k_last = k0 + BK - 1;
  const bool whole =
      k_last < a.kv_len &&
      (!a.causal || k_last < a.prefix_len ||
       (k_last <= rq0 && (!a.window || k0 > rq0 + 15 - a.window)));
  const bool raw = scale2 > 0.f;  // max(s)·scale2 = max(s·scale2); -inf stays
  const float pre = raw ? 1.f : scale2;    // applied before the max
  const float post = raw ? scale2 : 1.f;   // applied in the exponent
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  if (whole && raw) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
  } else if (whole) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      s[j] *= scale2;
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
    }
  } else {
    // the keys row qr + 8r may see: [lo[r], hi[r]) and [0, pre_len)
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qr + 8 * r;
      hi[r] = a.causal ? min(qi + 1, a.kv_len) : a.kv_len;
      lo[r] = a.causal && a.window ? qi - a.window + 1 : 0;
    }
    const int pre_len = a.causal ? min(a.prefix_len, a.kv_len) : 0;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + j * 8 + 2 * t4 + (e & 1), r = e >> 1;
        float& x = s[4 * j + e];
        x = (kj >= lo[r] && kj < hi[r]) || kj < pre_len ? x * pre
                                                        : -CUDART_INF_F;
        mx[r] = fmaxf(mx[r], x);
      }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r] * post);  // finite: m_r starts at kNeg
    corr[r] = exp2f(m_r[r] - m_new);
    m_r[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    s[j] = ex2(fmaf(s[j], post, -m_r[(j >> 1) & 1]));
    sum[(j >> 1) & 1] += s[j];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
    sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
    l_r[r] = l_r[r] * corr[r] + sum[r];
  }
}

// The work of a launch: n_qt · B · H items of 128 query rows, heaviest
// causal first (item i is q tile n_qt - 1 - i / (B·H) of head i % (B·H);
// but see item_coords).
// The grid is persistent, one block an SM; in round r block j takes item
// r·G + j, or r·G + G - 1 - j on odd rounds (a snake, so no block gets the
// heaviest item of every round).
__device__ __forceinline__ int item_of(int r) {
  const int G = gridDim.x, j = blockIdx.x;
  return r * G + ((r & 1) ? G - 1 - j : j);
}

// The (batch·head, q tile) of item `it`. The (64, 64) and (128, 128) builds
// take the items heaviest causal first, as above, in a causal launch. The
// (192, 128) and (256, 256) builds, and a launch without the causal mask
// over more than one round of items whose k and v pass the L2
// (launch_build), take them head by head
// (item i is q tile n_qt - 1 - i % n_qt of head i / n_qt): MLA has a kv head for every query head, 128 of ~2 MB at
// 3,072 tokens, far past the 50 MB L2, so the items that read one head's k
// and v must run together for the L2 to serve them. Heaviest first runs
// every head's tile of one row each round, and every item then reads its k
// and v from device memory (~3 GB a call at 3,072 tokens, ~0.9 ms). The
// snake pairs the heavy tiles one block takes in a round with light ones
// in the next.
template <bool HEAD_MAJOR>
__device__ __forceinline__ void item_coords(int it, int BH, int n_qt, int& bh,
                                            int& qt) {
  if constexpr (HEAD_MAJOR) {
    bh = it / n_qt;
    qt = n_qt - 1 - (it - bh * n_qt);
  } else {
    bh = it % BH;
    qt = n_qt - 1 - it / BH;
  }
}

template <int DQK, int DV, int BK, bool HEAD_MAJOR>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Smem<DQK, DV, BK>;
  extern __shared__ unsigned char smem[];
  const uint32_t sq = (smem_u32(smem) + 1023u) & ~1023u;  // the q buffers
  const uint32_t sk = sq + L::kQBufs * L::kQ, sv = sk + kStages * L::kK;
  const Bars bar{sv + kStages * L::kV};

  const int BH = a.B * a.H, n_qt = (a.S + kWBQ - 1) / kWBQ;
  const int n_items = n_qt * BH;
  const int n_kt = (a.kv_len + BK - 1) / BK;  // kv_len <= T
  const int wg = threadIdx.x / 128;  // 0: producer, 1 and 2: consumers

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar.q_full(i), 1);   // the producer's expect_tx
      mbar_init(bar.q_empty(i), 8);  // one arrive a consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar.k_full(s), 1);
      mbar_init(bar.v_full(s), 1);
      mbar_init(bar.k_empty(s), 8);
      mbar_init(bar.v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int r = 0, it = item_of(0); it < n_items; it = item_of(++r)) {
        int bh, qt;
        item_coords<HEAD_MAJOR>(it, BH, n_qt, bh, qt);
        const int b = bh / a.H, h = bh - b * a.H, kh = h / a.n_rep;
        const int q0 = qt * kWBQ, q_last = min(q0 + kWBQ, a.S) - 1;
        const int qb = L::qbuf(r);  // the q buffer of this item
        mbar_wait(bar.q_empty(qb), L::qlap(r) ^ 1);  // first use passes
        mbar_expect_tx(bar.q_full(qb), L::kQ);
        for (int c = 0; c < DQK / kBox; ++c)
          tma_load(sq + qb * L::kQ + c * kWBQ * 128, &tq, bar.q_full(qb),
                   c * kBox, q0, h, b);
        for (int kt = next_live(a, q0, q_last, 0, n_kt, BK); kt < n_kt;
             kt = next_live(a, q0, q_last, kt + 1, n_kt, BK)) {
          mbar_wait(bar.k_empty(stage), phase ^ 1);  // the first lap passes
          mbar_expect_tx(bar.k_full(stage), L::kK);
          for (int c = 0; c < DQK / kBox; ++c)
            tma_load(sk + stage * L::kK + c * BK * 128, &tk,
                     bar.k_full(stage), c * kBox, kt * BK, kh, b);
          mbar_wait(bar.v_empty(stage), phase ^ 1);
          mbar_expect_tx(bar.v_full(stage), L::kV);
          for (int c = 0; c < DV / kBox; ++c)
            tma_load(sv + stage * L::kV + c * BK * 128, &tv, bar.v_full(stage),
                     c * kBox, kt * BK, kh, b);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  // FlashAttention-3's intra-warpgroup overlap: the p·v product of tile
  // i - 1 runs on the tensor cores while the softmax of tile i runs here.
  // The first tile is peeled off and the last p·v follows the loop, so
  // every product is issued and waited for on one path (a wgmma in flight
  // across a branch makes ptxas serialize them all). The two warpgroups
  // take turns to issue their products (named barriers 1 and 2), so one's
  // softmax runs beside the other's products.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;  // which 64 rows of the block
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;  // accumulator column pair
  const float scale2 = a.scale * 1.4426950408889634f;  // · log2 e
  auto arrive = [&](uint32_t b) {  // this warp is done with a buffer
    __syncwarp();
    if (lane == 0) mbar_arrive(b);
  };
  float o[DV / 2];  // m64nDV accumulator: (row, 8j + 2 t4 + c) at o[4j + 2r + c]
  float s[BK / 2], corr[2];
  uint32_t p[BK / 4];  // p of the previous tile in bf16 pairs: the A
                         // fragments of its p·v (key pairs 16kk + [0, 16))

  if (cw == 1) named_arrive(1);  // the first warpgroup issues first
  int stage = 0, phase = 0;
  for (int r = 0, it = item_of(0); it < n_items; it = item_of(++r)) {
    int bh, qt;
    item_coords<HEAD_MAJOR>(it, BH, n_qt, bh, qt);
    const int b = bh / a.H, h = bh - b * a.H;
    const int q0 = qt * kWBQ, q_last = min(q0 + kWBQ, a.S) - 1;
    const int rq0 = q0 + 64 * cw + 16 * warp;  // this warp's first row
    const int qr = rq0 + (lane >> 2);          // this thread's rows qr, qr + 8
    const int qb = L::qbuf(r);
    // this warpgroup's 64 rows of q, one 128-byte column box after another
    const uint32_t qa = sq + qb * L::kQ + cw * 64 * 128;
#pragma unroll
    for (int j = 0; j < DV / 2; ++j) o[j] = 0.f;
    float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};  // rows qr and qr + 8

    mbar_wait(bar.q_full(qb), L::qlap(r));
    int kt = next_live(a, q0, q_last, 0, n_kt, BK);
    if (kt < n_kt) {
      mbar_wait(bar.k_full(stage), phase);
      named_sync(1 + cw);
      wg_fence();
      issue_qk<DQK, BK>(s, qa, sk + stage * L::kK);
      named_arrive(1 + (cw ^ 1));
      wg_wait<0>();
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) pin(s[j]);
      arrive(bar.k_empty(stage));
      softmax_tile<BK>(a, s, m_r, l_r, corr, kt * BK, rq0, qr, t4, scale2);
#pragma unroll
      for (int j = 0; j < BK / 4; ++j)
        p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      for (kt = next_live(a, q0, q_last, kt + 1, n_kt, BK); kt < n_kt;
           kt = next_live(a, q0, q_last, kt + 1, n_kt, BK)) {
        const int prev = stage, prev_phase = phase;
        if (++stage == kStages) stage = 0, phase ^= 1;
        mbar_wait(bar.v_full(prev), prev_phase);
        mbar_wait(bar.k_full(stage), phase);
        named_sync(1 + cw);
        wg_fence();
        issue_qk<DQK, BK>(s, qa, sk + stage * L::kK);
        issue_pv<DV, BK>(o, p, sv + prev * L::kV);
        named_arrive(1 + (cw ^ 1));
        wg_wait<1>();  // s is in; the p·v may still run
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) pin(s[j]);
        arrive(bar.k_empty(stage));
        softmax_tile<BK>(a, s, m_r, l_r, corr, kt * BK, rq0, qr, t4, scale2);
        wg_wait<0>();  // the p·v is done: o and p are free
#pragma unroll
        for (int j = 0; j < DV / 2; ++j) pin(o[j]);
#pragma unroll
        for (int j = 0; j < BK / 4; ++j) pin(p[j]);
        arrive(bar.v_empty(prev));
#pragma unroll
        for (int j = 0; j < DV / 2; ++j) o[j] *= corr[(j >> 1) & 1];
#pragma unroll
        for (int j = 0; j < BK / 4; ++j)
          p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      }
      arrive(bar.q_empty(qb));  // every q kᵀ of the item is done
      mbar_wait(bar.v_full(stage), phase);  // the last tile's p·v
      named_sync(1 + cw);
      wg_fence();
      issue_pv<DV, BK>(o, p, sv + stage * L::kV);
      named_arrive(1 + (cw ^ 1));
      wg_wait<0>();
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) pin(o[j]);
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) pin(p[j]);
      arrive(bar.v_empty(stage));
      if (++stage == kStages) stage = 0, phase ^= 1;
    } else {
      arrive(bar.q_empty(qb));
    }

    bf16* og = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qi = qr + rr * 8;
      if (qi >= a.S) continue;  // rows past S are never stored
      // acc / max(l, 1e-20) as a product with the reciprocal: within an
      // f32 ulp of the quotient, far below the bf16 rounding that follows
      const float inv = 1.f / fmaxf(l_r[rr], 1e-20f);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int d = j * 8 + 2 * t4;  // hv is a multiple of 8: d + 1 < hv
        if (d < a.hv)
          *reinterpret_cast<__nv_bfloat162*>(og + qi * a.o_ss + d) =
              __floats2bfloat162_rn(o[4 * j + 2 * rr] * inv,
                                    o[4 * j + 2 * rr + 1] * inv);
      }
    }
  }
  if (cw == 0) named_sync(1);  // the second warpgroup's last arrive
}

// ================================================================= float32

constexpr int kF32Threads = 256;

struct F32Layout {
  int ldq, ldk, ldv, lds;
  unsigned off_k, off_v, off_s, off_corr, off_l, total;
};

__host__ __device__ inline unsigned align128(unsigned x) {
  return (x + 127u) & ~127u;
}

inline F32Layout f32_layout(int hd, int hv) {
  F32Layout L{};
  L.ldq = L.ldk = hd + 1;  // odd pitch: a column walk hits distinct banks
  L.ldv = hv + 1;
  L.lds = kBK + 4;
  unsigned off = align128(sizeof(float) * kBQ * L.ldq);
  L.off_k = off; off = align128(off + sizeof(float) * kBK * L.ldk);
  L.off_v = off; off = align128(off + sizeof(float) * kBK * L.ldv);
  L.off_s = off; off = align128(off + sizeof(float) * kBQ * L.lds);
  L.off_corr = off; off = align128(off + sizeof(float) * kBQ);
  L.off_l = off; off = align128(off + sizeof(float) * kBQ);
  L.total = off;
  return L;
}

// rows [0, rows) of src (row stride sstride) into dst[64][ld], cols wide;
// rows [rows, 64) become zero, columns past cols are never written.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long sstride, int rows,
                                          int cols) {
  for (int i = threadIdx.x; i < 64 * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    dst[r * ld + c] = r < rows ? src[r * sstride + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32(const Args a, const F32Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = reinterpret_cast<float*>(smem + L.off_k);
  float* Vs = reinterpret_cast<float*>(smem + L.off_v);
  float* Ss = reinterpret_cast<float*>(smem + L.off_s);
  float* corr_s = reinterpret_cast<float*>(smem + L.off_corr);
  float* l_s = reinterpret_cast<float*>(smem + L.off_l);

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - (bh / a.H) * a.H, kh = h / a.n_rep;
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, a.S - q0);
  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh +
                    static_cast<long long>(q0) * a.q_ss;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + kh * a.v_sh;
  load_rows(Qs, L.ldq, qg, a.q_ss, q_rows, a.hd);

  // softmax state: four threads a row (sr), identical copies in each
  const int sr = tid >> 2, sub = tid & 3;
  float m_row = kNeg, l_row = 0.f;
  // this thread's outputs: rows tr + 16i, dims tc + 16j
  const int tr = tid >> 4, tc = tid & 15;
  float acc[4][kDVMax / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDVMax / 16; ++j) acc[i][j] = 0.f;

  const int n_kt = (a.kv_len + kBK - 1) / kBK;
  const int q_last = q0 + q_rows - 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const int k_rows = min(kBK, a.kv_len - k0);
    if (!tile_live(a, q0, q_last, k0, k0 + k_rows - 1)) continue;
    load_rows(Ks, L.ldk, kg + k0 * a.k_st, a.k_st, k_rows, a.hd);
    load_rows(Vs, L.ldv, vg + k0 * a.v_st, a.v_st, k_rows, a.hv);
    __syncthreads();

    {  // Ss = q kᵀ (unscaled)
      float s[4][4] = {};
      for (int d = 0; d < a.hd; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * L.ldq + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * L.ldk + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ss[(tr + 16 * i) * L.lds + tc + 16 * j] = s[i][j];
    }
    __syncthreads();

    {  // online softmax over this tile, row sr; p overwrites Ss
      const int qi = q0 + sr;
      float sv[kBK / 4];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < kBK / 4; ++t) {
        const int c = sub + 4 * t;
        sv[t] = key_valid(a, qi, k0 + c) ? Ss[sr * L.lds + c] * a.scale
                                         : -CUDART_INF_F;
        mx = fmaxf(mx, sv[t]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m_row, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kBK / 4; ++t) {
        const float p = expf(sv[t] - m_new);
        sum += p;
        Ss[sr * L.lds + sub + 4 * t] = p;
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const float corr = expf(m_row - m_new);
      l_row = l_row * corr + sum;
      m_row = m_new;
      if (sub == 0) corr_s[sr] = corr;
    }
    __syncthreads();

    {  // acc = acc · corr + p v
      float cr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cr[i] = corr_s[tr + 16 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDVMax / 16; ++j) acc[i][j] *= cr[i];
      for (int c = 0; c < k_rows; ++c) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ss[(tr + 16 * i) * L.lds + c];
#pragma unroll
        for (int j = 0; j < kDVMax / 16; ++j) {
          const int d = tc + 16 * j;
          if (d < a.hv) {
            const float vv = Vs[c * L.ldv + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();  // before the next tile overwrites Ks, Vs, Ss
  }

  if (sub == 0) l_s[sr] = l_row;
  __syncthreads();
  float* og = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh +
              static_cast<long long>(q0) * a.o_ss;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (r >= q_rows) continue;
    const float den = fmaxf(l_s[r], 1e-20f);
#pragma unroll
    for (int j = 0; j < kDVMax / 16; ++j) {
      const int d = tc + 16 * j;
      if (d < a.hv) og[r * a.o_ss + d] = acc[i][j] / den;
    }
  }
}

// ================================================================ launches

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the library links no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map of a bf16 tensor whose element (b, h, r, c) lies at
// b*sb + h*sh + r*sr + c: dims (cols, rows, heads, batch), boxes of 64
// columns by `box_rows` rows with the 128-byte swizzle, zeros outside. A dim
// of extent 1 is never stepped along, so its stride is replaced by a valid
// one. False when TMA cannot describe the tensor (a base not 16-byte
// aligned, a stride not a multiple of 16 bytes).
inline bool make_map(CUtensorMap* map, const void* base, int cols, int rows,
                     int heads, int batch, long long sr, long long sh,
                     long long sb, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long row_bytes = 16 * ((2ll * cols + 15) / 16);
  auto bytes = [&](long long st, int n) { return n > 1 ? 2 * st : row_bytes; };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(bytes(sr, rows)),
      static_cast<cuuint64_t>(bytes(sh, heads)),
      static_cast<cuuint64_t>(bytes(sb, batch))};
  for (const cuuint64_t st : strides)
    if (st % 16 != 0) return false;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBox),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV, int BK, bool HEAD_MAJOR>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int Hk = a.H / a.n_rep;
  if (!make_map(&tq, a.q, a.hd, a.S, a.H, a.B, a.q_ss, a.q_sh, a.q_sb, kWBQ) ||
      !make_map(&tk, a.k, a.hd, a.T, Hk, a.B, a.k_st, a.k_sh, a.k_sb, BK) ||
      !make_map(&tv, a.v, a.hv, a.T, Hk, a.B, a.v_st, a.v_sh, a.v_sb, BK))
    return cudaErrorInvalidValue;
  constexpr int smem = Smem<DQK, DV, BK>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<DQK, DV, BK, HEAD_MAJOR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return e;
  const int items = a.B * a.H * ((a.S + kWBQ - 1) / kWBQ);
  flash_fwd_wgmma<DQK, DV, BK, HEAD_MAJOR>
      <<<items < sms ? items : sms, kThreads, smem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

// The item order of a launch (item_coords): head by head for q/k head dims
// above 128, and for a launch without the causal mask whose items take
// more than one round of the grid and whose heads' k and v together pass
// the L2: there all items weigh the same, and the order only decides what
// the L2 holds in a round (whisper's encoder, 32,768 frames: one kv head's
// k and v are 8 MB, 32 of them 256 MB, past the 50 MB L2; on an H100
// head by head took 19.8-20.4 ms a call where heaviest first took
// 22.0-22.7).
// Heaviest causal item first otherwise: with every item in one round
// (whisper's cross attention, 64 items) the order only places the items
// on the SMs, and head by head took 0.34-0.35 ms where the other order
// took 0.33; with every head's k and v in the L2 (yi-9b's 4 kv heads at
// 3,072 tokens, 6 MB, without a mask) head by head took 0.265 ms where
// the other order took 0.262.
template <int DQK, int DV, int BK>
cudaError_t launch_build(const Args& a, cudaStream_t stream) {
  if constexpr (DQK > 128) {
    return launch_wgmma<DQK, DV, BK, true>(a, stream);
  } else {
    int dev = 0, sms = 0, l2 = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev)) !=
            cudaSuccess)
      return e;
    const long long items = 1ll * a.B * a.H * ((a.S + kWBQ - 1) / kWBQ);
    const long long kv_bytes =
        2ll * a.B * (a.H / a.n_rep) * a.kv_len * (a.hd + a.hv);
    return a.causal || items <= sms || kv_bytes <= l2
               ? launch_wgmma<DQK, DV, BK, false>(a, stream)
               : launch_wgmma<DQK, DV, BK, true>(a, stream);
  }
}

inline cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const F32Layout L = f32_layout(a.hd, a.hv);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.H);
  flash_fwd_f32<<<grid, kF32Threads, L.total, stream>>>(a, L);
  return cudaGetLastError();
}

}  // namespace fa
}  // namespace fbt

// The bf16 build for q/k head dim hd and v head dim hv: the narrowest of
// (64, 64), (128, 128), (192, 128) and (256, 256) that holds both (hd <=
// 256, hv <= 256), with its keys a tile: 64 for (256, 256), 128 otherwise.
template <typename F>
inline auto with_build(int hd, int hv, F&& f) {
  using std::integral_constant;
  if (hd > 192 || hv > 128)
    return f(integral_constant<int, 256>{}, integral_constant<int, 256>{},
             integral_constant<int, 64>{});
  if (hd > 128) return f(integral_constant<int, 192>{},
                         integral_constant<int, 128>{},
                         integral_constant<int, fbt::fa::kWBK>{});
  if (hd > 64 || hv > 64) return f(integral_constant<int, 128>{},
                                   integral_constant<int, 128>{},
                                   integral_constant<int, fbt::fa::kWBK>{});
  return f(integral_constant<int, 64>{}, integral_constant<int, 64>{},
           integral_constant<int, fbt::fa::kWBK>{});
}

// Plain C entry, bound with ctypes. dtype 0 = float32, 1 = bfloat16. The
// caller checks shapes (S, T >= 1, B*H <= 65535, q/k and v head dims <= 256,
// kv_len <= T; for bf16 head dims a multiple of 8, bases 16-byte aligned and
// strides a multiple of 8 elements), allocates the output and keeps every
// tensor alive. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an argument the kernel does not take).
extern "C" int fbt_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int n_rep, int S, int T, int hd, int hv, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_ss, int kv_len, int causal,
    int window, int prefix_len, float scale, void* stream) {
  using namespace fbt::fa;
  if (S < 1 || T < 1 || B < 1 || H < 1 || n_rep < 1 || H % n_rep != 0 ||
      B * H > 65535 || hd < 1 || hd > kDQkMax || hv < 1 || hv > kDVMax ||
      kv_len < 0 || kv_len > T)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.B = B; a.H = H; a.n_rep = n_rep; a.S = S; a.T = T; a.hd = hd; a.hv = hv;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_st = k_st;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_st = v_st;
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.kv_len = kv_len; a.causal = causal; a.window = window;
  a.prefix_len = prefix_len; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(a, s);
  if (dtype != 1 || hd % 8 != 0 || hv % 8 != 0) return cudaErrorInvalidValue;
  return with_build(hd, hv, [&](auto dqk, auto dv, auto bk) {
    return launch_build<decltype(dqk)::value, decltype(dv)::value,
                        decltype(bk)::value>(a, s);
  });
}

// What the bf16 build for q/k head dim hd and v head dim hv (its causal
// launch's instantiation) asks of the card: registers a thread as compiled (before setmaxnreg moves them from
// the producer to the consumers), static and dynamic shared memory in
// bytes, and the blocks that fit on one SM. Returns a CUDA error code.
extern "C" int fbt_flash_attention_attrs(int hd, int hv, int* regs,
                                         int* static_smem, int* dyn_smem,
                                         int* blocks_per_sm) {
  using namespace fbt::fa;
  if (hd < 1 || hd > kDQkMax || hv < 1 || hv > kDVMax)
    return cudaErrorInvalidValue;
  const void* fn = nullptr;
  int dyn = 0;
  with_build(hd, hv, [&](auto dqk, auto dv, auto bk) {
    constexpr int Q = decltype(dqk)::value, V = decltype(dv)::value,
                  K = decltype(bk)::value;
    fn = reinterpret_cast<const void*>(flash_fwd_wgmma<Q, V, K, (Q > 128)>);
    dyn = Smem<Q, V, K>::kBytes;
    return 0;
  });
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dyn);
  if (e != cudaSuccess) return e;
  *regs = fa.numRegs;
  *static_smem = static_cast<int>(fa.sharedSizeBytes);
  *dyn_smem = dyn;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                       kThreads, dyn);
}
