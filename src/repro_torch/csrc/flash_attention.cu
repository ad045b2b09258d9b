// FlashAttention-2 forward for Hopper (sm_90a): out = softmax(q kᵀ · scale,
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
// q, k, v and out, 1,400 operations a byte. The design: a block per
// (batch·head, 64 query rows), the heaviest causal tiles first, and a loop
// over 64-key tiles of k and v staged in shared memory, tiles the mask rules
// out entirely skipped (exact: there p = 0 and the correction is 1). In
// bf16 (the served path) four warps own 16 query rows each and keep
// everything in registers, as FlashAttention-2 does: q as mma.sync A
// fragments, the 16x64 scores as m16n8k16 accumulators (float32 sums),
// the running max and sum per row (four lanes a row), p repacked in place
// as the A fragments of p·v, and the output accumulator; k and v fragments
// come from shared memory through ldmatrix (.trans for v), rows padded by
// 16 bytes so the eight rows of an ldmatrix hit distinct banks; the next
// live k and v tiles are copied in with cp.async while the current ones are
// computed (two buffers); tiles the mask keeps whole for a warp's rows skip
// the per-score mask test, and the softmax runs in base 2 (one exp2f a
// score; the rounding of s·scale·log2 e moves p by ~1e-6 relative, far
// below the bf16 rounding of p that follows). In float32 (the reference's
// tests) 256 threads run scalar FMAs from shared memory. Next for speed:
// wgmma on 64-row warpgroups fed by TMA, and fewer registers (178 at head
// dim 128) for a third block on each SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace fbt {
namespace fa {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kDMax = 128;     // largest head dim the kernel takes
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
  int vec_q, vec_k, vec_v;  // 16-byte loads allowed (bf16 only)
  float scale;
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

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

// rows [0, rows) of src (row stride sstride) into dst[64][ld], cols wide;
// rows [rows, 64) become zero, columns past cols are never written.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long sstride, int rows,
                                          int cols, bool vec) {
  if (vec) {  // bf16, cols % 8 == 0, every source row 16-byte aligned
    const int cpr = cols / 8;
    for (int i = threadIdx.x; i < 64 * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows)
        val = *reinterpret_cast<const uint4*>(src + r * sstride + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < 64 * cols; i += blockDim.x) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld + c] = r < rows ? src[r * sstride + c] : from_float<T>(0.f);
    }
  }
}

__device__ __forceinline__ void zero_smem(unsigned char* p, unsigned bytes) {
  for (unsigned i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// ================================================================== bf16

constexpr int kTcWarps = 4;    // 16 query rows each

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a · b, m16n8k16, bf16 inputs, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without a register round trip; full = false
// writes 16 zero bytes (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {  // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// load_rows for bf16 tiles of D columns (cols <= D of them data),
// asynchronous where rows allow 16-byte copies (vec), else the synchronous
// copy; the caller commits and waits
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long sstride, int rows,
                                           int cols, bool vec) {
  constexpr int LD = D + 8, CPR = D / 8;
  if (!vec) {
    load_rows<bf16>(dst, LD, src, sstride, rows, cols, false);
    return;
  }
  for (int i = threadIdx.x; i < 64 * CPR; i += blockDim.x) {
    const int r = i / CPR, c = (i % CPR) * 8;
    if (c >= cols) continue;
    const bool ok = r < rows;
    cp_async16(dst + r * LD + c, src + (ok ? r * sstride + c : 0), ok);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

template <int D>  // head dims padded (with zeros) to D, D in {32, 64, 128}
__global__ void __launch_bounds__(32 * kTcWarps)
flash_fwd_tc(const Args a) {
  constexpr int LD = D + 8;  // row pitch in bf16: 16 bytes of pad
  constexpr int TILE = kBK * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Kb = Qs + kBQ * LD;   // two k tiles, then two v tiles
  bf16* Vb = Kb + 2 * TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row / column pair
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - (bh / a.H) * a.H, kh = h / a.n_rep;
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, a.S - q0);
  const int q_last = q0 + q_rows - 1;
  const int n_kt = (a.kv_len + kBK - 1) / kBK;  // kv_len <= T
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
                   static_cast<long long>(q0) * a.q_ss;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + kh * a.v_sh;
  auto next_live = [&](int kt) {  // first tile >= kt the mask does not skip
    for (; kt < n_kt; ++kt)
      if (tile_live(a, q0, q_last, kt * kBK, min(kt * kBK + kBK, a.kv_len) - 1))
        break;
    return kt;
  };
  auto stage_tile = [&](int kt, int buf) {
    const int k0 = kt * kBK, rows = min(kBK, a.kv_len - k0);
    stage_rows<D>(Kb + buf * TILE, kg + k0 * a.k_st, a.k_st, rows, a.hd,
                  a.vec_k);
    stage_rows<D>(Vb + buf * TILE, vg + k0 * a.v_st, a.v_st, rows, a.hv,
                  a.vec_v);
  };

  zero_smem(smem, sizeof(bf16) * (kBQ + 4 * kBK) * LD);  // pad cols stay 0
  __syncthreads();
  // pipeline: the copy of tile n+1 is in flight while tile n is computed
  stage_rows<D>(Qs, qg, a.q_ss, q_rows, a.hd, a.vec_q);
  cp_async_commit();
  int kt = next_live(0), buf = 0;
  if (kt < n_kt) stage_tile(kt, 0);
  cp_async_commit();
  cp_async_wait_1();  // q is in
  __syncthreads();
  unsigned qf[D / 16][4];  // this warp's 16 q rows as A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                        (lane >> 4) * 8);

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};  // rows g and g + 8
  const int qr = q0 + warp * 16 + g;
  const float scale2 = a.scale * 1.4426950408889634f;  // · log2 e

  while (kt < n_kt) {
    const int k0 = kt * kBK;
    const int nxt = next_live(kt + 1);
    if (nxt < n_kt) stage_tile(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();  // tile kt is in
    __syncthreads();
    const bf16* Ks = Kb + buf * TILE;
    const bf16* Vs = Vb + buf * TILE;

    // s = q kᵀ: 8 accumulators of 16 rows x 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        unsigned kb[4];  // b0, b1 of keys np*16 + [0, 8) and of [8, 16)
        ldsm_x4(kb, Ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma(s[2 * np], qf[kk], kb[0], kb[1]);
        mma(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // mask and scale (masked scores -inf, so p is exactly 0 there), row max;
    // a tile the mask keeps whole for this warp's 16 rows skips the test
    const int k_last = k0 + kBK - 1, wq0 = q0 + warp * 16;
    const bool whole =
        k_last < a.kv_len &&
        (!a.causal || k_last < a.prefix_len ||
         (k_last <= wq0 && (!a.window || k0 > wq0 + 15 - a.window)));
    // scores in the base-2 domain (s·scale·log2 e) so each exponential is
    // one exp2f: exp(x - m) = exp2(x·log2 e - m·log2 e)
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + j * 8 + 2 * t4 + (e & 1);
        const bool ok = whole || key_valid(a, qr + (e >> 1) * 8, kj);
        s[j][e] = ok ? s[j][e] * scale2 : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);  // finite: m_r starts at kNeg
      corr[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_r[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
      l_r[r] = l_r[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= corr[0]; o[j][1] *= corr[0];
      o[j][2] *= corr[1]; o[j][3] *= corr[1];
    }

    // o += p v: p (rounded to bf16) repacked as A fragments, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const unsigned pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned vb[4];  // b0, b1 of dims dp*16 + [0, 8) and of [8, 16)
        ldsm_x4_t(vb, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          dp * 16 + (lane >> 4) * 8);
        mma(o[2 * dp], pa, vb[0], vb[1]);
        mma(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
    kt = nxt;
    buf ^= 1;
  }

  bf16* og = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qr + r * 8;
    if (qi >= a.S) continue;
    const float den = fmaxf(l_r[r], 1e-20f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = j * 8 + 2 * t4 + c;
        if (d < a.hv)
          og[qi * a.o_ss + d] = __float2bfloat16(o[j][2 * r + c] / den);
      }
  }
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
  load_rows<float>(Qs, L.ldq, qg, a.q_ss, q_rows, a.hd, false);

  // softmax state: four threads a row (sr), identical copies in each
  const int sr = tid >> 2, sub = tid & 3;
  float m_row = kNeg, l_row = 0.f;
  // this thread's outputs: rows tr + 16i, dims tc + 16j
  const int tr = tid >> 4, tc = tid & 15;
  float acc[4][kDMax / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDMax / 16; ++j) acc[i][j] = 0.f;

  const int n_kt = (a.kv_len + kBK - 1) / kBK;
  const int q_last = q0 + q_rows - 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const int k_rows = min(kBK, a.kv_len - k0);
    if (!tile_live(a, q0, q_last, k0, k0 + k_rows - 1)) continue;
    load_rows<float>(Ks, L.ldk, kg + k0 * a.k_st, a.k_st, k_rows, a.hd, false);
    load_rows<float>(Vs, L.ldv, vg + k0 * a.v_st, a.v_st, k_rows, a.hv, false);
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
        for (int j = 0; j < kDMax / 16; ++j) acc[i][j] *= cr[i];
      for (int c = 0; c < k_rows; ++c) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ss[(tr + 16 * i) * L.lds + c];
#pragma unroll
        for (int j = 0; j < kDMax / 16; ++j) {
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
    for (int j = 0; j < kDMax / 16; ++j) {
      const int d = tc + 16 * j;
      if (d < a.hv) og[r * a.o_ss + d] = acc[i][j] / den;
    }
  }
}

// ================================================================ launches

template <int D>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(bf16) * (kBQ + 4 * kBK) * (D + 8));
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.H);
  flash_fwd_tc<D><<<grid, 32 * kTcWarps, smem, stream>>>(a);
  return cudaGetLastError();
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

// Plain C entry, bound with ctypes. dtype 0 = float32, 1 = bfloat16. The
// caller checks shapes (S, T >= 1, B*H <= 65535, head dims <= 128,
// kv_len <= T), allocates the output and keeps every tensor alive. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// argument the kernel does not take).
extern "C" int fbt_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int n_rep, int S, int T, int hd, int hv, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_ss, int kv_len, int causal,
    int window, int prefix_len, int vec_q, int vec_k, int vec_v, float scale,
    void* stream) {
  using namespace fbt::fa;
  if (S < 1 || T < 1 || B < 1 || H < 1 || n_rep < 1 || H % n_rep != 0 ||
      B * H > 65535 || hd < 1 || hd > kDMax || hv < 1 || hv > kDMax ||
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
  a.vec_q = vec_q; a.vec_k = vec_k; a.vec_v = vec_v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(a, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  const int d = hd > hv ? hd : hv;
  if (d <= 32) return launch_tc<32>(a, s);
  if (d <= 64) return launch_tc<64>(a, s);
  return launch_tc<128>(a, s);
}
