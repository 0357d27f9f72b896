// Flash-attention forward for Hopper (sm_90a) on the tensor cores: bf16 q,
// k, v at head dims 64 and 128, the dtype and widths of the prefill path.
//
// Replaces, with flash_attention.cu (which keeps f32 and bf16 at D=32), the
// TPU Pallas kernel in src/repro/kernels/flash_attention/kernel.py:
//   _flash_kernel / flash_attention_bhsd -> valve_flash_attention_sm90 (K5)
//
// Semantics, as flash_attention.cu: causal masking is top-left aligned,
// q_pos >= k_pos with both positions counted from 0, also when Sq != Skv;
// keys at or past skv are masked; a masked score is -1e30 (finite); the
// scale is applied after the dot; query head h reads kv head h / (Hq / Hkv);
// q (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D) are read in place.
//
// Numerics: S = Q K^T accumulates exact bf16 products in f32 (wgmma); the
// online softmax runs in f32 in base 2 (scale * log2 e folded into the
// scores after the dot).  For O += P V the tensor cores take P in bf16:
// rounding P to bf16 is what the JAX package's plain attention does to its
// probabilities (src/repro_torch/models/common.py notes it; the JAX Pallas
// kernel keeps P in f32).  Rounded alone, P moves the output by up to
// 2^-9 |v| a key, which at rows with few keys breaks the port's rule
// |out - ref| <= 1e-3 + 2^-7 |ref| against its f32-P plain version (a
// plain model of this kernel reaches 1.45x the rule at B=2, S=4096).  So the
// residual p - bf16(p), rounded to bf16 too, goes through a second product
// with the same V tile: P reaches V to ~2^-16.  l sums the unrounded f32 p;
// 1/l and the output's bf16 rounding happen once, at the end.
//
// What bounds it: operations.  At qwen3-0.6b's prefill widths (D=128)
// 4 * D flops per causal (q, k) pair against 4 bytes per token and head
// moved: ~1370 flop per byte at S=4096, far above the ~295 at which the
// bf16 tensor cores (989 TFLOP/s) become the limit.  The residual product
// adds half again to the tensor work.
//
// Design:
// - A CTA owns 128 query rows of one (b, h): two consumer warpgroups of 64
//   rows, and a producer warpgroup of which one thread issues the TMA loads;
//   setmaxnreg moves registers from the producer (24) to the consumers
//   (240).
// - Q is loaded once by TMA.  K and V tiles of 128 keys arrive by TMA in a
//   two-stage ring in shared memory (Q 32 KB + 2 x (K 32 KB + V 32 KB) at
//   D=128), each stage tracked by mbarriers: K full, V full (so S = Q K^T
//   starts before V lands) and empty (every consumer thread arrives after
//   its last product on the stage).
// - The tensor maps are 4-D (D, heads, seq, batch) over the model layout:
//   TMA zero-fills rows past Sq or Skv within each batch (the JAX kernel
//   pads instead) and masking decides their scores.  128-byte swizzle; a
//   box's inner extent is 64 bf16, so D=128 takes two boxes per tile.  The
//   maps are encoded on the host with cuTensorMapEncodeTiled, reached
//   through the runtime's driver entry point (no -lcuda), and passed as
//   __grid_constant__ parameters.
// - S = Q K^T: wgmma m64n128k16, both operands in shared memory (K-major).
// - The row max of the online softmax is reduced over the 4 threads of a
//   row's quad in the accumulator layout; l over the quad once at the end.
// - O += P V: P (then its residual) is the register A operand, which is the
//   S accumulator's own layout; V is the shared-memory B operand read
//   MN-major through the transpose bit, so V needs no transposed copy.
// - Causal: key tiles above the diagonal are never loaded; only a CTA's
//   last tile (the diagonal one, or the one that holds skv) is masked
//   elementwise; the longest causal rows launch first.
// - The output is normalised, rounded and stored once, from the
//   accumulator layout.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"

namespace {

constexpr int kBlockM = 128;      // query rows per CTA (two warpgroups of 64)
constexpr int kBlockN = 128;      // keys per K/V tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kConsumers = 256;   // threads of the two consumer warpgroups
constexpr int kThreads = 384;     // + the producer warpgroup
constexpr int kRowBytes = 128;    // one swizzled row: 64 bf16
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout (byte offsets from a 1024-byte aligned base, which
// the 128-byte swizzle needs).  A tile of R rows is D / 64 column halves of
// R swizzled 128-byte rows each.
template <int D>
struct Layout {
  static constexpr int kHalves = D / 64;
  static constexpr uint32_t kQBytes = kBlockM * D * 2;
  static constexpr uint32_t kTileBytes = kBlockN * D * 2;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBars = kV + kStages * kTileBytes;   // q, k[], v[], empty[]
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

// One TMA box of a 4-D map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S (+)= A . B: A (64 x 16) and B (16 x 128) both from shared memory,
// both K-major; accumulate = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// O += A . B: A (64 x 16) from registers (four bf16 pairs a thread, laid out
// as the f32 accumulator), B (16 x 128) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// O += A . B: A (64 x 16) from registers (four bf16 pairs a thread, laid out
// as the f32 accumulator), B (16 x 64) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a, uint64_t desc_v) {
  if constexpr (D == 128) wgmma_rs_n128(o, a, desc_v);
  else wgmma_rs_n64(o, a, desc_v);
}

// Grid (ceil(Sq / 128), B * Hq), 384 threads.  out: (B, Sq, Hq, D) bf16.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out, int sq,
                  int skv, int hq, int hkv, int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base + L::kQ, bars = base + L::kBars;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto k_tile = [&](int s) { return base + L::kK + s * L::kTileBytes; };
  auto v_tile = [&](int s) { return base + L::kV + s * L::kTileBytes; };

  const int iq = gridDim.x - 1 - blockIdx.x;    // the longest causal rows first
  const int b = blockIdx.y / hq, h = blockIdx.y - b * hq;
  const int hk = h / (hq / hkv);
  const int q0 = iq * kBlockM;
  int n_tiles = (skv + kBlockN - 1) / kBlockN;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kBlockN + 1);   // none above the diagonal
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                      // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int hf = 0; hf < L::kHalves; ++hf)
        tma_load(q_smem + hf * kBlockM * kRowBytes, &q_map, q_full, 64 * hf, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
        mbar_expect_tx(k_full(s), L::kTileBytes);
        for (int hf = 0; hf < L::kHalves; ++hf)
          tma_load(k_tile(s) + hf * kBlockN * kRowBytes, &k_map, k_full(s), 64 * hf, hk,
                   it * kBlockN, b);
        mbar_expect_tx(v_full(s), L::kTileBytes);
        for (int hf = 0; hf < L::kHalves; ++hf)
          tma_load(v_tile(s) + hf * kBlockN * kRowBytes, &v_map, v_full(s), 64 * hf, hk,
                   it * kBlockN, b);
      }
    }
  } else {                                      // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128, warp = (tid & 127) >> 5, lane = tid & 31;
    // this thread's rows of the accumulator layout: row and row + 8
    const int qa = q0 + wg * 64 + warp * 16 + (lane >> 2), qb = qa + 8;
    const int col0 = 2 * (lane & 3);
    const float scale2 = scale * kLog2e;
    const uint32_t q_wg = q_smem + wg * 64 * kRowBytes;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t phase = (it / kStages) & 1;
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      mbar_wait(k_full(s), phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)          // 16 of D a step; 4 steps a half
        wgmma_ss_n128(sc,
                      smem_desc(q_wg + (kk / 4) * kBlockM * kRowBytes + (kk % 4) * 32, 16, 1024),
                      smem_desc(k_tile(s) + (kk / 4) * kBlockN * kRowBytes + (kk % 4) * 32, 16, 1024),
                      kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale into base 2, mask the last tile, one online-softmax step
      const bool edge = it == n_tiles - 1;
      const int k0 = it * kBlockN;
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float x = sc[i] * scale2;
        if (edge) {
          const int kp = k0 + 8 * (i / 4) + col0 + (i & 1);
          const int qp = (i & 2) ? qb : qa;
          if (kp >= skv || (causal && kp > qp)) x = kNegInf;
        }
        sc[i] = x;
        if (i & 2) mx_b = fmaxf(mx_b, x);
        else mx_a = fmaxf(mx_a, x);
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
      const float alpha_a = ex2(m_a - mn_a), alpha_b = ex2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
      uint32_t p_hi[32], p_lo[32];
#pragma unroll
      for (int u = 0; u < 32; ++u) {             // elements 2u, 2u + 1: one row, two columns
        const float mrow = (u & 1) ? mn_b : mn_a;
        const float p0 = ex2(sc[2 * u] - mrow), p1 = ex2(sc[2 * u + 1] - mrow);
        if (u & 1) sum_b += p0 + p1;
        else sum_a += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[u] = bf16_bits(hi);
        p_lo[u] = bf16_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? alpha_b : alpha_a;

      mbar_wait(v_full(s), phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)    // 16 keys a step
        wgmma_pv<D>(o, p_hi + 4 * kk, smem_desc(v_tile(s) + kk * 16 * kRowBytes, kBlockN * kRowBytes, 1024));
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_pv<D>(o, p_lo + 4 * kk, smem_desc(v_tile(s) + kk * 16 * kRowBytes, kBlockN * kRowBytes, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty(s));                     // this thread is done with stage s
    }

    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a), inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
    const size_t q_step = static_cast<size_t>(hq) * D;
    __nv_bfloat16* out_a = out + (static_cast<size_t>(b) * sq + qa) * q_step + static_cast<size_t>(h) * D;
    __nv_bfloat16* out_b = out_a + 8 * q_step;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + col0;
      if (qa < sq)
        *reinterpret_cast<__nv_bfloat162*>(out_a + c) = __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      if (qb < sq)
        *reinterpret_cast<__nv_bfloat162*>(out_b + c) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
  }
}

// A 4-D map (D, heads, seq, batch) over a contiguous (batch, seq, heads, D)
// bf16 tensor; boxes of 64 columns x `rows` positions of one head, 128-byte
// swizzle, out-of-bounds rows read as zeros.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int batch, int seq, int heads, int d,
            int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {2ull * d, 2ull * d * heads, 2ull * d * heads * seq};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch, int sq, int skv,
                   int hq, int hkv, int causal, float scale, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap q_map, k_map, v_map;
  if (!encode(fn, &q_map, q, batch, sq, hq, D, kBlockM) ||
      !encode(fn, &k_map, k, batch, skv, hkv, D, kBlockN) ||
      !encode(fn, &v_map, v, batch, skv, hkv, D, kBlockN))
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(Layout<D>::kBytes);
  const cudaError_t err = cudaFuncSetAttribute(flash_sm90_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, batch * hq);
  flash_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(q_map, k_map, v_map,
                                                         static_cast<__nv_bfloat16*>(out), sq, skv,
                                                         hq, hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 q/k/v/out, d in {64, 128}, hq % hkv == 0, 16-byte aligned tensors.
extern "C" int valve_flash_attention_sm90(const void* q, const void* k, const void* v, void* out,
                                          int batch, int sq, int skv, int hq, int hkv, int d,
                                          int causal, float scale, void* stream) {
  if (batch == 0 || sq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 64) err = launch<64>(q, k, v, out, batch, sq, skv, hq, hkv, causal, scale, st);
  if (d == 128) err = launch<128>(q, k, v, out, batch, sq, skv, hq, hkv, causal, scale, st);
  return static_cast<int>(err);
}
