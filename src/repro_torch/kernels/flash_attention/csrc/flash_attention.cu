// Flash-attention forward for Hopper (sm_90a): whole-prompt prefill.
//
// Replaces the TPU Pallas kernel in src/repro/kernels/flash_attention/kernel.py:
//   _flash_kernel / flash_attention_bhsd   -> valve_flash_attention   (K5)
//
// Computes, per query row, softmax(q . K^T * scale) . V over the keys of kv
// head h // group, in f32: scores, the online softmax (m, l, acc) and the
// product with V are all f32 FMAs (no TF32, no rounding of the
// probabilities), whatever the input dtype (f32 or bf16); the output is
// rounded to the input dtype once.
//
// Semantics kept from the TPU kernel (kernels.common.mask_block_scores):
// - causal masking is top-left aligned, q_pos >= k_pos with both positions
//   counted from 0, also when Sq != Skv;
// - keys at or past skv are masked; query rows past sq are computed on
//   zeros and never stored;
// - a masked score is -1e30 (finite), so exp() of it underflows to 0.
//
// What bounds it: operations.  At the qwen3-0.6b prefill shape (S=4096,
// D=128) the call moves ~100 MB but does ~137 GFLOP of causal products,
// ~1370 flop per byte, far above the ~295 at which the H100's bf16 tensor
// cores (989 TFLOP/s) become the limit.
//
// What this first version does about it: little.  It is the simple, exact
// form: one CTA of 256 threads per (b * Hq + h, 64-row query block); the
// q tile stays in shared memory, 64-key K and V tiles stream through it,
// each thread holds a 4 x 4 block of scores and a 4 x D/16 block of the
// output accumulator in registers, and the row max and sum of the online
// softmax are reduced with shuffles over the 16 threads that share a row.
// The products run on the f32 FMA units (67 TFLOP/s peak, not the tensor
// cores), and the next tile's load is not overlapped with this tile's
// math.  Key blocks entirely above the causal diagonal are skipped, and
// the longest causal rows are scheduled first.  wgmma on bf16 tiles with a
// TMA producer is the later, fast version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;     // query rows per CTA
constexpr int kBlockK = 64;     // keys per streamed tile
constexpr int kThreads = 256;   // thread (ty, tx) = (tid / 16, tid % 16)
constexpr int kLd = 68;         // row stride (floats) of the transposed tiles
static_assert(kBlockQ == kBlockK, "the causal block skip assumes square tiles");

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  // q tile (D, kLd) transposed; a region holding first the transposed K
  // tile (D, kLd), then the transposed probabilities (kBlockK, kLd); the
  // V tile (kBlockK, D) row-major
  return static_cast<size_t>(D) * kLd + static_cast<size_t>(D > kBlockK ? D : kBlockK) * kLd +
         static_cast<size_t>(kBlockK) * D;
}

// Grid (n_qblocks, B * Hq).  q, out: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D),
// all contiguous, 16-byte aligned rows.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int sq, int skv, int hq, int hkv, int causal,
                       float scale) {
  constexpr int kCols = D / 16;                 // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                             // (D, kLd): qt[d][r] = q[q0 + r][d]
  float* kt = qt + D * kLd;                     // (D, kLd): kt[d][j] = k[k0 + j][d]
  float* pt = kt;                               // (kBlockK, kLd): pt[j][r] = p[r][j]
  float* vs = kt + (D > kBlockK ? D : kBlockK) * kLd;   // (kBlockK, D)

  const int iq = gridDim.x - 1 - blockIdx.x;    // the longest causal rows first
  const int b = blockIdx.y / hq, h = blockIdx.y - b * hq;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = iq * kBlockQ;
  const size_t q_step = static_cast<size_t>(hq) * D;    // between positions
  const size_t kv_step = static_cast<size_t>(hkv) * D;
  const T* qb = q + (static_cast<size_t>(b) * sq * hq + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * skv * hkv + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * skv * hkv + hk) * D;

  for (int c = tid; c < kBlockQ * D / 8; c += kThreads) {
    const int r = c % kBlockQ, d0 = (c / kBlockQ) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < sq) load8(qb + (q0 + r) * q_step + d0, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) qt[(d0 + i) * kLd + r] = x[i];
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_kblocks = (skv + kBlockK - 1) / kBlockK;
  if (causal) n_kblocks = min(n_kblocks, iq + 1);     // blocks above the diagonal: skipped

  for (int ik = 0; ik < n_kblocks; ++ik) {
    const int k0 = ik * kBlockK;
    __syncthreads();                                  // last tile's P and V consumed
    for (int c = tid; c < kBlockK * D / 8; c += kThreads) {
      const int j = c % kBlockK, d0 = (c / kBlockK) * 8;   // consecutive threads: consecutive keys
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + j < skv) load8(kb + (k0 + j) * kv_step + d0, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) kt[(d0 + i) * kLd + j] = x[i];
    }
    for (int c = tid; c < kBlockK * D / 8; c += kThreads) {
      const int j = c / (D / 8), d0 = (c % (D / 8)) * 8;   // consecutive threads: one row
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + j < skv) load8(vb + (k0 + j) * kv_step + d0, x);
      float4* dst = reinterpret_cast<float4*>(vs + j * D + d0);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();

    // scores s[i][j] = q[4ty + i] . k[4tx + j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kLd + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, then one online-softmax step per row (scale after the dot, as
    // in the TPU kernel)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + 4 * tx + j;
        const bool ok = kp < skv && (!causal || qp >= kp);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                                  // every thread is done with kt
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * kLd + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc[i][c] += sum_j p[4ty + i][j] * v[j][col(c)]
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + j * kLd + 4 * ty);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float* vr = vs + j * D;
      float vv[kCols];
      if constexpr (kCols >= 4) {
#pragma unroll
        for (int g = 0; g < kCols / 4; ++g) {           // columns 64 g + 4 tx + 0..3
          const float4 x = *reinterpret_cast<const float4*>(vr + 64 * g + 4 * tx);
          vv[4 * g] = x.x; vv[4 * g + 1] = x.y; vv[4 * g + 2] = x.z; vv[4 * g + 3] = x.w;
        }
      } else {                                          // columns 2 tx + 0..1
        const float2 x = *reinterpret_cast<const float2*>(vr + 2 * tx);
        vv[0] = x.x; vv[1] = x.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + (static_cast<size_t>(b) * sq + qp) * q_step + static_cast<size_t>(h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = kCols >= 4 ? 64 * (c / 4) + 4 * tx + (c % 4) : 2 * tx + c;
      store(orow + col, acc[i][c] / li);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch, int sq,
                   int skv, int hq, int hkv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * hq);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, hq, hkv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* out, int batch,
                       int sq, int skv, int hq, int hkv, int causal, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, out, batch, sq, skv, hq, hkv, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, batch, sq, skv, hq, hkv, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, batch, sq, skv, hq, hkv, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// is_bf16: 1 for bf16 q/k/v/out, 0 for f32.  d in {32, 64, 128}; hq % hkv == 0.
extern "C" int valve_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int batch, int sq, int skv, int hq, int hkv, int d,
                                     int is_bf16, int causal, float scale, void* stream) {
  if (batch == 0 || sq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(d, q, k, v, out, batch, sq, skv, hq, hkv, causal, scale, st)
              : dispatch_d<float>(d, q, k, v, out, batch, sq, skv, hq, hkv, causal, scale, st);
  return static_cast<int>(err);
}
