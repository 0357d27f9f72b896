// WKV6 (RWKV-6 "Finch") recurrence for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel in src/repro/kernels/rwkv6/kernel.py:
//   _wkv6_kernel / wkv6_bthk   -> valve_wkv6   (K6)
//
// Computes, per (b, h), over the tokens t in order:
//   y_t = r_t . (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t
// with the (K, V) state S in f32, from state_in to state_out; r/k/v/w/u are
// f32 or bf16, y is written in their dtype.
//
// Form: the serial recurrence, not the TPU kernel's chunk-parallel one.
// One CTA per (b, h), one thread per value column; thread c holds column c
// of S (K floats) and u in registers and applies the exact step above to
// each token.  Tokens are staged `chunk` at a time: r, k, w (chunk, K) and
// v (chunk, V), converted to f32, in shared memory, read by every thread as
// broadcasts.  This form has no overflow envelope: it never divides by a
// cumulative decay, so the TPU form's log(max(w, 1e-30)) clamp and midpoint
// normalisation have nothing to guard here, and any decay in [0, 1] is
// exact to f32 rounding.  Token padding is not needed either: the loop stops
// at T, and `chunk` only sets the staging depth (any chunk >= 1 gives the
// same result, also one longer than T).
//
// What bounds it: bytes.  Each token and head reads r, k, w (K each) and v
// and writes y (V), and does ~4 K V flops: at rwkv6-3b (K = V = 64, f32)
// that is ~13 flop per byte moved, under the ~20 at which the H100's f32
// units (67 TFLOP/s against 3.35 TB/s) would become the limit.
//
// What the design does about it: every input element is read from device
// memory once, with consecutive threads on consecutive addresses; only the
// state crosses the token loop, in registers.  The price is parallelism:
// B * H CTAs of V threads (160 CTAs of 64 threads at B = 4) leave each SM
// about two warps, too few to hide the latency of the staging loads or of
// the serial token loop, so the kernel runs far from its memory bound.
// Staging with loads in flight, splitting K over more threads, or the
// chunked form on tensor cores is the later, fast version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__host__ __device__ inline size_t smem_bytes(int k, int dv, int chunk) {
  return sizeof(float) * static_cast<size_t>(chunk) * (3 * k + dv);
}

// Grid (B * H), block (V).  r, k, w: (B, T, H, K); v, y: (B, T, H, V);
// u: (H, K); state_in, state_out: (B, H, K, V) f32.
template <typename T, int K>
__global__ void wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ w,
                            const T* __restrict__ u, const float* __restrict__ state_in,
                            T* __restrict__ y, float* __restrict__ state_out, int t_len,
                            int heads, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int dv = blockDim.x, col = threadIdx.x;
  float* rs = smem;                  // (chunk, K)
  float* ks = rs + chunk * K;        // (chunk, K)
  float* ws = ks + chunk * K;        // (chunk, K)
  float* vs = ws + chunk * K;        // (chunk, V)

  const int bh = blockIdx.x, b = bh / heads, h = bh - b * heads;
  const size_t tok_k = static_cast<size_t>(heads) * K;    // between tokens
  const size_t tok_v = static_cast<size_t>(heads) * dv;
  const size_t base_k = (static_cast<size_t>(b) * t_len * heads + h) * K;
  const size_t base_v = (static_cast<size_t>(b) * t_len * heads + h) * dv;

  float s[K], uu[K];
  const float* s0 = state_in + static_cast<size_t>(bh) * K * dv + col;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    s[i] = s0[static_cast<size_t>(i) * dv];
    uu[i] = to_f32(u[h * K + i]);
  }

  for (int t0 = 0; t0 < t_len; t0 += chunk) {
    const int n = min(chunk, t_len - t0);
    __syncthreads();                           // the previous chunk is consumed
    for (int c = threadIdx.x; c < n * K; c += dv) {
      const int tt = c / K, i = c - tt * K;
      const size_t off = base_k + (t0 + tt) * tok_k + i;
      rs[c] = to_f32(r[off]);
      ks[c] = to_f32(k[off]);
      ws[c] = to_f32(w[off]);
    }
    for (int tt = 0; tt < n; ++tt) vs[tt * dv + col] = to_f32(v[base_v + (t0 + tt) * tok_v + col]);
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float vt = vs[tt * dv + col];
      const float* rt = rs + tt * K;
      const float* kt = ks + tt * K;
      const float* wt = ws + tt * K;
      float y4[4] = {0.f, 0.f, 0.f, 0.f};      // four partial sums: short FMA chains
#pragma unroll
      for (int i = 0; i < K; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rt + i);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + i);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + i);
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = kv[e] * vt;                        // (k_t^T v_t)[i, col]
          y4[e] = fmaf(rv[e], fmaf(uu[i + e], a, s[i + e]), y4[e]);
          s[i + e] = fmaf(wv[e], s[i + e], a);
        }
      }
      store(y + base_v + (t0 + tt) * tok_v + col, (y4[0] + y4[1]) + (y4[2] + y4[3]));
    }
  }

  float* s1 = state_out + static_cast<size_t>(bh) * K * dv + col;
#pragma unroll
  for (int i = 0; i < K; ++i) s1[static_cast<size_t>(i) * dv] = s[i];
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* state_in, void* y, void* state_out, int batch, int t_len,
                   int heads, int dv, int chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes(K, dv, chunk);
  cudaError_t err = cudaFuncSetAttribute(wkv6_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  wkv6_kernel<T, K><<<batch * heads, dv, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), static_cast<const float*>(state_in),
      static_cast<T*>(y), static_cast<float*>(state_out), t_len, heads, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_k(int dk, const void* r, const void* k, const void* v, const void* w,
                       const void* u, const void* state_in, void* y, void* state_out, int batch,
                       int t_len, int heads, int dv, int chunk, cudaStream_t stream) {
  switch (dk) {
    case 16: return launch<T, 16>(r, k, v, w, u, state_in, y, state_out, batch, t_len, heads, dv, chunk, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, state_in, y, state_out, batch, t_len, heads, dv, chunk, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, state_in, y, state_out, batch, t_len, heads, dv, chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// is_bf16: 1 for bf16 r/k/v/w/u/y, 0 for f32.  dk in {16, 32, 64};
// 1 <= dv <= 1024; the state is f32.
extern "C" int valve_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* state_in, void* y, void* state_out,
                          int batch, int t_len, int heads, int dk, int dv, int chunk, int is_bf16,
                          void* stream) {
  if (batch == 0 || heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_k<__nv_bfloat16>(dk, r, k, v, w, u, state_in, y, state_out, batch, t_len,
                                          heads, dv, chunk, st)
              : dispatch_k<float>(dk, r, k, v, w, u, state_in, y, state_out, batch, t_len, heads,
                                  dv, chunk, st);
  return static_cast<int>(err);
}
