// Fused unembed + sampling for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel src/repro/kernels/sampling/kernel.py
// (_sample_kernel / unembed_sample_pallas): tokens = argmax(last @ head^T)
// for greedy, argmax(last @ head^T / T + gumbel(seed, row, col)) for T > 0,
// without ever writing the (B, V) logits to memory.
//
// What bounds it: bytes.  At B rows the kernel does 2*B flops per head
// element it reads; at B = 8 that is 8 flop/byte, far below the ~295 at which
// the bf16 tensor cores would become the limit.  The head (V x D bf16, 311 MB
// for qwen3-0.6b) is read once per decode step: ~93 us at 3.35 TB/s.
//
// What the design does about it:
// - The head is taken as (V, D) row-major, so each vocab row is one
//   contiguous D-long read: a warp reads a row with 16-byte loads, lanes
//   side by side, and dots it against all B rows of `last` (staged once per
//   CTA in shared memory as f32), so every head byte is read exactly once.
// - The grid runs over vocab tiles of `tile_v` rows; each CTA keeps a
//   running (value, index) per batch row and writes one partial pair per
//   (tile, row) to scratch.  A second small kernel reduces the partials.
//   The TPU kernel carried the argmax across a sequential grid instead; the
//   CTAs here run in parallel and in no order, so the cross-tile reduction
//   is a second pass.
// - One launch keeps at most 16 batch rows in registers; the wrapper
//   launches once per block of 16 rows, so a larger batch reads the head
//   once per block.
//
// Rounding: scores are f32 dot products of the bf16 operands (as the TPU
// kernel computes them), not bf16 logits.  The port's plain version and its
// unfused decode tail use the same f32 scores, so the fused and unfused
// greedy paths pick the same token except where two f32 scores tie to
// within the accumulation order.
//
// Tie-break: first occurrence, as jnp.argmax / torch.argmax.  Within a warp
// rows are visited in increasing order and only a strictly greater score
// replaces the best; across warps, CTAs and in the final pass an equal
// score goes to the lower vocab index.  Rows >= V are never visited, so
// they can never win.
//
// Temperature: the counter hash is the reference's splitmix finalizer in
// native uint32_t, so the bits are the plain version's exactly, and
// u = (bits >> 8) * 2^-24 + 2^-25 is exact in f32.  The double log and the
// division by T may round one ulp apart from PyTorch's, so a draw can
// differ only where two perturbed scores tie to within that.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBatch = 16;

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float gumbel(uint32_t seed, uint32_t row, uint32_t col) {
  const uint32_t h = hash_u32(seed ^ (row * 0x9E3779B9u));
  const uint32_t bits = hash_u32(h ^ col);
  const float u = static_cast<float>(bits >> 8) * 5.9604644775390625e-08f  // 2^-24
                  + 2.98023223876953125e-08f;                              // 2^-25
  return -logf(-logf(u));
}

// (value, index) order of the argmax: larger value, then lower index.
__device__ __forceinline__ bool better(float v, int i, float best_v, int best_i) {
  return v > best_v || (v == best_v && i < best_i);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (ceil(V / tile_v)); one partial (value, index) per (tile, row).
// Row b of `last` is row row0 + b of the caller's batch (the noise counter).
__global__ void unembed_tile_kernel(const __nv_bfloat16* __restrict__ last,   // (B, D)
                                    const __nv_bfloat16* __restrict__ head,   // (V, D)
                                    int batch, int d, int vocab, int tile_v,
                                    float temperature, uint32_t seed, uint32_t row0,
                                    float* __restrict__ part_val,             // (tiles, B)
                                    int* __restrict__ part_idx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* x = reinterpret_cast<float*>(smem_raw);                  // (B, D) f32
  __shared__ float warp_val[kWarps * kMaxBatch];
  __shared__ int warp_idx[kWarps * kMaxBatch];

  for (int i = threadIdx.x; i < batch * d; i += blockDim.x) x[i] = __bfloat162float(last[i]);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v0 = blockIdx.x * tile_v;
  const int v_end = min(v0 + tile_v, vocab);
  const int row_vecs = d / 8;
  float best_v = kNegInf;                 // lane b keeps batch row b's best
  int best_i = 0;

  for (int v = v0 + warp; v < v_end; v += kWarps) {
    const uint4* w_row = reinterpret_cast<const uint4*>(head + static_cast<size_t>(v) * d);
    float acc[kMaxBatch];
#pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) acc[b] = 0.f;
    for (int c = lane; c < row_vecs; c += 32) {
      const uint4 raw = __ldg(w_row + c);
      const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 w01 = __bfloat1622float2(w2[0]), w23 = __bfloat1622float2(w2[1]);
      const float2 w45 = __bfloat1622float2(w2[2]), w67 = __bfloat1622float2(w2[3]);
#pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b < batch) {
          const float4* xb = reinterpret_cast<const float4*>(x + b * d + c * 8);
          const float4 lo = xb[0], hi = xb[1];
          acc[b] += w01.x * lo.x + w01.y * lo.y + w23.x * lo.z + w23.y * lo.w +
                    w45.x * hi.x + w45.y * hi.y + w67.x * hi.z + w67.y * hi.w;
        }
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) {
      if (b < batch) {
        const float s = warp_sum(acc[b]);
        if (lane == b) mine = s;
      }
    }
    if (lane < batch) {
      float s = mine;
      if (temperature > 0.f) s = s / temperature + gumbel(seed, row0 + lane, v);
      if (s > best_v) {                     // strict: first occurrence wins
        best_v = s;
        best_i = v;
      }
    }
  }
  if (lane < batch) {
    warp_val[warp * kMaxBatch + lane] = best_v;
    warp_idx[warp * kMaxBatch + lane] = best_i;
  }
  __syncthreads();
  if (threadIdx.x < batch) {
    const int b = threadIdx.x;
    float bv = warp_val[b];
    int bi = warp_idx[b];
    for (int w = 1; w < kWarps; ++w) {
      const float wv = warp_val[w * kMaxBatch + b];
      const int wi = warp_idx[w * kMaxBatch + b];
      if (better(wv, wi, bv, bi)) {
        bv = wv;
        bi = wi;
      }
    }
    part_val[static_cast<size_t>(blockIdx.x) * batch + b] = bv;
    part_idx[static_cast<size_t>(blockIdx.x) * batch + b] = bi;
  }
}

// grid (B): reduce the per-tile partials of one batch row.
__global__ void argmax_reduce_kernel(const float* __restrict__ part_val,
                                     const int* __restrict__ part_idx, int batch, int n_tiles,
                                     int* __restrict__ out) {
  __shared__ float red_val[kThreads];
  __shared__ int red_idx[kThreads];
  const int b = blockIdx.x;
  float bv = kNegInf;
  int bi = 0x7fffffff;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    const float v = part_val[static_cast<size_t>(t) * batch + b];
    const int i = part_idx[static_cast<size_t>(t) * batch + b];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  red_val[threadIdx.x] = bv;
  red_idx[threadIdx.x] = bi;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride &&
        better(red_val[threadIdx.x + stride], red_idx[threadIdx.x + stride],
               red_val[threadIdx.x], red_idx[threadIdx.x])) {
      red_val[threadIdx.x] = red_val[threadIdx.x + stride];
      red_idx[threadIdx.x] = red_idx[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[b] = red_idx[0];
}

}  // namespace

// part_val / part_idx: scratch of ceil(vocab / tile_v) * batch entries.
// At most kMaxBatch rows per launch; `row0` is the first row's index in the
// caller's batch, so a batch split over launches draws the same noise.
extern "C" int valve_unembed_sample(const void* last, const void* head, int batch, int d,
                                    int vocab, int tile_v, float temperature, int seed,
                                    int row0, void* part_val, void* part_idx, void* out,
                                    void* stream) {
  if (batch == 0) return 0;
  if (batch > kMaxBatch || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (vocab + tile_v - 1) / tile_v;
  const size_t smem = sizeof(float) * static_cast<size_t>(batch) * d;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        unembed_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unembed_tile_kernel<<<n_tiles, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(last), static_cast<const __nv_bfloat16*>(head), batch, d,
      vocab, tile_v, temperature, static_cast<uint32_t>(seed), static_cast<uint32_t>(row0),
      static_cast<float*>(part_val),
      static_cast<int*>(part_idx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  argmax_reduce_kernel<<<batch, kThreads, 0, s>>>(static_cast<const float*>(part_val),
                                                  static_cast<const int*>(part_idx), batch,
                                                  n_tiles, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
