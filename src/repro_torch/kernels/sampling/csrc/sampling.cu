// Fused unembed + sampling for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU Pallas kernel src/repro/kernels/sampling/kernel.py
// (_sample_kernel / unembed_sample_pallas): tokens = argmax(last @ head^T)
// for greedy, argmax(last @ head^T / T + gumbel(seed, row, col)) for T > 0,
// without ever writing the (B, V) logits to memory.
//
// What bounds it: bytes.  At B rows the kernel does 2*B flops per head
// element it reads; at B = 16 that is 16 flop/byte, far below the ~295 at
// which the bf16 tensor cores would become the limit.  The head (V x D bf16,
// 311 MB for qwen3-0.6b) is read once per launch: ~93 us at 3.35 TB/s.  On
// the CUDA cores the same products cost more than the bytes (per 2 KB head
// row: 8 x 32 KB of f32 reads of `last` from shared memory, 40 shuffles,
// 16 K f32 FMAs), so the design moves them to the tensor cores and keeps
// the head streaming.
//
// Design (a skinny GEMM whose epilogue is an argmax):
// - Persistent CTAs: ops.plan_vocab_ranges cuts the vocab into at most one
//   contiguous range of whole 64-row tiles for each SM (132 on an H100),
//   one CTA each.
// - The head streams through a ring of up to 16 shared-memory stages, each
//   one TMA box of 64 vocab rows x 64 bf16 columns (8 KB, 128-byte
//   swizzle), tracked by mbarriers (full: the box landed; empty: its wgmma
//   finished).  One producer thread keeps the ring full across the CTA's
//   whole range, so the copies of the next tiles overlap the products and
//   the epilogue of this one.  The tensor maps are encoded on the host with
//   cuTensorMapEncodeTiled through the runtime's driver entry point (no
//   -lcuda; kernels/csrc/sm90.cuh, shared with flash_attention_sm90.cu).
// - `last` (at most 16 rows) is loaded once by TMA into the same swizzled
//   K-major layout; TMA zero-fills the rows past B (and columns past D).
// - Scores on the tensor cores: wgmma m64nNk16 (N = 8 for B <= 8, else 16),
//   A = the head box (64 x 16, K-major, shared memory: the head is (V, D)
//   row-major), B = last (N x 16, K-major, shared memory), accumulated in
//   f32 registers over D; a box's stage is released once its wgmma group
//   has completed, with one group kept in flight.
// - Epilogue on the accumulator registers, per thread (its two vocab rows
//   of each tile, its N / 4 batch columns): the Gumbel noise at T > 0 from
//   the same hash_u32 / gumbel code, then a running (value, index) per
//   column across the CTA's tiles; then the 8 lanes that share a column
//   (shuffles), then the 4 warps (shared memory): one (value, index)
//   partial per (CTA, batch row).  A second small kernel reduces the
//   partials.  The TPU kernel carried the argmax across a sequential grid;
//   the CTAs here run in parallel and in no order.
// - One launch takes at most 16 batch rows; the wrapper launches once per
//   block of 16 rows, so a larger batch reads the head once per block.
//
// Rounding: scores are f32 sums of exact bf16 x bf16 products, as the TPU
// kernel and the port's plain version compute them, but the tensor cores
// sum in another order and round those sums in their own way.  The plain
// version and the unfused decode tail take the f32 scores too, so fused
// and unfused greedy paths pick the same token except where two scores tie
// to within that rounding.
//
// Tie-break: first occurrence, as jnp.argmax / torch.argmax.  A thread
// visits its rows in increasing order and only a strictly greater score
// replaces its best; across lanes, warps, CTAs and in the final pass an
// equal score goes to the lower vocab index.  Rows >= V (TMA zero-fills
// them) are never considered, so they can never win.
//
// Temperature: the counter hash is the reference's splitmix finalizer in
// native uint32_t, so the bits are the plain version's exactly, and
// u = (bits >> 8) * 2^-24 + 2^-25 is exact in f32.  The double log and the
// division by T may round one ulp apart from PyTorch's, so a draw can
// differ only where two perturbed scores tie to within that.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxBatch = 16;
constexpr int kTileRows = 64;          // vocab rows of one tile (a wgmma's M)
constexpr int kRowBytes = 128;         // one swizzled row: 64 bf16
constexpr int kBoxBytes = kTileRows * kRowBytes;   // one head box: 8 KB
constexpr int kMaxStages = 16;
constexpr int kConsumers = 128;        // one warpgroup takes the products
constexpr int kThreads = kConsumers + 32;          // + the producer warp
constexpr int kReduceThreads = 256;
constexpr size_t kSmemBudget = 227 * 1024 - 1024;  // dynamic, after static

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

// One TMA box of a 2-D map (columns c0.., rows c1..) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// D (+)= A . B: A (64 x 16) and B (16 x N) both from shared memory, both
// K-major (descriptors: 1024 bytes between 8-row groups), f32 accumulators
// in registers.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss<8>(float (&d)[4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Grid (n_ctas), kThreads threads.  CTA c walks the vocab tiles
// [c * tiles_per_cta, (c + 1) * tiles_per_cta) (clipped to the vocab) and
// writes one partial (value, index) per batch row to part_val / part_idx
// (n_ctas, B).  Row b of `last` is row row0 + b of the caller's batch (the
// noise counter).  Shared memory (from a 1024-byte aligned base): the ring
// of `stages` head boxes, then `last` as ceil(D / 64) column slices of N
// swizzled rows, then the barriers.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
unembed_wgmma_kernel(const __grid_constant__ CUtensorMap head_map,
                     const __grid_constant__ CUtensorMap last_map, int batch, int d, int vocab,
                     int tiles_per_cta, int stages, float temperature, uint32_t seed,
                     uint32_t row0, float* __restrict__ part_val, int* __restrict__ part_idx) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red_val[kConsumers / 32][kMaxBatch];
  __shared__ int red_idx[kConsumers / 32][kMaxBatch];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int nb = (d + 63) / 64;                        // column slices of D
  const uint32_t ring = base, last_s = ring + stages * kBoxBytes;
  const uint32_t bars = last_s + nb * N * kRowBytes;
  const uint32_t last_full = bars + 16 * stages;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (stages + s); };
  const int n_tiles = (vocab + kTileRows - 1) / kTileRows;
  const int t_begin = blockIdx.x * tiles_per_cta;
  const int t_end = min(t_begin + tiles_per_cta, n_tiles);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    mbar_init(last_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                             // producer warp
    if (tid == kConsumers) {
      mbar_expect_tx(last_full, nb * N * kRowBytes);
      for (int j = 0; j < nb; ++j) tma_load_2d(last_s + j * N * kRowBytes, &last_map, last_full, 64 * j, 0);
      int it = 0;
      for (int t = t_begin; t < t_end; ++t)
        for (int j = 0; j < nb; ++j, ++it) {
          const int s = it % stages;
          if (it >= stages) mbar_wait(empty(s), ((it / stages) - 1) & 1);
          mbar_expect_tx(full(s), kBoxBytes);
          tma_load_2d(ring + s * kBoxBytes, &head_map, full(s), 64 * j, kTileRows * t);
        }
    }
  } else {                                             // the consumer warpgroup
    const int warp = tid >> 5, lane = tid & 31;
    // column slot cs = 2 (i / 4) + (i & 1) of accumulator i is batch column
    // 8 (i / 4) + 2 (lane & 3) + (i & 1); (i & 2) picks the row 8 further
    float best_v[N / 4];
    int best_i[N / 4];
#pragma unroll
    for (int cs = 0; cs < N / 4; ++cs) {
      best_v[cs] = kNegInf;
      best_i[cs] = 0x7fffffff;
    }
    mbar_wait(last_full, 0);
    int it = 0;
    for (int t = t_begin; t < t_end; ++t) {
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int j = 0; j < nb; ++j, ++it) {
        const int s = it % stages;
        mbar_wait(full(s), (it / stages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)               // 16 columns of D a step
          wgmma_ss<N>(acc, smem_desc(ring + s * kBoxBytes + 32 * kk, 16, 1024),
                      smem_desc(last_s + j * N * kRowBytes + 32 * kk, 16, 1024));
        wgmma_commit();
        if (prev >= 0) {                             // the previous box's products are done
          wgmma_wait<1>();
          mbar_arrive(empty(prev));
        }
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty(prev));

      const int ra = kTileRows * t + 16 * warp + (lane >> 2);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {              // row ra before ra + 8 in every column
        const int col = 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        const int row = ra + ((i & 2) ? 8 : 0);
        if (col < batch && row < vocab) {
          float sc = acc[i];
          if (temperature > 0.f) sc = sc / temperature + gumbel(seed, row0 + col, row);
          const int cs = 2 * (i / 4) + (i & 1);
          if (sc > best_v[cs]) {                     // strict: first occurrence wins
            best_v[cs] = sc;
            best_i[cs] = row;
          }
        }
      }
    }
    // the 8 lanes of a warp that share each column, then the warps
#pragma unroll
    for (int cs = 0; cs < N / 4; ++cs) {
      float v = best_v[cs];
      int ix = best_i[cs];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, ix, o);
        if (better(ov, oi, v, ix)) {
          v = ov;
          ix = oi;
        }
      }
      if (lane < 4) {
        const int col = 8 * (cs / 2) + 2 * lane + (cs & 1);
        red_val[warp][col] = v;
        red_idx[warp][col] = ix;
      }
    }
  }
  __syncthreads();
  if (tid < batch) {
    float bv = red_val[0][tid];
    int bi = red_idx[0][tid];
    for (int w = 1; w < kConsumers / 32; ++w)
      if (better(red_val[w][tid], red_idx[w][tid], bv, bi)) {
        bv = red_val[w][tid];
        bi = red_idx[w][tid];
      }
    part_val[static_cast<size_t>(blockIdx.x) * batch + tid] = bv;
    part_idx[static_cast<size_t>(blockIdx.x) * batch + tid] = bi;
  }
}

// grid (B): reduce the per-CTA partials of one batch row.
__global__ void argmax_reduce_kernel(const float* __restrict__ part_val,
                                     const int* __restrict__ part_idx, int batch, int n_parts,
                                     int* __restrict__ out) {
  __shared__ float red_val[kReduceThreads];
  __shared__ int red_idx[kReduceThreads];
  const int b = blockIdx.x;
  float bv = kNegInf;
  int bi = 0x7fffffff;
  for (int t = threadIdx.x; t < n_parts; t += blockDim.x) {
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

// A 2-D map (D, rows) over a contiguous (rows, D) bf16 matrix; boxes of 64
// columns x box_rows rows, 128-byte swizzle, out-of-bounds elements read as
// zeros.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rows, int d, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {2ull * d};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
cudaError_t launch(const void* last, const void* head, int batch, int d, int vocab,
                   int tiles_per_cta, float temperature, uint32_t seed, uint32_t row0,
                   float* part_val, int* part_idx, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap head_map, last_map;
  if (!encode(fn, &head_map, head, vocab, d, kTileRows) ||
      !encode(fn, &last_map, last, batch, d, N))
    return cudaErrorInvalidValue;
  const size_t fixed = 1024 + static_cast<size_t>((d + 63) / 64) * N * kRowBytes + 8;
  if (fixed + 2 * (kBoxBytes + 16) > kSmemBudget) return cudaErrorInvalidValue;
  const size_t fit = (kSmemBudget - fixed) / (kBoxBytes + 16);
  const int stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  const size_t smem = fixed + static_cast<size_t>(stages) * (kBoxBytes + 16);
  const cudaError_t err = cudaFuncSetAttribute(
      unembed_wgmma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_tiles = (vocab + kTileRows - 1) / kTileRows;
  const int n_ctas = (n_tiles + tiles_per_cta - 1) / tiles_per_cta;
  unembed_wgmma_kernel<N><<<n_ctas, kThreads, smem, stream>>>(
      head_map, last_map, batch, d, vocab, tiles_per_cta, stages, temperature, seed, row0,
      part_val, part_idx);
  return cudaGetLastError();
}

}  // namespace

// part_val / part_idx: scratch of ceil(vocab / rows_per_cta) * batch
// entries (one partial per CTA and row; ops.plan_vocab_ranges gives
// rows_per_cta, a multiple of 64).  At most kMaxBatch rows per launch;
// `row0` is the first row's index in the caller's batch, so a batch split
// over launches draws the same noise.  last (batch, d) and head (vocab, d)
// bf16, contiguous, 16-byte aligned; d % 8 == 0.
extern "C" int valve_unembed_sample(const void* last, const void* head, int batch, int d,
                                    int vocab, int rows_per_cta, float temperature, int seed,
                                    int row0, void* part_val, void* part_idx, void* out,
                                    void* stream) {
  if (batch == 0) return 0;
  if (batch > kMaxBatch || d % 8 != 0 || d <= 0 || vocab <= 0 || rows_per_cta <= 0 ||
      rows_per_cta % kTileRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_per_cta = rows_per_cta / kTileRows;
  cudaError_t err =
      batch <= 8 ? launch<8>(last, head, batch, d, vocab, tiles_per_cta, temperature,
                             static_cast<uint32_t>(seed), static_cast<uint32_t>(row0),
                             static_cast<float*>(part_val), static_cast<int*>(part_idx), s)
                 : launch<16>(last, head, batch, d, vocab, tiles_per_cta, temperature,
                              static_cast<uint32_t>(seed), static_cast<uint32_t>(row0),
                              static_cast<float*>(part_val), static_cast<int*>(part_idx), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_parts = (vocab + rows_per_cta - 1) / rows_per_cta;
  argmax_reduce_kernel<<<batch, kReduceThreads, 0, s>>>(static_cast<const float*>(part_val),
                                                        static_cast<const int*>(part_idx), batch,
                                                        n_parts, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
