// Paged decode attention for Hopper (sm_90a): the per-row page walk and the
// prefix-shared run pass.
//
// Replaces the TPU Pallas kernels in src/repro/kernels/paged_attention/kernel.py:
//   _paged_kernel / paged_attention_bhgd   -> valve_paged_decode       (K1)
//   _shared_run_kernel (phase 1)           -> valve_shared_run         (K2)
//   _tail_kernel (phase 2)                 -> valve_paged_decode with an
//                                             initial (m, l, acc) and a page
//                                             offset start[b]           (K3)
//
// What bounds it: bytes.  One new token per row does 4 flops per K/V element
// it reads (q.k and p.v), far below the ~295 flop/byte at which the H100's
// bf16 tensor cores would become the limit, so the time is the K/V pages
// streamed from device memory (3.35 TB/s).
//
// What the design does about it:
// - K1/K3: one CTA per (kv-head, row).  Each (page_size, D) K and V tile is
//   read from the pool once, with 16-byte loads, into shared memory and
//   scored against all G query heads of the group (GQA: the tile is read once
//   per kv-head, not once per query head).  The CTA walks only the row's live
//   pages, ceil(lengths[b] / page_size) - start[b] of them; the TPU grid walks
//   all maxp pages of the table.  Pages past the length are never read.
// - K2: one CTA per kv-head.  Each deduplicated shared page is read once for
//   the whole batch and scored against all B*G query rows under the (B, S)
//   participation mask, so a prefix shared by B rows costs one read, not B.
// - The f32 online-softmax state (m, l, acc) stays in shared memory across
//   pages; nothing but the output (or K2's partial state) reaches memory.
// This first version loads a tile, then computes on it, with no overlap of
// the next page's load; that, and splitting long rows over several CTAs, is
// work for a later change.
//
// Semantics kept from the TPU kernels: tokens at positions >= lengths[b] and
// non-participating shared slots score -1e30 (finite, so a fully masked row
// never makes NaN).  A row masked at every slot so far carries garbage mass
// at m = -1e30; the first finite score rescales it away (alpha =
// exp(-1e30 - m) = 0), so no reset is needed between the two phases.  A row
// whose l is 0 at the end writes 0.  A page id outside [0, n_pages) reads the
// quarantine page 0 instead, so no index ever leaves the pool.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared-memory layout for R query rows, one (pg, D) K tile and V tile.
struct Smem {
  float* q;               // (R, D) f32 queries
  __nv_bfloat16* k;       // (pg, D)
  __nv_bfloat16* v;       // (pg, D)
  float* s;               // (R, pg) scores, then probabilities
  float* m;               // (R,) running max
  float* l;               // (R,) running denominator
  float* alpha;           // (R,) rescale of this step
  float* acc;             // (R, D) running numerator
};

__host__ __device__ inline size_t smem_bytes(int rows, int pg, int d) {
  return align16(sizeof(float) * rows * d) + 2 * align16(sizeof(__nv_bfloat16) * pg * d) +
         align16(sizeof(float) * rows * pg) + 3 * align16(sizeof(float) * rows) +
         align16(sizeof(float) * rows * d);
}

__device__ inline Smem carve(unsigned char* base, int rows, int pg, int d) {
  Smem sm;
  size_t off = 0;
  sm.q = reinterpret_cast<float*>(base + off);             off += align16(sizeof(float) * rows * d);
  sm.k = reinterpret_cast<__nv_bfloat16*>(base + off);     off += align16(sizeof(__nv_bfloat16) * pg * d);
  sm.v = reinterpret_cast<__nv_bfloat16*>(base + off);     off += align16(sizeof(__nv_bfloat16) * pg * d);
  sm.s = reinterpret_cast<float*>(base + off);             off += align16(sizeof(float) * rows * pg);
  sm.m = reinterpret_cast<float*>(base + off);             off += align16(sizeof(float) * rows);
  sm.l = reinterpret_cast<float*>(base + off);             off += align16(sizeof(float) * rows);
  sm.alpha = reinterpret_cast<float*>(base + off);         off += align16(sizeof(float) * rows);
  sm.acc = reinterpret_cast<float*>(base + off);
  return sm;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy kv-head h of physical page `page` (a (pg, D) tile of the
// (P, pg, Hkv, D) pool) into shared memory with 16-byte loads.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ pool,
                                          int page, int pg, int hkv, int h, int d) {
  const int row_vecs = d / 8;
  for (int c = threadIdx.x; c < pg * row_vecs; c += blockDim.x) {
    const int t = c / row_vecs, j = c - t * row_vecs;
    const uint4* src = reinterpret_cast<const uint4*>(
        pool + ((static_cast<size_t>(page) * pg + t) * hkv + h) * d);
    reinterpret_cast<uint4*>(dst + t * d)[j] = __ldg(src + j);
  }
}

// Raw scores q_r . k_t for every (row, token) pair of the tile, one warp per
// pair, lanes over D; `valid(r, t)` decides masking.  Scale is applied after
// the dot, as in the TPU kernel.
template <typename Valid>
__device__ __forceinline__ void score_tile(const Smem& sm, int rows, int pg, int d, float scale,
                                           Valid valid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int pair = warp; pair < rows * pg; pair += n_warps) {
    const int r = pair / pg, t = pair - r * pg;
    const float* qr = sm.q + r * d;
    const __nv_bfloat16* kt = sm.k + t * d;
    float dot = 0.f;
    for (int i = lane * 4; i < d; i += 128) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + i);
      const float2 k01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kt + i));
      const float2 k23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kt + i + 2));
      dot += qv.x * k01.x + qv.y * k01.y + qv.z * k23.x + qv.w * k23.y;
    }
    dot = warp_sum(dot);
    if (lane == 0) sm.s[pair] = valid(r, t) ? dot * scale : kNegInf;
  }
}

// One online-softmax step over the scored tile (the TPU kernels'
// online_softmax_update): rescale by alpha = exp(m_prev - m_new), add p.v.
__device__ __forceinline__ void softmax_step(const Smem& sm, int rows, int pg, int d) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float* sr = sm.s + r * pg;
    const float m_prev = sm.m[r];
    float m_new = m_prev;
    for (int t = 0; t < pg; ++t) m_new = fmaxf(m_new, sr[t]);
    const float alpha = expf(m_prev - m_new);
    float sum = 0.f;
    for (int t = 0; t < pg; ++t) {
      const float p = expf(sr[t] - m_new);
      sr[t] = p;
      sum += p;
    }
    sm.l[r] = sm.l[r] * alpha + sum;
    sm.m[r] = m_new;
    sm.alpha[r] = alpha;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    const float* pr = sm.s + r * pg;
    float a = sm.acc[i] * sm.alpha[r];
    for (int t = 0; t < pg; ++t) a += pr[t] * __bfloat162float(sm.v[t * d + c]);
    sm.acc[i] = a;
  }
}

// K1 / K3: grid (Hkv, B).  q, out: (B, Hkv, G, D); the optional initial
// state m0, l0: (B, Hkv, G) and acc0: (B, Hkv, G, D) (NULL: empty state);
// the optional start: (B,) pages already covered by that state (NULL: 0).
__global__ void paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k_pool,
                                    const __nv_bfloat16* __restrict__ v_pool,
                                    const int* __restrict__ page_table,
                                    const int* __restrict__ start,
                                    const int* __restrict__ lengths,
                                    const float* __restrict__ m0,
                                    const float* __restrict__ l0,
                                    const float* __restrict__ acc0,
                                    __nv_bfloat16* __restrict__ out,
                                    int hkv, int g, int d, int n_pages, int pg, int maxp,
                                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y;
  const Smem sm = carve(smem_raw, g, pg, d);
  const size_t row0 = (static_cast<size_t>(b) * hkv + h) * g;   // first (b, h, 0) row

  for (int i = threadIdx.x; i < g * d; i += blockDim.x) {
    sm.q[i] = __bfloat162float(q[row0 * d + i]);
    sm.acc[i] = acc0 ? acc0[row0 * d + i] : 0.f;
  }
  for (int r = threadIdx.x; r < g; r += blockDim.x) {
    sm.m[r] = m0 ? m0[row0 + r] : kNegInf;
    sm.l[r] = l0 ? l0[row0 + r] : 0.f;
  }

  const int len = lengths[b];
  const int first = start ? start[b] : 0;
  int live = (len + pg - 1) / pg - first;           // only the row's live pages
  live = live < 0 ? 0 : (live > maxp ? maxp : live);
  const int* row_pages = page_table + static_cast<size_t>(b) * maxp;

  for (int ip = 0; ip < live; ++ip) {
    int page = row_pages[ip];
    if (page < 0 || page >= n_pages) page = 0;      // never leave the pool
    __syncthreads();                                // previous tile consumed
    load_tile(sm.k, k_pool, page, pg, hkv, h, d);
    load_tile(sm.v, v_pool, page, pg, hkv, h, d);
    __syncthreads();
    const int pos0 = (first + ip) * pg;
    score_tile(sm, g, pg, d, scale, [&](int, int t) { return pos0 + t < len; });
    __syncthreads();
    softmax_step(sm, g, pg, d);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * d; i += blockDim.x) {
    const float l = sm.l[i / d];
    out[row0 * d + i] = __float2bfloat16(sm.acc[i] / (l == 0.f ? 1.f : l));
  }
}

// K2: grid (Hkv).  Walks the S deduplicated shared pages; query row
// r = b * G + j of kv-head h attends slot s iff mask[b, s] > 0.  Shared
// pages are fully filled by the publication contract, so no length mask
// applies here.  Writes the partial state m, l: (B, Hkv, G) and
// acc: (B, Hkv, G, D), all f32.
__global__ void shared_run_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k_pool,
                                  const __nv_bfloat16* __restrict__ v_pool,
                                  const int* __restrict__ pages,
                                  const float* __restrict__ mask,
                                  float* __restrict__ m_out,
                                  float* __restrict__ l_out,
                                  float* __restrict__ acc_out,
                                  int batch, int hkv, int g, int d, int n_pages, int pg,
                                  int n_slots, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x;
  const int rows = batch * g;
  const Smem sm = carve(smem_raw, rows, pg, d);
  // query row r = b * g + j lives at ((b * hkv + h) * g + j) in (B, Hkv, G, .)
  auto row_index = [&](int r) {
    const int b = r / g;
    return (static_cast<size_t>(b) * hkv + h) * g + (r - b * g);
  };
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d;
    sm.q[i] = __bfloat162float(q[row_index(r) * d + (i - r * d)]);
    sm.acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
  for (int js = 0; js < n_slots; ++js) {
    int page = pages[js];
    if (page < 0 || page >= n_pages) page = 0;
    __syncthreads();
    load_tile(sm.k, k_pool, page, pg, hkv, h, d);
    load_tile(sm.v, v_pool, page, pg, hkv, h, d);
    __syncthreads();
    score_tile(sm, rows, pg, d, scale,
               [&](int r, int) { return mask[static_cast<size_t>(r / g) * n_slots + js] > 0.f; });
    __syncthreads();
    softmax_step(sm, rows, pg, d);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d;
    acc_out[row_index(r) * d + (i - r * d)] = sm.acc[i];
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    m_out[row_index(r)] = sm.m[r];
    l_out[row_index(r)] = sm.l[r];
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int valve_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                  const void* page_table, const void* start, const void* lengths,
                                  const void* m0, const void* l0, const void* acc0, void* out,
                                  int batch, int hkv, int g, int d, int n_pages, int pg, int maxp,
                                  float scale, void* stream) {
  if (batch == 0) return 0;
  const size_t smem = smem_bytes(g, pg, d);
  cudaError_t err = set_smem(paged_decode_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<<<dim3(hkv, batch), 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(start), static_cast<const int*>(lengths),
      static_cast<const float*>(m0), static_cast<const float*>(l0),
      static_cast<const float*>(acc0), static_cast<__nv_bfloat16*>(out),
      hkv, g, d, n_pages, pg, maxp, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int valve_shared_run(const void* q, const void* k_pool, const void* v_pool,
                                const void* pages, const void* mask, void* m_out, void* l_out,
                                void* acc_out, int batch, int hkv, int g, int d, int n_pages,
                                int pg, int n_slots, float scale, void* stream) {
  if (batch == 0) return 0;
  const size_t smem = smem_bytes(batch * g, pg, d);
  cudaError_t err = set_smem(shared_run_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  shared_run_kernel<<<hkv, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(pages),
      static_cast<const float*>(mask), static_cast<float*>(m_out), static_cast<float*>(l_out),
      static_cast<float*>(acc_out), batch, hkv, g, d, n_pages, pg, n_slots, scale);
  return static_cast<int>(cudaGetLastError());
}
