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
// - K1/K3 ("split-KV"): a row's page walk is cut into splits of pps pages
//   (ops.plan_splits picks pps from B, Hkv and the table width only, so the
//   host never reads lengths back), one CTA per (split, kv-head, row): 512
//   CTAs at the qwen3-0.6b decode shape, where one CTA per (kv-head, row)
//   left half the 132 SMs idle and walked up to 32 pages serially.  A CTA
//   starts every K and V page copy of its split up front with cp.async (16
//   bytes a thread, in at most 8 groups), then walks the pages in order,
//   each as soon as its group has landed: scores against all G query heads
//   of the group (the tile is read once per kv-head, not once per query
//   head), then the plain version's f32 online-softmax step.  A CTA whose
//   pages lie past the row's live pages, ceil(lengths[b] / page_size) -
//   start[b] of them, reads nothing and writes an empty partial (l = 0); the
//   TPU grid walks all maxp pages of the table.  Split 0 walks on from K3's
//   initial state, as the plain version does; the others start empty.  A
//   combine pass rescales each row's partials to their common max and sums
//   them in split order (no atomics: the same bits every run), then writes
//   bf16.  A table of at most 128 tokens is one split, which writes the
//   output itself, and the combine is not launched.
// - K2: one CTA per kv-head.  Each deduplicated shared page is read once for
//   the whole batch and scored against all B*G query rows under the (B, S)
//   participation mask, so a prefix shared by B rows costs one read, not B.
//   Its f32 online-softmax state (m, l, acc) stays in shared memory across
//   pages; it loads a tile, then computes on it, with no overlap.
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

// ---------------------------------------------------------------------------
// K1 / K3: the page walk split over CTAs ("split-KV"), then a combine pass
// ---------------------------------------------------------------------------

constexpr int kWalkThreads = 128;
constexpr int kSplitTokens = 128;   // most tokens (pps * pg) one split holds

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x[lane] for lane < N, from registers (no runtime index into the array).
template <int N>
__device__ __forceinline__ float pick(const float (&x)[N], int lane) {
  float v = x[0];
#pragma unroll
  for (int u = 1; u < N; ++u)
    if (lane == u) v = x[u];
  return v;
}

// Start the copy of kv-head h of pages[0..n) into a (n * pg, D) tile, 16
// bytes a thread per cp.async.  d / 8 divides the block's threads, so each
// thread keeps one 16-byte column and steps over the tokens.
__device__ __forceinline__ void issue_pages(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ pool,
                                            const int* pages, int n, int pg, int hkv, int h, int d) {
  const int row_vecs = d / 8, j = threadIdx.x % row_vecs;
  for (int t = threadIdx.x / row_vecs; t < n * pg; t += kWalkThreads / row_vecs) {
    const int ip = t / pg;
    cp_async16(dst + t * d + 8 * j,
               pool + ((static_cast<size_t>(pages[ip]) * pg + (t - ip * pg)) * hkv + h) * d + 8 * j);
  }
  cp_async_commit();
}

__host__ __device__ inline size_t walk_smem_bytes(int g, int pps, int pg, int d) {
  return 2 * sizeof(float) * g * d + 2 * sizeof(__nv_bfloat16) * pps * pg * d +
         sizeof(float) * g * (pps * pg + 3 * pps + 2);
}

// Grid (n_splits, Hkv, B).  Split s of row b covers the pages
// [s * pps, (s + 1) * pps) of the row's walk (table columns, counted from
// start[b]), clipped to its live pages; a split past them writes an empty
// partial (l = 0).  The split's pages are walked with the plain version's
// online-softmax step, page by page and in the same f32 order, but in
// phases over all of them at once: every K and V copy starts up front
// (K, then V, as two cp.async groups), the scores of every token are taken
// while V lands, then each page's max, running max, rescale alpha and p,
// then acc = alpha acc + p . V page after page.  q, out: (B, Hkv, G, D);
// the optional initial state m0, l0: (B, Hkv, G) and acc0: (B, Hkv, G, D)
// (NULL: empty state); the optional start: (B,) (NULL: 0).  Split 0 walks
// on from the initial state, as the plain version does (with no live page
// its partial is that state); the others walk from the empty state.  With
// one split the CTA writes out itself; otherwise each writes its partial to
// m_part, l_part (n_splits, B, Hkv, G) and acc_part (n_splits, B, Hkv, G,
// D), f32, for paged_combine_kernel.
__global__ void __launch_bounds__(kWalkThreads)
paged_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
                   const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ page_table,
                   const int* __restrict__ start, const int* __restrict__ lengths,
                   const float* __restrict__ m0, const float* __restrict__ l0,
                   const float* __restrict__ acc0, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   float* __restrict__ acc_part, int batch, int hkv, int g, int d, int n_pages,
                   int pg, int maxp, int pps, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int pages[kSplitTokens];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z, n_splits = gridDim.x;
  const int tokens = pps * pg;
  float* qs = reinterpret_cast<float*>(smem_raw);                       // (G, D)
  float* acc = qs + g * d;                                               // (G, D)
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(acc + g * d);   // (tokens, D)
  __nv_bfloat16* vs = ks + tokens * d;                                  // (tokens, D)
  float* ps = reinterpret_cast<float*>(vs + tokens * d);                // (G, tokens)
  float* pmax = ps + g * tokens;                                         // (G, pps) page max
  float* psum = pmax + g * pps;                                         // (G, pps) page sum of p
  float* alpha = psum + g * pps;                                        // (G, pps) page rescale
  float* ms = alpha + g * pps;                                          // (G,)
  float* ls = ms + g;                                                   // (G,)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const bool direct = n_splits == 1, from_state = split == 0 && m0 != nullptr;
  const size_t row0 = (static_cast<size_t>(b) * hkv + h) * g;   // first (b, h, 0) row
  const int p0 = split * pps;
  // everything the walk needs from memory, in one round trip: the split's
  // table columns, the queries, the initial state, the row's length
  for (int i = threadIdx.x; i < min(pps, maxp - p0); i += blockDim.x) {
    const int page = page_table[static_cast<size_t>(b) * maxp + p0 + i];
    pages[i] = (page < 0 || page >= n_pages) ? 0 : page;      // never leave the pool
  }
  for (int i = threadIdx.x; i < g * d; i += blockDim.x) {
    qs[i] = __bfloat162float(q[row0 * d + i]);
    acc[i] = from_state ? acc0[row0 * d + i] : 0.f;
  }
  for (int r = threadIdx.x; r < g; r += blockDim.x) {
    ms[r] = from_state ? m0[row0 + r] : kNegInf;
    ls[r] = from_state ? l0[row0 + r] : 0.f;
  }
  const int len = lengths[b];
  const int first = start ? start[b] : 0;
  int live = (len + pg - 1) / pg - first;           // only the row's live pages
  live = live < 0 ? 0 : (live > maxp ? maxp : live);
  const int n = max(0, min(pps, live - p0));       // this split's pages
  const int nt = n * pg;
  __syncthreads();

  if (n > 0) {
    issue_pages(ks, k_pool, pages, n, pg, hkv, h, d);         // group: K
    issue_pages(vs, v_pool, pages, n, pg, hkv, h, d);         // group: V
    cp_async_wait<1>();                                        // K landed; V still may not
    __syncthreads();

    // scores: a warp takes 8 tokens at a time, lanes over D, every query
    // row of the group; the 8 tokens' lane sums reduce side by side
    const int pos0 = (first + p0) * pg;
    for (int t0 = 8 * warp; t0 < nt; t0 += 8 * n_warps) {
      float kr[8][8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = lane * 4 + 128 * j, t = t0 + u;
          float2 k01 = make_float2(0.f, 0.f), k23 = k01;
          if (i < d && t < nt) {
            k01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ks + t * d + i));
            k23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ks + t * d + i + 2));
          }
          kr[u][4 * j] = k01.x; kr[u][4 * j + 1] = k01.y;
          kr[u][4 * j + 2] = k23.x; kr[u][4 * j + 3] = k23.y;
        }
      for (int r = 0; r < g; ++r) {
        float dot[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) dot[u] = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = lane * 4 + 128 * j;
          if (i < d) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + r * d + i);
#pragma unroll
            for (int u = 0; u < 8; ++u)
              dot[u] += qv.x * kr[u][4 * j] + qv.y * kr[u][4 * j + 1] + qv.z * kr[u][4 * j + 2] +
                        qv.w * kr[u][4 * j + 3];
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < 8; ++u) dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
        const float x = pick(dot, lane);
        if (lane < 8 && t0 + lane < nt)
          ps[r * tokens + t0 + lane] = pos0 + t0 + lane < len ? x * scale : kNegInf;
      }
    }
    __syncthreads();

    // each (row, page): the page's max; then each row's running max and
    // alpha, page by page; then each (row, page): p and its sum.  A warp
    // takes 4 (row, page) pairs at a time, reducing them side by side.
    const int pairs = g * n;
    for (int rp0 = 4 * warp; rp0 < pairs; rp0 += 4 * n_warps) {
      float mx[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mx[u] = kNegInf;
        if (rp0 + u < pairs) {
          const float* pr = ps + ((rp0 + u) / n) * tokens + ((rp0 + u) % n) * pg;
          for (int t = lane; t < pg; t += 32) mx[u] = fmaxf(mx[u], pr[t]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u) mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], o));
      const int rp = rp0 + lane;
      if (lane < 4 && rp < pairs) pmax[(rp / n) * pps + rp % n] = pick(mx, lane);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < g; r += blockDim.x) {
      float m = ms[r];
      for (int ip = 0; ip < n; ++ip) {
        const float m_new = fmaxf(m, pmax[r * pps + ip]);
        alpha[r * pps + ip] = expf(m - m_new);
        pmax[r * pps + ip] = m_new;          // now the running max
        m = m_new;
      }
    }
    __syncthreads();
    for (int rp0 = 4 * warp; rp0 < pairs; rp0 += 4 * n_warps) {
      float sum[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sum[u] = 0.f;
        const int rp = rp0 + u;
        if (rp < pairs) {
          float* pr = ps + (rp / n) * tokens + (rp % n) * pg;
          const float m_new = pmax[(rp / n) * pps + rp % n];
          for (int t = lane; t < pg; t += 32) {
            const float p = expf(pr[t] - m_new);
            pr[t] = p;
            sum[u] += p;
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u) sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], o);
      const int rp = rp0 + lane;
      if (lane < 4 && rp < pairs) psum[(rp / n) * pps + rp % n] = pick(sum, lane);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < g; r += blockDim.x) {
      float l = ls[r];
      for (int ip = 0; ip < n; ++ip) l = l * alpha[r * pps + ip] + psum[r * pps + ip];
      ls[r] = l;
      ms[r] = pmax[r * pps + n - 1];
    }
    cp_async_wait<0>();                                        // V landed
    __syncthreads();

    // acc = alpha acc + p . V page after page, one thread per (query row,
    // column pair)
    for (int i = threadIdx.x; i < g * d / 2; i += blockDim.x) {
      const int r = i / (d / 2), c = 2 * (i - r * (d / 2));
      const float* pr = ps + r * tokens;
      float a0 = acc[r * d + c], a1 = acc[r * d + c + 1];
      for (int ip = 0; ip < n; ++ip) {
        a0 *= alpha[r * pps + ip];
        a1 *= alpha[r * pps + ip];
#pragma unroll 8
        for (int t = ip * pg; t < (ip + 1) * pg; ++t) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vs + t * d + c));
          a0 += pr[t] * v.x;
          a1 += pr[t] * v.y;
        }
      }
      acc[r * d + c] = a0;
      acc[r * d + c + 1] = a1;
    }
  }
  __syncthreads();

  if (direct) {                          // acc / l (l == 0 writes 0), rounded to bf16
    for (int i = threadIdx.x; i < g * d; i += blockDim.x) {
      const float l = ls[i / d];
      out[row0 * d + i] = __float2bfloat16(acc[i] / (l == 0.f ? 1.f : l));
    }
    return;
  }
  const size_t prow0 = static_cast<size_t>(split) * batch * hkv * g + row0;
  for (int r = threadIdx.x; r < g; r += blockDim.x) {
    m_part[prow0 + r] = ms[r];
    l_part[prow0 + r] = ls[r];
  }
  if (n > 0 || split == 0)       // split 0's acc may be the initial state's
    for (int i = threadIdx.x; i < g * d / 4; i += blockDim.x)
      reinterpret_cast<float4*>(acc_part + prow0 * d)[i] = reinterpret_cast<const float4*>(acc)[i];
}

// Grid (Hkv, B).  Combines, for each query row of (b, kv-head), its splits'
// partials: the common max M over them, then l and acc as sums of each term
// rescaled by exp(m - M), taken in split order -- no atomics, so the result
// is the same bits run to run -- then acc / l (l == 0 writes 0) rounded to
// bf16.  Empty partials (l = 0) are skipped.  Dynamic shared memory:
// (3 n_splits + 2) G floats.
__global__ void __launch_bounds__(kWalkThreads)
paged_combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                     const float* __restrict__ acc_part, __nv_bfloat16* __restrict__ out,
                     int batch, int hkv, int g, int d, int n_splits) {
  extern __shared__ float wts[];
  float* mp = wts;                       // (n_splits, G) partial maxima
  float* lp = mp + n_splits * g;         // (n_splits, G) partial sums
  float* wp = lp + n_splits * g;         // (n_splits, G) their weights
  float* mxs = wp + n_splits * g;        // (G,) the common max
  float* lsum = mxs + g;                 // (G,) l (1 where l == 0)
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t row0 = (static_cast<size_t>(b) * hkv + h) * g;
  const size_t split_rows = static_cast<size_t>(batch) * hkv * g;
  for (int i = threadIdx.x; i < n_splits * g; i += blockDim.x) {
    const int s = i / g;
    const size_t prow = s * split_rows + row0 + (i - s * g);
    mp[i] = m_part[prow];
    lp[i] = l_part[prow];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < g; r += blockDim.x) {
    float mx = kNegInf;
    for (int s = 0; s < n_splits; ++s)
      if (lp[s * g + r] > 0.f) mx = fmaxf(mx, mp[s * g + r]);
    mxs[r] = mx;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_splits * g; i += blockDim.x)
    wp[i] = lp[i] > 0.f ? expf(mp[i] - mxs[i % g]) : 0.f;
  __syncthreads();
  for (int r = threadIdx.x; r < g; r += blockDim.x) {
    float l = 0.f;
    for (int s = 0; s < n_splits; ++s) l += lp[s * g + r] * wp[s * g + r];
    lsum[r] = l == 0.f ? 1.f : l;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * d / 2; i += blockDim.x) {
    const int r = i / (d / 2), c = 2 * (i - r * (d / 2));
    const size_t row = row0 + r;
    float o0 = 0.f, o1 = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_splits; ++s) {
      const float w = wp[s * g + r];
      float2 a = make_float2(0.f, 0.f);
      if (w != 0.f) a = *reinterpret_cast<const float2*>(acc_part + (s * split_rows + row) * d + c);
      o0 += a.x * w;
      o1 += a.y * w;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + row * d + c) =
        __floats2bfloat162_rn(o0 / lsum[r], o1 / lsum[r]);
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

// K1 / K3.  pps pages per split, n_splits splits (ops.plan_splits); with
// n_splits > 1 the caller passes f32 scratch m_part, l_part (n_splits, B,
// Hkv, G) and acc_part (n_splits, B, Hkv, G, D), else NULLs.  d / 8 a
// power of two up to 32, pps * pg <= 128.
extern "C" int valve_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                  const void* page_table, const void* start, const void* lengths,
                                  const void* m0, const void* l0, const void* acc0, void* out,
                                  void* m_part, void* l_part, void* acc_part, int batch, int hkv,
                                  int g, int d, int n_pages, int pg, int maxp, int pps,
                                  int n_splits, float scale, void* stream) {
  if (batch == 0) return 0;
  if (pps * pg > kSplitTokens || d < 8 || d > 256 || d % 8 || kWalkThreads % (d / 8) ||
      n_splits < 1 ||
      (n_splits > 1 && (!m_part || !l_part || !acc_part)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = walk_smem_bytes(g, pps, pg, d);
  cudaError_t err = set_smem(paged_split_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_split_kernel<<<dim3(n_splits, hkv, batch), kWalkThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(start), static_cast<const int*>(lengths),
      static_cast<const float*>(m0), static_cast<const float*>(l0),
      static_cast<const float*>(acc0), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(m_part), static_cast<float*>(l_part), static_cast<float*>(acc_part),
      batch, hkv, g, d, n_pages, pg, maxp, pps, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  const size_t wts = sizeof(float) * (3 * n_splits + 2) * g;
  err = set_smem(paged_combine_kernel, wts);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_combine_kernel<<<dim3(hkv, batch), kWalkThreads, wts, st>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<__nv_bfloat16*>(out), batch, hkv, g, d,
      n_splits);
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
