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
// streamed from device memory (3.35 TB/s).  At the decode shapes the pages
// are few, so in practice each CTA's serial chain of phases sets the time,
// and the designs shorten that chain.
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
// - K2: each deduplicated shared page is read once for the whole batch and
//   scored against all B*G query rows of a kv-head under the (B, S)
//   participation mask, so a prefix shared by B rows costs one read, not B.
//   The same phases as K1's split walk, in the plain version's f32 order:
//   half the CTA starts every K and V page copy with cp.async (the page ids
//   are the one load those wait for) while the other half loads the queries
//   and each row's mask columns; the scores of every (row, token) pair,
//   taken while V lands, four rows side by side a warp, each 8 tokens' lane
//   sums reduced in 9 shuffles (reduce8); the online-softmax steps slot by
//   slot, a warp a row (softmax_rows: one barrier); acc = alpha acc + p.V,
//   four columns of two rows a thread.  512 threads: every phase is a chain
//   of dependent steps, which more warps overlap.  A run of at most 128
//   tokens is one CTA per kv-head (ops.plan_shared_splits), in the plain
//   version's serial order, and writes the state itself; a longer run is
//   split over CTAs, and the combine pass merges the partial states in
//   split order into one (m, l, acc) state.  Past 32 query rows (B * G) the
//   rows are blocked over CTAs too, grid (slot splits, Hkv, row blocks), so
//   a CTA's shared memory holds at most 32 rows' queries, scores and acc
//   beside the split's pages, whatever the batch.  The TPU kernel walked
//   the slots serially on one core.
//
// Semantics kept from the TPU kernels: tokens at positions >= lengths[b] and
// non-participating shared slots score -1e30 (finite, so a fully masked row
// never makes NaN).  A row masked at every slot so far carries garbage mass
// at m = -1e30; the first finite score rescales it away (alpha =
// exp(-1e30 - m) = 0), so no reset is needed between the two phases; the
// combine keeps that state (a split masked for a row weighs exp(-1e30 - M)
// = 0, and a row masked in every split keeps m = -1e30 and the garbage).  A
// row whose l is 0 at the end writes 0.  A page id outside [0, n_pages)
// reads the quarantine page 0 instead, so no index ever leaves the pool.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWalkThreads = 128;
constexpr int kRunThreads = 512;
constexpr int kSplitTokens = 128;   // most tokens (pages * pg) one split holds
constexpr int kRunRows = 32;        // K2: most query rows one CTA takes
constexpr int kRowSoftmaxPages = 4; // K1/K3: most pages a split walks with softmax_rows
constexpr int kRowBlock = 4;        // K2: query rows a warp scores per K load
constexpr int kAccRows = 2;         // K2: query rows a thread keeps in its p.V sums

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
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&x)[N], int lane) {
  T v = x[0];
#pragma unroll
  for (int u = 1; u < N; ++u)
    if (lane == u) v = x[u];
  return v;
}

// Sum each of x[0..8) over the warp's 32 lanes with the xor butterfly's
// additions (lane strides 16, 8, 4, 2, 1: the same sums, so the same bits),
// in 9 shuffles instead of 40: each step hands the partner the half of the
// values it keeps.  Lane L ends with the sum of x[(L >> 2) & 7].
__device__ __forceinline__ float reduce8(const float (&x)[8], int lane) {
  const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4;
  float a[4], c[2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    a[k] = (b16 ? x[k + 4] : x[k]) + __shfl_xor_sync(0xffffffffu, b16 ? x[k] : x[k + 4], 16);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    c[k] = (b8 ? a[k + 2] : a[k]) + __shfl_xor_sync(0xffffffffu, b8 ? a[k] : a[k + 2], 8);
  float y = (b4 ? c[1] : c[0]) + __shfl_xor_sync(0xffffffffu, b4 ? c[0] : c[1], 4);
  y += __shfl_xor_sync(0xffffffffu, y, 2);
  return y + __shfl_xor_sync(0xffffffffu, y, 1);
}

// Start the copy of kv-head h of pages page_of(0..n) into a (n * pg, D)
// tile, 16 bytes a thread per cp.async, by threads tid of nthreads.  d / 8
// divides nthreads, so each thread keeps one 16-byte column and steps over
// the tokens.
template <typename PageOf>
__device__ __forceinline__ void issue_pages(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ pool,
                                            PageOf page_of, int n, int pg, int hkv, int h, int d,
                                            int tid, int nthreads) {
  const int row_vecs = d / 8, j = tid % row_vecs;
  for (int t = tid / row_vecs; t < n * pg; t += nthreads / row_vecs) {
    const int ip = t / pg;
    cp_async16(dst + t * d + 8 * j,
               pool + ((static_cast<size_t>(page_of(ip)) * pg + (t - ip * pg)) * hkv + h) * d + 8 * j);
  }
  cp_async_commit();
}

// The plain version's online-softmax step for each of n pages (or slots) of
// pg tokens, page by page in its f32 order, but in phases over all of them
// at once: each (row, page)'s max; then each row's running max and alpha,
// page by page; then each (row, page)'s p = exp(s - m) and its sum; then
// each row's l and m.  ps: (rows, stride * pg) scores, overwritten by p;
// pmax, psum, alpha: (rows, stride), pmax left holding the running max;
// ms, ls: (rows,), updated.  A warp takes 4 (row, page) pairs at a time,
// reducing them side by side.  No barrier after the last phase.
__device__ __forceinline__ void softmax_pages(float* ps, float* pmax, float* psum, float* alpha,
                                              float* ms, float* ls, int rows, int n, int pg,
                                              int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int tokens = stride * pg, pairs = rows * n;
  // the row and page of pairs rp0 .. rp0 + 3, stepped from rp0's
  auto locate = [&](int rp0, int (&rr)[4], int (&ii)[4]) {
    rr[0] = rp0 / n;
    ii[0] = rp0 - rr[0] * n;
#pragma unroll
    for (int u = 1; u < 4; ++u) {
      const bool wrap = ii[u - 1] + 1 == n;
      rr[u] = rr[u - 1] + wrap;
      ii[u] = wrap ? 0 : ii[u - 1] + 1;
    }
  };
  for (int rp0 = 4 * warp; rp0 < pairs; rp0 += 4 * n_warps) {
    int rr[4], ii[4];
    locate(rp0, rr, ii);
    float mx[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      mx[u] = kNegInf;
      if (rp0 + u < pairs) {
        const float* pr = ps + rr[u] * tokens + ii[u] * pg;
        for (int t = lane; t < pg; t += 32) mx[u] = fmaxf(mx[u], pr[t]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < 4; ++u) mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], o));
    if (lane < 4 && rp0 + lane < pairs) pmax[pick(rr, lane) * stride + pick(ii, lane)] = pick(mx, lane);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float m = ms[r];
    for (int ip = 0; ip < n; ++ip) {
      const float m_new = fmaxf(m, pmax[r * stride + ip]);
      alpha[r * stride + ip] = expf(m - m_new);
      pmax[r * stride + ip] = m_new;          // now the running max
      m = m_new;
    }
  }
  __syncthreads();
  for (int rp0 = 4 * warp; rp0 < pairs; rp0 += 4 * n_warps) {
    int rr[4], ii[4];
    locate(rp0, rr, ii);
    float sum[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      sum[u] = 0.f;
      if (rp0 + u < pairs) {
        float* pr = ps + rr[u] * tokens + ii[u] * pg;
        const float m_new = pmax[rr[u] * stride + ii[u]];
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
    if (lane < 4 && rp0 + lane < pairs) psum[pick(rr, lane) * stride + pick(ii, lane)] = pick(sum, lane);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float l = ls[r];
    for (int ip = 0; ip < n; ++ip) l = l * alpha[r * stride + ip] + psum[r * stride + ip];
    ls[r] = l;
    ms[r] = pmax[r * stride + n - 1];
  }
}

// The same steps, the same f32 operations in the same order, with a warp
// per query row walking its n pages in registers: each page's max over its
// pg scores, the running max and alpha, p = exp(s - m) and its sum (each
// lane's tokens, then the xor tree, as softmax_pages sums), then l -- one
// barrier in all where softmax_pages takes four.  ps: (rows, stride * pg)
// scores, overwritten by p; alpha: (rows, stride); ms, ls: (rows,),
// updated.  No barrier at the end.  Which is faster depends on the chain
// each warp walks (H100, chip_smoke.py phase 3): this one at up to 4 pages
// (K1/K3 at the decode shapes by ~0.0005 ms, a split a page by ~0.001 ms)
// and for K2's many rows; softmax_pages at 8 (by ~0.001-0.002 ms), where a
// warp a row walks a long serial chain; the two tie at 6.
__device__ __forceinline__ void softmax_rows(float* ps, float* alpha, float* ms, float* ls,
                                             int rows, int n, int pg, int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int tokens = stride * pg;
  for (int r = warp; r < rows; r += n_warps) {
    float m = ms[r], l = ls[r];
    for (int ip = 0; ip < n; ++ip) {
      float* pr = ps + r * tokens + ip * pg;
      float mx = kNegInf;
      for (int t = lane; t < pg; t += 32) mx = fmaxf(mx, pr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m, mx), al = expf(m - m_new);
      float sum = 0.f;
      for (int t = lane; t < pg; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l = l * al + sum;
      m = m_new;
      if (lane == 0) alpha[r * stride + ip] = al;
    }
    if (lane == 0) {
      ms[r] = m;
      ls[r] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// K1 / K3: the page walk split over CTAs ("split-KV"), then a combine pass
// ---------------------------------------------------------------------------

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
// while V lands, then the softmax steps (softmax_rows up to
// kRowSoftmaxPages pages, else softmax_pages), then acc = alpha acc + p . V
// page after page.  q, out: (B, Hkv, G, D); the optional initial state m0, l0:
// (B, Hkv, G) and acc0: (B, Hkv, G, D) (NULL: empty state); the optional
// start: (B,) (NULL: 0).  Split 0 walks on from the initial state, as the
// plain version does (with no live page its partial is that state); the
// others walk from the empty state.  With one split the CTA writes out
// itself; otherwise each writes its partial to m_part, l_part (n_splits,
// B, Hkv, G) and acc_part (n_splits, B, Hkv, G, D), f32, for
// paged_combine_kernel.
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
    auto page_of = [&](int ip) { return pages[ip]; };
    issue_pages(ks, k_pool, page_of, n, pg, hkv, h, d, threadIdx.x, blockDim.x);   // group: K
    issue_pages(vs, v_pool, page_of, n, pg, hkv, h, d, threadIdx.x, blockDim.x);   // group: V
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
    if (n > kRowSoftmaxPages)
      softmax_pages(ps, pmax, psum, alpha, ms, ls, g, n, pg, pps);
    else
      softmax_rows(ps, alpha, ms, ls, g, n, pg, pps);
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
// is the same bits run to run.  Empty partials (l = 0) are skipped.
// kState = false (K1/K3): writes acc / l (l == 0 writes 0) rounded to bf16
// into out.  kState = true (K2): writes the merged state m = M, l and acc,
// f32, into m_out, l_out (B, Hkv, G) and acc_out (B, Hkv, G, D).  Dynamic
// shared memory: (3 n_splits + 2) G floats.
template <bool kState>
__global__ void __launch_bounds__(kWalkThreads)
paged_combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                     const float* __restrict__ acc_part, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     float* __restrict__ acc_out, int batch, int hkv, int g, int d,
                     int n_splits) {
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
    if constexpr (kState) {
      m_out[row0 + r] = mxs[r];
      l_out[row0 + r] = l;
    }
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
    if constexpr (kState)
      *reinterpret_cast<float2*>(acc_out + row * d + c) = make_float2(o0, o1);
    else
      *reinterpret_cast<__nv_bfloat162*>(out + row * d + c) =
          __floats2bfloat162_rn(o0 / lsum[r], o1 / lsum[r]);
  }
}

// ---------------------------------------------------------------------------
// K2: the shared run, its slots split over CTAs past 128 tokens
// ---------------------------------------------------------------------------

// rows: the query rows of one CTA, at most kRunRows
__host__ __device__ inline size_t run_smem_bytes(int rows, int sps, int pg, int d) {
  const size_t tokens = static_cast<size_t>(sps) * pg;
  return sizeof(float) * (2 * rows * d + rows * tokens + 2 * rows * sps + 2 * rows) +
         2 * sizeof(__nv_bfloat16) * tokens * d;
}

// Grid (n_splits, Hkv, row blocks).  Split s reads the slots [s * sps,
// s * sps + n) of the S deduplicated shared pages; query row r = b * G + j
// of kv-head h attends slot js iff mask[b, js] > 0.  Row block z takes the
// query rows [z * kRunRows, (z + 1) * kRunRows), so shared memory does not
// grow with the batch; each row's arithmetic is the same in any block.  Shared pages are fully filled by the
// publication contract, so no length mask applies here.  The split's slots
// are walked as paged_split_kernel walks its pages: the plain version's
// online-softmax step slot by slot, in its f32 order, in phases over all
// the slots at once.  With one split the CTA writes the state m, l:
// (B, Hkv, G) and acc: (B, Hkv, G, D), f32; otherwise its partial goes to
// m_part, l_part (n_splits, B, Hkv, G) and acc_part (n_splits, B, Hkv, G,
// D) for paged_combine_kernel<true>.
__global__ void __launch_bounds__(kRunThreads)
shared_run_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
                  const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ pages,
                  const float* __restrict__ mask, float* __restrict__ m_out,
                  float* __restrict__ l_out, float* __restrict__ acc_out,
                  float* __restrict__ m_part, float* __restrict__ l_part,
                  float* __restrict__ acc_part, int batch, int hkv, int g, int d, int n_pages,
                  int pg, int n_slots, int sps, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, h = blockIdx.y, r_base = blockIdx.z * kRunRows;
  const int rows = min(kRunRows, batch * g - r_base), tokens = sps * pg;
  const int s0 = split * sps, n = max(0, min(sps, n_slots - s0)), nt = n * pg;
  float* qs = reinterpret_cast<float*>(smem_raw);                       // (rows, D)
  float* acc = qs + rows * d;                                            // (rows, D)
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(acc + rows * d);  // (tokens, D)
  __nv_bfloat16* vs = ks + tokens * d;                                  // (tokens, D)
  float* ps = reinterpret_cast<float*>(vs + tokens * d);                // (rows, tokens)
  float* alpha = ps + rows * tokens;                                     // (rows, sps) slot rescale
  float* ms = alpha + rows * sps;                                       // (rows,)
  float* ls = ms + rows;                                                // (rows,)
  float* mk = ls + rows;                                                // (rows, sps) mask

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  // the block's query row r is row r_base + r = b * g + j of the batch,
  // at ((b * hkv + h) * g + j) in (B, Hkv, G, .)
  auto row_index = [&](int r) {
    const int b = (r_base + r) / g;
    return (static_cast<size_t>(b) * hkv + h) * g + (r_base + r - b * g);
  };
  // half the threads start the K and V copies (their page ids are the one
  // load those wait for) while the other half loads each query row's mask
  // columns and the queries, so the two round trips overlap
  const int half = blockDim.x / 2;
  if (threadIdx.x < half) {
    auto page_of = [&](int ip) {
      const int page = pages[s0 + ip];
      return (page < 0 || page >= n_pages) ? 0 : page;        // never leave the pool
    };
    if (n > 0) {
      issue_pages(ks, k_pool, page_of, n, pg, hkv, h, d, threadIdx.x, half);   // group: K
      issue_pages(vs, v_pool, page_of, n, pg, hkv, h, d, threadIdx.x, half);   // group: V
    }
  } else {
    for (int i = threadIdx.x - half; i < rows * n; i += half) {
      const int r = i / n, js = i - r * n;
      mk[r * sps + js] = mask[static_cast<size_t>((r_base + r) / g) * n_slots + s0 + js];
    }
    for (int i = threadIdx.x - half; i < rows * d / 8; i += half) {   // 16 bytes a thread
      const int r = 8 * i / d, c = 8 * i - r * d;
      const uint4 raw = *reinterpret_cast<const uint4*>(q + row_index(r) * d + c);
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(q2[u]);
        qs[8 * i + 2 * u] = f.x;
        qs[8 * i + 2 * u + 1] = f.y;
      }
    }
  }
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) acc[i] = 0.f;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }
  __syncthreads();

  if (n > 0) {
    cp_async_wait<1>();                                        // K landed; V still may not
    __syncthreads();

    // scores: a warp takes 8 tokens and kRowBlock query rows at a time,
    // lanes over D; the 8 tokens' lane sums reduce side by side (reduce8)
    const int groups = (nt + 7) / 8, rblocks = (rows + kRowBlock - 1) / kRowBlock;
    for (int item = warp; item < groups * rblocks; item += n_warps) {
      const int t0 = 8 * (item % groups), r0 = kRowBlock * (item / groups);
      // tokens past the split's read (unstored) rows of the tile, so the
      // loads need no branch
      float kr[8][8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = lane * 4 + 128 * j;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          uint2 raw = make_uint2(0u, 0u);                      // one 8-byte read: no bank conflict
          if (i < d) raw = *reinterpret_cast<const uint2*>(ks + min(t0 + u, tokens - 1) * d + i);
          const float2 k01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 k23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          kr[u][4 * j] = k01.x; kr[u][4 * j + 1] = k01.y;
          kr[u][4 * j + 2] = k23.x; kr[u][4 * j + 3] = k23.y;
        }
      }
      const int t = t0 + ((lane >> 2) & 7);                   // this lane's token after reduce8
      const int js = t / pg;
      // the block's rows side by side (a row past the last repeats it,
      // unstored), so their shuffle chains overlap
      // each lane's partial dot: its 4 columns of D (and 4 more at D > 128),
      // summed as K1's walk sums them, less the add to an initial zero
      float dot[kRowBlock][8];
#pragma unroll
      for (int k = 0; k < kRowBlock; ++k) {
        const int r = min(r0 + k, rows - 1);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = lane * 4 + 128 * j;
          const float4 qv = i < d ? *reinterpret_cast<const float4*>(qs + r * d + i)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (j == 1 && i >= d) continue;
            const float part = qv.x * kr[u][4 * j] + qv.y * kr[u][4 * j + 1] +
                               qv.z * kr[u][4 * j + 2] + qv.w * kr[u][4 * j + 3];
            dot[k][u] = j == 0 ? part : dot[k][u] + part;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRowBlock; ++k) {
        const int r = r0 + k;
        const float x = reduce8(dot[k], lane);
        if (r < rows && (lane & 3) == 0 && t < nt)
          ps[r * tokens + t] = mk[r * sps + js] > 0.f ? x * scale : kNegInf;
      }
    }
    __syncthreads();
    softmax_rows(ps, alpha, ms, ls, rows, n, pg, sps);
    cp_async_wait<0>();                                        // V landed
    __syncthreads();

    // acc = alpha acc + p . V slot after slot; a thread keeps kAccRows
    // query rows of four columns, so each V read (8 bytes) serves both rows
    const int quads = d / 4, ablocks = (rows + kAccRows - 1) / kAccRows;
    for (int i = threadIdx.x; i < ablocks * quads; i += blockDim.x) {
      const int r0 = kAccRows * (i / quads), c = 4 * (i % quads);
      int rr[kAccRows];
      float4 a[kAccRows];
#pragma unroll
      for (int k = 0; k < kAccRows; ++k) {
        rr[k] = min(r0 + k, rows - 1);        // a row past the last repeats it, unstored
        a[k] = *reinterpret_cast<const float4*>(acc + rr[k] * d + c);
      }
      for (int js = 0; js < n; ++js) {
#pragma unroll
        for (int k = 0; k < kAccRows; ++k) {
          const float al = alpha[rr[k] * sps + js];
          a[k].x *= al;
          a[k].y *= al;
          a[k].z *= al;
          a[k].w *= al;
        }
#pragma unroll 4
        for (int t = js * pg; t < (js + 1) * pg; ++t) {
          const uint2 raw = *reinterpret_cast<const uint2*>(vs + t * d + c);
          const float2 v01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 v23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
#pragma unroll
          for (int k = 0; k < kAccRows; ++k) {
            const float p = ps[rr[k] * tokens + t];
            a[k].x += p * v01.x;
            a[k].y += p * v01.y;
            a[k].z += p * v23.x;
            a[k].w += p * v23.y;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kAccRows; ++k)
        if (r0 + k < rows) *reinterpret_cast<float4*>(acc + (r0 + k) * d + c) = a[k];
    }
  }
  __syncthreads();

  const bool direct = gridDim.x == 1;
  const size_t prow0 = direct ? 0 : static_cast<size_t>(split) * batch * hkv * g;
  float* m_dst = direct ? m_out : m_part + prow0;
  float* l_dst = direct ? l_out : l_part + prow0;
  float* acc_dst = direct ? acc_out : acc_part + prow0 * d;
  for (int i = threadIdx.x; i < rows * d / 4; i += blockDim.x) {
    const int r = 4 * i / d;
    *reinterpret_cast<float4*>(acc_dst + row_index(r) * d + (4 * i - r * d)) =
        reinterpret_cast<const float4*>(acc)[i];
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    m_dst[row_index(r)] = ms[r];
    l_dst[row_index(r)] = ls[r];
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
  err = set_smem(paged_combine_kernel<false>, wts);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_combine_kernel<false><<<dim3(hkv, batch), kWalkThreads, wts, st>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<__nv_bfloat16*>(out), nullptr, nullptr,
      nullptr, batch, hkv, g, d, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// K2.  sps slots per split, n_splits splits (ops.plan_shared_splits); with
// n_splits > 1 the caller passes f32 scratch m_part, l_part (n_splits, B,
// Hkv, G) and acc_part (n_splits, B, Hkv, G, D), else NULLs.  d / 8 a
// power of two up to 32, sps * pg <= 128.  At most kRunRows query rows a
// CTA bound its shared memory whatever the batch: 210 KB at D = 256 and
// page 16; a shape past the card's limit (D = 256 at page 1) returns the
// launch error.
extern "C" int valve_shared_run(const void* q, const void* k_pool, const void* v_pool,
                                const void* pages, const void* mask, void* m_out, void* l_out,
                                void* acc_out, void* m_part, void* l_part, void* acc_part,
                                int batch, int hkv, int g, int d, int n_pages, int pg,
                                int n_slots, int sps, int n_splits, float scale, void* stream) {
  if (batch == 0) return 0;
  if (sps < 1 || sps * pg > kSplitTokens || d < 8 || d > 256 || d % 8 ||
      kRunThreads % (d / 8) || n_splits < 1 || (n_slots + sps - 1) / sps > n_splits ||
      (n_splits > 1 && (!m_part || !l_part || !acc_part)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = batch * g, row_blocks = (rows + kRunRows - 1) / kRunRows;
  const size_t smem = run_smem_bytes(min(rows, kRunRows), sps, pg, d);
  cudaError_t err = set_smem(shared_run_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  shared_run_kernel<<<dim3(n_splits, hkv, row_blocks), kRunThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(pages),
      static_cast<const float*>(mask), static_cast<float*>(m_out), static_cast<float*>(l_out),
      static_cast<float*>(acc_out), static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part), batch, hkv, g, d, n_pages, pg, n_slots, sps, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  const size_t wts = sizeof(float) * (3 * n_splits + 2) * g;
  err = set_smem(paged_combine_kernel<true>, wts);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_combine_kernel<true><<<dim3(hkv, batch), kWalkThreads, wts, st>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), nullptr, static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<float*>(acc_out), batch, hkv, g, d, n_splits);
  return static_cast<int>(cudaGetLastError());
}
