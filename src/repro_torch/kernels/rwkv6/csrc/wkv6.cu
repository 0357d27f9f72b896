// WKV6 (RWKV-6 "Finch") for Hopper (sm_90a): tile-parallel on the tensor
// cores, with no decay envelope.
//
// Replaces the TPU Pallas kernel in src/repro/kernels/rwkv6/kernel.py:
//   _wkv6_kernel / wkv6_bthk   -> valve_wkv6   (K6)
//
// Computes, per (b, h), over the tokens t in order:
//   y_t = r_t . (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t
// with the (K, V) state S in f32, from state_in to state_out; r/k/v/w/u are
// f32 or bf16, y is written in their dtype.  Its plain version is
// ref.py's wkv6_tiled_ref, which follows the same steps.
//
// What bounds it: bytes.  Each token and head reads r, k, w (K each) and v
// and writes y (V): at rwkv6-3b (B = 4, T = 2048, H = 40, K = V = 64, f32)
// 424.6 MB with the state, 0.1268 ms at 3.35 TB/s.  The tiled form does
// about 2 (2 K V + 24 K + 24 V) operations a token and head (the state's
// read and update, the sub-block scores and their product with v), 7.4
// GFLOP a call: 0.11 ms at the f32 FMA peak, as much as the bytes; on the
// tensor cores as 3xTF32 (below) a third of mma.sync's TF32 rate.
//
// Design:
// - Grid (ceil(V / 64), H, B), the value block fastest: each column of S
//   evolves on its own, so a CTA owns 64 value columns of one (b, h) and
//   walks its tokens in 32-token tiles, carrying its (K, 64) block of S in
//   its state warps' registers.  No second pass, no state round trip
//   through device memory.  (16 or 32 columns a CTA, 640 or 320 CTAs at
//   rwkv6-3b, repeat the tile's score work in each CTA and ran slower.)
// - Warp roles: every warp takes part in a tile's prep (the running
//   products, the tables, the u bonus); then half the warps compute y,
//   starting with its product with S, while the other half compute the
//   scores, hand them over on a named barrier and update S.
// - Loads in flight: once a tile's prep has read its raw r, k, w, one
//   thread starts the next tile's by TMA (one box each, rows past T
//   zero-filled, completing on an mbarrier), behind the tile's products;
//   every thread starts its share of the next v tile by cp.async at the top
//   of the tile, into the other stage of a two-stage ring (rows padded
//   against bank conflicts).  (Per-thread cp.async for r, k, w as well, 8
//   copies a thread a tile, stalled the warps at the top of each tile.)
//   bf16 inputs are converted after the copy.  Two CTAs fit an SM (~105 KB
//   of shared memory each at K = 64).
// - Every product on the tensor cores as 3xTF32 (mma.sync m16n8k8): each f32
//   operand is a TF32 high part plus a TF32 residual, and a_hi b_hi +
//   a_hi b_lo + a_lo b_hi keeps f32 accuracy (one pass of TF32 keeps ~3
//   digits).  The products: the sub-block scores (16 x 16 over K), y_intra =
//   masked scores . v, y_inter = r_dec . S, and the update k_end^T . v.
// - No decay envelope.  Each 16-token sub-block takes running products of w
//   (no log, no exp, no division by a cumulative decay): r~_t = r_t
//   prod_{start <= tau < t} w, k^_s = k_s prod_{s < tau <= end} w, every
//   factor <= 1, so they can underflow to the right answer but never
//   overflow.  Between sub-blocks the decay is r~ k^ times the totals in
//   between (<= 1).  On a diagonal block it is r~ k^ / T_I, for each channel
//   whose sub-block total T_I >= 1e-24; a channel below that (a sub-block
//   that decays by more than ~55 nats, w = 0 included) is summed pair by pair
//   with its own prod_{s < tau < t} w, on the FMA units.  The u bonus is the
//   diagonal of the scores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"

namespace {

constexpr int SUB = 16;                // tokens a sub-block: one decay reference
constexpr int NSUB = 2;                // sub-blocks a tile
constexpr int TILE = SUB * NSUB;       // tokens a tile
constexpr float kSafeTotal = 1e-24f;   // ref.py SAFE_TOTAL

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Named barriers of a subset of the CTA's threads (0 is __syncthreads).
constexpr int kScoresBar = 1;   // the state warps' scores -> the y warps
constexpr int kStateBar = 2;    // the state warps among themselves
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One TMA box of a 4-D map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// x = hi + lo: hi is x rounded to TF32 (ties away, as cvt.rna.tf32.f32 by
// integer ops), lo = x - hi is exact in f32, and the tensor core reads lo's
// top 10 mantissa bits, so hi + lo carries x to ~2^-21.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, m16n8k8, TF32 operands, f32 accumulators.  Fragments (g = lane
// / 4, q = lane % 4): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8,
// q + 4); b0 (k = q, n = g), b1 (q + 4, g); d0 (g, 2q), d1 (g, 2q + 1),
// d2 (g + 8, 2q), d3 (g + 8, 2q + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: d += a b to f32 accuracy, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// A fragment of rows row0.., columns col0.. of a row-major f32 matrix m,
// column j scaled by scale[j] (nullptr: no scale).
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* m, int ld,
                                       int row0, int col0, const float* scale, int g, int q) {
  const float s0 = scale ? scale[col0 + q] : 1.f, s1 = scale ? scale[col0 + q + 4] : 1.f;
  split(m[(row0 + g) * ld + col0 + q] * s0, hi[0], lo[0]);
  split(m[(row0 + g + 8) * ld + col0 + q] * s0, hi[1], lo[1]);
  split(m[(row0 + g) * ld + col0 + q + 4] * s1, hi[2], lo[2]);
  split(m[(row0 + g + 8) * ld + col0 + q + 4] * s1, hi[3], lo[3]);
}

// A fragment of the transpose: element (i, j) = m[(col0 + j) * ld + row0 + i]
// * scale[row0 + i].
__device__ __forceinline__ void load_at(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* m,
                                        int ld, int row0, int col0, const float* scale, int g,
                                        int q) {
  const float s0 = scale[row0 + g], s1 = scale[row0 + g + 8];
  split(m[(col0 + q) * ld + row0 + g] * s0, hi[0], lo[0]);
  split(m[(col0 + q) * ld + row0 + g + 8] * s1, hi[1], lo[1]);
  split(m[(col0 + q + 4) * ld + row0 + g] * s0, hi[2], lo[2]);
  split(m[(col0 + q + 4) * ld + row0 + g + 8] * s1, hi[3], lo[3]);
}

// B fragment, element (kk, n) = m[(k0 + kk) * ld + n0 + n] (m stored K by N).
template <typename T>
__device__ __forceinline__ void load_b_kn(uint32_t (&hi)[2], uint32_t (&lo)[2], const T* m, int ld,
                                          int k0, int n0, int g, int q) {
  split(to_f32(m[(k0 + q) * ld + n0 + g]), hi[0], lo[0]);
  split(to_f32(m[(k0 + q + 4) * ld + n0 + g]), hi[1], lo[1]);
}

// B fragment, element (kk, n) = m[(n0 + n) * ld + k0 + kk] (m stored N by K).
__device__ __forceinline__ void load_b_nk(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* m,
                                          int ld, int k0, int n0, int g, int q) {
  split(m[(n0 + g) * ld + k0 + q], hi[0], lo[0]);
  split(m[(n0 + g) * ld + k0 + q + 4], hi[1], lo[1]);
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

constexpr int VB = 64;                 // value columns a CTA
constexpr int NW = 8;                  // warps
constexpr int YN = 4;                  // 8-column n-tiles of a y or state warp
constexpr int NT = 32 * NW;

// Shared memory of one CTA: the raw r, k, w tile (refilled once the tile's
// prep has read it), a two-stage ring of v tiles, r~ and k^, the scores, the
// state block before and after the tile, and the per-channel tables.  Row
// strides of what the fragment loads read are padded so that a warp's
// loads fall on distinct banks.
template <typename T, int K>
struct Layout {
  static constexpr int KS = K + 4;        // r~, k^ (f32)
  static constexpr int VS = VB + 8;       // a v tile (T)
  static constexpr int PS = TILE + 4;     // scores (f32)
  static constexpr int SS = VB + 8;       // the state block (f32)
  static constexpr size_t raw = 0;        // [r, k, w][TILE][K] (T), TMA boxes
  static constexpr size_t vt = raw + 3 * TILE * K * sizeof(T);
  static constexpr size_t rt = align16(vt + 2 * TILE * VS * sizeof(T));
  static constexpr size_t kh = rt + TILE * KS * 4;
  static constexpr size_t pm = kh + TILE * KS * 4;
  static constexpr size_t st = pm + TILE * PS * 4;
  static constexpr size_t tabs = st + 2 * K * SS * 4;   // S before and after a tile
  // G [NSUB][NSUB][K], apre and apost [NSUB][K], aend, u [K], bonus [TILE]
  static constexpr size_t bars = align16(tabs + 4 * (NSUB * K * (NSUB + 2) + 2 * K + TILE));
  static constexpr size_t bytes = bars + 8;   // the raw tile's mbarrier
};

// Start the r, k, w boxes of tokens t0.. of head h, batch b (rows past T
// read as zeros) into one ring stage, completing on `bar`.
template <int K, typename T>
__device__ __forceinline__ void load_rkw(uint32_t dst, uint32_t bar, const CUtensorMap* r_map,
                                         const CUtensorMap* k_map, const CUtensorMap* w_map,
                                         int h, int t0, int b) {
  constexpr uint32_t box = TILE * K * sizeof(T);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the ring's generic reads
  mbar_expect_tx(bar, 3 * box);
  tma_load_4d(dst, r_map, bar, 0, h, t0, b);
  tma_load_4d(dst + box, k_map, bar, 0, h, t0, b);
  tma_load_4d(dst + 2 * box, w_map, bar, 0, h, t0, b);
}

// Start copying the v rows of tokens t0.., value columns col_base.. into a
// v tile: cp.async where rows are 16-byte aligned (vec), plain loads
// otherwise; zeros past t_len and past dv.
template <typename T, int VS>
__device__ __forceinline__ void load_v(T* dst, const T* v, size_t base, size_t tok, int t0,
                                       int t_len, int col_base, int dv, int vec, int tid) {
  constexpr int EPC = 16 / sizeof(T), CPR = VB / EPC;
  const int n = min(TILE, t_len - t0);
  for (int i = tid; i < TILE * CPR; i += NT) {
    const int row = i / CPR, c = (i % CPR) * EPC, col = col_base + c;
    T* d = dst + row * VS + c;
    const T* src = v + base + static_cast<size_t>(t0 + row) * tok + col;
    if (row < n && vec && col < dv) {
      cp_async16(d, src);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) d[e] = (row < n && col + e < dv) ? src[e] : from_f32<T>(0.f);
    }
  }
}

// Grid (ceil(V / VB), H, B), NT threads.  r, k, w: (B, T, H, K), by their
// TMA maps; v, y: (B, T, H, V); u: (H, K); state_in, state_out: (B, H, K,
// V) f32.  Every warp takes part in the tile's prep.  Then the first NW / 2
// warps compute y, its product with S first; the others compute the scores,
// hand them over on a named barrier, and update the state.  y warp w owns
// the rows of sub-blocks I = w % 2 (mod 2) and the 32 columns from 32 (w /
// 2); state warp w' = w - NW / 2 the rows of 16-row tiles m = w' % 2 (mod 2)
// and the 32 columns from 32 (w' / 2), carried in registers from tile to
// tile and written to shared memory (S after the tile) for the y warps.
template <typename T, int K>
__global__ void __launch_bounds__(NT, 2)
    wkv6_tile_kernel(const __grid_constant__ CUtensorMap r_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap w_map, const T* __restrict__ v,
                     const T* __restrict__ u,
                     const float* __restrict__ state_in, T* __restrict__ y,
                     float* __restrict__ state_out, int t_len, int heads, int dv, int vec_v) {
  using L = Layout<T, K>;
  constexpr int KS = L::KS, VS = L::VS, PS = L::PS, SS = L::SS;
  constexpr int KM = K / 16;              // 16-row tiles of the state
  constexpr int SJ = (KM + 1) / 2;        // of which a warp owns at most SJ
  constexpr int KT = TILE / 8;            // 8-token steps of a tile

  extern __shared__ __align__(128) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem + L::raw);
  T* raw_r = raw;
  T* raw_k = raw_r + TILE * K;
  T* raw_w = raw_k + TILE * K;
  const uint32_t raw_s = smem_u32(raw), bar = smem_u32(smem + L::bars);
  T* vtile = reinterpret_cast<T*>(smem + L::vt);
  float* rt = reinterpret_cast<float*>(smem + L::rt);     // r~  (TILE, KS)
  float* kh = reinterpret_cast<float*>(smem + L::kh);     // k^  (TILE, KS)
  float* pm = reinterpret_cast<float*>(smem + L::pm);     // scores (TILE, PS)
  float* st = reinterpret_cast<float*>(smem + L::st);     // S block [2](K, SS)
  float* gm = reinterpret_cast<float*>(smem + L::tabs);   // G_IJ     [NSUB][NSUB][K]
  float* apre = gm + NSUB * NSUB * K;                     // before I [NSUB][K]
  float* apost = apre + NSUB * K;                         // after J  [NSUB][K]
  float* aend = apost + NSUB * K;                         // the tile [K]
  float* us = aend + K;                                   // u        [K]
  float* bonus = us + K;                                  // r.(u k)  [TILE]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const bool y_warp = warp < NW / 2;
  const int wr = y_warp ? warp : warp - NW / 2;
  const int par = wr & 1, c0 = 8 * YN * (wr >> 1);  // this warp's rows mod 2, columns
  const int vb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int col_base = vb * VB;
  const size_t tok_v = static_cast<size_t>(heads) * dv;
  const size_t base_v = (static_cast<size_t>(b) * t_len * heads + h) * dv;
  const size_t base_s = static_cast<size_t>(b * heads + h) * K * dv;
  const int n_tiles = (t_len + TILE - 1) / TILE;

  for (int i = tid; i < K; i += NT) us[i] = to_f32(u[static_cast<size_t>(h) * K + i]);

  // the state block: a state warp's rows in accumulator fragments
  float sacc[SJ][YN][4];
#pragma unroll
  for (int i = 0; i < SJ; ++i) {
    const int m = par + 2 * i;
#pragma unroll
    for (int nt = 0; nt < YN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * m + g + (e >= 2 ? 8 : 0), cl = c0 + 8 * nt + 2 * q + (e & 1);
        const int col = col_base + cl;
        float s = 0.f;
        if (!y_warp && m < KM && col < dv)
          s = state_in[base_s + static_cast<size_t>(row) * dv + col];
        sacc[i][nt][e] = s;
        if (!y_warp && m < KM) st[row * SS + cl] = s;
      }
  }

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n_tiles > 0) {
    if (tid == 0) load_rkw<K, T>(raw_s, bar, &r_map, &k_map, &w_map, h, 0, b);
    load_v<T, VS>(vtile, v, base_v, tok_v, 0, t_len, col_base, dv, vec_v, tid);
  }
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * TILE, slot = it & 1;
    mbar_wait(bar, it & 1);
    cp_async_wait_all();
    if (t0 + TILE > t_len)  // a token past t_len decays nothing: w = 1
      for (int i = (t_len - t0) * K + tid; i < TILE * K; i += NT) raw_w[i] = from_f32<T>(1.f);
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (it + 1 < n_tiles)
      load_v<T, VS>(vtile + (slot ^ 1) * TILE * VS, v, base_v, tok_v, t0 + TILE, t_len,
                    col_base, dv, vec_v, tid);
    cp_async_commit();
    const T* vs = vtile + slot * TILE * VS;
    const float* s_in = st + slot * K * SS;  // S before this tile
    float* s_out = st + (slot ^ 1) * K * SS;  // S after it

    // Threads [0, K): r~ forward over the sub-blocks, then the channel's
    // tables (a channel whose sub-block decays past kSafeTotal gets G_II = 0
    // and is summed pair by pair below).  [K, 2K): k^ backward.  The second
    // half of the warps: the u bonus, r_t . (u k_t), 4 lanes a row, the
    // channels skewed by row so that the lanes' loads fall on distinct banks.
    int unsafe = 0;
    if (tid < K) {
      const int c = tid;
      float tt[NSUB];
#pragma unroll
      for (int si = 0; si < NSUB; ++si) {
        float a = 1.f;
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          const int t = si * SUB + j;
          rt[t * KS + c] = to_f32(raw_r[t * K + c]) * a;
          a *= to_f32(raw_w[t * K + c]);
        }
        tt[si] = a;
      }
#pragma unroll
      for (int i = 0; i < NSUB; ++i) {
        const bool safe = tt[i] >= kSafeTotal;
        gm[(i * NSUB + i) * K + c] = safe ? 1.f / tt[i] : 0.f;
        unsafe |= !safe;
        float between = 1.f;
        for (int j = i - 1; j >= 0; --j) {
          gm[(i * NSUB + j) * K + c] = between;
          between *= tt[j];
        }
      }
      float a = 1.f;
#pragma unroll
      for (int i = 0; i < NSUB; ++i) {
        apre[i * K + c] = a;
        a *= tt[i];
      }
      aend[c] = a;
      a = 1.f;
#pragma unroll
      for (int j = NSUB - 1; j >= 0; --j) {
        apost[j * K + c] = a;
        a *= tt[j];
      }
    } else if (tid < 2 * K) {
      const int c = tid - K;
#pragma unroll
      for (int si = 0; si < NSUB; ++si) {
        float a = 1.f;
#pragma unroll
        for (int j = SUB - 1; j >= 0; --j) {
          const int t = si * SUB + j;
          kh[t * KS + c] = to_f32(raw_k[t * K + c]) * a;
          a *= to_f32(raw_w[t * K + c]);
        }
      }
    }
    for (int row0 = 8 * (warp - NW / 2); warp >= NW / 2 && row0 < TILE; row0 += 4 * NW) {
      const int rr = lane >> 2, part = lane & 3, t = row0 + rr;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < K / 4; ++i) {
        const int c = (part + 4 * (i + rr)) & (K - 1);
        acc += to_f32(raw_r[t * K + c]) * us[c] * to_f32(raw_k[t * K + c]);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) bonus[t] = acc;
    }
    const int any_unsafe = __syncthreads_or(unsafe);
    // the raw tile is consumed unless a diagonal block needs its pairs: copy
    // the next one in behind the products
    if (!any_unsafe && it + 1 < n_tiles && tid == 0)
      load_rkw<K, T>(raw_s, bar, &r_map, &k_map, &w_map, h, t0 + TILE, b);

    if (y_warp) {  // y = (r~ apre) . S + scores . v for sub-blocks I = par (mod 2)
#pragma unroll
      for (int si = par; si < NSUB; si += 2) {
        float acc[YN][4] = {};
#pragma unroll
        for (int kk = 0; kk < K / 8; ++kk) {
          uint32_t ah[4], al[4];
          load_a(ah, al, rt, KS, si * SUB, 8 * kk, apre + si * K, g, q);
#pragma unroll
          for (int nt = 0; nt < YN; ++nt) {
            uint32_t bh[2], bl[2];
            load_b_kn(bh, bl, s_in, SS, 8 * kk, c0 + 8 * nt, g, q);
            mma3(acc[nt], ah, al, bh, bl);
          }
        }
        if (si == par) bar_sync(kScoresBar, NT);  // the state warps' scores are in
#pragma unroll
        for (int ks = 0; ks < KT; ++ks) {
          if (ks >= 2 * (si + 1)) break;  // the scores right of the diagonal block are 0
          uint32_t ah[4], al[4];
          load_a(ah, al, pm, PS, si * SUB, 8 * ks, nullptr, g, q);
#pragma unroll
          for (int nt = 0; nt < YN; ++nt) {
            uint32_t bh[2], bl[2];
            load_b_kn(bh, bl, vs, VS, 8 * ks, c0 + 8 * nt, g, q);
            mma3(acc[nt], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int nt = 0; nt < YN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = t0 + si * SUB + g + (e >= 2 ? 8 : 0);
            const int col = col_base + c0 + 8 * nt + 2 * q + (e & 1);
            if (t < t_len && col < dv)
              y[base_v + static_cast<size_t>(t) * tok_v + col] = from_f32<T>(acc[nt][e]);
          }
      }
    } else {
      // scores of sub-block I against J <= I: (r~_I G_IJ) . k^_J, masked; a
      // job is one 8-column n-tile, its K steps in two accumulators
      for (int job = wr; job < NSUB * (NSUB + 1); job += NW / 2) {
        const int nt = job & 1;
        int si = 0, sj = job >> 1;
        while (sj > si) sj -= ++si;
        float acc[2][4] = {};
        const float* gsc = gm + (si * NSUB + sj) * K;
#pragma unroll
        for (int kk = 0; kk < K / 8; ++kk) {
          uint32_t ah[4], al[4], bh[2], bl[2];
          load_a(ah, al, rt, KS, si * SUB, 8 * kk, gsc, g, q);
          load_b_nk(bh, bl, kh, KS, 8 * kk, sj * SUB + 8 * nt, g, q);
          mma3(acc[kk & 1], ah, al, bh, bl);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tl = g + (e >= 2 ? 8 : 0), sl = 8 * nt + 2 * q + (e & 1);
          const int t = si * SUB + tl;
          float val = acc[0][e] + acc[1][e];
          if (si == sj) val = sl < tl ? val : (sl == tl ? bonus[t] : 0.f);
          pm[t * PS + sj * SUB + sl] = val;
        }
      }
      if (any_unsafe) {  // the diagonal blocks' unsafe channels, pair by pair
        bar_sync(kStateBar, NT / 2);
        for (int idx = tid - NT / 2; idx < NSUB * SUB * SUB; idx += NT / 2) {
          const int si = idx / (SUB * SUB), tl = (idx / SUB) % SUB, sl = idx % SUB;
          if (sl >= tl) continue;
          const int t = si * SUB + tl, s = si * SUB + sl;
          float acc = 0.f;
          for (int c = 0; c < K; ++c) {
            if (gm[(si * NSUB + si) * K + c] != 0.f) continue;
            float d = 1.f;
            for (int tau = s + 1; tau < t; ++tau) d *= to_f32(raw_w[tau * K + c]);
            acc += to_f32(raw_r[t * K + c]) * to_f32(raw_k[s * K + c]) * d;
          }
          pm[t * PS + s] += acc;
        }
        bar_sync(kStateBar, NT / 2);
        if (it + 1 < n_tiles && tid == NT / 2)
          load_rkw<K, T>(raw_s, bar, &r_map, &k_map, &w_map, h, t0 + TILE, b);
      }
      __threadfence_block();  // the scores before the y warps read them
      bar_arrive(kScoresBar, NT);

      // S <- diag(aend) S + (k^ apost)^T . v, in registers
#pragma unroll
      for (int i = 0; i < SJ; ++i) {
        const int m = par + 2 * i;
        if (m >= KM) break;
#pragma unroll
        for (int nt = 0; nt < YN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[i][nt][e] *= aend[16 * m + g + (e >= 2 ? 8 : 0)];
      }
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        uint32_t bh[YN][2], bl[YN][2];
#pragma unroll
        for (int nt = 0; nt < YN; ++nt) load_b_kn(bh[nt], bl[nt], vs, VS, 8 * ks, c0 + 8 * nt, g, q);
#pragma unroll
        for (int i = 0; i < SJ; ++i) {
          const int m = par + 2 * i;
          if (m >= KM) break;
          uint32_t ah[4], al[4];
          load_at(ah, al, kh, KS, 16 * m, 8 * ks, apost + (8 * ks / SUB) * K, g, q);
#pragma unroll
          for (int nt = 0; nt < YN; ++nt) mma3(sacc[i][nt], ah, al, bh[nt], bl[nt]);
        }
      }
#pragma unroll
      for (int i = 0; i < SJ; ++i) {  // for the next tile's y warps
        const int m = par + 2 * i;
        if (m >= KM) break;
#pragma unroll
        for (int nt = 0; nt < YN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s_out[(16 * m + g + (e >= 2 ? 8 : 0)) * SS + c0 + 8 * nt + 2 * q + (e & 1)] =
                sacc[i][nt][e];
      }
    }
  }

  if (!y_warp) {
#pragma unroll
    for (int i = 0; i < SJ; ++i) {
      const int m = par + 2 * i;
      if (m >= KM) break;
#pragma unroll
      for (int nt = 0; nt < YN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * m + g + (e >= 2 ? 8 : 0);
          const int col = col_base + c0 + 8 * nt + 2 * q + (e & 1);
          if (col < dv) state_out[base_s + static_cast<size_t>(row) * dv + col] = sacc[i][nt][e];
        }
    }
  }
}

// A 4-D map (K, heads, seq, batch) over a contiguous (batch, seq, heads, K)
// tensor: boxes of one head's K columns x TILE tokens, rows past seq read as
// zeros.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, CUtensorMapDataType type,
            size_t elem_bytes, int batch, int seq, int heads, int d) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {elem_bytes * d, elem_bytes * d * heads,
                                 elem_bytes * d * heads * seq};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(d), 1, TILE, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* state_in, void* y, void* state_out, int batch, int t_len,
                   int heads, int dv, cudaStream_t stream) {
  using L = Layout<T, K>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap r_map, k_map, w_map;
  if (t_len > 0 && (!encode(fn, &r_map, r, type, sizeof(T), batch, t_len, heads, K) ||
                    !encode(fn, &k_map, k, type, sizeof(T), batch, t_len, heads, K) ||
                    !encode(fn, &w_map, w, type, sizeof(T), batch, t_len, heads, K)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wkv6_tile_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  const int vec_v = (dv * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid((dv + VB - 1) / VB, heads, batch);
  wkv6_tile_kernel<T, K><<<grid, NT, L::bytes, stream>>>(
      r_map, k_map, w_map, static_cast<const T*>(v), static_cast<const T*>(u),
      static_cast<const float*>(state_in), static_cast<T*>(y), static_cast<float*>(state_out),
      t_len, heads, dv, vec_v);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_k(int dk, const void* r, const void* k, const void* v, const void* w,
                       const void* u, const void* state_in, void* y, void* state_out, int batch,
                       int t_len, int heads, int dv, cudaStream_t stream) {
  switch (dk) {
    case 16: return launch<T, 16>(r, k, v, w, u, state_in, y, state_out, batch, t_len, heads, dv, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, state_in, y, state_out, batch, t_len, heads, dv, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, state_in, y, state_out, batch, t_len, heads, dv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// is_bf16: 1 for bf16 r/k/v/w/u/y, 0 for f32.  dk in {16, 32, 64};
// 1 <= dv <= 1024; the state is f32.  r, k, w must start on 16 bytes
// (TMA).
extern "C" int valve_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* state_in, void* y, void* state_out,
                          int batch, int t_len, int heads, int dk, int dv, int is_bf16,
                          void* stream) {
  if (batch == 0 || heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_k<__nv_bfloat16>(dk, r, k, v, w, u, state_in, y, state_out, batch, t_len,
                                          heads, dv, st)
              : dispatch_k<float>(dk, r, k, v, w, u, state_in, y, state_out, batch, t_len, heads,
                                  dv, st);
  return static_cast<int>(err);
}
