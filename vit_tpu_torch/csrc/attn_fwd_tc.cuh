// The bf16 attention forwards, K1 (streaming, flash_fwd.cu) and K2 (short,
// short_fwd.cu), on Hopper's tensor cores. They compute what those files'
// headers say, with every cast in the same place:
//   Qs = bf16(Q * bf16(scale)); S = Qs K^T with fp32 sums;
//   keys at or past T at -1e30 before the row max;
//   l sums P unrounded and before the dropout mask;
//   P * M/keep rounded to bf16 before P~ V, fp32 sums;
//   K1: an online softmax over 64-key tiles, the accumulator rescaled by
//       exp(m_old - m_new); O = bf16(acc / max(l, 1e-30)),
//       lse = m + log(max(l, 1e-30));
//   K2: an exact two-pass softmax, m the max of the whole row, no
//       rescaling; O = bf16(acc / l), lse = m + log(l).
// The fp32 instantiations keep the FMA bodies of flash_fwd.cu and
// short_fwd.cu (tensor cores in fp32 would be TF32).
//
// Design. One warpgroup (128 threads) per CTA owns 64 query rows of one
// head. Its Q tile is loaded once by TMA and scaled in place; 64-key tiles
// of K and V are double-buffered by TMA on mbarriers (hopper.cuh), filled
// with zeros past T, so only the last key tile masks S and rows past T are
// not stored.
// * S = Qs K^T is an m64n64 wgmma with both tiles in shared memory (d/16
//   k-steps). The row max and l are reduced across the four lanes that hold
//   a row with two shuffles. P = 2^(S log2 e - m log2 e) on the special-
//   function unit; the dropout keep factor is common.cuh's hash.
// * P~ = P * M/keep, rounded to bf16, is packed in place as the A operand
//   of O += P~ V, a register-A wgmma with the V tile read transposed
//   (MN-major), four k16 steps per tile.
// * K1 walks the tiles once. The accumulator is rescaled by alpha only
//   after the previous P~ V has been waited on.
// * K2 (T <= 512, at most 8 tiles) walks them twice through the same ring:
//   pass 1 forms S and the row max (K tiles only), pass 2 forms S again
//   (the same instruction on the same inputs: the same bits), then P, l
//   and P~ V (K and V tiles).
// * Several CTAs share an SM (three at d <= 64, two at d = 128), so one
//   CTA's exps and hash run while another's wgmma is on the tensor cores;
//   within a CTA the loop is serial. Issuing tile j + 1's S before tile j's
//   P~ V had been waited on (a second P~ fragment, the softmax of j + 1
//   between the two waits) gave equal bits but ran slower on the card:
//   ptxas serialised the wgmma (C7514). Each output row is summed in one
//   CTA and written once: two calls give equal bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace vtt {
namespace attn_fwd_tc {

using namespace hopper;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* lse;
  int bh, t;
  float scale;  // already rounded to bf16
  Dropout dr;
};

// Shared memory: Q (scaled in place), then two stages of (K, V); three
// mbarriers (Q, stage 0, stage 1).
template <int D> struct Smem {
  static constexpr int T = Tile<D>::BYTES;
  static constexpr int Q = 0, K = T, V = 2 * T, STAGE = 2 * T;
  static constexpr int BARS = 5 * T;
  static constexpr int BYTES = BARS + 64 + 1024;  // + slack to align the base to 1024
};

// s = Qs K^T of one 64 x 64 tile, fp32. Accumulator element 4j + 2h + e is
// row 16 * warp + g + 8h, key 8j + 2c + e of the tile.
template <int D>
__device__ __forceinline__ void qk(float (&s)[32], uint32_t q_tile, uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, desc_k<D>(q_tile, kk), desc_k<D>(k_tile, kk), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  hold(s);
}

// acc += P~ V over one 64-key tile, P~ packed in a.
template <int D>
__device__ __forceinline__ void pv(float (&acc)[D / 2], uint32_t (&a)[16], uint32_t v_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) WgmmaRS<D>::mma(acc, a + 4 * kk, desc_mn<D>(v_tile, kk));
  wgmma_commit();
  wgmma_wait_all();
  hold(acc);
  hold(a);
}

// Keys at or past t to -1e30 (only the last key tile has any).
__device__ __forceinline__ void mask_keys(float (&s)[32], int k0, int c, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (k0 + 8 * j + 2 * c + e >= t) s[4 * j + e] = s[4 * j + 2 + e] = NEG_INF;
}

// mx[h] = max(mx[h], this thread's part of row h of s).
__device__ __forceinline__ void row_max(const float (&s)[32], float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mx[h] = fmaxf(mx[h], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
}

// Max and sum over the four lanes that hold one row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// P = exp(S - m) of one tile, m * log2(e) in m2: added to this thread's part
// of l unrounded and unmasked, then P * M/keep rounded to bf16 and packed
// into a as the A operand of P~ V (a[2j + h]: row h, keys 8j + 2c, +1).
__device__ __forceinline__ void softmax_tile(const float (&s)[32], const float (&m2)[2],
                                             float (&l)[2], uint32_t (&a)[16],
                                             const int (&row)[2], int k0, int c,
                                             const Dropout& dr, unsigned head) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = exp2_ftz(fmaf(s[4 * j + 2 * h + e], LOG2E, -m2[h]));
        l[h] += p[e];
        if (dr.on) p[e] *= keep_factor(dr, head, row[h], k0 + 8 * j + 2 * c + e);
      }
      a[2 * j + h] = pack_bf16(p[0], p[1]);
    }
  }
}

// O = bf16(acc / l) and lse = m + log(l) of this thread's two rows; l is
// this thread's part, reduced here.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], const float (&m)[2],
                                           const float (&l)[2], bool clamp, const int (&row)[2],
                                           int c, int bh, int t, __nv_bfloat16* __restrict__ o,
                                           float* __restrict__ lse) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = quad_sum(l[h]);
    if (clamp) lt = fmaxf(lt, 1e-30f);
    if (row[h] >= t) continue;
    const size_t r = static_cast<size_t>(bh) * t + row[h];
    __nv_bfloat16* out = o + r * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * c) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] / lt, acc[4 * j + 2 * h + 1] / lt);
    if (c == 0) lse[r] = m[h] + logf(lt);
  }
}

// The prologue both kernels share: barriers, the Q tile's load and its
// scaling in place. `first` issues the first loads of the ring.
template <int D, typename First>
__device__ __forceinline__ void load_q(uint8_t* sm, uint32_t base, const CUtensorMap* tq,
                                       int q0, int bh, float scale, First first) {
  const uint32_t bar_q = base + Smem<D>::BARS;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q + 8, 1);
    mbar_init(bar_q + 16, 1);
    fence_proxy_async();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, Tile<D>::BYTES);
    load_tile<D>(base + Smem<D>::Q, tq, bar_q, q0, bh);
    first();
  }
  __syncwarp();
  mbar_wait(bar_q, 0);
  scale_tile<D>(sm + Smem<D>::Q, sm + Smem<D>::Q, scale);
  fence_proxy_async();
  __syncthreads();
}

// ---- K1: the streaming forward ------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, D == 128 ? 2 : 3)
flash_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, int t, int n_qt, float scale, Dropout dr) {
  using L = Tile<D>;
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  const uint32_t bar_kv = base + S::BARS + 8;  // stage s: bar_kv + 8s

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x / n_qt, q0 = (blockIdx.x % n_qt) * TILE_ROWS;
  const int n_kt = (t + TILE_ROWS - 1) / TILE_ROWS;
  auto load_kv = [&](int kt) {
    const int st = kt & 1;
    mbar_expect_tx(bar_kv + 8 * st, 2 * L::BYTES);
    load_tile<D>(base + S::K + st * S::STAGE, &tk, bar_kv + 8 * st, kt * TILE_ROWS, bh);
    load_tile<D>(base + S::V + st * S::STAGE, &tv, bar_kv + 8 * st, kt * TILE_ROWS, bh);
  };
  load_q<D>(sm, base, &tq, q0, bh, scale, [&] {
    for (int kt = 0; kt < 2 && kt < n_kt; ++kt) load_kv(kt);
  });

  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const unsigned head = head_term(dr, bh);
  float acc[D / 2], s[32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t a[16];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * TILE_ROWS;
    mbar_wait(bar_kv + 8 * st, (kt >> 1) & 1);
    qk<D>(s, base + S::Q, base + S::K + st * S::STAGE);
    if (k0 + TILE_ROWS > t) mask_keys(s, k0, c, t);

    float mx[2] = {m[0], m[1]}, m2[2];
    row_max(s, mx);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = quad_max(mx[h]);
      const float alpha = exp2_ftz((m[h] - m_new) * LOG2E);
      l[h] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * h] *= alpha;
        acc[4 * j + 2 * h + 1] *= alpha;
      }
      m[h] = m_new;
      m2[h] = m_new * LOG2E;
    }
    softmax_tile(s, m2, l, a, row, k0, c, dr, head);
    pv<D>(acc, a, base + S::V + st * S::STAGE);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && kt + 2 < n_kt) load_kv(kt + 2);
    __syncwarp();
  }
  store_rows<D>(acc, m, l, true, row, c, bh, t, o, lse);
}

// ---- K2: the short forward, two passes ----------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, D == 128 ? 2 : 3)
short_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, int t, int n_qt, float scale, Dropout dr) {
  using L = Tile<D>;
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  const uint32_t bar_kv = base + S::BARS + 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x / n_qt, q0 = (blockIdx.x % n_qt) * TILE_ROWS;
  const int n_kt = (t + TILE_ROWS - 1) / TILE_ROWS, n_it = 2 * n_kt;
  // Step it reads key tile it % n_kt: its K in pass 1 (it < n_kt), K and V
  // in pass 2.
  auto load_step = [&](int it) {
    const int st = it & 1, k0 = (it % n_kt) * TILE_ROWS;
    const bool with_v = it >= n_kt;
    mbar_expect_tx(bar_kv + 8 * st, (with_v ? 2 : 1) * L::BYTES);
    load_tile<D>(base + S::K + st * S::STAGE, &tk, bar_kv + 8 * st, k0, bh);
    if (with_v) load_tile<D>(base + S::V + st * S::STAGE, &tv, bar_kv + 8 * st, k0, bh);
  };
  auto next = [&](int it) {
    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && it + 2 < n_it) load_step(it + 2);
    __syncwarp();
  };
  load_q<D>(sm, base, &tq, q0, bh, scale, [&] {
    for (int it = 0; it < 2; ++it) load_step(it);
  });

  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const unsigned head = head_term(dr, bh);
  float acc[D / 2], s[32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t a[16];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  for (int it = 0; it < n_kt; ++it) {  // pass 1: the row max
    const int st = it & 1, k0 = it * TILE_ROWS;
    mbar_wait(bar_kv + 8 * st, (it >> 1) & 1);
    qk<D>(s, base + S::Q, base + S::K + st * S::STAGE);
    if (k0 + TILE_ROWS > t) mask_keys(s, k0, c, t);
    row_max(s, m);
    next(it);
  }
  float m2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = quad_max(m[h]);
    m2[h] = m[h] * LOG2E;
  }
  for (int it = n_kt; it < n_it; ++it) {  // pass 2: P, l and P~ V
    const int st = it & 1, k0 = (it - n_kt) * TILE_ROWS;
    mbar_wait(bar_kv + 8 * st, (it >> 1) & 1);
    qk<D>(s, base + S::Q, base + S::K + st * S::STAGE);
    if (k0 + TILE_ROWS > t) mask_keys(s, k0, c, t);
    softmax_tile(s, m2, l, a, row, k0, c, dr, head);
    pv<D>(acc, a, base + S::V + st * S::STAGE);
    next(it);
  }
  store_rows<D>(acc, m, l, false, row, c, bh, t, o, lse);
}

// ---- host side ---------------------------------------------------------

// `kernel` is flash_kernel<D> or short_kernel<D>: one CTA per (bh, 64 query
// rows).
template <int D, typename Kernel>
cudaError_t launch(Kernel kernel, const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t e;
  if ((e = map_rows<D>(&tq, a.q, a.bh, a.t)) != cudaSuccess ||
      (e = map_rows<D>(&tk, a.k, a.bh, a.t)) != cudaSuccess ||
      (e = map_rows<D>(&tv, a.v, a.bh, a.t)) != cudaSuccess)
    return e;
  constexpr size_t smem = Smem<D>::BYTES;
  if ((e = allow_smem(kernel, smem)) != cudaSuccess) return e;
  const int n_qt = (a.t + TILE_ROWS - 1) / TILE_ROWS;
  kernel<<<n_qt * a.bh, THREADS, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(a.o),
                                                 static_cast<float*>(a.lse), a.t, n_qt,
                                                 a.scale, a.dr);
  return cudaGetLastError();
}

}  // namespace attn_fwd_tc
}  // namespace vtt
