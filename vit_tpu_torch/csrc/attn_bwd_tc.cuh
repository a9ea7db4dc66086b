// The bf16 passes of the short-sequence attention backward (K6,
// short_bwd.cu) on Hopper's tensor cores: a dQ pass and a dK/dV pass. They
// compute what attn_bwd.cuh's passes compute, with every cast of its header
// comment in the same place:
//   S  = (Q * bf16(scale) rounded to bf16) K^T, fp32 sums;
//   P  = exp(S - lse), 0 for rows and keys at or past T;
//   dS = P (dP * M/keep - delta) with dP = dO V^T, rounded to bf16;
//   dQ = bf16(scale * sum_k dS K)
//   dV = bf16(sum_q bf16(P * M/keep)^T dO)
//   dK = bf16(sum_q dS^T bf16(Q * bf16(scale))), no final scale
// attn_bwd.cuh keeps the fp32 instantiations (tensor cores in fp32 would
// be TF32). The streaming backward (K4 and K5) is one pass of its own,
// attn_bwd_fused_tc.cuh.
//
// Design. One warpgroup (128 threads) per CTA owns 64 rows of the output
// and walks 64-row tiles of the other side:
// * dQ pass, one CTA per (bh, 64 queries): S = Qs K^T and dP = dO V^T as
//   wgmma m64n64k16 with both operands in shared memory (K-major); P, the
//   keep mask and dS in registers; dS rounded to bf16 is repacked in place
//   as the A operand (the fp32 accumulator fragment of m64nN is the A
//   fragment of the next product, two columns per 32-bit register) of
//   dQ += dS K, a wgmma with B = the K tile read transposed (MN-major).
// * dK/dV pass, one CTA per (bh, 64 keys), in the transposed orientation
//   so that P~^T and dS^T come out of the accumulators as A operands:
//   S^T = K Qs^T, dP^T = V dO^T; dV += bf16(P~^T) dO; dK += bf16(dS^T) QS.
//   lse and delta are per column there.
// * Tiles are bf16 in shared memory in the swizzled layout that TMA writes
//   and wgmma reads (hopper.cuh), double-buffered: TMA loads tile j + 1
//   into the other stage while tile j is computed, and completes on an
//   mbarrier. TMA fills rows at or past T with zeros, so the products need
//   no row masks; P is masked.
// * The exps and the dropout hash run on the CUDA cores between the
//   products; several CTAs share an SM, so one CTA's elementwise work runs
//   while another's wgmma is on the tensor cores. The ragged-edge masks run
//   only in the last tile, and where bf16(scale) is a power of two (d = 16,
//   64) the Q tile is used as it is with the scale in the exponent, which
//   gives the same bits as the scaled copy made otherwise.
// * Each output row is summed in one CTA's registers and written once: no
//   atomics, two calls give equal bits.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "attn_bwd.cuh"
#include "common.cuh"

namespace vtt {
namespace attn_bwd_tc {

using namespace hopper;

// The dQ pass's elementwise step on one 64 x 64 tile: accumulator element
// 4j + 2h + e is row row[h], key k0 + 8j + 2c + e. a[2j + h] receives
// dS = P (dP * M/keep - delta) of that row's two keys, rounded to bf16 and
// packed as the A operand of dS K. EDGE masks keys at or past t (only the
// last key tile has any).
template <bool EDGE>
__device__ __forceinline__ void dq_ds(const float (&s)[32], const float (&dp)[32],
                                      uint32_t (&a)[16], const int (&row)[2],
                                      const float (&lse2)[2], const float (&del)[2], int k0,
                                      int c, int t, const Dropout& dr, unsigned head) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e, col = k0 + 8 * j + 2 * c + e;
        float p = exp2_ftz(fmaf(s[i], LOG2E, -lse2[h]));
        if (EDGE && col >= t) p = 0.f;
        float d = dp[i];
        if (dr.on) d *= keep_factor(dr, head, row[h], col);
        ds[e] = p * (d - del[h]);
      }
      a[2 * j + h] = pack_bf16(ds[0], ds[1]);  // dS rounded to K's dtype
    }
  }
}

// The dK/dV pass's elementwise step, transposed: accumulator element 4j + 2h + e is
// key key[h], query q0 + 8j + 2c + e; stats holds that tile's lse * log2(e)
// (64) then delta (64). ap/as receive P~ = P * M/keep and dS, rounded to
// bf16 and packed as A operands. `s_mul` is log2(e), times the Q scale
// when S was formed from Q unscaled. EDGE masks keys and queries at or past
// t. The keep mask is hashed once for both P~ and dP.
template <bool EDGE>
__device__ __forceinline__ void dkv_pds(const float (&s)[32], const float (&dp)[32],
                                        uint32_t (&ap)[16], uint32_t (&as)[16],
                                        const int (&key)[2], const float* stats, float s_mul,
                                        int q0, int c, int t, const Dropout& dr,
                                        unsigned head) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ql = 8 * j + 2 * c;
    const float2 l2 = *reinterpret_cast<const float2*>(stats + ql);
    const float2 d2 = *reinterpret_cast<const float2*>(stats + TILE_ROWS + ql);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float pt[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e, qrow = q0 + ql + e;
        float p = exp2_ftz(fmaf(s[i], s_mul, -(e ? l2.y : l2.x)));
        if (EDGE && (key[h] >= t || qrow >= t)) p = 0.f;
        const float m = dr.on ? keep_factor(dr, head, qrow, key[h]) : 1.f;
        pt[e] = p * m;
        ds[e] = p * (dp[i] * m - (e ? d2.y : d2.x));
      }
      ap[2 * j + h] = pack_bf16(pt[0], pt[1]);  // P~ rounded to dO's dtype
      as[2 * j + h] = pack_bf16(ds[0], ds[1]);  // dS rounded to Q's dtype
    }
  }
}

// ---- the dQ pass -------------------------------------------------------

// Shared memory of the dQ pass: Q (scaled in place) and dO, then two
// stages of (K, V); three mbarriers.
template <int D> struct DqSmem {
  static constexpr int T = Tile<D>::BYTES;
  static constexpr int Q = 0, DO = T, K = 2 * T, V = 3 * T, STAGE = 2 * T;
  static constexpr int BARS = 6 * T;
  static constexpr int BYTES = BARS + 64 + 1024;  // + slack to align the base to 1024
};

template <int D>
__global__ void __launch_bounds__(THREADS, D == 128 ? 2 : 3)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int t, int n_qt, float scale, Dropout dr) {
  using L = Tile<D>;
  using S = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  const uint32_t bar_q = base + S::BARS, bar_kv = bar_q + 8;  // stage s: bar_kv + 8s

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x / n_qt, q0 = (blockIdx.x % n_qt) * TILE_ROWS;
  const int n_kt = (t + TILE_ROWS - 1) / TILE_ROWS;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv + 8, 1);
    fence_proxy_async();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * L::BYTES);
    load_tile<D>(base + S::Q, &tq, bar_q, q0, bh);
    load_tile<D>(base + S::DO, &tdo, bar_q, q0, bh);
    for (int st = 0; st < 2 && st < n_kt; ++st) {
      mbar_expect_tx(bar_kv + 8 * st, 2 * L::BYTES);
      load_tile<D>(base + S::K + st * S::STAGE, &tk, bar_kv + 8 * st, st * TILE_ROWS, bh);
      load_tile<D>(base + S::V + st * S::STAGE, &tv, bar_kv + 8 * st, st * TILE_ROWS, bh);
    }
  }
  __syncwarp();

  // This thread's two rows of every accumulator: 16*warp + g and 8 below.
  int row[2];
  float lse2[2], del[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + 16 * warp + g + 8 * h;
    const size_t i = static_cast<size_t>(bh) * t + row[h];
    lse2[h] = row[h] < t ? lse[i] * LOG2E : 0.f;
    del[h] = row[h] < t ? delta[i] : 0.f;
  }
  const unsigned head = head_term(dr, bh);

  mbar_wait(bar_q, 0);
  scale_tile<D>(sm + S::Q, sm + S::Q, round_to<__nv_bfloat16>(scale));
  fence_proxy_async();
  __syncthreads();

  float acc[D / 2], s[32], dp[32];
  uint32_t a[16];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    const uint32_t k_tile = base + S::K + st * S::STAGE, v_tile = base + S::V + st * S::STAGE;
    mbar_wait(bar_kv + 8 * st, (kt >> 1) & 1);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k<D>(base + S::Q, kk), desc_k<D>(k_tile, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<D>(base + S::DO, kk), desc_k<D>(v_tile, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    hold(s);
    hold(dp);

    const int k0 = kt * TILE_ROWS;
    if (k0 + TILE_ROWS <= t)
      dq_ds<false>(s, dp, a, row, lse2, del, k0, c, t, dr, head);
    else
      dq_ds<true>(s, dp, a, row, lse2, del, k0, c, t, dr, head);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) WgmmaRS<D>::mma(acc, a + 4 * kk, desc_mn<D>(k_tile, kk));
    wgmma_commit();
    wgmma_wait_all();
    hold(acc);
    hold(a);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && kt + 2 < n_kt) {
      mbar_expect_tx(bar_kv + 8 * st, 2 * L::BYTES);
      load_tile<D>(k_tile, &tk, bar_kv + 8 * st, (kt + 2) * TILE_ROWS, bh);
      load_tile<D>(v_tile, &tv, bar_kv + 8 * st, (kt + 2) * TILE_ROWS, bh);
    }
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= t) continue;
    __nv_bfloat16* out = dq + (static_cast<size_t>(bh) * t + row[h]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * c) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

// ---- the dK/dV pass ----------------------------------------------------

// Shared memory of the dK/dV pass: K, V, the scaled copy of the current Q
// tile, two stages of (Q, dO), two of (lse, delta) of the tile's 64 query
// rows; three mbarriers.
template <int D> struct DkvSmem {
  static constexpr int T = Tile<D>::BYTES;
  static constexpr int K = 0, V = T, QS = 2 * T, Q = 3 * T, DO = 4 * T, STAGE = 2 * T;
  static constexpr int STATS = 7 * T;  // stage s: 64 lse then 64 delta, 512 bytes each
  static constexpr int BARS = STATS + 1024;
  static constexpr int BYTES = BARS + 64 + 1024;
};

// dK is summed from the scaled Q and written unscaled (K6's rounding).
template <int D>
__global__ void __launch_bounds__(THREADS, D == 128 ? 1 : 2)
dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int t, int n_kt,
           float scale, Dropout dr) {
  using L = Tile<D>;
  using S = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  const uint32_t bar_kv = base + S::BARS, bar_q = bar_kv + 8;  // stage s: bar_q + 8s

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x / n_kt, k0 = (blockIdx.x % n_kt) * TILE_ROWS;
  const int n_qt = n_kt;
  // Thread tid stages lse * log2(e) of query row tid (tid < 64) or delta of
  // row tid - 64 of each query tile with plain loads, issued a tile ahead
  // (a flat 1-D TMA box over lse faulted on the card once T was not a
  // multiple of 64). 0 past T.
  float* stats = reinterpret_cast<float*>(sm + S::STATS);  // stage s at stats + 128s
  const float* stat_src = (tid < TILE_ROWS ? lse : delta) + static_cast<size_t>(bh) * t;
  const float stat_mul = tid < TILE_ROWS ? LOG2E : 1.f;
  auto stat = [&](int qt) {
    const int r = qt * TILE_ROWS + (tid & (TILE_ROWS - 1));
    return r < t ? stat_src[r] * stat_mul : 0.f;
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_q, 1);
    mbar_init(bar_q + 8, 1);
    fence_proxy_async();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * L::BYTES);
    load_tile<D>(base + S::K, &tk, bar_kv, k0, bh);
    load_tile<D>(base + S::V, &tv, bar_kv, k0, bh);
    for (int st = 0; st < 2 && st < n_qt; ++st) {
      const uint32_t bar = bar_q + 8 * st;
      mbar_expect_tx(bar, 2 * L::BYTES);
      load_tile<D>(base + S::Q + st * S::STAGE, &tq, bar, st * TILE_ROWS, bh);
      load_tile<D>(base + S::DO + st * S::STAGE, &tdo, bar, st * TILE_ROWS, bh);
    }
  }
  __syncwarp();
  for (int st = 0; st < 2 && st < n_qt; ++st) stats[128 * st + tid] = stat(st);

  // This thread's two keys of every accumulator: 16*warp + g and 8 below.
  int key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key[h] = k0 + 16 * warp + g + 8 * h;
  const unsigned head = head_term(dr, bh);
  const float qscale = round_to<__nv_bfloat16>(scale);
  // A power-of-two scale (d = 16, 64) rounds nothing: S = (Q K^T) * qscale
  // holds the same bits as (Q * qscale) K^T, so S^T is formed from the Q
  // tile as it is and the scale joins log2(e) in the exponent. Otherwise
  // (d = 32, 128) each Q tile is first copied scaled and rounded into QS.
  // dK = sum dS^T bf16(Q * qscale) then reads QS too, and is written
  // without the final scale. Where Q is left unscaled, scale * sum dS^T Q
  // has the same bits: a power-of-two scale rounds nothing, so sum dS^T
  // (Q * qscale) = qscale * sum dS^T Q exactly, and qscale is `scale` there.
  const bool q_unscaled = (__float_as_uint(qscale) & 0x7FFFFFu) == 0;
  const float s_mul = q_unscaled ? qscale * LOG2E : LOG2E;
  const float dk_mul = q_unscaled ? scale : 1.f;

  float dk_acc[D / 2], dv_acc[D / 2], s[32], dp[32];
  uint32_t ap[16], as[16];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  __syncthreads();  // the first two stages' stats
  mbar_wait(bar_kv, 0);
  for (int qt = 0; qt < n_qt; ++qt) {
    const int st = qt & 1;
    const uint32_t q_tile = base + S::Q + st * S::STAGE, do_tile = base + S::DO + st * S::STAGE;
    const float next_stat = qt + 2 < n_qt ? stat(qt + 2) : 0.f;  // in flight over the tile
    mbar_wait(bar_q + 8 * st, (qt >> 1) & 1);
    if (!q_unscaled) {
      scale_tile<D>(sm + S::QS, sm + S::Q + st * S::STAGE, qscale);
      fence_proxy_async();
      __syncthreads();
    }
    const uint32_t qs_tile = q_unscaled ? q_tile : base + S::QS;

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k<D>(base + S::K, kk), desc_k<D>(qs_tile, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<D>(base + S::V, kk), desc_k<D>(do_tile, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    hold(s);
    hold(dp);

    const int q0 = qt * TILE_ROWS;
    if (k0 + TILE_ROWS <= t && q0 + TILE_ROWS <= t)
      dkv_pds<false>(s, dp, ap, as, key, stats + 128 * st, s_mul, q0, c, t, dr, head);
    else
      dkv_pds<true>(s, dp, ap, as, key, stats + 128 * st, s_mul, q0, c, t, dr, head);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) WgmmaRS<D>::mma(dv_acc, ap + 4 * kk, desc_mn<D>(do_tile, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<D>::mma(dk_acc, as + 4 * kk, desc_mn<D>(qs_tile, kk));
    wgmma_commit();
    wgmma_wait_all();
    hold(dv_acc);
    hold(dk_acc);
    hold(ap);
    hold(as);

    __syncthreads();  // every warp is done with this stage and with QS: refill
    if (tid == 0 && qt + 2 < n_qt) {
      const uint32_t bar = bar_q + 8 * st;
      mbar_expect_tx(bar, 2 * L::BYTES);
      load_tile<D>(q_tile, &tq, bar, (qt + 2) * TILE_ROWS, bh);
      load_tile<D>(do_tile, &tdo, bar, (qt + 2) * TILE_ROWS, bh);
    }
    __syncwarp();
    if (qt + 2 < n_qt) stats[128 * st + tid] = next_stat;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= t) continue;
    const size_t off = (static_cast<size_t>(bh) * t + key[h]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j + 2 * c) =
          __floats2bfloat162_rn(dk_acc[i] * dk_mul, dk_acc[i + 1] * dk_mul);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j + 2 * c) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// ---- host side ---------------------------------------------------------

template <int D> cudaError_t launch_dq(const attn_bwd::Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e;
  if ((e = map_rows<D>(&tq, a.q, a.bh, a.t)) != cudaSuccess ||
      (e = map_rows<D>(&tk, a.k, a.bh, a.t)) != cudaSuccess ||
      (e = map_rows<D>(&tv, a.v, a.bh, a.t)) != cudaSuccess ||
      (e = map_rows<D>(&tdo, a.dout, a.bh, a.t)) != cudaSuccess)
    return e;
  constexpr size_t smem = DqSmem<D>::BYTES;
  auto kernel = dq_kernel<D>;
  if ((e = allow_smem(kernel, smem)) != cudaSuccess) return e;
  const int n_qt = (a.t + TILE_ROWS - 1) / TILE_ROWS;
  kernel<<<n_qt * a.bh, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dq), a.t, n_qt, a.scale, a.dr);
  return cudaGetLastError();
}

template <int D> cudaError_t launch_dkv(const attn_bwd::Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e;
  if ((e = map_rows<D>(&tq, a.q, a.bh, a.t)) != cudaSuccess ||
      (e = map_rows<D>(&tk, a.k, a.bh, a.t)) != cudaSuccess ||
      (e = map_rows<D>(&tv, a.v, a.bh, a.t)) != cudaSuccess ||
      (e = map_rows<D>(&tdo, a.dout, a.bh, a.t)) != cudaSuccess)
    return e;
  constexpr size_t smem = DkvSmem<D>::BYTES;
  auto kernel = dkv_kernel<D>;
  if ((e = allow_smem(kernel, smem)) != cudaSuccess) return e;
  const int n_kt = (a.t + TILE_ROWS - 1) / TILE_ROWS;
  kernel<<<n_kt * a.bh, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.t, n_kt, a.scale,
      a.dr);
  return cudaGetLastError();
}

}  // namespace attn_bwd_tc
}  // namespace vtt