// The bf16 flash-attention backward as one pass on Hopper's tensor cores
// (flash_bwd.cu). It computes what attn_bwd_tc.cuh's dQ and dK/dV passes
// computed for K4 and K5, with every cast in the same place:
//   S  = (Q * bf16(scale) rounded to bf16) K^T, fp32 sums;
//   P  = exp(S - lse), 0 for rows and keys at or past T;
//   dS = P (dP * M/keep - delta) with dP = dO V^T, rounded to bf16;
//   dQ = bf16(scale * sum_k dS K), the sum fp32 in key-block order;
//   dV = bf16(sum_q bf16(P * M/keep)^T dO);
//   dK = bf16(scale * sum_q dS^T Q), Q as it is;
// M the keep mask of the global (seed, bh, row, col) (common.cuh).
//
// Design: one CTA per (bh, block of KEYS keys), walking every 64-row query
// tile in the transposed orientation, so each element's S, dP, exp and hash
// are formed once (K4 and K5 each formed them: seven T x T x d products and
// two exps and hashes an element, where this pass has five and one).
// * Warp specialisation: a producer warpgroup and NWG consumer warpgroups
//   of 64 keys each (NWG = 2, 128 keys, at d <= 64; 1 at d = 128, where a
//   thread's dK and dV sums alone take 128 registers). Producer warp 0 loads
//   the CTA's K and V once, then each query tile's Q and dO (TMA, zeros past
//   T) and its 64 lse * log2(e) and delta values into a ring of STAGES
//   slots, one full and one empty mbarrier a slot; both consumer
//   warpgroups read every slot. With two consumer warpgroups the producer
//   warpgroup gives registers back (setmaxnreg 40) and the consumers take
//   them (232), and one warpgroup's exps and hash run on the CUDA cores
//   while the other's products are on the tensor cores.
// * A consumer warpgroup, per query tile: S^T = K Qs^T and dP^T = V dO^T
//   (wgmma, both operands K-major in shared memory); P, the keep mask and
//   dS in registers, P~^T = bf16(P * M/keep)^T and dS^T packed as A
//   fragments; dV += P~^T dO and dK += dS^T Q (A from registers, B read
//   MN-major), summed in registers over every tile and written once at the
//   end; dS^T stored to shared memory in bf16, swizzled as TMA writes a
//   tile, and read back MN-major as the A operand of dQ_wg = dS K (64
//   queries x d, fp32, this warpgroup's 64 keys).
// * dQ leaves the CTA once per query tile, summed over its keys: warpgroup
//   0 stores its partial to OUT (shared memory, fp32, laid out as dq_at),
//   warpgroup 1 then adds its own (partial 0 + partial 1). Producer warp 1
//   (the writer) moves OUT into an fp32 workspace (BH, T_pad, d) of the
//   wrapper's with one bulk copy on the TMA engine: key block 0 stores (no
//   memset of the workspace), blocks 1 .. n-2 add (cp.reduce.async.bulk
//   .add.f32, done at L2). Deterministic order: a counter per (bh, query
//   tile) counts the key blocks that have added; block j waits until it
//   reads j (ld.acquire) before it adds, and releases the tile (red.release)
//   once its copy is complete, a tile later, while two OUT buffers alternate.
//   The last block bulk-loads the workspace's tile ahead, adds its own sum
//   and bulk-stores bf16(scale * sum) to dq's rows below T. Two calls give
//   equal bits, and a head's bits do not depend on the other heads of the
//   launch (stacked replicas, a rank's bh_offset). Single-warp writers that
//   added with red.global.add.v4 from registers, or with 256-byte bulk
//   copies row by row, held the consumers back (3.0 ms at the stride-1
//   shape, PERF.md); a tile's one 16 KB copy does not.
// * Block order: blockIdx = key block * BH + bh, so every head's block 0
//   is scheduled first and a block waits only on blocks scheduled before
//   it, which therefore run; the wait traps after 2^24 polls, as mbar_wait
//   does, so a fault fails the launch instead of hanging the card.
// * The scale: where bf16(scale) is a power of two (d = 16, 64) S^T is
//   formed from the Q tile as it is and the scale joins log2(e) in the
//   exponent (the same bits as the scaled copy); otherwise (d = 32, 128)
//   each warpgroup first copies the Q tile scaled and rounded (its QS).
// * The elementwise masks run only where a tile crosses T (EDGE).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_bwd.cuh"
#include "attn_bwd_tc.cuh"  // dkv_pds, the elementwise step of K6's dK/dV pass
#include "common.cuh"
#include "hopper.cuh"

namespace vtt {
namespace attn_bwd_fused_tc {

using namespace hopper;

constexpr int DS_BYTES = TILE_ROWS * TILE_ROWS * 2;  // a 64 x 64 bf16 tile of dS^T
// Registers a thread with two consumer warpgroups: 128 x 40 + 256 x 232 =
// 384 x 168, what the launch holds (__launch_bounds__(384, 1)).
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// Geometry and shared memory of the pass at head dim D.
template <int D> struct Cfg {
  static constexpr int NWG = D <= 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int KEYS = NWG * TILE_ROWS;  // keys a CTA
  static constexpr int CONSUMERS = NWG * THREADS;
  static constexpr int ALL_THREADS = CONSUMERS + THREADS;  // + the producer warpgroup
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr int T = Tile<D>::BYTES;
  static constexpr int NOUT = D <= 64 ? 2 : 1;  // dQ sum buffers, by tile
  static constexpr int OUT_BYTES = TILE_ROWS * D * 4;
  // Offsets: K, V and QS a tile per warpgroup; dS^T two tiles per warpgroup;
  // ring slot s: Q at RING + 2Ts, dO after it; stats slot s: 64 lse * log2(e)
  // then 64 delta; OUT[s], a query tile's dQ sum over the CTA's keys (fp32,
  // 64 x D in the layout of dq_at); WSB, the workspace's tile, which the
  // last key block loads; OB, the last key block's bf16 dq rows.
  static constexpr int K = 0, V = NWG * T, QS = 2 * NWG * T, DS = 3 * NWG * T;
  static constexpr int RING = DS + 2 * NWG * DS_BYTES;
  static constexpr int STATS = RING + STAGES * 2 * T;
  static constexpr int OUT = STATS + STAGES * 512;
  static constexpr int WSB = OUT + NOUT * OUT_BYTES;
  static constexpr int OB = WSB + OUT_BYTES;
  static constexpr int BARS = OB + TILE_ROWS * D * 2;
  static constexpr int BYTES = BARS + 128 + 1024;  // + barriers, slack to align to 1024
  static_assert(BYTES <= 227 * 1024, "shared memory");
};

// The pass's mbarriers: kv and ws (the last key block's workspace loads);
// full[s], empty[s] of the ring; of OUT[s]: half (warpgroup 0 has stored
// its partial), sum (the CTA's sum is in) and free (the bulk copy has read it).
template <int STAGES, int NOUT> struct Bars {
  uint32_t base;
  __device__ __forceinline__ uint32_t kv() const { return base; }
  __device__ __forceinline__ uint32_t ws() const { return base + 8; }
  __device__ __forceinline__ uint32_t full(int i) const { return base + 16 + 8 * (i % STAGES); }
  __device__ __forceinline__ uint32_t empty(int i) const {
    return base + 16 + 8 * (STAGES + i % STAGES);
  }
  __device__ __forceinline__ uint32_t half(int i) const {
    return base + 16 + 16 * STAGES + 8 * (i % NOUT);
  }
  __device__ __forceinline__ uint32_t sum(int i) const {
    return base + 16 + 16 * STAGES + 8 * (NOUT + i % NOUT);
  }
  __device__ __forceinline__ uint32_t free(int i) const {
    return base + 16 + 16 * STAGES + 8 * (2 * NOUT + i % NOUT);
  }
};

// Float index of dQ element (row, col) of a 64 x D tile in OUT and in the
// workspace: row-major with the 8-float groups of a row permuted by the row
// (col ^ 8 (row % G)), so that the accumulator fragments of a warp's eight
// rows store to distinct banks. A float4 of four columns 4c..4c+3 stays
// contiguous.
template <int D> __device__ __forceinline__ int dq_at(int row, int col) {
  constexpr int G = (D < 64 ? D : 64) / 8;
  return row * D + (col ^ ((row % G) << 3));
}


// Wait until the counter at p reads `want` (acquire: the adds it counts are
// visible). Traps after 2^24 polls, as mbar_wait does.
__device__ __forceinline__ void wait_count(const unsigned* p, unsigned want) {
  for (uint32_t polls = 0;; ++polls) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    if (v == want) return;
    if (polls == (1u << 24)) __trap();
  }
}

// Add 1 to the counter at p after this thread's earlier writes (release).
__device__ __forceinline__ void release_count(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p) : "memory");
}

// Bulk load of `bytes` from global into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Bulk copies between shared and global memory on the TMA engine, from
// this thread's bulk group (16-byte aligned, a multiple of 16 bytes): store,
// and the fp32 add of shared memory into global memory (done at L2).
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_add_f32(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::
                   "l"(dst), "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's latest bulk groups are incomplete
// (their writes performed), or, READ, have their shared-memory sources left
// to read.
template <int N, bool READ = false> __device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Order this thread's async-proxy (bulk) accesses to global memory with its
// generic ones, both ways.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// dS^T (as[2j + h]: key row 16 warp + g + 8h, query columns 8j + 2c, +1)
// into a 64 x 64 bf16 tile with 128-byte rows in TMA's 128-byte swizzle
// (16-byte chunk j of row r at chunk j ^ (r % 8)), which desc_mn reads.
__device__ __forceinline__ void store_ds(uint8_t* tile, const uint32_t (&as)[16], int warp,
                                         int g, int c) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g + 8 * h;
      *reinterpret_cast<uint32_t*>(tile + row * 128 + ((j ^ (row & 7)) << 4) + 4 * c) =
          as[2 * j + h];
    }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::ALL_THREADS, 1)
bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
           __nv_bfloat16* __restrict__ dv, float* __restrict__ dq_ws,
           unsigned* __restrict__ counters, int n_bh, int t, float scale, Dropout dr) {
  using C = Cfg<D>;
  constexpr int STAGES = C::STAGES, NWG = C::NWG, T = C::T;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  const Bars<STAGES, C::NOUT> bars{base + C::BARS};

  const int tid = threadIdx.x, lane = tid & 31;
  const int kb = blockIdx.x / n_bh, bh = blockIdx.x % n_bh;  // every head's block 0 first
  const int k0 = kb * C::KEYS;
  const int n_qt = (t + TILE_ROWS - 1) / TILE_ROWS;
  const int n_kb = (t + C::KEYS - 1) / C::KEYS;
  float* stats_all = reinterpret_cast<float*>(sm + C::STATS);  // slot s at + 128 s
  auto out_of = [&](int i) {
    return reinterpret_cast<float*>(sm + C::OUT + (i % C::NOUT) * C::OUT_BYTES);
  };

  if (tid == 0) {
    mbar_init(bars.kv(), 1);
    mbar_init(bars.ws(), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars.full(s), 32);        // the producer warp's lanes (stats; lane 0 arms TMA)
      mbar_init(bars.empty(s), NWG * 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < C::NOUT; ++s) {
      mbar_init(bars.half(s), THREADS);  // warpgroup 0's threads
      mbar_init(bars.sum(s), THREADS);   // the last consumer warpgroup's threads
      mbar_init(bars.free(s), 1);        // the writer
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= C::CONSUMERS) {
    // ---- producer warpgroup: warp 0 loads, warp 1 writes dQ ----
    if constexpr (NWG == 2) setmaxnreg_dec<PRODUCER_REGS>();
    const int pwarp = (tid - C::CONSUMERS) / 32;
    if (pwarp == 0) {
      if (lane == 0) {
        mbar_expect_tx(bars.kv(), 2 * NWG * T);
        for (int w = 0; w < NWG; ++w) {
          load_tile<D>(base + C::K + w * T, &tk, bars.kv(), k0 + w * TILE_ROWS, bh);
          load_tile<D>(base + C::V + w * T, &tv, bars.kv(), k0 + w * TILE_ROWS, bh);
        }
      }
      const float* lse_h = lse + static_cast<size_t>(bh) * t;
      const float* del_h = delta + static_cast<size_t>(bh) * t;
      for (int i = 0; i < n_qt; ++i) {
        const int r = i * TILE_ROWS + 2 * lane;  // this lane's two query rows
        const float2 l2 = make_float2(r < t ? lse_h[r] * LOG2E : 0.f,
                                      r + 1 < t ? lse_h[r + 1] * LOG2E : 0.f);
        const float2 d2 = make_float2(r < t ? del_h[r] : 0.f, r + 1 < t ? del_h[r + 1] : 0.f);
        if (i >= STAGES) mbar_wait(bars.empty(i), (i / STAGES + 1) & 1);
        float* st = stats_all + 128 * (i % STAGES);
        *reinterpret_cast<float2*>(st + 2 * lane) = l2;
        *reinterpret_cast<float2*>(st + TILE_ROWS + 2 * lane) = d2;
        if (lane == 0) {
          const uint32_t slot = base + C::RING + (i % STAGES) * 2 * T;
          mbar_expect_tx(bars.full(i), 2 * T);
          load_tile<D>(slot, &tq, bars.full(i), i * TILE_ROWS, bh);
          load_tile<D>(slot + T, &tdo, bars.full(i), i * TILE_ROWS, bh);
        } else {
          mbar_arrive(bars.full(i));
        }
      }
    } else if (pwarp == 1) {
      // The writer, lane 0. The consumers leave each query tile's dQ sum
      // over the CTA's keys in OUT. Block 0 stores it to the workspace, blocks
      // 1 .. n-2 add it there, each once block kb - 1 has released the tile,
      // with one bulk copy; the tile is released to block kb + 1 once that
      // copy is complete, a tile later (so that the wait seldom stalls). The
      // last block loads the workspace's tile (ahead, as soon as it is
      // released), adds, and stores bf16(scale * sum) to dq's rows below T.
      const bool first = kb == 0, last = kb == n_kb - 1;
      constexpr int C4 = D / 4, V4 = TILE_ROWS * C4;  // float4s a row, a tile
      float* wsb = reinterpret_cast<float*>(sm + C::WSB);
      __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(sm + C::OB);
      auto count = [&](int j) { return counters + static_cast<size_t>(bh) * n_qt + j; };
      auto tile_ws = [&](int j) {
        return dq_ws + (static_cast<size_t>(bh) * n_qt + j) * TILE_ROWS * D;
      };
      auto load_ws = [&](int j) {  // lane 0
        wait_count(count(j), kb);
        fence_proxy_async_global();
        mbar_expect_tx(bars.ws(), C::OUT_BYTES);
        bulk_load(smem_u32(wsb), tile_ws(j), C::OUT_BYTES, bars.ws());
      };
      if (last) {
        if (!first && lane == 0) load_ws(0);
        for (int i = 0; i < n_qt; ++i) {
          const float* out = out_of(i);
          mbar_wait(bars.sum(i), (i / C::NOUT) & 1);
          if (!first) mbar_wait(bars.ws(), i & 1);
          if (lane == 0) bulk_wait<0, true>();  // tile i - 1's dq rows are read from OB
          __syncwarp();
          for (int e = lane; e < V4; e += 32) {
            const int r = e / C4, col = 4 * (e % C4), at = dq_at<D>(r, col);
            float4 v = *reinterpret_cast<const float4*>(out + at);
            if (!first) {
              const float4 a = *reinterpret_cast<const float4*>(wsb + at);
              v = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
            }
            __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x * scale, v.y * scale),
                                   __floats2bfloat162_rn(v.z * scale, v.w * scale)};
            *reinterpret_cast<uint2*>(ob + r * D + col) = *reinterpret_cast<const uint2*>(h);
          }
          fence_proxy_async();  // OB, to the bulk copy
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(bars.free(i));  // OUT and WSB are read
            const int rows = min(TILE_ROWS, t - i * TILE_ROWS);
            bulk_store(dq + (static_cast<size_t>(bh) * t + i * TILE_ROWS) * D, smem_u32(ob),
                       rows * D * 2);
            bulk_commit();
            if (!first && i + 1 < n_qt) load_ws(i + 1);
          }
        }
        if (lane == 0) bulk_wait<0>();
      } else if (lane == 0) {
        for (int i = 0; i < n_qt; ++i) {
          mbar_wait(bars.sum(i), (i / C::NOUT) & 1);
          if (!first) {  // key block kb - 1 has added its tile i
            wait_count(count(i), kb);
            fence_proxy_async_global();
          }
          const uint32_t src = smem_u32(out_of(i));
          if (first)
            bulk_store(tile_ws(i), src, C::OUT_BYTES);
          else
            bulk_add_f32(tile_ws(i), src, C::OUT_BYTES);
          bulk_commit();
          bulk_wait<0, true>();
          mbar_arrive(bars.free(i));  // OUT is read
          if (i > 0) {  // tile i - 1's copy is complete: release it
            bulk_wait<1>();
            fence_proxy_async_global();
            release_count(count(i - 1));
          }
        }
        bulk_wait<0>();
        fence_proxy_async_global();
        release_count(count(n_qt - 1));
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  if constexpr (NWG == 2) setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = tid / THREADS, wtid = tid % THREADS, warp = wtid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const uint32_t k_tile = base + C::K + wg * T, v_tile = base + C::V + wg * T;
  const uint32_t qs_own = base + C::QS + wg * T;
  // This thread's two keys of every accumulator: 16*warp + g and 8 below.
  int key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key[h] = k0 + wg * TILE_ROWS + 16 * warp + g + 8 * h;
  const bool keys_inside = k0 + (wg + 1) * TILE_ROWS <= t;
  const unsigned head = head_term(dr, bh);
  const float qscale = round_to<__nv_bfloat16>(scale);
  // A power-of-two scale (d = 16, 64) rounds nothing: S = (Q K^T) * qscale
  // holds the same bits as (Q * qscale) K^T, so S^T is formed from the Q
  // tile as it is and the scale joins log2(e) in the exponent. Otherwise
  // each Q tile is first copied scaled and rounded into this warpgroup's QS.
  const bool q_unscaled = (__float_as_uint(qscale) & 0x7FFFFFu) == 0;
  const float s_mul = q_unscaled ? qscale * LOG2E : LOG2E;

  // The dQ partial takes S^T's and dP^T's registers, which it can once both
  // are spent.
  float dk_acc[D / 2], dv_acc[D / 2], sdp[64];
  float(&s)[32] = *reinterpret_cast<float(*)[32]>(sdp);
  float(&dp)[32] = *reinterpret_cast<float(*)[32]>(sdp + 32);
  float(&dq_acc)[D / 2] = *reinterpret_cast<float(*)[D / 2]>(sdp);
  uint32_t ap[16], as[16];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sdp[i] = 0.f;

  mbar_wait(bars.kv(), 0);
  for (int i = 0; i < n_qt; ++i) {
    const uint32_t q_tile = base + C::RING + (i % STAGES) * 2 * T, do_tile = q_tile + T;
    const float* stats = stats_all + 128 * (i % STAGES);
    const uint32_t ds_tile = base + C::DS + (2 * wg + (i & 1)) * DS_BYTES;
    mbar_wait(bars.full(i), (i / STAGES) & 1);
    if (!q_unscaled) {  // QS's last reader, tile i - 1's S^T, has completed
      scale_tile<D>(sm + C::QS + wg * T, sm + (q_tile - base), qscale, wtid);
      fence_proxy_async();
      named_sync(1 + wg, THREADS);
    }
    const uint32_t qs_tile = q_unscaled ? q_tile : qs_own;

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k<D>(k_tile, kk), desc_k<D>(qs_tile, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<D>(v_tile, kk), desc_k<D>(do_tile, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    hold(sdp);

    const int q0 = i * TILE_ROWS;
    if (keys_inside && q0 + TILE_ROWS <= t)
      attn_bwd_tc::dkv_pds<false>(s, dp, ap, as, key, stats, s_mul, q0, c, t, dr, head);
    else
      attn_bwd_tc::dkv_pds<true>(s, dp, ap, as, key, stats, s_mul, q0, c, t, dr, head);

    // dS^T to shared memory for dQ = dS K. Two tiles alternate: tile i - 2's
    // was read by a dQ product that every warp waited for before it reached
    // tile i - 1's barrier below.
    store_ds(sm + (ds_tile - base), as, warp, g, c);
    fence_proxy_async();
    named_sync(1 + wg, THREADS);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) WgmmaRS<D>::mma(dv_acc, ap + 4 * kk, desc_mn<D>(do_tile, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) WgmmaRS<D>::mma(dk_acc, as + 4 * kk, desc_mn<D>(q_tile, kk));
    if constexpr (D == 128) {  // dK, dV and dQ sums at once would not fit the registers
      wgmma_commit();
      wgmma_wait<0>();
      hold(dv_acc);
      hold(dk_acc);
      hold(ap);
      hold(as);
      wgmma_fence();
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaSS<D, 1, 1>::mma(dq_acc, desc_mn<64>(ds_tile, kk), desc_mn<D>(k_tile, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    hold(dv_acc);
    hold(dk_acc);
    hold(dq_acc);
    hold(ap);
    hold(as);
    if (lane == 0) mbar_arrive(bars.empty(i));  // this warp is done with the slot

    // The CTA's dQ sum of the tile into OUT: warpgroup 0 stores its
    // partial, warpgroup 1 then adds its own (partial 0 + partial 1).
    float* out = out_of(i);
    if (wg == 0) {
      if (i >= C::NOUT)  // the copy of tile i - NOUT has read OUT
        mbar_wait(bars.free(i), (i / C::NOUT + 1) & 1);
    } else {
      mbar_wait(bars.half(i), (i / C::NOUT) & 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g + 8 * h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        // A select, not a branch: the accumulator registers are read on one
        // path by both warpgroups (warpgroup 0 ignores what it reads).
        float2* at = reinterpret_cast<float2*>(out + dq_at<D>(row, 8 * j + 2 * c));
        const float2 v = make_float2(dq_acc[4 * j + 2 * h], dq_acc[4 * j + 2 * h + 1]);
        const float2 p = *at;
        *at = wg == 1 ? make_float2(p.x + v.x, p.y + v.y) : v;
      }
    }
    fence_proxy_async();  // OUT, to the writer's bulk copy
    mbar_arrive(NWG == 2 && wg == 0 ? bars.half(i) : bars.sum(i));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= t) continue;
    const size_t off = (static_cast<size_t>(bh) * t + key[h]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int e = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j + 2 * c) =
          __floats2bfloat162_rn(dk_acc[e] * scale, dk_acc[e + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j + 2 * c) =
          __floats2bfloat162_rn(dv_acc[e], dv_acc[e + 1]);
    }
  }
}

// Launch the pass: q, k, v, dout, dq, dk, dv (bh, t, D) bf16, 16-byte
// aligned; lse, delta (bh, t) fp32; a.dq_ws (bh, T_pad, D) fp32 with
// T_pad = 64 ceil(t / 64), written before it is read; a.counters (bh,
// ceil(t / 64)) uint32, zero. Refuses a build whose register count would
// leave the consumers' setmaxnreg without registers to take (it would wait
// forever).
template <int D> cudaError_t launch(const attn_bwd::Args& a, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e;
  if ((e = map_rows<D>(&tq, a.q, a.bh, a.t)) != cudaSuccess ||
      (e = map_rows<D>(&tk, a.k, a.bh, a.t)) != cudaSuccess ||
      (e = map_rows<D>(&tv, a.v, a.bh, a.t)) != cudaSuccess ||
      (e = map_rows<D>(&tdo, a.dout, a.bh, a.t)) != cudaSuccess)
    return e;
  auto kernel = bwd_kernel<D>;
  if ((e = allow_smem(kernel, C::BYTES)) != cudaSuccess) return e;
  if constexpr (C::NWG == 2) {
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return e;
    if (attr.numRegs * C::ALL_THREADS < PRODUCER_REGS * THREADS + CONSUMER_REGS * C::CONSUMERS)
      return cudaErrorInvalidConfiguration;
  }
  const int n_kb = (a.t + C::KEYS - 1) / C::KEYS;
  kernel<<<n_kb * a.bh, C::ALL_THREADS, C::BYTES, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dq), static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.dq_ws, a.counters, a.bh, a.t, a.scale, a.dr);
  return cudaGetLastError();
}

}  // namespace attn_bwd_fused_tc
}  // namespace vtt
