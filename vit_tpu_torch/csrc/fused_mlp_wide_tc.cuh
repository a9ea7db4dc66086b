// The bf16 fused MLP at 128 < D <= 1024 (ViT-S/16's D384, ViT-B/16's D768,
// ViT-L/16's D1024) on Hopper's tensor cores: K3, the forward, and K7, the
// backward. They compute what vit_tpu/ops/fused_mlp.py::_fwd_kernel (:72)
// and _bwd_kernel (:83) compute, with every cast in the same place:
//   pre = x W1^T + b1                      fp32 sums, b1 added to the sum;
//   h   = g = bf16(gelu_AS(pre))           the Abramowitz-Stegun erf, fp32;
//   y   = bf16(h W2^T + b2)                fp32 sums, b2 added to the sum;
//   dh  = bf16((dy W2) * dgelu_AS(pre))    fp32;
//   dx  = bf16(dh W1);
//   dW1 = dh^T x, db1 = sum dh, dW2 = dy^T g, db2 = sum dy, in fp32.
// x and dy are (R, D), W1 (F, D) and W2 (D, F) in torch's nn.Linear layout,
// read as they lie. The D <= 128 routes (fused_mlp_tc.cuh,
// fused_mlp_bwd_tc.cuh) keep the (R, F) intermediates in registers.
//
// What bounds it on the H100: 4 R D F operations for K3 and 10 R D F for K7
// on the tensor cores (K7 recomputes pre); at ViT-B/16's shape (R 12608,
// D 768, F 3072) 0.120 ms and 0.301 ms at 989 TFLOP/s. Bytes are a tenth
// of that.
//
// Why not the D <= 128 design. Its accumulators cover 64 rows and at most
// 128 columns of y (or dx); a wider D means a column tile per 128 columns,
// each recomputing pre (and dg) over all of F: 14 R D F of products for K3
// at D768 where 4 are needed. y for 64 rows and D768 is 192 KB of fp32, so
// no single SM's registers (256 KB, less what pre and the addresses need)
// hold a row block's y at D >= 768. Two designs compute each product once:
// * A thread-block cluster per row block, each CTA owning D/n columns of y,
//   the CTA that forms an F chunk's pre broadcasting its bf16 h chunk into
//   every peer's shared memory. Each F chunk's W1 rows and W2 columns are
//   then read once per 64 rows (64 operations a byte of L2 traffic, about
//   what a 128 x 128 tile gets), and every chunk costs two cluster
//   barriers with the tensor cores idle during the GELU.
// * h (K3), g and dh (K7) written once to device memory in bf16, and each
//   pass a plain tiled product. That costs 2 R F bytes written and read per
//   tensor: 0.046 ms at ViT-B/16's shape for K3's h, against its 0.120 ms
//   bound, and at ViT-S/16's (R 8320, F 1536, 26 MB) they stay in the 50 MB
//   L2. In exchange every pass is a 128-row tile with two consumer
//   warpgroups fed by a TMA producer warp, the tensor cores never wait on a
//   barrier between CTAs, and the weight gradients come out of a product
//   over rows like any other instead of a pass that would recompute
//   full-D pre and dg for every F chunk.
// This file takes the second. Each product and each GELU is done once per
// element: K3 4 R D F operations, K7 10 R D F. (A cluster of 2 or 4 of K7's
// act-pass CTAs along F, x and dy multicast into all of them by TMA, was
// built and ran slower on the card: sharing slots puts the CTAs in
// lockstep, and that pass is not bound by reading x and dy from L2.)
//
// Passes (each a kernel; all three share the producer/consumer ring):
// * act_kernel: a CTA per 128 rows x N columns of F (K3: 256; K7: 64).
//   pre = x W1c^T (both K-major) over D in k-blocks of 64, and for K7 dg =
//   dy W2c (W2 read MN-major) beside it; the epilogue adds b1, applies the
//   GELU (and its derivative) on the accumulator fragment and writes h, or
//   g and dh, as bf16 to (R, F) scratch. K7 adds each k-block's products
//   into fp32 registers instead of letting the tensor cores carry the sum
//   over D (see act_kernel: the weight gradients are sums of g and dh).
// * out_kernel: y = h W2^T + b2 (W2 K-major) for K3, dx = dh W1 (W1 read
//   MN-major) for K7: a CTA per 128 rows x 256 columns of D, over F in
//   k-blocks of 64; bf16 out.
// * wgt_kernel (K7): dW1 = dh^T x and dW2 = dy^T g, a CTA per 128 x 256
//   output tile and segment of rows, both operands read MN-major from the
//   (R, .) matrices as they lie; the CTAs of each product's first column
//   tile also sum their A tile's columns over the rows (db1 from dh, db2
//   from dy) while the products run. One segment writes the gradients
//   themselves; more write fp32 partials that fused_mlp_bwd.cu's reduce
//   pass sums in segment order. No atomics: two calls give equal bits.
// * The ring: STAGES slots of one k-block each. Warp 8 (the producer) waits
//   for a slot's empty barrier, arms its full barrier with the slot's bytes
//   and issues the TMA loads; the two consumer warpgroups (threads 0-255,
//   rows 0-63 and 64-127 of the tile) wait on the full barrier, issue the
//   k-block's wgmma, and release the previous k-block's slot once
//   wait_group 1 says its products are done, so one k-block's products run
//   while the next one's are issued and later ones' loads are in flight.
// * Nothing stays resident, so each pass moves its operand tiles from L2
//   once per k-block; the tiles are as wide as the registers allow, which
//   sets the bytes moved per product (a 128 x 256 tile: 85 operations a
//   byte; K7's act pass, 128 x 64 with dy and W2 beside: 44).
// * TMA zero-fills rows and columns past R, D and F, so ragged edges add
//   exact zeros; the epilogues mask their stores.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace vtt {
namespace fused_mlp_wide_tc {

using namespace hopper;

constexpr int BM = 128;                  // rows of a tile: two consumer warpgroups of 64
constexpr int BK = 64;                   // k-block: one 128-byte swizzled box row
constexpr int CONSUMERS = 2 * THREADS;   // threads 0-255
constexpr int ALL_THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int BOX = 64 * BK * 2;         // a 64 x 64 bf16 box, 8 KB
constexpr int TILE_A = BM * BK * 2;      // 128 rows x one k-block, 16 KB
constexpr int RING_BYTES = 196 * 1024;   // shared memory for the ring's slots
// Tile columns. Every pass streams its operands from L2 (the tiles do not
// stay resident), so the widest tile the registers allow moves the fewest
// bytes per product: 256 (128 accumulator registers a thread) for K3's act
// pass, the out pass and the weight-gradient pass; 64 for K7's act pass,
// whose two accumulators and their fp32 sums take 128 (see act_kernel).
constexpr int N_ACT3 = 256, N_ACT7 = 64, N_OUT = 256, N_WGT = 256;
constexpr int D_MIN = 129, D_MAX = 1024;

// Widths this route takes (a static rule; D <= 128 takes the on-chip route).
inline bool takes(int d, int f) {
  return d >= D_MIN && d <= D_MAX && d % 16 == 0 && f % 16 == 0;
}

// Slots that fit the ring for a slot of `slot` bytes.
__host__ __device__ constexpr int stages_for(int slot) {
  return RING_BYTES / slot < 8 ? RING_BYTES / slot : 8;
}

// K-major operand: 16 columns (k-step kk) of 64-row (A) or N-row (B) boxes
// with 128-byte rows; rows 8 apart are 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return make_desc(tile + kk * 32, 16, 1024, 1);
}

// MN-major operand: rows 16kk.. of 64 x 64 boxes as the k dimension, their
// columns as M or N; consecutive 64-column boxes BOX bytes apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t boxes, int kk) {
  return make_desc(boxes + kk * 16 * 128, BOX, 1024, 1);
}

// The ring's barriers: full[s] at bars + 8s, empty[s] at bars + 8 (STAGES + s).
template <int STAGES> struct Ring {
  uint32_t bars;
  __device__ __forceinline__ uint32_t full(int i) const { return bars + 8 * (i % STAGES); }
  __device__ __forceinline__ uint32_t empty(int i) const {
    return bars + 8 * (STAGES + i % STAGES);
  }
  __device__ __forceinline__ void init() const {  // one thread
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);
    }
    fence_proxy_async();
  }
  // Producer: wait until item i's slot is free, arm its full barrier.
  __device__ __forceinline__ void acquire(int i, uint32_t bytes) const {
    if (i >= STAGES) mbar_wait(empty(i), (i / STAGES + 1) & 1);
    mbar_expect_tx(full(i), bytes);
  }
  // Consumer: wait for item i's loads.
  __device__ __forceinline__ void wait(int i) const { mbar_wait(full(i), (i / STAGES) & 1); }
  // Consumer: this warp is done with item i's slot.
  __device__ __forceinline__ void release(int i) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(i));
  }
};

// ---- act_kernel: pre (and dg), the GELU (and its derivative) -----------

// Slot bytes of act_kernel<DUAL, N>: x (128 rows x 64) | W1 (N F rows x 64)
// [| dy (128 x 64) | W2 (64 D rows x N F, N / 64 boxes)].
__host__ __device__ constexpr int act_slot(bool dual, int n) {
  return dual ? 2 * (TILE_A + n * BK * 2) : TILE_A + n * BK * 2;
}

// DUAL = false (K3): h = bf16(gelu(x W1^T + b1)) into out0, a CTA per 128
// rows x N columns of F; the products accumulate over D in the wgmma
// accumulators, one k-block's running while the next is issued. (An h that
// rounds to the other bf16 side moves y by an ulp of h times |W2|, far
// inside y's own rounding.)
// DUAL = true (K7): g into out0, dh = bf16((dy W2) * dgelu(pre)) into out1.
// g and dh feed fp32 weight-gradient sums over every row, where one bf16
// rounding that lands on the other side of a boundary moves dW by an ulp of
// g or dh times |dy| or |x|, so K7 keeps pre and dg as close to fp32 sums
// as the plain version's: each k-block's products start from zero in the
// accumulators and are added into fp32 registers. Left to the tensor
// cores' own running sum over D1024, g rounded off a float64 reference
// three times as often as the plain version's fp32 sums do (K3's h still
// does: chip_smoke.py's rounding row; K7's g and dh now less often than the
// plain version's), which at R 64 put one flipped g times |dy| past the
// weight gradients' limit; the approximate GELU (gelu_dgelu) adds next to
// nothing. Two accumulators and two sums of N / 2 registers each, so N = 64.
template <bool DUAL, int N>
__global__ void __launch_bounds__(ALL_THREADS, 1)
act_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
           const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap tw2,
           const __nv_bfloat16* __restrict__ b1, __nv_bfloat16* __restrict__ out0,
           __nv_bfloat16* __restrict__ out1, int r, int d, int f) {
  constexpr int A = TILE_A, B = N * BK * 2;
  constexpr int SLOT = act_slot(DUAL, N);
  constexpr int STAGES = stages_for(SLOT);
  constexpr bool PROMOTE = DUAL;
  constexpr int ACC = N / 2;  // accumulator registers of a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t slots = smem_u32(sm);
  const Ring<STAGES> ring{slots + STAGES * SLOT};
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * N, r0 = blockIdx.y * BM;
  const int n_k = (d + BK - 1) / BK;

  if (tid == 0) ring.init();
  __syncthreads();
  if (tid >= CONSUMERS) {  // the producer warp
    if (tid == CONSUMERS) {
      for (int i = 0; i < n_k; ++i) {
        const uint32_t s = slots + (i % STAGES) * SLOT, bar = ring.full(i);
        ring.acquire(i, SLOT);
        tma_load_2d(s, &tx, bar, i * BK, r0);
        tma_load_2d(s + A, &tw1, bar, i * BK, f0);
        if constexpr (DUAL) {
          tma_load_2d(s + A + B, &tdy, bar, i * BK, r0);
#pragma unroll
          for (int b = 0; b < N / 64; ++b)
            tma_load_2d(s + 2 * A + B + b * BOX, &tw2, bar, f0 + 64 * b, i * BK);
        }
      }
    }
    return;
  }

  const int wg = tid / THREADS, warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  float pre[ACC], dg[DUAL ? ACC : 1], pre_sum[PROMOTE ? ACC : 1], dg_sum[PROMOTE ? ACC : 1];
#pragma unroll
  for (int i = 0; i < ACC; ++i) pre[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DUAL ? ACC : 1); ++i) dg[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (PROMOTE ? ACC : 1); ++i) pre_sum[i] = dg_sum[i] = 0.f;

  for (int i = 0; i < n_k; ++i) {
    const uint32_t s = slots + (i % STAGES) * SLOT;
    const int keep = PROMOTE ? 0 : i > 0;  // add to the accumulators' running sum
    ring.wait(i);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaSS<N, 0, 0>::mma(pre, kmajor(s + wg * BOX, kk), kmajor(s + A, kk), keep || kk > 0);
    if constexpr (DUAL) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        WgmmaSS<N, 0, 1>::mma(dg, kmajor(s + A + B + wg * BOX, kk),
                              mnmajor(s + 2 * A + B, kk), keep || kk > 0);
    }
    wgmma_commit();
    if constexpr (PROMOTE) {
      wgmma_wait<0>();
      hold(pre);
      hold(dg);
      ring.release(i);
#pragma unroll
      for (int e = 0; e < ACC; ++e) {
        pre_sum[e] += pre[e];
        dg_sum[e] += dg[e];
      }
    } else {
      wgmma_wait<1>();
      if (i > 0) ring.release(i - 1);
    }
  }
  if constexpr (PROMOTE) {
#pragma unroll
    for (int e = 0; e < ACC; ++e) {
      pre[e] = pre_sum[e];
      dg[e] = dg_sum[e];
    }
  } else {
    wgmma_wait<0>();
    hold(pre);
    if constexpr (DUAL) hold(dg);
  }

  // Accumulator element 4j + 2hh + e is row 16*warp + g + 8hh of the
  // warpgroup's 64, column 8j + 2c + e of the tile.
  const int row_base = r0 + wg * 64 + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = f0 + 8 * j + 2 * c;  // f is a multiple of 16: col < f covers col + 1
    if (col < f) {
      const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + col));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row_base + 8 * hh, e = 4 * j + 2 * hh;
        if (row < r) {
          const size_t at = static_cast<size_t>(row) * f + col;
          if constexpr (DUAL) {
            float g0, g1, d0, d1;
            gelu_dgelu(pre[e] + bias.x, g0, d0);
            gelu_dgelu(pre[e + 1] + bias.y, g1, d1);
            *reinterpret_cast<__nv_bfloat162*>(out0 + at) = __floats2bfloat162_rn(g0, g1);
            *reinterpret_cast<__nv_bfloat162*>(out1 + at) =
                __floats2bfloat162_rn(dg[e] * d0, dg[e + 1] * d1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(out0 + at) =
                __floats2bfloat162_rn(gelu_tc(pre[e] + bias.x), gelu_tc(pre[e + 1] + bias.y));
          }
        }
      }
    }
  }
}

// ---- out_kernel: y = h W2^T + b2 (K3), dx = dh W1 (K7) ---------------------

// Slot bytes of out_kernel<B_MN, N>: A (128 rows x 64) | B (N columns x 64).
__host__ __device__ constexpr int out_slot(int n) { return TILE_A + n * BK * 2; }

// A CTA per 128 rows x N columns of D. A: (R, F) bf16, K-major. B_MN =
// false: B is W2 (D, F), K-major (one box of N D rows x 64); true: B is W1
// (F, D), read MN-major (N / 64 boxes of 64 x 64). bias: b2, or null.
template <bool B_MN, int N>
__global__ void __launch_bounds__(ALL_THREADS, 1)
out_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
           const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int r,
           int d, int f) {
  constexpr int A = TILE_A;
  constexpr int SLOT = out_slot(N);
  constexpr int STAGES = stages_for(SLOT);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t slots = smem_u32(sm);
  const Ring<STAGES> ring{slots + STAGES * SLOT};
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * N, r0 = blockIdx.y * BM;
  const int n_k = (f + BK - 1) / BK;

  if (tid == 0) ring.init();
  __syncthreads();
  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      for (int i = 0; i < n_k; ++i) {
        const uint32_t s = slots + (i % STAGES) * SLOT, bar = ring.full(i);
        ring.acquire(i, SLOT);
        tma_load_2d(s, &ta, bar, i * BK, r0);
        if constexpr (B_MN) {
#pragma unroll
          for (int b = 0; b < N / 64; ++b)
            tma_load_2d(s + A + b * BOX, &tb, bar, n0 + 64 * b, i * BK);
        } else {
          tma_load_2d(s + A, &tb, bar, i * BK, n0);
        }
      }
    }
    return;
  }

  const int wg = tid / THREADS, warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_k; ++i) {
    const uint32_t s = slots + (i % STAGES) * SLOT;
    ring.wait(i);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaSS<N, 0, B_MN ? 1 : 0>::mma(acc, kmajor(s + wg * BOX, kk),
                                         B_MN ? mnmajor(s + A, kk) : kmajor(s + A, kk),
                                         i > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0) ring.release(i - 1);
  }
  wgmma_wait<0>();
  hold(acc);

  const int row_base = r0 + wg * 64 + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = n0 + 8 * j + 2 * c;  // d is a multiple of 16
    if (col < d) {
      const float2 b =
          bias != nullptr
              ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col))
              : make_float2(0.f, 0.f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row_base + 8 * hh, e = 4 * j + 2 * hh;
        if (row < r)
          *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * d + col) =
              __floats2bfloat162_rn(acc[e] + b.x, acc[e + 1] + b.y);
      }
    }
  }
}

// ---- wgt_kernel: dW1, db1, dW2, db2 ----------------------------------------

// Slot bytes of wgt_kernel<N>: 64 rows of the A tile (128 columns) and of
// the B tile (N columns).
__host__ __device__ constexpr int wgt_slot(int n) { return 2 * BOX + n * 128; }

// Byte offset of element (row, col) of a 64 x 64 box as TMA's 128-byte
// swizzle lays it out (the box base aligned to 1024).
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  const uint32_t o = row * 128 + col * 2;
  return o ^ ((row & 7) << 4);
}

// Product 0: dW1 (F, D) = dh^T x, column sums of dh -> db1. Product 1:
// dW2 (D, F) = dy^T g, column sums of dy -> db2. C (M, N) = sum over the
// segment's rows of A[row, m] B[row, n], A and B (R, M) and (R, N) read
// MN-major. out + seg * ld holds [dW1 | db1 | dW2 | db2]. Tiles of 128 x N.
// Slot: A (64 rows x 128 of M, two boxes) | B (64 rows x N, N / 64 boxes).
template <int N>
__global__ void __launch_bounds__(ALL_THREADS, 1)
wgt_kernel(const __grid_constant__ CUtensorMap tdh, const __grid_constant__ CUtensorMap tx,
           const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap tg,
           float* __restrict__ out, size_t ld, int r, int d, int f, int tiles0,
           int seg_blocks) {
  constexpr int SLOT = wgt_slot(N);
  constexpr int STAGES = stages_for(SLOT);
  // Column sums: thread t sums columns 2 (t % 64) + {0, 1} of the A tile
  // over rows 16 (t / 64) .. + 16 of each k-block.
  constexpr int PAIRS = BM / 2, GROUPS = CONSUMERS / PAIRS, GROUP_ROWS = 64 / GROUPS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t slots = smem_u32(sm);
  const Ring<STAGES> ring{slots + STAGES * SLOT};
  float* sums = reinterpret_cast<float*>(sm + STAGES * SLOT + 16 * STAGES);  // GROUPS x BM
  const int tid = threadIdx.x;

  const int p = blockIdx.x >= tiles0;
  const int m_total = p ? d : f, n_total = p ? f : d;
  const int t = blockIdx.x - p * tiles0, n_tiles = (n_total + N - 1) / N;
  const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * N;
  const CUtensorMap* ma = p ? &tdy : &tdh;
  const CUtensorMap* mb = p ? &tg : &tx;
  const int n_blocks = (r + 63) / 64, blk0 = blockIdx.y * seg_blocks;
  const int n_k = max(0, min(n_blocks, blk0 + seg_blocks) - blk0);

  if (tid == 0) ring.init();
  __syncthreads();
  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      for (int i = 0; i < n_k; ++i) {
        const uint32_t s = slots + (i % STAGES) * SLOT, bar = ring.full(i);
        const int row = (blk0 + i) * 64;
        ring.acquire(i, SLOT);
        tma_load_2d(s, ma, bar, m0, row);
        tma_load_2d(s + BOX, ma, bar, m0 + 64, row);
#pragma unroll
        for (int b = 0; b < N / 64; ++b) tma_load_2d(s + (2 + b) * BOX, mb, bar, n0 + 64 * b, row);
      }
    }
    return;
  }

  const int wg = tid / THREADS, warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const bool colsum = n0 == 0;  // the first column tile sums A's columns
  const int pair = tid % PAIRS, group = tid / PAIRS;
  const int sum_box = 2 * pair / 64, sum_col = 2 * pair % 64;
  float2 csum = make_float2(0.f, 0.f);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < n_k; ++i) {
    const uint32_t s = slots + (i % STAGES) * SLOT;
    ring.wait(i);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaSS<N, 1, 1>::mma(acc, mnmajor(s + wg * BOX, kk), mnmajor(s + 2 * BOX, kk),
                             i > 0 || kk > 0);
    wgmma_commit();
    if (colsum) {  // while the products run; rows past R are zeros
      const uint8_t* box = sm + (s - slots) + sum_box * BOX;
#pragma unroll
      for (int q = 0; q < GROUP_ROWS; ++q) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            box + swizzled(group * GROUP_ROWS + q, sum_col)));
        csum.x += v.x;
        csum.y += v.y;
      }
    }
    wgmma_wait<1>();
    if (i > 0) ring.release(i - 1);
  }
  wgmma_wait<0>();
  hold(acc);

  float* base = out + static_cast<size_t>(blockIdx.y) * ld;
  const size_t fd = static_cast<size_t>(f) * d;
  float* c_out = base + (p ? fd + f : 0);
  const int row_base = m0 + wg * 64 + 16 * warp + g;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_base + 8 * hh;
    if (row < m_total) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = n0 + 8 * j + 2 * c, e = 4 * j + 2 * hh;
        if (col < n_total)
          *reinterpret_cast<float2*>(c_out + static_cast<size_t>(row) * n_total + col) =
              make_float2(acc[e], acc[e + 1]);
      }
    }
  }
  if (colsum) {  // the groups' sums, added in group order
    sums[group * BM + 2 * pair] = csum.x;
    sums[group * BM + 2 * pair + 1] = csum.y;
    named_sync(1, CONSUMERS);
    if (tid < BM && m0 + tid < m_total) {
      float v = 0.f;
      for (int q = 0; q < GROUPS; ++q) v += sums[q * BM + tid];
      base[(p ? 2 * fd + f : fd) + m0 + tid] = v;
    }
  }
}

// ---- host side ---------------------------------------------------------

// Dynamic shared memory of a kernel whose ring has slots of `slot` bytes:
// the slots, two mbarriers a slot, `extra`, slack to align the base to 1024.
inline size_t smem_for(int slot, size_t extra = 0) {
  return static_cast<size_t>(stages_for(slot)) * slot + 16 * stages_for(slot) + extra + 1024;
}

// K3. x, y: (r, d); w1: (f, d); b1: (f); w2: (d, f); b2: (d); h: (r, f)
// scratch; bf16, contiguous, 16-byte aligned; takes(d, f). N: the act
// pass's tile columns. (A template, so that only the library that launches
// K3 instantiates its passes.)
template <int N = N_ACT3>
cudaError_t launch_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* y, void* h, int r, int d, int f,
                       cudaStream_t stream) {
  CUtensorMap tx, tw1, th, tw2;
  cudaError_t e;
  if ((e = map_matrix(&tx, x, r, d, BK, BM)) != cudaSuccess ||
      (e = map_matrix(&tw1, w1, f, d, BK, N)) != cudaSuccess ||
      (e = map_matrix(&th, h, r, f, BK, BM)) != cudaSuccess ||
      (e = map_matrix(&tw2, w2, d, f, BK, N_OUT)) != cudaSuccess)
    return e;
  const size_t smem_act = smem_for(act_slot(false, N));
  auto act = act_kernel<false, N>;
  if ((e = allow_smem(act, smem_act)) != cudaSuccess) return e;
  act<<<dim3((f + N - 1) / N, (r + BM - 1) / BM), ALL_THREADS, smem_act, stream>>>(
      tx, tw1, tx, tw1, static_cast<const __nv_bfloat16*>(b1), static_cast<__nv_bfloat16*>(h),
      nullptr, r, d, f);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t smem_out = smem_for(out_slot(N_OUT));
  auto out = out_kernel<false, N_OUT>;
  if ((e = allow_smem(out, smem_out)) != cudaSuccess) return e;
  out<<<dim3((d + N_OUT - 1) / N_OUT, (r + BM - 1) / BM), ALL_THREADS, smem_out, stream>>>(
      th, tw2, static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(y), r, d, f);
  return cudaGetLastError();
}

// Weight-gradient tiles of both products (dW1's, then dW2's), 128 x N_WGT.
inline int wgt_tiles0(int d, int f) { return ((f + BM - 1) / BM) * ((d + N_WGT - 1) / N_WGT); }
inline int wgt_tiles(int d, int f) {
  return wgt_tiles0(d, f) + ((d + BM - 1) / BM) * ((f + N_WGT - 1) / N_WGT);
}

// K7. x, dy, dx: (r, d); w1: (f, d); b1: (f); w2: (d, f); g, dh: (r, f)
// scratch; bf16, contiguous, 16-byte aligned; takes(d, f). out: n_seg
// blocks of ld = 2 f d + f + d fp32, [dW1 (f, d) | db1 | dW2 (d, f) | db2]
// over the segment's rows (n_seg = 1: the gradients), every element
// written; the rows split into n_seg segments of whole 64-row blocks, none
// empty. N: the act pass's tile columns.
template <int N = N_ACT7>
cudaError_t launch_bwd(const void* x, const void* dy, const void* w1, const void* b1,
                       const void* w2, void* dx, void* g, void* dh, void* out, int r, int d,
                       int f, int n_seg, cudaStream_t stream) {
  CUtensorMap tx, tdy, tw1, tw2;
  cudaError_t e;
  if ((e = map_matrix(&tx, x, r, d, BK, BM)) != cudaSuccess ||
      (e = map_matrix(&tdy, dy, r, d, BK, BM)) != cudaSuccess ||
      (e = map_matrix(&tw1, w1, f, d, BK, N)) != cudaSuccess ||
      (e = map_matrix(&tw2, w2, d, f, 64, BK)) != cudaSuccess)
    return e;
  const size_t smem_act = smem_for(act_slot(true, N));
  auto act = act_kernel<true, N>;
  if ((e = allow_smem(act, smem_act)) != cudaSuccess) return e;
  act<<<dim3((f + N - 1) / N, (r + BM - 1) / BM), ALL_THREADS, smem_act, stream>>>(
      tx, tw1, tdy, tw2, static_cast<const __nv_bfloat16*>(b1), static_cast<__nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(dh), r, d, f);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  CUtensorMap tdh_rows, tw1_mn;
  if ((e = map_matrix(&tdh_rows, dh, r, f, BK, BM)) != cudaSuccess ||
      (e = map_matrix(&tw1_mn, w1, f, d, 64, BK)) != cudaSuccess)
    return e;
  const size_t smem_out = smem_for(out_slot(N_OUT));
  auto dxk = out_kernel<true, N_OUT>;
  if ((e = allow_smem(dxk, smem_out)) != cudaSuccess) return e;
  dxk<<<dim3((d + N_OUT - 1) / N_OUT, (r + BM - 1) / BM), ALL_THREADS, smem_out, stream>>>(
      tdh_rows, tw1_mn, nullptr, static_cast<__nv_bfloat16*>(dx), r, d, f);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  CUtensorMap tdh, tx64, tdy64, tg;
  if ((e = map_matrix(&tdh, dh, r, f, 64, 64)) != cudaSuccess ||
      (e = map_matrix(&tx64, x, r, d, 64, 64)) != cudaSuccess ||
      (e = map_matrix(&tdy64, dy, r, d, 64, 64)) != cudaSuccess ||
      (e = map_matrix(&tg, g, r, f, 64, 64)) != cudaSuccess)
    return e;
  // + the column sums' group partials
  const size_t smem_w = smem_for(wgt_slot(N_WGT), 2 * CONSUMERS * sizeof(float));
  auto wgt = wgt_kernel<N_WGT>;
  if ((e = allow_smem(wgt, smem_w)) != cudaSuccess) return e;
  const int n_blocks = (r + 63) / 64, seg_blocks = (n_blocks + n_seg - 1) / n_seg;
  const size_t ld = 2 * static_cast<size_t>(f) * d + f + d;
  wgt<<<dim3(wgt_tiles(d, f), n_seg), ALL_THREADS, smem_w, stream>>>(
      tdh, tx64, tdy64, tg, static_cast<float*>(out), ld, r, d, f, wgt_tiles0(d, f),
      seg_blocks);
  return cudaGetLastError();
}

}  // namespace fused_mlp_wide_tc
}  // namespace vtt
