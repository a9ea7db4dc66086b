// The bf16 fused MLP backward (K7) on Hopper's tensor cores. It computes what
// vit_tpu/ops/fused_mlp.py::_bwd_kernel (:83) computes, launched there by
// _pallas_bwd (:146), with every cast in the same place:
//   pre = x W1^T + b1                      fp32 sums, b1 added to the sum;
//   g   = bf16(gelu_AS(pre))               the Abramowitz-Stegun erf, fp32;
//   dh  = bf16((dy W2) * dgelu_AS(pre))    fp32;
//   dx  = bf16(dh W1);
//   dW1 = dh^T x, db1 = sum dh, dW2 = dy^T g, db2 = sum dy, in fp32.
// x and dy are (R, D), W1 (F, D) and W2 (D, F) in torch's nn.Linear layout,
// read as they lie. This is the route for D <= 128 (the spectra configs);
// fused_mlp_wide_tc.cuh takes 128 < D <= 1024, and fused_mlp_bwd.cu keeps
// the FMA kernels for fp32 (tensor cores in fp32 would be TF32) and for
// widths neither takes.
//
// What bounds it on the H100: 10 R D F operations (five R x D x F products,
// the pre-activation recomputed) against x, dy, dx and the weights moved
// once: at the stride-1 shape (R = 65056, D = 128, F = 512) 42.6 GFLOP,
// 0.043 ms at 989 TFLOP/s. The GELU and its derivative on the CUDA cores
// (R F = 33 M elements in each pass, each a reciprocal, an exp and some
// twenty other instructions) are outside the bound and cost about as much.
//
// Design. No (R, F) tensor reaches device memory: g and dh live in
// registers, as the accumulator fragment of one product repacked as the A
// operand of the next (hopper.cuh). Two passes, one warpgroup a CTA each,
// then a sum of partials (fused_mlp_bwd.cu):
// * dx pass, a CTA per 64 rows and a column tile of up to 128 of dx. The x
//   and dy tiles stay in shared memory. F goes in chunks of 64; per chunk
//   and k = 64 columns of D one ring slot holds W2's and W1's boxes. Per
//   chunk: dg = dy W2c (B read MN-major) and pre = x W1c^T (both K-major),
//   then dgelu on the accumulator fragment, dh rounded to bf16 in place, and
//   dx += dh W1c[:, tile] (B the same W1 boxes read MN-major: they are
//   streamed last and kept in the ring until this product, which reads
//   both of a 128-column tile's boxes as one m64n128 operand). dx is
//   written once, in bf16.
// * weight pass, a CTA per (F chunk of 64, column tile of up to 128 of D,
//   segment of rows). Its W1 and W2 chunks stay in shared memory; the x and
//   dy boxes of each 64-row block of the segment stream through the ring.
//   It forms the transposed activations, as K5 does (attn_bwd_tc.cuh), so
//   they leave the accumulators as A operands: pre^T = W1c x^T, dg^T =
//   W2c^T dy^T (A read MN-major), g^T and dh^T in registers, dW1c += dh^T x
//   and dW2c^T += g^T dy (B read MN-major). db1 is the row sum of dh^T in
//   registers; db2 the column sum of the dy boxes in shared memory, taken
//   by the first F chunk's CTAs while their products run. Each segment
//   writes fp32 partials in a fixed layout; the last pass sums them over
//   the segments in order. No atomics: two calls give equal bits.
// * Each group of products is waited on once: the boxes of a column tile
//   are issued back to back. Queueing the next group behind the last
//   product of this one (a software pipeline) made ptxas serialise every
//   wgmma (C7515) and ran slower on the card.
// * TMA zero-fills rows and columns past R, D and F, so ragged edges add
//   exact zeros (rows past R give dh = 0 since dy is 0 there, and g times a
//   zero dy row adds nothing).
// * The GELU and its derivative share one reciprocal and one exp
//   (hopper.cuh::gelu_dgelu): erf's exp(-z^2) with z = x / sqrt(2) is the
//   pdf's exp(-x^2 / 2). Both are special-function instructions
//   (rcp.approx, ex2.approx), as in K3.
// * One column tile covers D <= 128, so nothing is recomputed. A wider D
//   would need a tile per 128 columns, each recomputing pre and dg (three
//   times at D = 384), so it takes the wide route (takes).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace vtt {
namespace fused_mlp_bwd_tc {

using namespace hopper;

constexpr int FC = 64;      // F chunk: the N of pre and dg (dx pass), their M (weight pass)
// Ring slots. Even and more than the boxes of a column tile: a tile's two
// boxes are the last two items of a group of an even number of items, so
// they land in slots 2i and 2i + 1, one wgmma of N = 128 reads across both.
constexpr int STAGES = 4;
static_assert(STAGES % 2 == 0, "a column tile's two boxes must not wrap the ring");
constexpr int TILE_N = 128; // columns of D a CTA's accumulators cover
constexpr int D_MAX = TILE_N;  // one column tile: wider D takes fused_mlp_wide_tc.cuh

// Widths this path takes; the others take the wide route or keep the FMA
// kernels (a static rule, not a fallback: a refused launch here still fails).
inline bool takes(int d, int f) { return d % 16 == 0 && f % 16 == 0 && d <= D_MAX; }

// D padded to whole boxes and column tiles: 16, 32, 64, or a multiple of 128.
inline int padded(int d) { return d <= 32 ? d : d <= 64 ? 64 : (d + 127) / 128 * 128; }

// Position in the D boxes of the stream's p-th box: the boxes outside the
// column tile [t0, t0 + nb) first, the tile's last, so that they are still
// in the ring for the products that read them again.
__device__ __forceinline__ int tile_last(int p, int n, int t0, int nb) {
  const int rest = n - nb;
  return p < rest ? (p < t0 ? p : p + nb) : t0 + p - rest;
}

// B read MN-major (k-step kk) over the column boxes of a tile, which lie
// `stride` bytes apart in consecutive ring slots (NB = 2) or are one box.
template <int BW>
__device__ __forceinline__ uint64_t desc_tile(uint32_t box, int kk, uint32_t stride) {
  using L = Tile<BW>;
  return make_desc(box + kk * 16 * L::ROW_BYTES, stride, 8 * L::ROW_BYTES, L::LAYOUT);
}

// ---- dx pass -----------------------------------------------------------

// BW: columns of a box (the padded D up to 64); NB boxes make the column
// tile. A ring slot holds the W2 box (BW rows of D x 64 of F) and the W1 box
// (64 of F x BW of D) of one k = BW columns of D.
template <int BW, int NB>
__global__ void __launch_bounds__(THREADS, 2)
dx_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
          const __grid_constant__ CUtensorMap tw1, const __grid_constant__ CUtensorMap tw2,
          const __nv_bfloat16* __restrict__ b1, __nv_bfloat16* __restrict__ dx, int r, int d,
          int f, int dp) {
  constexpr int BOX = Tile<BW>::BYTES;  // a 64 x BW box of x, dy or W1; a BW x 64 box of W2
  constexpr int SLOT = 2 * BOX, N = BW * NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const int nbox = dp / BW;
  const uint32_t x_t = smem_u32(sm), dy_t = x_t + nbox * BOX, slots = dy_t + nbox * BOX;
  const uint32_t bar_x = slots + STAGES * SLOT, bar0 = bar_x + 8;  // slot s: bar0 + 8s

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int row0 = blockIdx.x * TILE_ROWS, t0 = blockIdx.y * NB, col0 = t0 * BW;
  const int n_chunks = (f + FC - 1) / FC;
  const int n_items = n_chunks * nbox;  // per chunk: the D boxes, the tile's last

  const CUtensorMap* m1 = &tw1;
  const CUtensorMap* m2 = &tw2;
  auto load_item = [&](int i) {  // thread 0 only
    const int ch = i / nbox, k = tile_last(i - ch * nbox, nbox, t0, NB), s = i % STAGES;
    const uint32_t bar = bar0 + 8 * s, dst = slots + s * SLOT;
    mbar_expect_tx(bar, SLOT);
    tma_load_2d(dst, m2, bar, ch * FC, k * BW);
    tma_load_2d(dst + BOX, m1, bar, k * BW, ch * FC);
  };

  if (tid == 0) {
    mbar_init(bar_x, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    fence_proxy_async();
  }
  __syncthreads();
  int loaded = min(STAGES, n_items);  // thread 0's count of items loaded or in flight
  if (tid == 0) {
    mbar_expect_tx(bar_x, 2 * nbox * BOX);
    for (int k = 0; k < nbox; ++k) {
      tma_load_2d(x_t + k * BOX, &tx, bar_x, k * BW, row0);
      tma_load_2d(dy_t + k * BOX, &tdy, bar_x, k * BW, row0);
    }
    for (int i = 0; i < loaded; ++i) load_item(i);
  }
  __syncwarp();

  // Every warp is done with the slots of items before `done`: refill them.
  auto release = [&](int done) {
    __syncthreads();
    if (tid == 0)
      for (; loaded < n_items && loaded < done + STAGES; ++loaded) load_item(loaded);
    __syncwarp();
  };
  auto slot = [&](int i) { return slots + (i % STAGES) * SLOT; };
  auto wait = [&](int i) { mbar_wait(bar0 + 8 * (i % STAGES), (i / STAGES) & 1); };

  float acc[N / 2], pre[32], dg[32];
  uint32_t dh[16];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) pre[i] = dg[i] = 0.f;

  mbar_wait(bar_x, 0);
  int item = 0;
  for (int ch = 0; ch < n_chunks; ++ch) {
    // dg = dy W2c (W2 read MN-major), pre = x W1c^T (both K-major). Boxes
    // outside the tile are waited on and released one by one; the tile's
    // are issued back to back and kept for dx.
    for (int p = 0; p < nbox; ++p) {
      const int k = tile_last(p, nbox, t0, NB);
      wait(item);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BW / 16; ++kk)
        wgmma_ss_n64<0, 1>(dg, desc_k<BW>(dy_t + k * BOX, kk), desc_mn<64>(slot(item), kk),
                           p > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < BW / 16; ++kk)
        wgmma_ss_n64(pre, desc_k<BW>(x_t + k * BOX, kk), desc_k<BW>(slot(item) + BOX, kk),
                     p > 0 || kk > 0);
      wgmma_commit();
      ++item;
      if (p < nbox - NB) {
        wgmma_wait_all();
        hold(dg);
        hold(pre);
        release(item);
      }
    }
    wgmma_wait_all();
    hold(dg);
    hold(pre);

    // Accumulator element 4j + 2hh + e is row 16*warp + g + 8hh, column
    // f0 + 8j + 2c + e; dh[2j + hh] packs that row's two columns.
    const int f0 = ch * FC;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = f0 + 8 * j + 2 * c;  // f is a multiple of 16: col < f covers col + 1
      const float2 bias = col < f ? __bfloat1622float2(
                                        *reinterpret_cast<const __nv_bfloat162*>(b1 + col))
                                  : make_float2(0.f, 0.f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float gl, d0, d1;
        gelu_dgelu(pre[4 * j + 2 * hh] + bias.x, gl, d0);
        gelu_dgelu(pre[4 * j + 2 * hh + 1] + bias.y, gl, d1);
        dh[2 * j + hh] = pack_bf16(dg[4 * j + 2 * hh] * d0, dg[4 * j + 2 * hh + 1] * d1);
      }
    }

    // dx += dh W1c[:, tile], W1 read MN-major across the tile's slots.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaRS<N, 1>::mma(acc, dh + 4 * kk, desc_tile<BW>(slot(item - NB) + BOX, kk, SLOT));
    wgmma_commit();
    wgmma_wait_all();
    hold(acc);
    hold(dh);
    release(item);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 16 * warp + g + 8 * hh;
    if (row >= r) continue;
    __nv_bfloat16* out = dx + static_cast<size_t>(row) * d;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = col0 + 8 * j + 2 * c;  // d is a multiple of 16
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

// ---- weight pass -------------------------------------------------------

// Byte offset of element (row, col) in a box of 64 rows of BW bf16, as TMA
// swizzles it: the 16-byte unit of each row XORed with the row's bits
// (32-, 64- or 128-byte swizzle; the box base is aligned to its span).
template <int BW> __device__ __forceinline__ uint32_t swizzled(int row, int col) {
  constexpr uint32_t RB = BW * 2;
  const uint32_t o = row * RB + col * 2;
  return o ^ (((o >> 7) & (RB / 16 - 1)) << 4);
}

// Partials of segment s at part + s * ld: dW1 (f, d) | db1 (f) | dW2^T
// (f, d) | db2 (d); the last pass writes dW2 as (d, f). A ring slot holds
// the x box and the dy box (64 rows x BW of D) of one k of one row block.
template <int BW, int NB>
__global__ void __launch_bounds__(THREADS, 1)
wgt_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
           const __grid_constant__ CUtensorMap tw1, const __grid_constant__ CUtensorMap tw2,
           const __nv_bfloat16* __restrict__ b1, float* __restrict__ part, size_t ld, int r,
           int d, int f, int dp, int n_fc, int seg_blocks) {
  constexpr int BOX = Tile<BW>::BYTES;
  constexpr int SLOT = 2 * BOX, N = BW * NB;
  // db2: thread tid sums columns 2 (tid % PAIRS) + {0, 1} of the tile over
  // rows [GROUP_ROWS * q, + GROUP_ROWS) of each block, q = tid / PAIRS.
  constexpr int PAIRS = N / 2, GROUPS = THREADS / PAIRS, GROUP_ROWS = TILE_ROWS / GROUPS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const int nbox = dp / BW;
  const uint32_t w1_t = smem_u32(sm), w2_t = w1_t + nbox * BOX, slots = w2_t + nbox * BOX;
  const uint32_t bar_w = slots + STAGES * SLOT, bar0 = bar_w + 8;  // slot s: bar0 + 8s
  float* db2_part = reinterpret_cast<float*>(sm + (bar_w - w1_t) + 64);  // GROUPS x N

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int fc = blockIdx.x % n_fc, t0 = (blockIdx.x / n_fc) * NB;
  const int f0 = fc * FC, col0 = t0 * BW;
  const int n_blocks = (r + TILE_ROWS - 1) / TILE_ROWS;
  const int blk0 = blockIdx.y * seg_blocks;
  const int n_blk = max(0, min(n_blocks, blk0 + seg_blocks) - blk0);
  const int n_items = n_blk * nbox;  // per row block: the D boxes, the tile's last

  const CUtensorMap* mx = &tx;
  const CUtensorMap* mdy = &tdy;
  auto load_item = [&](int i) {  // thread 0 only
    const int blk = blk0 + i / nbox, s = i % STAGES;
    const int k = tile_last(i % nbox, nbox, t0, NB);
    const uint32_t bar = bar0 + 8 * s, dst = slots + s * SLOT;
    mbar_expect_tx(bar, SLOT);
    tma_load_2d(dst, mx, bar, k * BW, blk * TILE_ROWS);
    tma_load_2d(dst + BOX, mdy, bar, k * BW, blk * TILE_ROWS);
  };

  if (tid == 0) {
    mbar_init(bar_w, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    fence_proxy_async();
  }
  __syncthreads();
  int loaded = min(STAGES, n_items);
  if (tid == 0) {
    mbar_expect_tx(bar_w, 2 * nbox * BOX);
    for (int k = 0; k < nbox; ++k) {
      tma_load_2d(w1_t + k * BOX, &tw1, bar_w, k * BW, f0);
      tma_load_2d(w2_t + k * BOX, &tw2, bar_w, f0, k * BW);
    }
    for (int i = 0; i < loaded; ++i) load_item(i);
  }
  __syncwarp();

  auto release = [&](int done) {
    __syncthreads();
    if (tid == 0)
      for (; loaded < n_items && loaded < done + STAGES; ++loaded) load_item(loaded);
    __syncwarp();
  };
  auto slot = [&](int i) { return slots + (i % STAGES) * SLOT; };  // x box, then dy box
  auto wait = [&](int i) { mbar_wait(bar0 + 8 * (i % STAGES), (i / STAGES) & 1); };

  // This thread's two F rows of every accumulator: f0 + 16*warp + g + 8hh.
  float bias[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int fr = f0 + 16 * warp + g + 8 * hh;
    bias[hh] = fr < f ? __bfloat162float(b1[fr]) : 0.f;
  }
  const int pair = tid % PAIRS, group = tid / PAIRS;
  const int db2_box = 2 * pair / BW, db2_col = 2 * pair % BW;

  float dw1[N / 2], dw2[N / 2], pre[32], dg[32], db1[2] = {0.f, 0.f};
  float2 db2 = make_float2(0.f, 0.f);
  uint32_t ga[16], da[16];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dw1[i] = dw2[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) pre[i] = dg[i] = 0.f;

  mbar_wait(bar_w, 0);
  int item = 0;
  for (int bi = 0; bi < n_blk; ++bi) {
    // pre^T = W1c x^T; dg^T = W2c^T dy^T (W2 read MN-major). Boxes outside
    // the tile are waited on and released one by one; the tile's are issued
    // back to back and kept for dW.
    for (int p = 0; p < nbox; ++p) {
      const int k = tile_last(p, nbox, t0, NB);
      wait(item);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BW / 16; ++kk)
        wgmma_ss_n64(pre, desc_k<BW>(w1_t + k * BOX, kk), desc_k<BW>(slot(item), kk),
                     p > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < BW / 16; ++kk)
        wgmma_ss_n64<1, 0>(dg, desc_mn<64>(w2_t + k * BOX, kk),
                           desc_k<BW>(slot(item) + BOX, kk), p > 0 || kk > 0);
      wgmma_commit();
      ++item;
      if (p < nbox - NB) {
        wgmma_wait_all();
        hold(pre);
        hold(dg);
        release(item);
      }
    }
    wgmma_wait_all();
    hold(pre);
    hold(dg);

    // Accumulator element 4j + 2hh + e is F row f0 + 16*warp + g + 8hh,
    // row 8j + 2c + e of the block; ga / da[2j + hh] pack g^T / dh^T there.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * j + 2 * hh;
        float g0, g1, d0, d1;
        gelu_dgelu(pre[i] + bias[hh], g0, d0);
        gelu_dgelu(pre[i + 1] + bias[hh], g1, d1);
        ga[2 * j + hh] = pack_bf16(g0, g1);
        const __nv_bfloat162 dh = __floats2bfloat162_rn(dg[i] * d0, dg[i + 1] * d1);
        da[2 * j + hh] = *reinterpret_cast<const uint32_t*>(&dh);
        const float2 dhr = __bfloat1622float2(dh);
        db1[hh] += dhr.x + dhr.y;  // the rounded dh, as the plain version sums it
      }

    // dW1c += dh^T x, dW2c^T += g^T dy; x and dy read MN-major across the
    // tile's slots.
    const uint32_t tile = slot(item - NB);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      WgmmaRS<N, 1>::mma(dw1, da + 4 * kk, desc_tile<BW>(tile, kk, SLOT));
      WgmmaRS<N, 1>::mma(dw2, ga + 4 * kk, desc_tile<BW>(tile + BOX, kk, SLOT));
    }
    wgmma_commit();
    if (fc == 0) {  // db2: column sums of the dy tile while the products run (zeros past R)
      const uint8_t* box = sm + (tile - w1_t) + db2_box * SLOT + BOX;
#pragma unroll
      for (int i = 0; i < GROUP_ROWS; ++i) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            box + swizzled<BW>(group * GROUP_ROWS + i, db2_col)));
        db2.x += v.x;
        db2.y += v.y;
      }
    }
    wgmma_wait_all();
    hold(dw1);
    hold(dw2);
    hold(ga);
    hold(da);
    release(item);
  }

  float* out = part + static_cast<size_t>(blockIdx.y) * ld;
  const size_t fd = static_cast<size_t>(f) * d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int fr = f0 + 16 * warp + g + 8 * hh;
    float s = db1[hh];  // over the four lanes that share the row, in a fixed order
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (fr >= f) continue;
    if (t0 == 0 && c == 0) out[fd + fr] = s;
    float* w1row = out + static_cast<size_t>(fr) * d;
    float* w2row = out + fd + f + static_cast<size_t>(fr) * d;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = col0 + 8 * j + 2 * c, i = 4 * j + 2 * hh;
      if (col >= d) continue;
      *reinterpret_cast<float2*>(w1row + col) = make_float2(dw1[i], dw1[i + 1]);
      *reinterpret_cast<float2*>(w2row + col) = make_float2(dw2[i], dw2[i + 1]);
    }
  }
  if (fc == 0) {  // the groups' db2 sums, added in group order
    db2_part[group * N + 2 * pair] = db2.x;
    db2_part[group * N + 2 * pair + 1] = db2.y;
    __syncthreads();
    if (tid < N && col0 + tid < d) {
      float s = 0.f;
      for (int q = 0; q < GROUPS; ++q) s += db2_part[q * N + tid];
      out[2 * fd + f + col0 + tid] = s;
    }
  }
}

// ---- host side ---------------------------------------------------------

template <int BW, int NB>
cudaError_t launch_bw(const void* x, const void* dy, const void* w1, const void* b1,
                      const void* w2, void* dx, void* part, int r, int d, int f, int dp,
                      int n_seg, cudaStream_t stream) {
  constexpr int BOX = Tile<BW>::BYTES;
  CUtensorMap tx, tdy, tw1, tw2;
  cudaError_t e;
  if ((e = map_matrix(&tx, x, r, d, BW, TILE_ROWS)) != cudaSuccess ||
      (e = map_matrix(&tdy, dy, r, d, BW, TILE_ROWS)) != cudaSuccess ||
      (e = map_matrix(&tw1, w1, f, d, BW, TILE_ROWS)) != cudaSuccess ||
      (e = map_matrix(&tw2, w2, d, f, FC, BW)) != cudaSuccess)
    return e;
  const int nbox = dp / BW, n_tiles = nbox / NB;
  const auto* bias = static_cast<const __nv_bfloat16*>(b1);
  // x and dy tiles, ring, STAGES + 1 mbarriers, slack to align the base to 1024.
  const size_t smem_dx = static_cast<size_t>(2 * nbox + 2 * STAGES) * BOX + 64 + 1024;
  auto kdx = dx_kernel<BW, NB>;
  if ((e = allow_smem(kdx, smem_dx)) != cudaSuccess) return e;
  kdx<<<dim3((r + TILE_ROWS - 1) / TILE_ROWS, n_tiles), THREADS, smem_dx, stream>>>(
      tx, tdy, tw1, tw2, bias, static_cast<__nv_bfloat16*>(dx), r, d, f, dp);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  // ... and db2's group sums, 2 * THREADS floats.
  const size_t smem_w =
      static_cast<size_t>(2 * nbox + 2 * STAGES) * BOX + 64 + 2 * THREADS * 4 + 1024;
  auto kw = wgt_kernel<BW, NB>;
  if ((e = allow_smem(kw, smem_w)) != cudaSuccess) return e;
  const int n_fc = (f + FC - 1) / FC, n_blocks = (r + TILE_ROWS - 1) / TILE_ROWS;
  const int seg_blocks = (n_blocks + n_seg - 1) / n_seg;
  const size_t ld = 2 * static_cast<size_t>(f) * d + f + d;
  kw<<<dim3(n_fc * n_tiles, n_seg), THREADS, smem_w, stream>>>(
      tx, tdy, tw1, tw2, bias, static_cast<float*>(part), ld, r, d, f, dp, n_fc, seg_blocks);
  return cudaGetLastError();
}

// x, dy, dx: (r, d); w1: (f, d); b1: (f); w2: (d, f); bf16, contiguous,
// 16-byte aligned; takes(d, f). part: fp32 n_seg * (2 f d + f + d), every
// element written (dW2 transposed, see wgt_kernel).
inline cudaError_t launch(const void* x, const void* dy, const void* w1, const void* b1,
                          const void* w2, void* dx, void* part, int r, int d, int f, int n_seg,
                          cudaStream_t s) {
  const int dp = padded(d);
  if (dp <= 16) return launch_bw<16, 1>(x, dy, w1, b1, w2, dx, part, r, d, f, dp, n_seg, s);
  if (dp <= 32) return launch_bw<32, 1>(x, dy, w1, b1, w2, dx, part, r, d, f, dp, n_seg, s);
  if (dp <= 64) return launch_bw<64, 1>(x, dy, w1, b1, w2, dx, part, r, d, f, dp, n_seg, s);
  return launch_bw<64, TILE_N / 64>(x, dy, w1, b1, w2, dx, part, r, d, f, dp, n_seg, s);
}

}  // namespace fused_mlp_bwd_tc
}  // namespace vtt
