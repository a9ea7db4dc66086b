// The bf16 fused MLP forward (K3) on Hopper's tensor cores. It computes what
// vit_tpu/ops/fused_mlp.py::_fwd_kernel (:72) computes, launched there by
// _pallas_fwd (:124), with every cast in the same place:
//   pre = x W1^T + b1                 fp32 sums, b1 added to the sum;
//   h   = bf16(gelu_AS(pre))          the Abramowitz-Stegun erf, in fp32;
//   y   = bf16(h W2^T + b2)           fp32 sums, b2 added to the sum.
// x is (R, D), W1 (F, D) and W2 (D, F) in torch's nn.Linear layout; both
// weights are K-major as they lie (W1 for pre, W2 for y), so nothing is
// transposed. This is the route for D <= 128 (the spectra configs);
// fused_mlp_wide_tc.cuh takes 128 < D <= 1024, and fused_mlp_fwd.cu keeps
// the FMA kernel for fp32 (tensor cores in fp32 would be TF32) and for
// widths neither takes.
//
// What bounds it on the H100: 4 R D F operations on the tensor cores against
// x and y moved once. At the stride-1 shape (R = 65056, D = 128, F = 512)
// that is 17.05 GFLOP, 0.0172 ms at 989 TFLOP/s; x and y are 33 MB, 0.010
// ms at 3.35 TB/s. What the bound leaves out: the GELU of R F = 33 M
// elements on the CUDA cores, each a reciprocal, an exp and about 12 FMAs,
// which is the larger cost once the products run on the tensor cores.
//
// Design. A warpgroup (128 threads) owns 64 rows of x and all N columns of
// y (N, the padded D: one column tile, so nothing is recomputed; a wider D
// would need a tile per 128 columns, each recomputing pre, which is why it
// takes the wide route). A CTA holds two warpgroups that share the weight
// tiles,
// so each tile is read from L2 once per 128 rows, where that still leaves
// two CTAs per SM of the grid (and both x tiles fit); else one:
// * The x tiles (64 x D each) are loaded once by TMA and stay in shared
//   memory.
//   W1 and W2 are walked in F-chunks of 64 through a ring of STAGES slots on
//   mbarriers, in one stream of loads: for each chunk, W1's 64 rows in
//   pieces of N columns of D, then W2's N rows x the chunk's 64 columns.
//   Thread 0 refills a slot once every warp is done with it, STAGES loads
//   ahead. TMA zero-fills rows and columns past R, D and F, so a ragged
//   edge adds exact zeros to the sums and needs no mask in the products.
// * Per chunk: pre (m64n64, fp32) = x W1c^T as wgmma with both operands
//   K-major in shared memory; b1 and the GELU on the accumulator fragment;
//   h rounded to bf16 and packed in place as the A fragment of the next
//   product (hopper.cuh); y (m64nN, fp32) += h W2c^T as a register-A wgmma
//   with B K-major. The (R, F) intermediate never leaves the registers.
// * The GELU (hopper.cuh::gelu_tc) is kept short: the reciprocal and
//   exp(-z^2) each one special-function instruction, rcp.approx and
//   ex2.approx(-z^2 log2 e) (what __expf does). Each is within a few fp32
//   ulps of 1.0f / x and expf, which moves h only where pre sits on a bf16
//   rounding boundary (one bf16 ulp of h times |W2| in y, inside the bf16
//   tolerance). The correctly rounded reciprocal (__frcp_rn, the bits of
//   1.0f / x) is a
//   longer sequence and made the kernel measurably slower on the card, most
//   at D = 384. b1 is read once per chunk. Several CTAs share an SM, so one
//   CTA's GELU runs while another's wgmma is on the tensor cores.
// * Each y element is summed in one CTA's registers and written once: no
//   atomics, two calls give equal bits.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace vtt {
namespace fused_mlp_tc {

using namespace hopper;

constexpr int FC = 64;       // F chunk: the N of pre, the K of y += h W2c^T
constexpr int STAGES = 3;    // ring slots
constexpr int D_MAX = 128;   // one column tile: wider D takes fused_mlp_wide_tc.cuh

// Widths this path takes; the others take the wide route or keep the FMA
// kernel (a static rule, not a fallback: a refused launch here still fails).
inline bool takes(int d, int f) { return d % 16 == 0 && f % 16 == 0 && d <= D_MAX; }

// D padded to the tile's columns: 16, 32, or a multiple of 64.
inline int padded(int d) { return d <= 32 ? d : (d + 63) / 64 * 64; }

// Shared-memory geometry for a column tile of N (the padded D up to 128,
// else 128). x and W1 are cut into boxes of 64 rows x BOX_COLS columns; a
// ring slot holds one W1 piece (64 rows x N columns) or one W2 chunk (N rows
// x 64 columns), both N * 128 bytes.
template <int N> struct Geo {
  static constexpr int BOX_COLS = N < 64 ? N : 64;
  static constexpr int ROW_BYTES = BOX_COLS * 2;  // = the swizzle width
  static constexpr int SUB = TILE_ROWS * ROW_BYTES;
  static constexpr int SLOT = N * 128;
  static constexpr uint64_t LAYOUT = ROW_BYTES == 128 ? 1 : (ROW_BYTES == 64 ? 2 : 3);
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "column tile");
};

// K-major descriptor of k-step kk (16 columns) of a 64-row tile cut into
// boxes of BOX_COLS columns.
template <int N> __device__ __forceinline__ uint64_t desc_x(uint32_t tile, int kk) {
  using G = Geo<N>;
  const uint32_t addr = tile + (kk * 16 / G::BOX_COLS) * G::SUB + (kk * 16 % G::BOX_COLS) * 2;
  return make_desc(addr, 16, 8 * G::ROW_BYTES, G::LAYOUT);
}

// pre (+)= x[:, 16 k0 ...] W1-piece^T over K k-steps; waits for the result.
template <int N, int K>
__device__ __forceinline__ void pre_mma(float (&pre)[32], uint32_t x_tile, uint32_t w1, int k0,
                                        bool accumulate) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    wgmma_ss_n64(pre, desc_x<N>(x_tile, k0 + kk), desc_x<N>(w1, kk), accumulate || kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  hold(pre);
}

// WG warpgroups, each with its own 64 rows of x, share the weight ring.
template <int N, int WG>
__global__ void __launch_bounds__(WG * THREADS, 2)
fwd_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
           const __grid_constant__ CUtensorMap tw2, const __nv_bfloat16* __restrict__ b1,
           const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ y, int r, int d,
           int f, int dp) {
  using G = Geo<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t x_tiles = smem_u32(sm);  // warpgroup w's: x_tiles + w * 128 * dp
  const uint32_t slots = x_tiles + WG * TILE_ROWS * dp * 2;
  const uint32_t bar_x = slots + STAGES * G::SLOT, bar0 = bar_x + 8;  // slot s: bar0 + 8s

  const int tid = threadIdx.x, wg = tid / THREADS, warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int row0 = blockIdx.x * WG * TILE_ROWS, col0 = blockIdx.y * N;
  const uint32_t x_tile = x_tiles + wg * TILE_ROWS * dp * 2;
  const int n_chunks = (f + FC - 1) / FC;
  const int n_pieces = (dp + N - 1) / N;  // W1 pieces of a chunk
  const int per_chunk = n_pieces + 1;
  const int n_items = n_chunks * per_chunk;

  // Load item i of the stream into slot i % STAGES (thread 0 only).
  const CUtensorMap* m1 = &tw1;
  const CUtensorMap* m2 = &tw2;
  auto load_item = [&](int i) {
    const int ch = i / per_chunk, p = i - ch * per_chunk, s = i % STAGES;
    const uint32_t bar = bar0 + 8 * s, dst = slots + s * G::SLOT;
    if (p < n_pieces) {
      const int boxes = min(N, dp - p * N) / G::BOX_COLS;
      mbar_expect_tx(bar, boxes * G::SUB);
      for (int b = 0; b < boxes; ++b)
        tma_load_2d(dst + b * G::SUB, m1, bar, p * N + b * G::BOX_COLS, ch * FC);
    } else {
      mbar_expect_tx(bar, G::SLOT);
      tma_load_2d(dst, m2, bar, ch * FC, col0);
    }
  };

  if (tid == 0) {
    mbar_init(bar_x, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    fence_proxy_async();
  }
  __syncthreads();
  int loaded = min(STAGES, n_items);  // thread 0's count of items loaded or in flight
  if (tid == 0) {
    const int boxes = dp / G::BOX_COLS;
    mbar_expect_tx(bar_x, WG * boxes * G::SUB);
    for (int w = 0; w < WG; ++w)
      for (int b = 0; b < boxes; ++b)
        tma_load_2d(x_tiles + w * TILE_ROWS * dp * 2 + b * G::SUB, &tx, bar_x,
                    b * G::BOX_COLS, row0 + w * TILE_ROWS);
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

  float yacc[N / 2], pre[32];
  uint32_t h[16];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) yacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) pre[i] = 0.f;

  mbar_wait(bar_x, 0);
  int item = 0;
  for (int ch = 0; ch < n_chunks; ++ch) {
    for (int p = 0; p < n_pieces; ++p) {
      const int s = item % STAGES;
      mbar_wait(bar0 + 8 * s, (item / STAGES) & 1);
      const uint32_t w1 = slots + s * G::SLOT;
      if (N < 128 || dp - p * N >= N)
        pre_mma<N, N / 16>(pre, x_tile, w1, p * (N / 16), p > 0);
      else  // the last piece of a D that is an odd multiple of 64
        pre_mma<N, N / 32>(pre, x_tile, w1, p * (N / 16), p > 0);
      release(++item);
    }

    // Thread's accumulator element 4j + 2hh + e is row 16*warp + g + 8hh,
    // column f0 + 8j + 2c + e; h[2j + hh] packs that row's two columns.
    const int f0 = ch * FC;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = f0 + 8 * j + 2 * c;  // f is a multiple of 16: col < f covers col + 1
      const float2 bias = col < f ? __bfloat1622float2(
                                        *reinterpret_cast<const __nv_bfloat162*>(b1 + col))
                                  : make_float2(0.f, 0.f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        h[2 * j + hh] = pack_bf16(gelu_tc(pre[4 * j + 2 * hh] + bias.x),
                                  gelu_tc(pre[4 * j + 2 * hh + 1] + bias.y));
    }

    const int s = item % STAGES;
    mbar_wait(bar0 + 8 * s, (item / STAGES) & 1);
    const uint32_t w2 = slots + s * G::SLOT;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // W2c: N rows of 64 columns (128-byte rows), K-major
      WgmmaRS<N, 0>::mma(yacc, h + 4 * kk, make_desc(w2 + kk * 32, 16, 1024, 1));
    wgmma_commit();
    wgmma_wait_all();
    hold(yacc);
    hold(h);
    release(++item);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + wg * TILE_ROWS + 16 * warp + g + 8 * hh;
    if (row >= r) continue;
    __nv_bfloat16* out = y + static_cast<size_t>(row) * d;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = col0 + 8 * j + 2 * c;
      if (col >= d) continue;
      const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + col));
      *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
          yacc[4 * j + 2 * hh] + bias.x, yacc[4 * j + 2 * hh + 1] + bias.y);
    }
  }
}

// ---- host side ---------------------------------------------------------

template <int N, int WG>
cudaError_t launch_n(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* y, int r, int d, int f, int dp, cudaStream_t stream) {
  using G = Geo<N>;
  CUtensorMap tx, tw1, tw2;
  cudaError_t e;
  if ((e = map_matrix(&tx, x, r, d, G::BOX_COLS, TILE_ROWS)) != cudaSuccess ||
      (e = map_matrix(&tw1, w1, f, d, G::BOX_COLS, TILE_ROWS)) != cudaSuccess ||
      (e = map_matrix(&tw2, w2, d, f, FC, N)) != cudaSuccess)
    return e;
  // x tiles, ring, STAGES + 1 mbarriers, slack to align the base to 1024.
  const size_t smem =
      static_cast<size_t>(WG) * TILE_ROWS * dp * 2 + STAGES * G::SLOT + 64 + 1024;
  auto kernel = fwd_kernel<N, WG>;
  if ((e = allow_smem(kernel, smem)) != cudaSuccess) return e;
  const dim3 grid((r + WG * TILE_ROWS - 1) / (WG * TILE_ROWS), (d + N - 1) / N);
  kernel<<<grid, WG * THREADS, smem, stream>>>(
      tx, tw1, tw2, static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(b2),
      static_cast<__nv_bfloat16*>(y), r, d, f, dp);
  return cudaGetLastError();
}

// x, y: (r, d); w1: (f, d); b1: (f); w2: (d, f); b2: (d); bf16, contiguous,
// 16-byte aligned; takes(d, f).
template <int WG>
cudaError_t launch_wg(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* y, int r, int d, int f, cudaStream_t s) {
  const int dp = padded(d);
  if (dp <= 16) return launch_n<16, WG>(x, w1, b1, w2, b2, y, r, d, f, dp, s);
  if (dp <= 32) return launch_n<32, WG>(x, w1, b1, w2, b2, y, r, d, f, dp, s);
  if (dp <= 64) return launch_n<64, WG>(x, w1, b1, w2, b2, y, r, d, f, dp, s);
  return launch_n<128, WG>(x, w1, b1, w2, b2, y, r, d, f, dp, s);
}

// Two warpgroups a CTA read each weight tile once for 128 rows, where that
// still leaves CTAS_2WG CTAs or more; otherwise one, for more CTAs.
constexpr int CTAS_2WG = 2 * 132;

inline cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                          const void* b2, void* y, int r, int d, int f, cudaStream_t s) {
  if ((r + 127) / 128 >= CTAS_2WG) return launch_wg<2>(x, w1, b1, w2, b2, y, r, d, f, s);
  return launch_wg<1>(x, w1, b1, w2, b2, y, r, d, f, s);
}

}  // namespace fused_mlp_tc
}  // namespace vtt
