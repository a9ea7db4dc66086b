// Fused transformer MLP backward (K7).
//
// Replaces: vit_tpu/ops/fused_mlp.py::_bwd_kernel (:83-121), launched by
// _pallas_bwd (:146). Same function: with the pre-activation recomputed,
// pre = x W1 + b1 (fp32), g = gelu(pre) and dh = (dy W2^T * gelu'(pre))
// both rounded to the input dtype,
//   dx = dh W1^T (cast to the input dtype),
//   dW1 = x^T dh, db1 = sum_rows dh, dW2 = g^T dy, db2 = sum_rows dy,
// the four weight gradients summed in fp32 and returned in fp32 (as the
// Pallas kernel's fp32 outputs, :170-175). Weights are in torch's
// nn.Linear layout: w1 (F, D), w2 (D, F), so dW1 is (F, D) and dW2 (D, F).
//
// What bounds it on the H100: 10*R*D*F operations (five R x D x F
// products, counting the recomputed pre-activation) and 2*R*F exps against
// x, dy, dx, the weights and the fp32 weight gradients: bound by operations.
//
// What the designs do about the TPU's sequential grid: the TPU carries
// dW1/db1/dW2/db2 in VMEM across row blocks; CTAs here run in parallel in
// no order, so the weight gradients are summed as per-segment fp32
// partials (each CTA owns a tile of the weight gradients and a fixed
// segment of rows) and reduced in a fixed order by a last pass: no float
// atomics, so a step is bit-repeatable. Three bodies, chosen by the caller
// (`body`) by a static rule on dtype and width, not on failure:
// * bf16 with D and F multiples of 16 and D <= 128 (the spectra configs)
//   runs fused_mlp_bwd_tc.cuh: every product as wgmma on the tensor cores,
//   g and dh kept in registers (no (R, F) tensor in device memory); a dx
//   pass, a weight-gradient pass, then the sum of partials.
// * bf16 with D and F multiples of 16 and 128 < D <= 1024 (ViT-S/16's D384,
//   ViT-B/16's D768, ViT-L/16's D1024) runs fused_mlp_wide_tc.cuh: g and dh
//   written once in bf16 to (R, F) scratch by one pass, then dx = dh W1 and
//   the four weight gradients as products over them, every product a wgmma
//   tile fed by TMA; the sum of partials only with more than one segment.
// * fp32 (tensor cores would mean TF32) and other bf16 widths run the FMA
//   kernels below, five launches per call:
//   1. act:      g and dh for a 64-row x 64-column tile of (R, F), written
//                to scratch in the input dtype (the one place this body
//                moves an (R, F) tensor through device memory);
//   2. dx:       dh W1^T, 64 x 64 output tiles;
//   3./4. dW1, dW2 partials, with the column sums db1 / db2 beside them;
//   5. reduce:   every partial, summed over the segments in order.
//   All products on the fp32 FMA units from shared memory; T and widths are
//   not padded, ragged tiles are masked here.
// A call counts as one launch of K7 whichever body runs.
#include "common.cuh"
#include "fused_mlp_bwd_tc.cuh"
#include "fused_mlp_wide_tc.cuh"

using namespace vtt;

namespace {

constexpr int BR = 64;  // rows of a tile
constexpr int BC = 64;  // columns of a tile
constexpr int KC = 32;  // depth of one shared-memory slice
constexpr int THREADS = 256;
constexpr int SP = BC + 1;  // padded smem row

// Pass 1: g = gelu(pre), dh = dy W2^T * gelu'(pre) for rows [r0, r0+64) and
// F columns [f0, f0+64), both rounded to T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
act_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ w1,
           const T* __restrict__ b1, const T* __restrict__ w2, T* __restrict__ g,
           T* __restrict__ dh, int r, int d, int f) {
  __shared__ float xs[BR][KC + 1], dys[BR][KC + 1], w1s[KC][SP], w2s[KC][SP];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * BR, f0 = blockIdx.y * BC;
  float pre[4][4] = {}, dg[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < BR * KC; i += THREADS) {
      const int rr = i / KC, kk = i % KC, row = r0 + rr, col = k0 + kk;
      const bool ok = row < r && col < d;
      const size_t at = static_cast<size_t>(row) * d + col;
      xs[rr][kk] = ok ? to_f<T>(x[at]) : 0.f;
      dys[rr][kk] = ok ? to_f<T>(dy[at]) : 0.f;
    }
    for (int i = tid; i < BC * KC; i += THREADS) {
      const int ff = i / KC, kk = i % KC;  // w1 (F, D): contiguous along D
      w1s[kk][ff] = (f0 + ff < f && k0 + kk < d)
                        ? to_f<T>(w1[static_cast<size_t>(f0 + ff) * d + k0 + kk]) : 0.f;
    }
    for (int i = tid; i < KC * BC; i += THREADS) {
      const int kk = i / BC, ff = i % BC;  // w2 (D, F): contiguous along F
      w2s[kk][ff] = (k0 + kk < d && f0 + ff < f)
                        ? to_f<T>(w2[static_cast<size_t>(k0 + kk) * f + f0 + ff]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float ax[4], ad[4], b1v[4], b2v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ax[i] = xs[ty + 16 * i][kk];
        ad[i] = dys[ty + 16 * i][kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b1v[j] = w1s[kk][tx + 16 * j];
        b2v[j] = w2s[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pre[i][j] = fmaf(ax[i], b1v[j], pre[i][j]);
          dg[i][j] = fmaf(ad[i], b2v[j], dg[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= r) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = f0 + tx + 16 * j;
      if (col >= f) continue;
      const float z = pre[i][j] + to_f<T>(b1[col]);
      const size_t at = static_cast<size_t>(row) * f + col;
      g[at] = from_f<T>(gelu_as(z));
      dh[at] = from_f<T>(dg[i][j] * dgelu_as(z));
    }
  }
}

// Pass 2: dx (R, D) = dh (R, F) W1 (F, D), 64 x 64 output tiles.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dx_kernel(const T* __restrict__ dh, const T* __restrict__ w1, T* __restrict__ dx, int r,
          int d, int f) {
  __shared__ float as[BR][KC + 1], bs[KC][SP];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * BR, c0 = blockIdx.y * BC;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < f; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < BR * KC; i += THREADS) {
      const int rr = i / KC, kk = i % KC, row = r0 + rr, col = k0 + kk;
      as[rr][kk] = (row < r && col < f) ? to_f<T>(dh[static_cast<size_t>(row) * f + col]) : 0.f;
    }
    for (int i = tid; i < KC * BC; i += THREADS) {
      const int kk = i / BC, cc = i % BC;
      bs[kk][cc] = (k0 + kk < f && c0 + cc < d)
                       ? to_f<T>(w1[static_cast<size_t>(k0 + kk) * d + c0 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= r) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < d) dx[static_cast<size_t>(row) * d + col] = from_f<T>(acc[i][j]);
    }
  }
}

// Passes 3/4: the partial of C (M, N) = A^T B over the rows of segment z,
// A (R, M), B (R, N); CTAs of the first column tile also write the partial
// column sums of A. part: [seg][M*N], colsum: [seg][M] (row stride `ld`).
template <typename T>
__global__ void __launch_bounds__(THREADS)
tn_partial_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ part,
                  float* __restrict__ colsum, size_t ld, int r, int m, int n, int seg_rows) {
  __shared__ float as[KC][SP], bs[KC][SP];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BC, n0 = blockIdx.y * BC, z = blockIdx.z;
  const int rs = z * seg_rows, re = min(r, rs + seg_rows);
  float acc[4][4] = {}, asum[4] = {};
  for (int k0 = rs; k0 < re; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < KC * BC; i += THREADS) {
      const int kk = i / BC, cc = i % BC, row = k0 + kk;
      as[kk][cc] = (row < re && m0 + cc < m) ? to_f<T>(a[static_cast<size_t>(row) * m + m0 + cc]) : 0.f;
      bs[kk][cc] = (row < re && n0 + cc < n) ? to_f<T>(b[static_cast<size_t>(row) * n + n0 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        asum[i] += av[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  float* out = part + static_cast<size_t>(z) * ld;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) out[static_cast<size_t>(row) * n + col] = acc[i][j];
    }
    if (blockIdx.y == 0 && tx == 0) colsum[static_cast<size_t>(z) * ld + row] = asum[i];
  }
}

// Pass 5: out[i] = sum over segments s = 0, 1, ... of part[s * ld + i].
// With w2_t (the tensor-core body) the dW2 block of the partials is dW2^T,
// (f, d), and is written to out as (d, f).
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                              size_t ld, int n_seg, int f, int d, int w2_t) {
  const size_t fd = static_cast<size_t>(f) * d, w2 = fd + f;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < ld;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < n_seg; ++z) s += part[static_cast<size_t>(z) * ld + i];
    size_t o = i;
    if (w2_t && i >= w2 && i < w2 + fd) o = w2 + ((i - w2) % d) * f + (i - w2) / d;
    out[o] = s;
  }
}

cudaError_t reduce(void* part, void* grads, int f, int d, int n_seg, int w2_t, cudaStream_t s) {
  const size_t ld = 2 * static_cast<size_t>(f) * d + f + d;
  const size_t want = (ld + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  reduce_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(part),
                                       static_cast<float*>(grads), ld, n_seg, f, d, w2_t);
  return cudaGetLastError();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
cudaError_t run(const void* x, const void* dy, const void* w1, const void* b1, const void* w2,
                void* dx, void* g, void* dh, void* part, void* grads, int r, int d, int f,
                int n_seg, cudaStream_t s) {
  const T *xt = static_cast<const T*>(x), *dyt = static_cast<const T*>(dy);
  const T *w1t = static_cast<const T*>(w1), *w2t = static_cast<const T*>(w2);
  T *gt = static_cast<T*>(g), *dht = static_cast<T*>(dh);
  act_kernel<T><<<dim3(cdiv(r, BR), cdiv(f, BC)), THREADS, 0, s>>>(
      xt, dyt, w1t, static_cast<const T*>(b1), w2t, gt, dht, r, d, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dx_kernel<T><<<dim3(cdiv(r, BR), cdiv(d, BC)), THREADS, 0, s>>>(dht, w1t, static_cast<T*>(dx),
                                                                  r, d, f);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // grads = [dW1 (F*D) | db1 (F) | dW2 (D*F) | db2 (D)]; part[seg] alike.
  const size_t ld = 2 * static_cast<size_t>(f) * d + f + d;
  float* p = static_cast<float*>(part);
  const int seg_rows = cdiv(cdiv(r, n_seg), KC) * KC;
  tn_partial_kernel<T><<<dim3(cdiv(f, BC), cdiv(d, BC), n_seg), THREADS, 0, s>>>(
      dht, xt, p, p + static_cast<size_t>(f) * d, ld, r, f, d, seg_rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t w2_off = static_cast<size_t>(f) * d + f;
  tn_partial_kernel<T><<<dim3(cdiv(d, BC), cdiv(f, BC), n_seg), THREADS, 0, s>>>(
      dyt, gt, p + w2_off, p + w2_off + static_cast<size_t>(d) * f, ld, r, d, f, seg_rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce(part, grads, f, d, n_seg, 0, s);
}

}  // namespace

// x, dy, dx: (r, d), w1 (f, d), b1 (f), w2 (d, f), in float32 (is_bf16 = 0)
// or bfloat16. body: BODY_TC takes fused_mlp_bwd_tc.cuh (bf16 and its
// takes(d, f), else cudaErrorInvalidValue; g and dh unused, may be null),
// BODY_WIDE fused_mlp_wide_tc.cuh (likewise; g and dh (r, f) bf16 scratch;
// part unused, may be null, when n_seg = 1), BODY_FMA the FMA body, with g
// and dh (r, f) scratch in the input dtype. bf16 inputs of the tensor-core
// bodies are 16-byte aligned for TMA. part: fp32 scratch of n_seg * (2*f*d
// + f + d); grads: fp32 (2*f*d + f + d), written as [dW1 (f, d) | db1 (f) |
// dW2 (d, f) | db2 (d)]. The rows split into n_seg segments (FMA: of whole
// 32-row slices; tensor cores: of whole 64-row blocks, none empty when
// n_seg = ceil(blocks / ceil(blocks / n_seg))).
// Returns the first non-zero cudaGetLastError() of the launches.
enum Body { BODY_FMA = 0, BODY_TC = 1, BODY_WIDE = 2 };

extern "C" int fused_mlp_bwd(const void* x, const void* dy, const void* w1, const void* b1,
                             const void* w2, void* dx, void* g, void* dh, void* part,
                             void* grads, int r, int d, int f, int n_seg, int is_bf16,
                             int body, void* stream) {
  if (r <= 0 || d <= 0 || f <= 0 || n_seg <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == BODY_TC) {
    if (!is_bf16 || !fused_mlp_bwd_tc::takes(d, f)) return cudaErrorInvalidValue;
    const cudaError_t e = fused_mlp_bwd_tc::launch(x, dy, w1, b1, w2, dx, part, r, d, f, n_seg, s);
    return e != cudaSuccess ? e : reduce(part, grads, f, d, n_seg, 1, s);
  }
  if (body == BODY_WIDE) {
    if (!is_bf16 || !fused_mlp_wide_tc::takes(d, f) || g == nullptr || dh == nullptr ||
        (n_seg > 1 && part == nullptr))
      return cudaErrorInvalidValue;
    const cudaError_t e = fused_mlp_wide_tc::launch_bwd(x, dy, w1, b1, w2, dx, g, dh,
                                                        n_seg > 1 ? part : grads, r, d, f,
                                                        n_seg, s);
    return e != cudaSuccess || n_seg == 1 ? e : reduce(part, grads, f, d, n_seg, 0, s);
  }
  if (body != BODY_FMA || g == nullptr || dh == nullptr) return cudaErrorInvalidValue;
  return is_bf16 ? run<__nv_bfloat16>(x, dy, w1, b1, w2, dx, g, dh, part, grads, r, d, f,
                                      n_seg, s)
                 : run<float>(x, dy, w1, b1, w2, dx, g, dh, part, grads, r, d, f, n_seg, s);
}
