// Fused transformer MLP forward (K3): y = gelu(x W1 + b1) W2 + b2.
//
// Replaces: vit_tpu/ops/fused_mlp.py::_fwd_kernel (:72-80), launched by
// _pallas_fwd (:124). Same function: pre = x W1 + b1 in fp32, the
// Abramowitz-Stegun erf GELU in fp32 (vit_tpu's _erf_f32, not erff), h cast
// to the input dtype, y = h W2 + b2 accumulated in fp32 and cast.
//
// What bounds it on the H100: 4*R*D*F FLOPs against R*D elements in and out
// plus the weights, about F/1.5 FLOPs per element moved (340 at the
// stride-1 shape, D=128, F=512): bound by operations, just past the bf16
// tensor-core balance point, and far past the fp32 one.
//
// Three bodies, chosen by a static rule on dtype and width (not a fallback:
// a refused launch raises either way):
// * bf16 with D and F multiples of 16 and D <= 128 (the spectra configs)
//   runs fused_mlp_tc.cuh: both products as wgmma on the tensor cores from
//   TMA-loaded tiles, the GELU on the accumulator fragment, h handed to the
//   second product in registers.
// * bf16 with D and F multiples of 16 and 128 < D <= 1024 (the image
//   family: ViT-S/16, ViT-B/16, ViT-L/16) runs fused_mlp_wide_tc.cuh: h =
//   bf16(gelu(x W1^T + b1)) once per element into the (R, F) scratch `h`,
//   then y = h W2^T + b2, both as wgmma tiles fed by TMA.
// * fp32 (tensor cores would mean TF32) and any other bf16 width run the
//   FMA kernel below. The (R, F) intermediate never reaches device memory.
//   One CTA of 256 threads per (64-row block, output column tile of up to
//   128) loops over F in chunks of 64: it computes the chunk's
//   pre-activation from x and W1 staged through shared memory in 32-wide
//   slices of D, applies the GELU, stages h in shared memory, and adds h
//   times the chunk's W2 columns into fp32 registers. The weights are read
//   in torch's nn.Linear layout, (out, in), so the model passes its
//   parameters as they are; each tile is loaded along the contiguous `in`
//   axis and transposed on its way into (padded) shared memory. Nothing
//   stays resident across F or D, so the kernel runs at every width (the
//   TPU kernel's VMEM limit does not carry over); for D > 128 each column
//   tile recomputes h.
#include "common.cuh"
#include "fused_mlp_tc.cuh"
#include "fused_mlp_wide_tc.cuh"

using namespace vtt;

namespace {

constexpr int BR = 64;  // rows per CTA
constexpr int FC = 64;  // F chunk
constexpr int KC = 32;  // D slice of the first product
constexpr int THREADS = 256;

template <int NC> constexpr size_t smem_floats() {
  return BR * (KC + 1) + KC * (FC + 1) + BR * (FC + 1) + FC * (16 * NC + 1);
}

template <typename T, int NC>  // NC output columns per thread: a column tile of 16*NC
__global__ void __launch_bounds__(THREADS)
fused_mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ b2, T* __restrict__ y, int r, int d, int f) {
  constexpr int DC = 16 * NC;
  extern __shared__ float smem[];
  float* xs = smem;                // BR x (KC+1)
  float* w1s = xs + BR * (KC + 1);      // KC x (FC+1)
  float* hs = w1s + KC * (FC + 1);      // BR x (FC+1), h rounded to T
  float* w2s = hs + BR * (FC + 1);      // FC x (DC+1)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * BR;
  const int col0 = blockIdx.y * DC;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int f0 = 0; f0 < f; f0 += FC) {
    float pre[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pre[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += KC) {
      __syncthreads();  // previous slice (and previous chunk's hs/w2s) consumed
      for (int i = tid; i < BR * KC; i += THREADS) {
        const int rr = i / KC, cc = i % KC, row = row0 + rr, col = k0 + cc;
        xs[rr * (KC + 1) + cc] =
            (row < r && col < d) ? to_f<T>(x[static_cast<size_t>(row) * d + col]) : 0.f;
      }
      for (int i = tid; i < KC * FC; i += THREADS) {
        const int ff = i / KC, kk = i % KC;
        w1s[kk * (FC + 1) + ff] = (k0 + kk < d && f0 + ff < f)
                     ? to_f<T>(w1[static_cast<size_t>(f0 + ff) * d + k0 + kk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[(ty + 16 * i) * (KC + 1) + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = w1s[kk * (FC + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) pre[i][j] = fmaf(a[i], b[j], pre[i][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int fc = f0 + tx + 16 * j;
      const float bias = fc < f ? to_f<T>(b1[fc]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hs[(ty + 16 * i) * (FC + 1) + tx + 16 * j] =
            fc < f ? round_to<T>(gelu_as(pre[i][j] + bias)) : 0.f;
    }
    for (int i = tid; i < FC * DC; i += THREADS) {
      const int cc = i / FC, ff = i % FC;
      w2s[ff * (DC + 1) + cc] = (f0 + ff < f && col0 + cc < d)
                   ? to_f<T>(w2[static_cast<size_t>(col0 + cc) * f + f0 + ff]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < FC; ++j) {
      float b[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) b[c] = w2s[j * (DC + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float h = hs[(ty + 16 * i) * (FC + 1) + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(h, b[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= r) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = col0 + tx + 16 * c;
      if (col < d)
        y[static_cast<size_t>(row) * d + col] = from_f<T>(acc[i][c] + to_f<T>(b2[col]));
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* y, int r, int d, int f, cudaStream_t stream) {
  const size_t smem = smem_floats<NC>() * sizeof(float);
  auto kernel = fused_mlp_fwd_kernel<T, NC>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((r + BR - 1) / BR, (d + 16 * NC - 1) / (16 * NC));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(y), r, d, f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_w(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* y, int r, int d, int f, cudaStream_t s) {
  if (d <= 32) return launch<T, 2>(x, w1, b1, w2, b2, y, r, d, f, s);
  if (d <= 64) return launch<T, 4>(x, w1, b1, w2, b2, y, r, d, f, s);
  return launch<T, 8>(x, w1, b1, w2, b2, y, r, d, f, s);
}

}  // namespace

// x, y: (r, d); w1: (f, d); b1: (f); w2: (d, f); b2: (d); all contiguous in
// float32 (is_bf16 = 0) or bfloat16, and in bfloat16 16-byte aligned (TMA).
// h: (r, f) bf16 scratch, read only on the wide route (null elsewhere).
// Returns cudaGetLastError() after the launches.
extern "C" int fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* y, void* h, int r, int d, int f,
                             int is_bf16, void* stream) {
  if (r <= 0 || d <= 0 || f <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && fused_mlp_tc::takes(d, f))
    return fused_mlp_tc::launch(x, w1, b1, w2, b2, y, r, d, f, s);
  if (is_bf16 && fused_mlp_wide_tc::takes(d, f)) {
    if (h == nullptr) return cudaErrorInvalidValue;
    return fused_mlp_wide_tc::launch_fwd(x, w1, b1, w2, b2, y, h, r, d, f, s);
  }
  return is_bf16 ? launch_w<__nv_bfloat16>(x, w1, b1, w2, b2, y, r, d, f, s)
                 : launch_w<float>(x, w1, b1, w2, b2, y, r, d, f, s);
}
