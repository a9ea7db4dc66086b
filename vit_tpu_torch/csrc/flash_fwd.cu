// Streaming flash-attention forward (K1).
//
// Replaces: vit_tpu/ops/flash_attention.py::_flash_fwd_kernel (:359-404),
// launched by _flash_fwd (:407). Same function: O = softmax(Q K^T d^-1/2) V
// with the scale folded into Q in the input dtype, keys at or past T masked
// to -1e30, an online softmax whose m, l and accumulator are fp32, P cast to
// the input dtype before P.V, l clamped at 1e-30, and lse = m + log(l) per
// row. With dropout (rate > 0) P is multiplied by the keep mask of the
// global (seed, bh, row, col) after l has summed the UNMASKED P, and the
// product P*M/keep is what is rounded to the input dtype before P.V
// (:389-396).
//
// What bounds it on the H100: 4*BH*T^2*d multiply-adds and BH*T^2 exps
// against only 4*BH*T*d elements moved, so it is bound by operations, not
// bytes (at the stride-1 serving shape, BH=32, T=4066, d=64: 135 GFLOP).
//
// What the design does about it: the 64x64 score tile, the softmax
// statistics and the output accumulator of a 64-row query tile never leave
// the SM, so device memory sees Q, K, V, O and lse once per query tile and
// no T x T tensor. bf16 runs attn_fwd_tc.cuh: both products as wgmma on the
// tensor cores (bf16 operands, fp32 sums) from TMA-loaded, double-buffered
// 64-key tiles, the exps and the hash on the CUDA cores between them. fp32
// runs the body below on the FMA units (tensor cores would mean TF32): one
// CTA of 256 threads per (bh, 64-row query tile), K and V through shared
// memory in 64-key tiles, each thread a 4x4 score block and a 4 x d/16
// output block. T and d are not padded: the ragged key tile and query tile
// are masked here.
#include <type_traits>

#include "attn_fwd_tc.cuh"
#include "common.cuh"

using namespace vtt;

namespace {

constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // keys per shared-memory tile
constexpr int THREADS = 256;

template <int D> constexpr size_t smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int t, int n_qt, float scale,
                 Dropout dr) {
  constexpr int DP = D + 1;   // padded rows: column reads hit distinct banks
  constexpr int PP = BK + 1;
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;           // BQ x DP, Q * scale rounded to T
  float* ks = qs + BQ * DP;   // BK x DP
  float* vs = ks + BK * DP;   // BK x D
  float* ps = vs + BK * D;    // BQ x PP, P rounded to T

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BQ;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const unsigned head = head_term(dr, bh);

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, row = q0 + r;
    const float x = row < t ? to_f<T>(q[base + static_cast<size_t>(row) * D + c]) : 0.f;
    qs[r * DP + c] = round_to<T>(x * scale);
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += BK) {
    __syncthreads();  // Q is staged; the previous tile's ps/vs reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, row = k0 + r;
      const size_t g = base + static_cast<size_t>(row) * D + c;
      ks[r * DP + c] = row < t ? to_f<T>(k[g]) : 0.f;
      vs[r * D + c] = row < t ? to_f<T>(v[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * DP + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tx + 16 * j >= t)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = NEG_INF;

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = max16(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] - m_new);
        rs += p;  // the denominator sums the unrounded, unmasked probabilities
        if (dr.on) p *= keep_factor(dr, head, q0 + ty + 16 * i, k0 + tx + 16 * j);
        ps[(ty + 16 * i) * PP + tx + 16 * j] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float b[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) b[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * PP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, b[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    T* orow = o + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / lf);
    if (tx == 0) lse[static_cast<size_t>(bh) * t + row] = m[i] + logf(lf);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int t, float scale, Dropout dr, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return attn_fwd_tc::launch<D>(attn_fwd_tc::flash_kernel<D>,
                                  {q, k, v, o, lse, bh, t, scale, dr}, stream);
  } else {
    const size_t smem = smem_floats<D>() * sizeof(float);
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const int n_qt = (t + BQ - 1) / BQ;
    kernel<<<n_qt * bh, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), t, n_qt, scale, dr);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                     int t, int d, float scale, Dropout dr, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, t, scale, dr, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, t, scale, dr, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, t, scale, dr, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, t, scale, dr, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (bh, t, d) contiguous in float32 (is_bf16 = 0) or bfloat16;
// lse: (bh, t) float32. `scale` is d^-1/2 already rounded to the input dtype.
// Dropout: `dropout` = rate > 0, `seed` a device pointer to the int32 seeds
// (read by the kernel, as the Pallas kernel reads its seed operand from
// SMEM, so a captured CUDA graph replays with the seeds its buffer holds;
// unread when `dropout` is 0), one for every `bh_per_seed` heads (common.cuh
// Dropout; bh_per_seed = bh for one seed), `bh_offset` the launch's first
// global head (0 unless a data-parallel rank), `threshold` and `inv_keep` from the host
// (keep iff hash < threshold).
// Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bh, int t, int d, float scale, int is_bf16, int dropout,
                         const void* seed, int bh_per_seed, int bh_offset,
                         unsigned threshold, float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{static_cast<const int*>(seed), bh_per_seed, threshold, inv_keep,
                   dropout, bh_offset};
  return is_bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, lse, bh, t, d, scale, dr, s)
                 : launch_d<float>(q, k, v, o, lse, bh, t, d, scale, dr, s);
}
