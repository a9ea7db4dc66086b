// Short-sequence attention forward (K2), for T up to 512.
//
// Replaces: vit_tpu/ops/flash_attention.py::_short_fwd_kernel (:203-221),
// launched by _short_fwd (:259). Same function as the streaming kernel, by
// an exact two-pass softmax with no rescaling: S = (Q*scale) K^T in fp32,
// keys at or past T masked to -1e30, m = max, P = exp(S - m), l = sum P,
// lse = m + log(l), O = (P cast to the input dtype) V / l. With dropout
// (rate > 0) P is multiplied by the keep mask of the global (seed, bh, row,
// col) after l has summed the unmasked P (:213-219), before the cast.
//
// What bounds it on the H100: at the baseline serving shape (T=129, d=16,
// fp32) the 4*BH*T^2*d multiply-adds are few per byte of Q, K, V and O
// (about 2*T/3 = 86 FLOP per 4-byte element): under the H100's balance
// point even for fp32 CUDA-core math, so bytes and the launch bound it.
//
// What the design does about it: the T x T tensor never reaches device
// memory. bf16 runs attn_fwd_tc.cuh: one warpgroup per (bh, 64 query rows)
// walks the <= 8 key tiles twice (row max, then P and P~ V), the products
// as wgmma on the tensor cores from TMA-loaded tiles. fp32 runs the body
// below on the FMA units (tensor cores would mean TF32): one CTA per
// (bh, 32-row query tile) holds the whole 32 x T score block in shared
// memory (T <= 512) and reads K and V in 64-key tiles, once per query
// tile; the softmax is exact, two passes over the block in shared memory.
// T and d are not padded, the ragged edges are masked here.
#include <type_traits>

#include "attn_fwd_tc.cuh"
#include "common.cuh"

using namespace vtt;

namespace {

constexpr int BQ = 32;  // query rows per CTA
constexpr int BK = 64;  // keys per shared-memory tile
constexpr int THREADS = 256;
constexpr int T_MAX = 512;

template <int D> size_t smem_floats(int t) {
  const int tp = (t + BK - 1) / BK * BK;
  return BQ * (D + 1) + BK * (D + 1) + BQ * (tp + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
short_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int t, int n_qt, float scale,
                 Dropout dr) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  const int tp = (t + BK - 1) / BK * BK;  // score columns held
  const int SP = tp + 1;
  extern __shared__ float smem[];
  float* qs = smem;          // BQ x DP, Q * scale rounded to T
  float* kv = qs + BQ * DP;  // BK x DP, a K tile in pass 1, a V tile in pass 2
  float* ss = kv + BK * DP;  // BQ x SP, scores, then P rounded to T

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

  // Pass 1: the whole score block.
  for (int k0 = 0; k0 < t; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, row = k0 + r;
      kv[r * DP + c] = row < t ? to_f<T>(k[base + static_cast<size_t>(row) * D + c]) : 0.f;
    }
    __syncthreads();
    float s[2][4] = {};
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float a0 = qs[ty * DP + kk], a1 = qs[(ty + 16) * DP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = kv[(tx + 16 * j) * DP + kk];
        s[0][j] = fmaf(a0, b, s[0][j]);
        s[1][j] = fmaf(a1, b, s[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ss[(ty + 16 * i) * SP + col] = col < t ? s[i][j] : NEG_INF;
      }
  }
  __syncthreads();

  // Softmax over each row; the 16 lanes of a half-warp share one row.
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* row = ss + (ty + 16 * i) * SP;
    float mx = NEG_INF;
    for (int c = tx; c < tp; c += 16) mx = fmaxf(mx, row[c]);
    mx = max16(mx);
    float sum = 0.f;
    for (int c = tx; c < tp; c += 16) {
      float p = expf(row[c] - mx);
      sum += p;  // the denominator sums the unrounded, unmasked probabilities
      if (dr.on) p *= keep_factor(dr, head, q0 + ty + 16 * i, c);
      row[c] = round_to<T>(p);
    }
    m[i] = mx;
    l[i] = sum16(sum);
  }

  // Pass 2: O = P V, V in 64-key tiles.
  float acc[2][NC] = {};
  for (int k0 = 0; k0 < t; k0 += BK) {
    __syncthreads();  // P is written; the previous V tile is consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, row = k0 + r;
      kv[r * DP + c] = row < t ? to_f<T>(v[base + static_cast<size_t>(row) * D + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float b[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) b[c] = kv[j * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p = ss[(ty + 16 * i) * SP + k0 + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, b[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    T* orow = o + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / l[i]);
    if (tx == 0) lse[static_cast<size_t>(bh) * t + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int t, float scale, Dropout dr, cudaStream_t stream) {
  if (t > T_MAX) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return attn_fwd_tc::launch<D>(attn_fwd_tc::short_kernel<D>,
                                  {q, k, v, o, lse, bh, t, scale, dr}, stream);
  } else {
    const size_t smem = smem_floats<D>(t) * sizeof(float);
    auto kernel = short_fwd_kernel<T, D>;
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

// q, k, v, o: (bh, t, d) contiguous, t <= 512, in float32 (is_bf16 = 0) or
// bfloat16; lse: (bh, t) float32. `scale` is d^-1/2 rounded to the input
// dtype. Dropout arguments as for flash_fwd. Returns cudaGetLastError()
// after the launch.
extern "C" int short_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bh, int t, int d, float scale, int is_bf16, int dropout,
                         const void* seed, int bh_per_seed, int bh_offset,
                         unsigned threshold, float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{static_cast<const int*>(seed), bh_per_seed, threshold, inv_keep,
                   dropout, bh_offset};
  return is_bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, lse, bh, t, d, scale, dr, s)
                 : launch_d<float>(q, k, v, o, lse, bh, t, d, scale, dr, s);
}
