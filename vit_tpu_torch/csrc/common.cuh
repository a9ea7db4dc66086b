// Shared helpers of the port's kernels: dtype conversion, rounding to the
// input dtype, and reductions over the 16 lanes of a half-warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vtt {

constexpr float NEG_INF = -1e30f;  // masked scores, as in the Pallas kernels

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision and kept as float: the `.astype(dtype)` casts
// of the Pallas kernels (q*scale, P before P.V, the GELU output).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Max and sum over the 16 lanes that share (lane >> 4): one row of a tile.
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Attention dropout, vit_tpu/ops/flash_attention.py::_hash_bits (:115): a
// murmur3-finalised hash of the GLOBAL (seed, bh, row, col), so every
// kernel and every tiling draws the same mask. The seeds lie in device
// memory (the Pallas kernels' SMEM seed operand): each CTA reads its one
// seed once, so a captured launch draws whatever seed its buffer holds at
// replay. Heads come in groups of `bh_per_seed` with a seed each: a launch
// over R stacked replicas of B*H heads passes R seeds and bh_per_seed = B*H,
// and head bh hashes (seed[bh / bh_per_seed], bh % bh_per_seed), what each
// replica draws alone (vit_tpu's kernel under jax.vmap). One seed for the
// whole launch is bh_per_seed = B*H: seed[0] and the global bh. A data-
// parallel rank's launch covers heads [bh_offset, bh_offset + B_local*H) of
// the global batch: head bh hashes bh % bh_per_seed + bh_offset, its global
// index, so the rank draws its rows of the one-device mask. The
// host computes the keep threshold and 1/keep (vit_tpu_torch/ops/dropout.py::
// keep_params), which depend on the rate only, and passes them in; an element
// is kept when its bits are below the threshold.
struct Dropout {
  const int* seed;     // device pointer to the int32 seeds; unread when off
  int bh_per_seed;     // heads that share one seed (> 0 when on)
  unsigned threshold;  // keep iff bits < threshold
  float inv_keep;      // 1 / (1 - rate)
  int on;              // rate > 0
  int bh_offset;       // the launch's first global head (a rank's batch offset times H)
};

__device__ __forceinline__ unsigned fmix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// seed*H_SEED + bh*H_BH, the part of the hash that is fixed for one head:
// the head's own seed and its index within that seed's group.
__device__ __forceinline__ unsigned head_term(const Dropout& dr, int bh) {
  if (!dr.on) return static_cast<unsigned>(bh) * 0xC2B2AE35u;
  const int group = bh / dr.bh_per_seed;
  const unsigned seed = static_cast<unsigned>(__ldg(dr.seed + group));
  return seed * 0x27D4EB2Fu +
         static_cast<unsigned>(bh - group * dr.bh_per_seed + dr.bh_offset) * 0xC2B2AE35u;
}

// The keep factor (0 or 1/keep) of element (row, col) of one head.
__device__ __forceinline__ float keep_factor(const Dropout& dr, unsigned head, int row,
                                             int col) {
  const unsigned x = (static_cast<unsigned>(row) * 0x9E3779B1u) ^
                     (static_cast<unsigned>(col) * 0x85EBCA6Bu);
  return fmix32(x + head) < dr.threshold ? dr.inv_keep : 0.f;
}

// Abramowitz & Stegun 7.1.26 erf (max abs err 1.5e-7), as vit_tpu's
// _erf_f32 (vit_tpu/ops/fused_mlp.py:46), and the exact GELU and its
// derivative built on it (_gelu_f32, _dgelu_f32), all in fp32.
__device__ __forceinline__ float erf_as(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + p * ax);
  const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return sign * (1.0f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu_as(float x) {
  return 0.5f * x * (1.0f + erf_as(x * 0.7071067811865476f));
}

__device__ __forceinline__ float dgelu_as(float x) {
  const float cdf = 0.5f * (1.0f + erf_as(x * 0.7071067811865476f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * x * x);
  return cdf + x * pdf;
}

// Raise the dynamic shared-memory cap of `kernel` to `bytes` (needed above 48 KB).
template <typename K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace vtt
