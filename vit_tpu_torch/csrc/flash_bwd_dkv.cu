// Flash-attention backward, dK/dV pass (K5).
//
// Replaces: vit_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel
// (:496-540), launched by _flash_bwd (:579). Same function: for each key,
// dV = sum_q (P * M/keep)^T dO with the masked P rounded to dO's dtype, and
// dK = scale * sum_q ds^T Q with ds rounded to Q's dtype and Q as it is
// (the scale is applied once at the end, :534-539); both sums fp32, cast to
// the input dtype. The math and the tiling are in attn_bwd.cuh.
//
// What bounds it on the H100: 8*BH*T^2*d operations (four T x T x d
// products) and BH*T^2 exps: bound by operations (271 GFLOP at the stride-1
// shape). One CTA per (bh, 64 keys) keeps its dK and dV accumulators in
// registers over every query tile and writes them once; fp32 FMA units.
#include "attn_bwd.cuh"

using namespace vtt;

namespace {

template <typename T, int D> struct DKV {
  static cudaError_t run(const attn_bwd::Args& a, cudaStream_t s) {
    return attn_bwd::launch_dkv<T, D, /*QS_IN_DK=*/false>(a, s);
  }
};

}  // namespace

// q, k, v, dout, dk, dv: (bh, t, d) contiguous in float32 (is_bf16 = 0) or
// bfloat16; lse, delta: (bh, t) float32; `scale` d^-1/2 in fp32. Dropout
// arguments as for flash_fwd. Returns cudaGetLastError() after the launch.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int t, int d, float scale, int is_bf16, int dropout,
                             unsigned seed, unsigned threshold, float inv_keep, void* stream) {
  const attn_bwd::Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, t, scale,
                         Dropout{seed, threshold, inv_keep, dropout}};
  return attn_bwd::dispatch<DKV>(a, d, is_bf16, static_cast<cudaStream_t>(stream));
}
