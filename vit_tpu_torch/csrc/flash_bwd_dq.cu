// Flash-attention backward, dQ pass (K4).
//
// Replaces: vit_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (:459-493),
// launched by _flash_bwd (:556). Same function: for each query row,
// dQ = scale * sum_k ds K with P = exp(S - lse), dP = dO V^T times the
// dropout keep factor, ds = P (dP - delta) rounded to K's dtype; the sum is
// fp32 and the result is cast to the input dtype. The math and the tiling
// are in attn_bwd.cuh.
//
// What bounds it on the H100: 6*BH*T^2*d operations (three T x T x d
// products) and BH*T^2 exps against q, k, v, dO, dQ and two fp32 rows moved:
// bound by operations (at the stride-1 shape, BH=32, T=4066, d=64: 203
// GFLOP). This simple design runs them on the fp32 FMA units from shared
// memory, far above the tensor-core bound; the T x T tiles stay on chip.
#include "attn_bwd.cuh"

using namespace vtt;

namespace {

template <typename T, int D> struct DQ {
  static cudaError_t run(const attn_bwd::Args& a, cudaStream_t s) {
    return attn_bwd::launch_dq<T, D>(a, s);
  }
};

}  // namespace

// q, k, v, dout, dq: (bh, t, d) contiguous in float32 (is_bf16 = 0) or
// bfloat16; lse, delta: (bh, t) float32. `scale` is d^-1/2 in fp32 (the
// kernel rounds it to the input dtype where Q is scaled). Dropout arguments
// as for flash_fwd. Returns cudaGetLastError() after the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int t, int d,
                            float scale, int is_bf16, int dropout, unsigned seed,
                            unsigned threshold, float inv_keep, void* stream) {
  const attn_bwd::Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, t, scale,
                         Dropout{seed, threshold, inv_keep, dropout}};
  return attn_bwd::dispatch<DQ>(a, d, is_bf16, static_cast<cudaStream_t>(stream));
}
