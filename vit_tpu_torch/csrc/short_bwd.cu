// Short-sequence attention backward (K6), for T up to 512.
//
// Replaces: vit_tpu/ops/flash_attention.py::_short_bwd_kernel (:224-256),
// launched by _short_bwd (:308). Same function as K4 + K5 with one
// difference in rounding: dK = ds^T (Q*scale rounded to the input dtype)
// with no final scale (:255-256), where K5 scales ds^T Q at the end. dQ =
// scale * ds K and dV = (P * M/keep)^T dO as in K4/K5.
//
// What bounds it on the H100: 10*BH*T^2*d operations over BH*T*d*8
// elements moved; at the baseline training shape (B64 H2 T129 d16 fp32)
// about 2*T*10/8 = 320 operations per 4-byte element moved: past the fp32
// balance point, so operations, and at these sizes the launch. The TPU
// kernel holds a whole (heads, T, T) block in VMEM; here two passes, a dQ
// pass and a dK/dV pass (attn_bwd.cuh), each keep 64 x 64 tiles on chip.
// One entry call launches both and counts as one launch.
#include "attn_bwd.cuh"

using namespace vtt;

namespace {

constexpr int T_MAX = 512;

template <typename T, int D> struct ShortBwd {
  static cudaError_t run(const attn_bwd::Args& a, cudaStream_t s) {
    cudaError_t e = attn_bwd::launch_dq<T, D>(a, s);
    if (e != cudaSuccess) return e;
    return attn_bwd::launch_dkv<T, D, /*QS_IN_DK=*/true>(a, s);
  }
};

}  // namespace

// As flash_bwd_dq and flash_bwd_dkv together, for t <= 512: writes dq, dk
// and dv. Returns the first non-zero cudaGetLastError() of the two launches.
extern "C" int short_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, void* dk, void* dv,
                         int bh, int t, int d, float scale, int is_bf16, int dropout,
                         unsigned seed, unsigned threshold, float inv_keep, void* stream) {
  if (t > T_MAX) return cudaErrorInvalidValue;
  const attn_bwd::Args a{q, k, v, dout, lse, delta, dq, dk, dv, bh, t, scale,
                         Dropout{seed, threshold, inv_keep, dropout}};
  return attn_bwd::dispatch<ShortBwd>(a, d, is_bf16, static_cast<cudaStream_t>(stream));
}
