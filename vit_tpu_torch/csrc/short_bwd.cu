// Short-sequence attention backward (K6), for T up to 512.
//
// Replaces: vit_tpu/ops/flash_attention.py::_short_bwd_kernel (:224-256),
// launched by _short_bwd (:308). Same function as K4 + K5 with one
// difference in rounding: dK = ds^T (Q*scale rounded to the input dtype)
// with no final scale (:255-256), where K5 scales ds^T Q at the end. dQ =
// scale * ds K and dV = (P * M/keep)^T dO as in K4/K5.
//
// What bounds it on the H100: 10*BH*T^2*d operations (five T x T x d
// products, S and dP counted in both passes make seven) against
// BH*T*d*7 elements moved. In bf16 at B16 H12 T197 d64 that is 0.0048 ms
// of products at 989 TFLOP/s against 0.0102 ms of bytes at 3.35 TB/s:
// bound by bytes; in fp32 at the baseline training shape (B64 H2 T129 d16)
// by operations on the FMA units, and at these sizes by the launch.
// Design. The TPU kernel holds a whole (heads, T, T) block in VMEM; here
// two passes, a dQ pass and a dK/dV pass, each keep 64 x 64 tiles on chip:
// * bf16 runs the tensor-core passes of attn_bwd_tc.cuh, a dQ pass and a
//   dK/dV pass; the latter sums dK from the scaled, rounded copy of each Q
//   tile that it already makes for S (d = 32, 128) and drops the final
//   scale; at d = 16, 64 the scale is a power of two and scale * dS^T Q has
//   the same bits.
// * fp32 runs attn_bwd.cuh's FMA passes with QS_IN_DK (tensor cores would
//   mean TF32).
// One entry call launches both passes and counts as one launch.
#include <type_traits>

#include "attn_bwd.cuh"
#include "attn_bwd_tc.cuh"

using namespace vtt;

namespace {

constexpr int T_MAX = 512;

template <typename T, int D> struct ShortBwd {
  static cudaError_t run(const attn_bwd::Args& a, cudaStream_t s) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      cudaError_t e = attn_bwd_tc::launch_dq<D>(a, s);
      if (e != cudaSuccess) return e;
      return attn_bwd_tc::launch_dkv<D>(a, s);
    } else {
      cudaError_t e = attn_bwd::launch_dq<T, D>(a, s);
      if (e != cudaSuccess) return e;
      return attn_bwd::launch_dkv<T, D, /*QS_IN_DK=*/true>(a, s);
    }
  }
};

}  // namespace

// As flash_bwd_dq and flash_bwd_dkv together, for t <= 512: writes dq, dk
// and dv. Returns the first non-zero cudaGetLastError() of the two launches.
extern "C" int short_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, void* dk, void* dv,
                         int bh, int t, int d, float scale, int is_bf16, int dropout,
                         const void* seed, int bh_per_seed, int bh_offset,
                         unsigned threshold, float inv_keep, void* stream) {
  if (t > T_MAX) return cudaErrorInvalidValue;
  const attn_bwd::Args a{q, k, v, dout, lse, delta, dq, dk, dv, bh, t, scale,
                         Dropout{static_cast<const int*>(seed), bh_per_seed, threshold, inv_keep,
                                 dropout, bh_offset}};
  return attn_bwd::dispatch<ShortBwd>(a, d, is_bf16, static_cast<cudaStream_t>(stream));
}
