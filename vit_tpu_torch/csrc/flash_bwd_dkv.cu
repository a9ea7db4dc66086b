// Flash-attention backward, dK/dV pass (K5).
//
// Replaces: vit_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel
// (:496-540), launched by _flash_bwd (:579). Same function: for each key,
// dV = sum_q (P * M/keep)^T dO with the masked P rounded to dO's dtype, and
// dK = scale * sum_q ds^T Q with ds rounded to Q's dtype and Q as it is
// (the scale is applied once at the end, :534-539); both sums fp32, cast to
// the input dtype.
//
// What bounds it on the H100: 8*BH*T^2*d operations (four T x T x d
// products: S^T, dP^T, P~^T dO, dS^T Q): bound by operations. At the
// stride-1 shape (BH = 32, T = 4066, d = 64, bf16) that is 271 GFLOP,
// 0.274 ms at 989 TFLOP/s.
// What the bound leaves out: BH*T^2 = 5.3e8 exps on the special-function
// units (~0.13 ms), and with dropout the hash of common.cuh (~10 integer
// operations an element, ~5e9, ~0.3 ms on the CUDA cores if nothing
// overlaps it); the keep mask is hashed once an element for both P~ and dP.
// Design: bf16 runs attn_bwd_tc.cuh, one CTA per (bh, 64 keys) in the
// transposed orientation, the four products as wgmma on the tensor cores
// from TMA-loaded, double-buffered swizzled tiles, with P~^T and dS^T
// passed from the accumulators to the next products in registers; the exps
// and the hash overlap with the tensor cores of the other CTAs on the SM.
// dK and dV are summed in registers over every query tile and written once.
// fp32 runs attn_bwd.cuh on the FMA units (tensor cores would mean TF32).
#include <type_traits>

#include "attn_bwd.cuh"
#include "attn_bwd_tc.cuh"

using namespace vtt;

namespace {

template <typename T, int D> struct DKV {
  static cudaError_t run(const attn_bwd::Args& a, cudaStream_t s) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      return attn_bwd_tc::launch_dkv<D>(a, s);
    } else {
      return attn_bwd::launch_dkv<T, D, /*QS_IN_DK=*/false>(a, s);
    }
  }
};

}  // namespace

// q, k, v, dout, dk, dv: (bh, t, d) contiguous in float32 (is_bf16 = 0) or
// bfloat16, 16-byte aligned; lse, delta: (bh, t) float32; `scale` d^-1/2 in
// fp32. Dropout arguments as for flash_fwd. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int t, int d, float scale, int is_bf16, int dropout,
                             const void* seed, int bh_per_seed, int bh_offset, unsigned threshold,
                             float inv_keep, void* stream) {
  const attn_bwd::Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, bh, t, scale,
                         Dropout{static_cast<const int*>(seed), bh_per_seed, threshold, inv_keep,
                                 dropout, bh_offset}};
  return attn_bwd::dispatch<DKV>(a, d, is_bf16, static_cast<cudaStream_t>(stream));
}
