// Flash-attention backward, dQ pass (K4).
//
// Replaces: vit_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (:459-493),
// launched by _flash_bwd (:556). Same function: for each query row,
// dQ = scale * sum_k ds K with P = exp(S - lse), dP = dO V^T times the
// dropout keep factor, ds = P (dP - delta) rounded to K's dtype; the sum is
// fp32 and the result is cast to the input dtype.
//
// What bounds it on the H100: 6*BH*T^2*d operations (three T x T x d
// products: S, dP, dS K) against q, k, v, dO, dQ and two fp32 rows moved:
// bound by operations. At the stride-1 shape (BH = 32, T = 4066, d = 64,
// bf16) that is 203 GFLOP, 0.205 ms at 989 TFLOP/s.
// What the bound leaves out: BH*T^2 = 5.3e8 exps on the special-function
// units (~0.13 ms at 16 a clock on each of 132 SMs), and with dropout the
// hash of common.cuh (~10 integer operations an element, ~5e9, ~0.3 ms on
// the CUDA cores if nothing overlaps it).
// Design: bf16 runs attn_bwd_tc.cuh, the three products as wgmma on the
// tensor cores (bf16 operands, fp32 sums) from TMA-loaded, double-buffered
// swizzled tiles; the exps and the hash run on the CUDA cores in registers
// between the products, and overlap with the tensor cores of the other
// CTAs on the SM (four a SM at d = 64). fp32 runs attn_bwd.cuh on the FMA
// units: tensor cores would mean TF32. No T x T tensor reaches memory.
#include <type_traits>

#include "attn_bwd.cuh"
#include "attn_bwd_tc.cuh"

using namespace vtt;

namespace {

template <typename T, int D> struct DQ {
  static cudaError_t run(const attn_bwd::Args& a, cudaStream_t s) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      return attn_bwd_tc::launch_dq<D>(a, s);
    } else {
      return attn_bwd::launch_dq<T, D>(a, s);
    }
  }
};

}  // namespace

// q, k, v, dout, dq: (bh, t, d) contiguous in float32 (is_bf16 = 0) or
// bfloat16, 16-byte aligned; lse, delta: (bh, t) float32. `scale` is d^-1/2
// in fp32 (the kernel rounds it to the input dtype where Q is scaled).
// Dropout arguments as for flash_fwd. Returns cudaGetLastError() after the
// launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int t, int d,
                            float scale, int is_bf16, int dropout, const void* seed,
                            int bh_per_seed, int bh_offset, unsigned threshold,
                            float inv_keep, void* stream) {
  const attn_bwd::Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, bh, t, scale,
                         Dropout{static_cast<const int*>(seed), bh_per_seed, threshold, inv_keep,
                                 dropout, bh_offset}};
  return attn_bwd::dispatch<DQ>(a, d, is_bf16, static_cast<cudaStream_t>(stream));
}
