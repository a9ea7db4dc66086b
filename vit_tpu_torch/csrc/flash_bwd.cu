// Flash-attention backward (K4 and K5 as one kernel).
//
// Replaces: vit_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (:459-493)
// and _flash_bwd_dkv_kernel (:496-540), launched by _flash_bwd (:556,
// :579). Same function: with P = exp(S - lse), dP = dO V^T times the
// dropout keep factor and ds = P (dP - delta), dQ = scale * sum_k ds K with
// ds rounded to K's dtype; dV = sum_q (P * M/keep)^T dO with the masked P
// rounded to dO's dtype; dK = scale * sum_q ds^T Q with Q as it is (the
// scale applied once at the end, :534-539); every sum fp32, the results
// cast to the input dtype.
//
// What bounds it on the H100: 10*BH*T^2*d operations, the five T x T x d
// products S, dP, P~^T dO, dS^T Q and dS K, against q, k, v, dO, dq, dk, dv
// and two fp32 rows moved: bound by operations. At the stride-1 shape (BH =
// 32, T = 4066, d = 64, bf16) that is 338.6 GFLOP, 0.3424 ms at 989
// TFLOP/s. What the bound leaves out: BH*T^2 = 5.3e8 exps on the
// special-function units (~0.13 ms), and with dropout the hash of
// common.cuh (~10 integer operations an element, ~0.3 ms on the CUDA cores
// if nothing overlaps it).
//
// What the design does about it (bf16, attn_bwd_fused_tc.cuh): one pass,
// so S, dP, the exp and the hash are formed once an element where K4 and K5
// each formed them (seven products and two exps and hashes before); all
// five products as wgmma on the tensor cores from TMA-loaded tiles; a CTA
// per (head, 128 keys) at d <= 64 with a producer warpgroup (TMA loads; a
// writer warp) and two consumer warpgroups of 64 keys, so one warpgroup's
// elementwise work runs while the other's products do; dK and dV summed in
// registers and written once; dQ summed in the CTA over its keys, then
// across key blocks into an fp32 workspace by one bulk copy a tile on the
// TMA engine, in key-block order (a counter per head and query tile): two
// calls give equal bits. No T x T tensor reaches memory. fp32 runs
// attn_bwd.cuh's dQ and dK/dV passes on the FMA units (tensor cores would
// mean TF32), two launches behind this one entry.
#include <type_traits>

#include "attn_bwd.cuh"
#include "attn_bwd_fused_tc.cuh"

using namespace vtt;

namespace {

template <typename T, int D> struct Bwd {
  static cudaError_t run(const attn_bwd::Args& a, cudaStream_t s) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      return attn_bwd_fused_tc::launch<D>(a, s);
    } else {
      cudaError_t e = attn_bwd::launch_dq<T, D>(a, s);
      if (e != cudaSuccess) return e;
      return attn_bwd::launch_dkv<T, D, /*QS_IN_DK=*/false>(a, s);
    }
  }
};

}  // namespace

// q, k, v, dout, dq, dk, dv: (bh, t, d) contiguous in float32 (is_bf16 = 0)
// or bfloat16, 16-byte aligned; lse, delta: (bh, t) float32; `scale` d^-1/2
// in fp32 (the kernel rounds it to the input dtype where Q is scaled). bf16
// also takes dq_ws, (bh, 64 ceil(t / 64), d) float32, and counters,
// (bh, ceil(t / 64)) uint32 zeros; fp32 ignores both. Dropout arguments as
// for flash_fwd. Returns the first non-zero cudaGetLastError() of its
// launches.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, void* dk, void* dv,
                         void* dq_ws, void* counters, int bh, int t, int d, float scale,
                         int is_bf16, int dropout, const void* seed, int bh_per_seed,
                         int bh_offset, unsigned threshold, float inv_keep, void* stream) {
  if (is_bf16 && (dq_ws == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
  const attn_bwd::Args a{q, k, v, dout, lse, delta, dq, dk, dv, bh, t, scale,
                         Dropout{static_cast<const int*>(seed), bh_per_seed, threshold, inv_keep,
                                 dropout, bh_offset},
                         static_cast<float*>(dq_ws), static_cast<unsigned*>(counters)};
  return attn_bwd::dispatch<Bwd>(a, d, is_bf16, static_cast<cudaStream_t>(stream));
}
