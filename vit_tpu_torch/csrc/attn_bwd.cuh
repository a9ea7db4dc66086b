// The two fp32 passes of the attention backward, shared by the flash
// backward (flash_bwd.cu: K4 and K5's function) and K6 (short_bwd.cu).
//
// With P = exp(S - lse) re-derived from Q, K and the forward's lse,
// dP = dO V^T masked by the dropout keep mask M/keep, and
// ds = P * (dP - delta) with delta = rowsum(dO * O) from the host:
//   dQ = scale * ds K                       (ds rounded to K's dtype)
//   dV = (P * M/keep)^T dO                  (rounded to dO's dtype)
//   dK = scale * ds^T Q    (K5), or ds^T (Q*scale rounded)   (K6)
// S = (Q*scale rounded to the input dtype) K^T in fp32, as in the forward.
// These are the casts of vit_tpu/ops/flash_attention.py: K4 :475-493,
// K5 :513-540, K6 :233-256.
//
// Design (simple and right, on the fp32 FMA units): a 64 x 64 tile of S
// per step, 256 threads each holding a 4 x 4 block of it. The dQ pass runs
// one CTA per (bh, 64 query rows) and walks the key tiles; the dK/dV pass
// one CTA per (bh, 64 keys) and walks the query tiles; each accumulates in
// registers and writes once. No T x T tensor reaches device memory. T and
// d are not padded: rows and keys at or past T are masked here.
#pragma once

#include "common.cuh"

namespace vtt {
namespace attn_bwd {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int THREADS = 256;

template <int D> constexpr size_t dq_smem_floats() {
  return 2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 2 * BQ;
}

template <int D, bool QS_IN_DK> constexpr size_t dkv_smem_floats() {
  return (QS_IN_DK ? 2 : 3) * BQ * (D + 1) + 2 * BK * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ;
}

// Rows [r0, r0 + n) of one head of x (t x D) into smem (n x (D+1)), zero
// past T; with `scale` != 0 each value is x*scale rounded to T.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ x, size_t base,
                                          int r0, int n, int t, float scale) {
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int r = i / D, c = i % D, row = r0 + r;
    float val = row < t ? to_f<T>(x[base + static_cast<size_t>(row) * D + c]) : 0.f;
    if (scale != 0.f) val = round_to<T>(val * scale);
    dst[r * (D + 1) + c] = val;
  }
}

// S and dP for the 4 x 4 block (rows ty + 16i, cols tx + 16j) of a tile.
template <int D>
__device__ __forceinline__ void scores(const float* qs, const float* dos, const float* ks,
                                       const float* vs, int tx, int ty, float s[4][4],
                                       float dp[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D; ++kk) {
    float aq[4], ao[4], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      aq[i] = qs[(ty + 16 * i) * DP + kk];
      ao[i] = dos[(ty + 16 * i) * DP + kk];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = ks[(tx + 16 * j) * DP + kk];
      bv[j] = vs[(tx + 16 * j) * DP + kk];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(ao[i], bv[j], dp[i][j]);
      }
  }
}

// dQ: one CTA per (bh, BQ query rows).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int t, int n_qt, float scale,
          Dropout dr) {
  constexpr int DP = D + 1, PP = BK + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x DP, Q*scale rounded to T
  float* dos = qs + BQ * DP;   // BQ x DP, dO
  float* ks = dos + BQ * DP;   // BK x DP
  float* vs = ks + BK * DP;    // BK x DP
  float* dss = vs + BK * DP;   // BQ x PP, ds rounded to T
  float* lses = dss + BQ * PP; // BQ
  float* dels = lses + BQ;     // BQ

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BQ;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const unsigned head = head_term(dr, bh);

  load_rows<T, D>(qs, q, base, q0, BQ, t, round_to<T>(scale));
  load_rows<T, D>(dos, dout, base, q0, BQ, t, 0.f);
  for (int r = tid; r < BQ; r += THREADS) {
    const int row = q0 + r;
    lses[r] = row < t ? lse[static_cast<size_t>(bh) * t + row] : 0.f;
    dels[r] = row < t ? delta[static_cast<size_t>(bh) * t + row] : 0.f;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < t; k0 += BK) {
    __syncthreads();  // Q/dO staged; the previous tile's ks/dss reads are done
    load_rows<T, D>(ks, k, base, k0, BK, t, 0.f);
    load_rows<T, D>(vs, v, base, k0, BK, t, 0.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(qs, dos, ks, vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = col < t ? expf(s[i][j] - lses[r]) : 0.f;
        float d = dp[i][j];
        if (dr.on) d *= keep_factor(dr, head, q0 + r, col);
        dss[r * PP + tx + 16 * j] = round_to<T>(p * (d - dels[r]));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float b[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) b[c] = ks[j * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = dss[(ty + 16 * i) * PP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(a, b[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    T* out = dq + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) out[tx + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

// dK and dV: one CTA per (bh, BK keys).
template <typename T, int D, bool QS_IN_DK>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int t,
           int n_kt, float scale, Dropout dr) {
  constexpr int DP = D + 1, PP = BK + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                                // BQ x DP, Q*scale rounded to T
  float* qr = QS_IN_DK ? qs : qs + BQ * DP;        // BQ x DP, Q as it is (K5)
  float* dos = qr + BQ * DP;                       // BQ x DP
  float* ks = dos + BQ * DP;                       // BK x DP
  float* vs = ks + BK * DP;                        // BK x DP
  float* pts = vs + BK * DP;                       // BQ x PP, P*M/keep rounded to T
  float* dss = pts + BQ * PP;                      // BQ x PP, ds rounded to T
  float* lses = dss + BQ * PP;                     // BQ
  float* dels = lses + BQ;                         // BQ

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * BK;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const unsigned head = head_term(dr, bh);
  const float qscale = round_to<T>(scale);

  load_rows<T, D>(ks, k, base, k0, BK, t, 0.f);
  load_rows<T, D>(vs, v, base, k0, BK, t, 0.f);

  float dk_acc[4][NC], dv_acc[4][NC];  // key rows ty + 16i, columns tx + 16c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int q0 = 0; q0 < t; q0 += BQ) {
    __syncthreads();  // the previous query tile's pts/dss/qr/dos reads are done
    load_rows<T, D>(qs, q, base, q0, BQ, t, qscale);
    if (!QS_IN_DK) load_rows<T, D>(qr, q, base, q0, BQ, t, 0.f);
    load_rows<T, D>(dos, dout, base, q0, BQ, t, 0.f);
    for (int r = tid; r < BQ; r += THREADS) {
      const int row = q0 + r;
      lses[r] = row < t ? lse[static_cast<size_t>(bh) * t + row] : 0.f;
      dels[r] = row < t ? delta[static_cast<size_t>(bh) * t + row] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(qs, dos, ks, vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = (row < t && col < t) ? expf(s[i][j] - lses[r]) : 0.f;
        const float m = dr.on ? keep_factor(dr, head, row, col) : 1.f;
        pts[r * PP + tx + 16 * j] = round_to<T>(p * m);
        dss[r * PP + tx + 16 * j] = round_to<T>(p * (dp[i][j] * m - dels[r]));
      }
    }
    __syncthreads();
    const float* qk = QS_IN_DK ? qs : qr;
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float bo[NC], bq[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        bo[c] = dos[r * DP + tx + 16 * c];
        bq[c] = qk[r * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ap = pts[r * PP + ty + 16 * i];
        const float as = dss[r * PP + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[i][c] = fmaf(ap, bo[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(as, bq[c], dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= t) continue;
    const size_t off = base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(QS_IN_DK ? dk_acc[i][c] : dk_acc[i][c] * scale);
      dv[off + tx + 16 * c] = from_f<T>(dv_acc[i][c]);
    }
  }
}

// Pointers of one backward call, as the C entry points receive them;
// dq_ws and counters are the bf16 flash backward's dQ workspace and its
// per-(bh, query tile) counters (attn_bwd_fused_tc.cuh), null elsewhere.
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int bh, t;
  float scale;
  Dropout dr;
  float* dq_ws = nullptr;
  unsigned* counters = nullptr;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  auto kernel = dq_kernel<T, D>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int n_qt = (a.t + BQ - 1) / BQ;
  kernel<<<n_qt * a.bh, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.t, n_qt, a.scale, a.dr);
  return cudaGetLastError();
}

template <typename T, int D, bool QS_IN_DK>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D, QS_IN_DK>() * sizeof(float);
  auto kernel = dkv_kernel<T, D, QS_IN_DK>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int n_kt = (a.t + BK - 1) / BK;
  kernel<<<n_kt * a.bh, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.t,
      n_kt, a.scale, a.dr);
  return cudaGetLastError();
}

// F<T, D>::run(a, stream) for the runtime dtype and head dim.
template <template <typename, int> class F>
cudaError_t dispatch(const Args& a, int d, int is_bf16, cudaStream_t s) {
  if (a.bh <= 0 || a.t <= 0) return cudaErrorInvalidValue;
  if (is_bf16) {
    switch (d) {
      case 16: return F<__nv_bfloat16, 16>::run(a, s);
      case 32: return F<__nv_bfloat16, 32>::run(a, s);
      case 64: return F<__nv_bfloat16, 64>::run(a, s);
      case 128: return F<__nv_bfloat16, 128>::run(a, s);
    }
  } else {
    switch (d) {
      case 16: return F<float, 16>::run(a, s);
      case 32: return F<float, 32>::run(a, s);
      case 64: return F<float, 64>::run(a, s);
      case 128: return F<float, 128>::run(a, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace attn_bwd
}  // namespace vtt
