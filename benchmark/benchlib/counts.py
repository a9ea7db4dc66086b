"""Operations and bytes of the model's work, and the card's published peaks.

``model_flops`` is the project's analytic matmul count of one forward
(patch embedding, per-layer QKV and output projections, the two T x T
attention products, the MLP pair, the head; a multiply-add is 2 FLOPs);
a training step is three forwards' worth. Elementwise work and the
recompute of checkpointed layers are not counted, so a share of the peak
built on it is a lower bound.

``attention_fwd`` and ``attention_bwd`` count the exact-attention
algorithm's own work at one launch's shape, whatever kernel does it: the
forward's two T x T products and its exponentials; the backward from the
saved log-sum-exp: five T x T products (S again, dP, dV, dQ, dK) and the
exponentials of P again. Bytes read each input once and write each output
once: q, k, v (and dO, lse, delta for the backward) in, O and lse (dQ, dK,
dV) out.
"""

from __future__ import annotations

from benchlib.dims import Dims

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
SMS = 132
SFU_EXP_PER_SM_CLOCK = 16
MAX_SM_CLOCK_HZ = 1.98e9
SFU_EXP_PER_S = SMS * SFU_EXP_PER_SM_CLOCK * MAX_SM_CLOCK_HZ


def model_flops(d: Dims, rows: int, train: bool) -> float:
    t, h, inter = d.seq, d.hidden, d.inter
    embed = 2.0 * d.patches * d.patch_in * h
    per_layer = 8.0 * t * h * h + 4.0 * t * t * h + 4.0 * t * h * inter
    fwd = rows * (d.layers * per_layer + embed + 2.0 * h * d.labels)
    return 3.0 * fwd if train else fwd


def attention_fwd(b: int, h: int, t: int, dh: int, itemsize: int = 2):
    """(FLOPs, exponentials, bytes) of one forward launch."""
    bht = b * h * t
    return 4.0 * b * h * t * t * dh, float(b * h * t * t), 4.0 * bht * dh * itemsize + 4.0 * bht


def attention_bwd(b: int, h: int, t: int, dh: int, itemsize: int = 2):
    """(FLOPs, exponentials, bytes) of one backward launch."""
    bht = b * h * t
    return (10.0 * b * h * t * t * dh, float(b * h * t * t),
            7.0 * bht * dh * itemsize + 8.0 * bht)


def least_seconds(flops: float, exps: float, nbytes: float, bf16: bool = True) -> float:
    """The least time the card could take: the larger of the products at
    the dtype's peak, the exponentials on the SFUs, and the bytes at HBM
    bandwidth."""
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS
    return max(flops / peak, exps / SFU_EXP_PER_S, nbytes / HBM_BYTES_PER_S)
