"""Fused transformer MLP: ``gelu(x @ w1.T + b1) @ w2.T + b2``, forward and backward.

Port of ``vit_tpu/ops/fused_mlp.py::fused_mlp`` with its ``custom_vjp``.
The forward kernel (``csrc/fused_mlp_fwd.cu``, replaces ``_fwd_kernel``)
keeps the (rows, F) intermediate on chip; :func:`fused_mlp_plain` is
``_jnp_mlp``. The backward kernel (``csrc/fused_mlp_bwd.cu``, replaces
``_bwd_kernel``) recomputes the pre-activation and returns dx in the input
dtype and dW1, db1, dW2, db2 summed in fp32 and returned in fp32;
:func:`fused_mlp_bwd_plain` is its plain version. All use the
Abramowitz-Stegun erf of the Pallas kernels (not ``torch.erf``), compute
the GELU and its derivative in fp32, and cast the GELU output and dh to the
input dtype before the products that read them. The weights are in torch's
``nn.Linear`` layout, (out, in): ``w1`` is (F, D) and ``w2`` is (D, F), the
transposes of the Pallas kernel's.

The wrappers take the plain versions for tensors on the CPU and launch the
kernels for tensors on the card. The kernels tile over F and over the
output columns, so they run at every width. Each kernel picks its body by
a fixed rule, not on failure: bf16 with D and F multiples of 16 and D at
most 1024 (forward) or 512 (backward, :func:`bwd_plan`) runs its products
on the tensor cores (``csrc/fused_mlp_tc.cuh``, ``csrc/fused_mlp_bwd_tc.cuh``);
fp32, where tensor cores would mean TF32, and other bf16 widths run on the
fp32 FMA units. So the backward of ViT-B (D768) and ViT-L (D1024) takes the
FMA body, which ``vit_tpu`` never launches there: its Pallas MLP falls back
to ``_jnp_mlp`` past a 12 MiB VMEM envelope
(``vit_tpu/ops/fused_mlp.py:247-261``).

Under ``torch.func.vmap`` over R replicas (a stacked sweep,
:mod:`vit_tpu_torch.opt.parallel_sweep`), each replica has its own weights:
:class:`_FusedMLP`'s ``vmap`` rule launches the kernels once per replica on
that replica's rows and weights, R launches of each.

Serving (no gradient, no ``vmap``) calls K3 through the custom operator
``torch.ops.vit_tpu_torch.fused_mlp_fwd`` (CUDA: the launch; CPU: the plain
version; a fake version gives the shape), so ``torch.export`` keeps it as
one opaque node (:mod:`vit_tpu_torch.export`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from vit_tpu_torch.func_internals import is_batched
from vit_tpu_torch.ops._build import KERNELS
from vit_tpu_torch.ops.flash_attention import _aligned, replica_first

__all__ = ["fused_mlp", "fused_mlp_plain", "fused_mlp_bwd", "fused_mlp_bwd_plain", "bwd_plan",
           "gelu_as", "dgelu_as", "erf_as"]

_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 rational erf (max abs err 1.5e-7), fp32."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    ax = x.abs()
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_as(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + erf_as(x * _SQRT_HALF))


def dgelu_as(x: torch.Tensor) -> torch.Tensor:
    """GELU's derivative on :func:`erf_as`, fp32 (``_dgelu_f32``)."""
    cdf = 0.5 * (1.0 + erf_as(x * _SQRT_HALF))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * x * x)
    return cdf + x * pdf


def fused_mlp_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """(R, D) rows -> (R, D), the math of ``_jnp_mlp``."""
    pre = torch.matmul(x.float(), w1.float().t()) + b1.float()
    h = gelu_as(pre).to(x.dtype)
    return (torch.matmul(h.float(), w2.float().t()) + b2.float()).to(x.dtype)


def fused_mlp_bwd_plain(x, dy, w1, b1, w2):
    """``_bwd_kernel`` on (R, D) rows: (dx in x's dtype, then dW1 (F, D),
    db1 (F), dW2 (D, F), db2 (D) in fp32)."""
    xf, dyf = x.float(), dy.float()
    pre = torch.matmul(xf, w1.float().t()) + b1.float()
    g = gelu_as(pre).to(x.dtype).float()
    dh = (torch.matmul(dyf, w2.float()) * dgelu_as(pre)).to(x.dtype).float()
    dx = torch.matmul(dh, w1.float()).to(x.dtype)
    return dx, dh.t() @ xf, dh.sum(0), dyf.t() @ g, dyf.sum(0)


def _check(x, w1, b1, w2, b2) -> None:
    r, d = x.shape
    f = w1.shape[0]
    if w1.shape != (f, d) or b1.shape != (f,) or w2.shape != (d, f) or b2.shape != (d,):
        raise ValueError(
            f"fused_mlp shapes: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 "
            f"{tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}"
        )
    ts = (x, w1, b1, w2, b2)
    if len({t.dtype for t in ts}) != 1 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_mlp operands must all be float32 or bfloat16: {[t.dtype for t in ts]}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("fused_mlp operands must lie on one device")


def _launch(x, w1, b1, w2, b2) -> torch.Tensor:
    r, d = x.shape
    y = torch.empty_like(x)
    if r == 0:
        return y
    if x.dtype == torch.bfloat16:  # the tensor-core body reads through TMA
        x, w1, b1, w2, b2 = (_aligned(t) for t in (x, w1, b1, w2, b2))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNELS["fused_mlp_fwd"].launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), r, d, w1.shape[0], int(x.dtype == torch.bfloat16), stream,
    )
    return y


def _on_cpu(x) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def _fwd(x2, w1, b1, w2, b2) -> torch.Tensor:
    _check(x2, w1, b1, w2, b2)
    return fused_mlp_plain(x2, w1, b1, w2, b2) if _on_cpu(x2) else _launch(x2, w1, b1, w2, b2)


@torch.library.custom_op("vit_tpu_torch::fused_mlp_fwd", mutates_args=())
def _fused_mlp_fwd_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """K3 as an opaque operator (the served forward) on (R, D) rows."""
    return _fwd(x, w1, b1, w2, b2)


@_fused_mlp_fwd_op.register_fake
def _fused_mlp_fwd_fake(x, w1, b1, w2, b2):
    return torch.empty_like(x)


_WAVES = 2 * 132  # CTAs that fill two waves of the H100's 132 SMs
_BWD_TC_D_MAX = 512  # csrc/fused_mlp_bwd_tc.cuh::D_MAX


def bwd_plan(r: int, d: int, f: int, dtype: torch.dtype) -> Tuple[bool, int]:
    """K7's body and row segments for (R, D) rows and F hidden units:
    ``(tensor_cores, n_seg)``.

    bf16 with D and F multiples of 16 and D at most 512 takes the tensor
    cores (``fused_mlp_bwd_tc.cuh::takes``); fp32 and other widths the FMA
    body. Either way the weight-gradient CTAs (one per F chunk of 64 and
    column tile of D) are repeated over ``n_seg`` segments of rows, enough
    for about two waves of 132 SMs; each segment writes 2FD + F + D fp32
    partials. Tensor cores: segments of whole 64-row blocks and D tiles of
    128, none empty. FMA: 64 x 64 tiles, each segment at least 128 rows."""
    tc = (dtype == torch.bfloat16 and d % 16 == 0 and f % 16 == 0 and d <= _BWD_TC_D_MAX)
    if not tc:
        tiles = -(-f // 64) * -(-d // 64)
        return False, max(1, min(-(-_WAVES // tiles), -(-r // 128)))
    blocks = max(1, -(-r // 64))
    tiles = -(-f // 64) * -(-d // 128)
    per_seg = -(-blocks // min(-(-_WAVES // tiles), blocks))
    return True, -(-blocks // per_seg)


def _bwd_scratch(r: int, d: int, f: int, dtype: torch.dtype, device):
    """K7's plan and scratch: (tensor_cores, n_seg, g, dh, partials). g and
    dh are the FMA body's (R, F) intermediates in the input dtype, None on
    the tensor cores; the partials are (n_seg, 2FD + F + D) fp32."""
    tc, n_seg = bwd_plan(r, d, f, dtype)
    g = dh = None
    if not tc:
        g = torch.empty((r, f), dtype=dtype, device=device)
        dh = torch.empty_like(g)
    part = torch.empty((n_seg, 2 * f * d + f + d), dtype=torch.float32, device=device)
    return tc, n_seg, g, dh, part


def fused_mlp_bwd(x, dy, w1, b1, w2):
    """The backward (K7) of :func:`fused_mlp` on (R, D) rows, operands as
    there: (dx, dW1, db1, dW2, db2), the weight gradients fp32. Only the
    FMA body allocates (R, F) scratch (g and dh)."""
    _check(x, w1, b1, w2, torch.empty(x.shape[1], dtype=x.dtype, device=x.device))
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x: {dy.shape} {dy.dtype}, {x.shape} {x.dtype}")
    if _on_cpu(x):
        return fused_mlp_bwd_plain(x, dy, w1, b1, w2)
    r, d = x.shape
    f = w1.shape[0]
    dx = torch.empty_like(x)
    # Every element is written by the kernel's last pass; with no rows, the
    # gradients are zeros.
    grads = (torch.empty if r > 0 else torch.zeros)(2 * f * d + f + d, dtype=torch.float32,
                                                    device=x.device)
    if r > 0:
        tc, n_seg, g, dh, part = _bwd_scratch(r, d, f, x.dtype, x.device)
        if tc:  # the tensor-core body reads through TMA
            x, dy, w1, b1, w2 = (_aligned(t) for t in (x, dy, w1, b1, w2))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNELS["fused_mlp_bwd"].launch(
            x.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            dx.data_ptr(), None if tc else g.data_ptr(), None if tc else dh.data_ptr(),
            part.data_ptr(), grads.data_ptr(), r, d, f, n_seg, int(x.dtype == torch.bfloat16),
            int(tc), stream,
        )
    dw1, db1, dw2, db2 = torch.split(grads, [f * d, f, d * f, d])
    return dx, dw1.view(f, d), db1, dw2.view(d, f), db2


def _cast(x2, *ws):
    return tuple(w.to(x2.dtype).contiguous() for w in ws)


class _FusedMLP(torch.autograd.Function):
    """K3 forward, K7 backward (``_core_fwd`` / ``_core_bwd``). The weights
    are cast to x's dtype here, so the kernel's fp32 weight gradients reach
    fp32 parameters unrounded, as vit_tpu's fp32 ``_bwd_kernel`` outputs
    reach its parameters through ``astype`` (autograd casts them to a
    parameter's own dtype where that differs). The cast w1, b1, w2 are
    returned beside y (not differentiable) for the backward to save."""

    @staticmethod
    def forward(x2, w1, b1, w2, b2):
        ws = _cast(x2, w1, b1, w2, b2)
        # Views: a weight already in x's dtype is the input itself, which
        # autograd will not save as an output.
        return (_fwd(x2, *ws), *(w.view_as(w) for w in ws[:3]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, *ws = output
        ctx.mark_non_differentiable(*ws)
        ctx.save_for_backward(inputs[0], *ws)

    @staticmethod
    def backward(ctx, dy, *_):
        x2, w1, b1, w2 = ctx.saved_tensors
        return fused_mlp_bwd(x2, dy.contiguous(), w1, b1, w2)

    @staticmethod
    def vmap(info, in_dims, *args):
        """One application (K3 now, K7 in the backward) per replica."""
        n = info.batch_size
        args = [replica_first(t, d, n) for t, d in zip(args, in_dims)]
        outs = zip(*(_FusedMLP.apply(*(a[r] for a in args)) for r in range(n)))
        return tuple(torch.stack(o) for o in outs), (0,) * 4


def fused_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """``x``: (..., D) in fp32 or bf16; ``w1``: (F, D); ``w2``: (D, F);
    biases (F,) / (D,), cast to x's dtype inside. Differentiable through the
    backward kernel; the weights' gradients come back in fp32, unrounded,
    for fp32 weights (the model's mixed-precision path)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    ts = (x2, w1, b1, w2, b2)
    if (torch.is_grad_enabled() and any(t.requires_grad for t in ts)) or any(map(is_batched, ts)):
        y = _FusedMLP.apply(*ts)[0]
    else:
        y = _fused_mlp_fwd_op(x2, *_cast(x2, w1, b1, w2, b2))
    return y.reshape(shape)
