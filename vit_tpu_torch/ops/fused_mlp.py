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
output columns, so they run at every width. Both pick their body by one
fixed rule on dtype and width, not on failure (:func:`mlp_body`): bf16 with
D and F multiples of 16 runs every product on the tensor cores, with the
(R, F) intermediates in registers at D <= 128 (``csrc/fused_mlp_tc.cuh``,
``csrc/fused_mlp_bwd_tc.cuh``) and written once in bf16 to (R, F) scratch
at 128 < D <= 1024 (``csrc/fused_mlp_wide_tc.cuh``: ViT-S/16's D384,
ViT-B/16's D768, ViT-L/16's D1024); fp32, where tensor cores would mean
TF32, and other widths run on the fp32 FMA units.

The model takes these kernels inside ``vit_tpu``'s envelope only
(``vit_tpu/ops/fused_mlp.py:247-261``): past ``(16 + 2·itemsize)·D·F`` =
12 MiB (:func:`in_envelope`; ViT-S/16 in fp32, ViT-B/16 and ViT-L/16) it
prints ``vit_tpu``'s line once (:func:`note_outside_envelope`) and runs
:func:`library_mlp`, ``_jnp_mlp``'s math on the library's operations, as
``vit_tpu`` runs ``_jnp_mlp`` there. The op itself keeps its device rule:
called on the card, :func:`fused_mlp` launches the kernels at any width.

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
import torch.nn.functional as F

from vit_tpu_torch.func_internals import is_batched
from vit_tpu_torch.ops._build import KERNELS
from vit_tpu_torch.ops.flash_attention import _aligned, replica_first

__all__ = ["fused_mlp", "fused_mlp_plain", "fused_mlp_bwd", "fused_mlp_bwd_plain", "mlp_body",
           "bwd_plan", "gelu_as", "dgelu_as", "erf_as", "ENVELOPE_BYTES", "resident_bytes",
           "in_envelope", "note_outside_envelope", "library_mlp"]

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


def _ptr(t):
    """A tensor's device pointer for a kernel's C entry, None for no tensor."""
    return None if t is None else t.data_ptr()


def _fwd_scratch(r: int, d: int, f: int, dtype: torch.dtype, device):
    """K3's scratch: h, the (R, F) GELU output in bf16, on the wide route;
    None on the others (the intermediate stays on chip)."""
    if mlp_body(d, f, dtype) != "wide":
        return None
    return torch.empty((r, f), dtype=dtype, device=device)


def _launch(x, w1, b1, w2, b2) -> torch.Tensor:
    r, d = x.shape
    y = torch.empty_like(x)
    if r == 0:
        return y
    if x.dtype == torch.bfloat16:  # the tensor-core bodies read through TMA
        x, w1, b1, w2, b2 = (_aligned(t) for t in (x, w1, b1, w2, b2))
    h = _fwd_scratch(r, d, w1.shape[0], x.dtype, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNELS["fused_mlp_fwd"].launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), _ptr(h), r, d, w1.shape[0],
        int(x.dtype == torch.bfloat16), stream,
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
_TC_D_MAX = 128  # csrc/fused_mlp_tc.cuh, csrc/fused_mlp_bwd_tc.cuh::D_MAX
_WIDE_D_MAX = 1024  # csrc/fused_mlp_wide_tc.cuh::D_MAX
_WIDE_TILE = (128, 256)  # fused_mlp_wide_tc.cuh::BM, N_WGT: a weight-gradient tile
BODIES = ("fma", "tc", "wide")  # the C entry points' body codes 0, 1, 2


def mlp_body(d: int, f: int, dtype: torch.dtype) -> str:
    """The body K3 and K7 run for width D and F hidden units: ``"tc"``
    (bf16, D and F multiples of 16, D <= 128: the (R, F) intermediates stay
    in registers), ``"wide"`` (the same with 128 < D <= 1024: h, or g and
    dh, written once in bf16 to (R, F) scratch) or ``"fma"`` (fp32, where
    tensor cores would mean TF32, and every other width)."""
    if dtype != torch.bfloat16 or d % 16 or f % 16 or d > _WIDE_D_MAX:
        return "fma"
    return "tc" if d <= _TC_D_MAX else "wide"


def bwd_plan(r: int, d: int, f: int, dtype: torch.dtype) -> Tuple[bool, int]:
    """K7's body and row segments for (R, D) rows and F hidden units:
    ``(tensor_cores, n_seg)``, tensor_cores unless :func:`mlp_body` is
    ``"fma"``.

    The weight-gradient CTAs (each an output tile) are repeated over
    ``n_seg`` segments of rows, enough for about two waves of 132 SMs; each
    segment sums its rows' 2FD + F + D gradients in fp32. On the tensor
    cores segments are whole 64-row blocks, none empty: ``"tc"`` tiles an F
    chunk of 64 by D (one column tile), at least two waves; ``"wide"`` both
    products (dW1 (F, D), dW2 (D, F)) by 128 x 256 output tiles, the count
    nearest two waves (its CTAs fill an SM each, and one segment needs no
    partials). FMA: 64 x 64 tiles, each segment at least 128 rows."""
    body = mlp_body(d, f, dtype)
    if body == "fma":
        tiles = -(-f // 64) * -(-d // 64)
        return False, max(1, min(-(-_WAVES // tiles), -(-r // 128)))
    blocks = max(1, -(-r // 64))
    if body == "tc":
        want = -(-_WAVES // (-(-f // 64) * -(-d // 128)))
    else:
        m, n = _WIDE_TILE
        tiles = -(-f // m) * -(-d // n) + -(-d // m) * -(-f // n)
        want = max(1, int(_WAVES / tiles + 0.5))
    per_seg = -(-blocks // min(want, blocks))
    return True, -(-blocks // per_seg)


def _bwd_scratch(r: int, d: int, f: int, dtype: torch.dtype, device):
    """K7's body, segments and scratch: (body, n_seg, g, dh, partials). g
    and dh are (R, F) in the input dtype on the FMA and wide bodies (the
    intermediates the other passes read), None on ``"tc"`` (on chip). The
    partials are (n_seg, 2FD + F + D) fp32, None on the wide body with one
    segment, whose last pass writes the gradients themselves."""
    body = mlp_body(d, f, dtype)
    n_seg = bwd_plan(r, d, f, dtype)[1]
    g = dh = None
    if body != "tc":
        g = torch.empty((r, f), dtype=dtype, device=device)
        dh = torch.empty_like(g)
    part = None
    if body != "wide" or n_seg > 1:
        part = torch.empty((n_seg, 2 * f * d + f + d), dtype=torch.float32, device=device)
    return body, n_seg, g, dh, part


def fused_mlp_bwd(x, dy, w1, b1, w2):
    """The backward (K7) of :func:`fused_mlp` on (R, D) rows, operands as
    there: (dx, dW1, db1, dW2, db2), the weight gradients fp32. The FMA and
    wide bodies allocate (R, F) scratch (g and dh, :func:`_bwd_scratch`)."""
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
        body, n_seg, g, dh, part = _bwd_scratch(r, d, f, x.dtype, x.device)
        if body != "fma":  # the tensor-core bodies read through TMA
            x, dy, w1, b1, w2 = (_aligned(t) for t in (x, dy, w1, b1, w2))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNELS["fused_mlp_bwd"].launch(
            x.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            dx.data_ptr(), _ptr(g), _ptr(dh), _ptr(part), grads.data_ptr(), r, d, f, n_seg,
            int(x.dtype == torch.bfloat16), BODIES.index(body), stream,
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


# -- vit_tpu's envelope, and what runs outside it -------------------------------
ENVELOPE_BYTES = 12 * 1024**2  # vit_tpu/ops/fused_mlp.py:252
_ENVELOPE_NOTED = False  # vit_tpu's fused_mlp._warned: the line is printed once a process


def resident_bytes(d: int, f: int, dtype: torch.dtype) -> int:
    """``vit_tpu``'s estimate of its Pallas MLP's resident VMEM for width D,
    F hidden units and the compute dtype: the backward's fp32 dW1/dW2
    accumulators and both weight blocks, ``(16 + 2·itemsize)·D·F`` bytes."""
    return (16 + 2 * dtype.itemsize) * d * f


def in_envelope(d: int, f: int, dtype: torch.dtype) -> bool:
    """True where ``vit_tpu``'s model runs its Pallas MLP (resident bytes
    at most 12 MiB); outside, it runs ``_jnp_mlp``."""
    return resident_bytes(d, f, dtype) <= ENVELOPE_BYTES


def note_outside_envelope(d: int, f: int, dtype: torch.dtype) -> None:
    """``vit_tpu``'s line for a width outside the envelope, once a process."""
    global _ENVELOPE_NOTED
    if not _ENVELOPE_NOTED:
        print(f"[fused_mlp] d={d}, f={f} exceeds the kernel's VMEM envelope "
              f"(~{resident_bytes(d, f, dtype) / 1e6:.0f} MB resident); using the XLA path")
        _ENVELOPE_NOTED = True


class _F32Product(torch.autograd.Function):
    """``a @ b.T`` for ``a``, ``b`` of one dtype, summed in fp32 and
    returned in fp32 (``jnp.dot(..., preferred_element_type=jnp.float32)``):
    on the card a bf16 product with an fp32 result (``torch.mm(...,
    out_dtype=torch.float32)``), elsewhere an fp32 product of the same
    values. The backward rounds the incoming gradient to the operands'
    dtype, as a cast's gradient does, and takes its two products there."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        if a.dtype == torch.float32 or a.device.type != "cuda":
            return torch.matmul(a.float(), b.float().t())
        return torch.mm(a, b.t(), out_dtype=torch.float32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ b, g.t() @ a


def library_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """``_jnp_mlp``'s math with the library's operations, what the model runs
    outside the envelope: x·W1 summed in fp32 plus b1, the exact (erf) GELU
    in fp32 (whatever ``gelu_approximate`` says, as in the fused path), h
    rounded to x's dtype, h·W2 summed in fp32 plus b2, rounded. Operands as
    :func:`fused_mlp`'s, the weights cast to x's dtype (as ``vit_tpu``'s
    model casts them); the gradients come from autograd. No kernel of this
    package runs here, and no plain version of one.

    The GELU is torch's one pass over the fp32 pre-activation, not
    :func:`gelu_as`: ``_gelu_f32``'s Abramowitz-Stegun erf is within 1.5e-7
    of erf, below one fp32 ulp of most GELU values, and its ~20 eager
    passes over (R, F) fp32 would cost more than both products."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    w1, b1, w2, b2 = (w.to(x.dtype) for w in (w1, b1, w2, b2))
    h = F.gelu(_F32Product.apply(x2, w1) + b1.float()).to(x.dtype)
    return (_F32Product.apply(h, w2) + b2.float()).to(x.dtype).reshape(shape)
