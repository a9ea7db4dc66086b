"""Parameter holders with flax's mixed-precision semantics.

``vit_tpu`` keeps fp32 parameters and computes in the config's dtype:
``nn.Dense(dtype=bf16)`` casts the input, kernel and bias to bf16, rounds
the product to bf16 and then adds the bias; ``nn.LayerNorm(dtype=bf16)``
computes its statistics and the affine map in fp32 and rounds once at the
end. :class:`Linear` and :class:`LayerNorm` do the same, with torch's
(out, in) weight layout. Parameters start empty and are filled by
:func:`init_normal_` from an explicit ``torch.Generator`` or by
``load_state_dict``.

Every dense layer of the model runs :meth:`Linear.forward`, so it is the
one place a serving-time substitute can take over a layer's product
(:func:`intercept_linear`, the port's counterpart of flax's
``nn.intercept_methods`` on ``nn.Dense.__call__``; int8 serving,
:mod:`vit_tpu_torch.ops.quant`), and the place a weight split over the
``model`` axis runs column-parallel
(:func:`~vit_tpu_torch.parallel.tensor.column_parallel`).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Optional, Tuple

import torch
from torch import nn

__all__ = ["Linear", "DenseHolder", "LayerNorm", "dense", "init_normal_", "intercept_linear",
           "KERNEL_STD", "LN_EPS"]

KERNEL_STD = 0.02  # HF initializer_range
LN_EPS = 1e-12  # HF ViTConfig layer_norm_eps


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """``x @ weight.T + bias`` in ``dtype``, rounded after the product and
    again after the bias, as flax's Dense does."""
    y = torch.matmul(x.to(dtype), weight.to(dtype).t())
    return y if bias is None else y + bias.to(dtype)


# fn(linear, x, dtype) -> a tensor that replaces the layer's product, or None;
# per thread (and asyncio task), so concurrent forwards do not see each other's.
_INTERCEPT: contextvars.ContextVar = contextvars.ContextVar("intercept_linear", default=None)


@contextlib.contextmanager
def intercept_linear(fn: Callable) -> Iterator[None]:
    """Within the context, each :meth:`Linear.forward` first calls
    ``fn(linear, x, dtype)``: a tensor it returns is the layer's output,
    None runs the layer's own product. Contexts nest; the inner one rules."""
    token = _INTERCEPT.set(fn)
    try:
        yield
    finally:
        _INTERCEPT.reset(token)


class Linear(nn.Module):
    """``weight`` of ``shape`` (out, *in); the product flattens ``in``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 weight_shape: Optional[Tuple[int, ...]] = None) -> None:
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.empty(weight_shape or (out_features, in_features)))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        fn = _INTERCEPT.get()
        if fn is not None:
            y = fn(self, x, dtype)
            if y is not None:
                return y
        if getattr(self.weight, "_shard", None) is not None:
            from vit_tpu_torch.parallel.tensor import column_parallel

            return column_parallel(x, self.weight, self.bias, dtype, self.in_features)
        return dense(x, self.weight.reshape(-1, self.in_features), self.bias, dtype)

    def init_(self, g: torch.Generator) -> None:
        init_normal_(self.weight, KERNEL_STD, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class DenseHolder(nn.Module):
    """Holds one :class:`Linear` as ``dense``: the HF key level of
    ``attention.output.dense``, ``intermediate.dense`` and ``output.dense``."""

    def __init__(self, in_features: int, out_features: int) -> None:
        super().__init__()
        self.dense = Linear(in_features, out_features)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-12, dtype=dtype)``: fp32 statistics
    (E[x²] - E[x]², clipped at 0), fp32 affine, one rounding to ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype, eps: float = LN_EPS) -> None:
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min(xf.square().mean(dim=-1, keepdim=True) - mu.square(), 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mu) * mul + self.bias.float()).to(self.dtype)

    def init_(self, g: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


def init_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=g)
