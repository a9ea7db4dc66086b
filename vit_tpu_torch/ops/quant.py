"""Post-training int8 quantization for serving (port of ``vit_tpu/ops/quant.py``).

Scheme, as in ``vit_tpu`` (symmetric, LLM.int8-style):

* **Weights**: per-output-channel int8. A :class:`~vit_tpu_torch.models.
  layers.Linear` weight ``W`` is (N, K) here, torch's (out, in) layout, so
  ``scale_n = max(max_k |W[n, :]|, 1e-12) / 127`` and ``wq = round(W /
  scale)`` clipped to +-127, an (N, K) int8 tensor. Quantized once, at load.
* **Activations**: dynamic per-row int8, ``sx = max(max_k |x|, 1e-12) / 127``
  per row, or one calibrated scalar (:func:`calibrate_activation_scales`).
  Rounding is half to even, as ``jnp.round``'s.
* **Product**: ``torch._int_mm(xq, wq.t())``, int8 x int8 -> int32 on the
  card's int8 tensor cores (``vit_tpu``'s is XLA's int8 ``dot_general``,
  outside any Pallas kernel), then ``y_int32.float() * (sx * scale) + bias``
  in fp32, returned in the incoming x's dtype.
* **Weight-only** (``int8-wo``): ``(wq * scale)`` in the layer's compute
  dtype, the product in that dtype, then the bias, back to x's dtype.

What is quantized: every ``Linear`` with a 2-D weight whose fan-in is at
least ``min_fan_in``, except those whose qualified module name holds a
component of :data:`DEFAULT_EXCLUDE`: the task head (``classifier`` /
``regressor``), the covariance ``preprocessor`` and the MoE ``router``, as
``vit_tpu`` excludes them. The side table is keyed by the ``Linear``'s
qualified name (``vit.encoder.layer.0.attention.attention.query``).

Integration: :meth:`Linear.forward` is the one chokepoint of every dense
layer (:func:`~vit_tpu_torch.models.layers.intercept_linear`), so the
model's own forward runs and only the quantized layers' products change.
The fused MLP and fused QKV read their weights directly and are not
intercepted: a quantized :class:`~vit_tpu_torch.serve.Predictor` refuses
them, and ``from_checkpoint`` rebuilds with both off.

``torch._int_mm`` on CUDA takes more than 16 rows and K and N multiples of
8. Fewer rows are padded with zero rows up to 17 (rows are independent, so
the result is exact); a K or N it cannot take raises (no float fallback).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from vit_tpu_torch.models.layers import Linear, intercept_linear

__all__ = [
    "quantize_dense_params",
    "int8_dense",
    "int8_dense_weight_only",
    "int8_matmul",
    "strip_quantized",
    "quantized_apply",
    "quantized_interceptor",
    "quantized_size_bytes",
    "calibrate_activation_scales",
    "W8A8_WO_BATCH_THRESHOLD",
    "DEFAULT_EXCLUDE",
    "INT_MM_MIN_ROWS",
]

# vit_tpu's routing threshold for an uncalibrated quantize="int8" (batch
# size, in samples): dynamic W8A8 below it, weight-only at or above it. Kept
# as it is, so both packages pick the same variant; PERF.md has the
# H100's measurement of the crossover.
W8A8_WO_BATCH_THRESHOLD = 64

# Module-name components whose Linear layers are never quantized.
DEFAULT_EXCLUDE: Tuple[str, ...] = ("classifier", "regressor", "preprocessor", "router")

INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows

Table = Dict[str, Dict[str, Optional[torch.Tensor]]]


def quantize_dense_params(module: torch.nn.Module, min_fan_in: int = 64,
                          exclude: Tuple[str, ...] = DEFAULT_EXCLUDE) -> Table:
    """The int8 side table of ``module``: ``{qualified name: {"wq": int8 (N,
    K), "scale": fp32 (N,), "bias": fp32 (N,) or None}}`` for every
    :class:`Linear` with a 2-D weight, fan-in ``K >= min_fan_in`` and no
    excluded name component, on the weights' device."""
    table: Table = {}
    for name, mod in module.named_modules():
        if not isinstance(mod, Linear) or mod.weight.dim() != 2:
            continue
        if mod.in_features < min_fan_in or set(name.split(".")) & set(exclude):
            continue
        with torch.no_grad():
            w = mod.weight.detach().float()
            scale = torch.clamp_min(w.abs().amax(dim=1), 1e-12) / 127.0
            wq = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
            bias = None if mod.bias is None else mod.bias.detach().float().clone()
        table[name] = {"wq": wq, "scale": scale, "bias": bias}
    return table


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq @ wq.T`` in int32 by ``torch._int_mm``: ``xq`` (..., K) int8,
    ``wq`` (N, K) int8. Fewer than :data:`INT_MM_MIN_ROWS` rows are padded
    with zeros up to it; on the card, a K or N not a multiple of 8 raises."""
    k, n = xq.shape[-1], wq.shape[0]
    if wq.shape[1] != k:
        raise ValueError(f"int8_matmul: x has K={k}, the weight {tuple(wq.shape)}")
    if xq.is_cuda and (k % 8 or n % 8):
        raise ValueError(f"torch._int_mm on CUDA takes K and N multiples of 8: K={k}, N={n}")
    x2 = xq.reshape(-1, k)
    rows = x2.shape[0]
    if rows < INT_MM_MIN_ROWS:
        x2 = torch.cat([x2, x2.new_zeros(INT_MM_MIN_ROWS - rows, k)])
    y = torch._int_mm(x2, wq.t())
    return y[:rows].reshape(*xq.shape[:-1], n)


def int8_dense(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               sx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 dense layer: int8 activations (dynamic per-row scale, or the
    static scalar ``sx``) times the int8 weight, int32 sums, rescaled in
    fp32, plus the bias; in x's dtype."""
    xf = x.float()
    if sx is None:
        sx = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-12) / 127.0
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    y = int8_matmul(xq, wq).float() * (sx * scale)
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def int8_dense_weight_only(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Weight-only int8 dense layer: the weight dequantized in
    ``compute_dtype`` (the layer's), the product and bias there, in x's dtype."""
    c = compute_dtype
    w = wq.to(c) * scale.to(c)[:, None]
    y = torch.matmul(x.to(c), w.t())
    if bias is not None:
        y = y + bias.to(c)
    return y.to(x.dtype)


def quantized_interceptor(module: torch.nn.Module, qtable: Mapping[str, Mapping],
                          weight_only: bool = False,
                          observe: Optional[Callable] = None) -> Callable:
    """The :func:`~vit_tpu_torch.models.layers.intercept_linear` function
    that computes ``module``'s quantized layers from ``qtable``;
    ``observe(name, x)`` is called first for each of them."""
    names = {mod: name for name, mod in module.named_modules() if name in qtable}

    def interceptor(lin, x, dtype):
        name = names.get(lin)
        if name is None:
            return None
        if observe is not None:
            observe(name, x)
        q = qtable[name]
        if weight_only:
            return int8_dense_weight_only(x, q["wq"], q["scale"], q["bias"], compute_dtype=dtype)
        return int8_dense(x, q["wq"], q["scale"], q["bias"], sx=q.get("sx"))

    return interceptor


@torch.no_grad()
def calibrate_activation_scales(module: torch.nn.Module, qtable: Mapping[str, Mapping], *args,
                                margin: float = 1.0, **kwargs) -> Table:
    """One calibration forward (W8A8 active, so each layer sees its serving
    input) recording ``max|x|`` per quantized layer as a device tensor (no
    read-back); returns a new table whose entries carry ``sx = max(max|x|,
    1e-12) * (margin / 127)`` as a 0-d fp32 tensor. Inputs past the
    calibrated range saturate at +-127."""
    maxima: Dict[str, torch.Tensor] = {}

    def observe(name, x):
        m = x.float().abs().amax()
        maxima[name] = m if name not in maxima else torch.maximum(maxima[name], m)

    with intercept_linear(quantized_interceptor(module, qtable, observe=observe)):
        module(*args, **kwargs)
    out: Table = {}
    for name, entry in qtable.items():
        e = dict(entry)
        if name in maxima:
            e["sx"] = (torch.clamp_min(maxima[name], 1e-12) * (float(margin) / 127.0)).float()
        out[name] = e
    return out


def quantized_apply(module: torch.nn.Module, qtable: Mapping[str, Mapping], *args,
                    weight_only: bool = False, **kwargs):
    """``module(*args, **kwargs)`` with its quantized layers computed from
    ``qtable`` (W8A8, or weight-only with ``weight_only=True``)."""
    with intercept_linear(quantized_interceptor(module, qtable, weight_only)):
        return module(*args, **kwargs)


def strip_quantized(module: torch.nn.Module, qtable: Mapping[str, Mapping]) -> torch.nn.Module:
    """Replace the fp32 weight of each quantized layer with a (1, 1)
    placeholder, in place, so it leaves the device memory; the quantized
    forward never reads it (an unintercepted call fails on its shape)."""
    for name, mod in module.named_modules():
        if name in qtable:
            w = mod.weight
            mod.weight = torch.nn.Parameter(torch.zeros(1, 1, dtype=w.dtype, device=w.device),
                                            requires_grad=False)
    return module


def quantized_size_bytes(qtable: Mapping[str, Mapping]) -> int:
    """Total bytes of the int8 table (weights, scales, biases, ``sx``)."""
    return sum(t.numel() * t.element_size() for entry in qtable.values()
               for t in entry.values() if t is not None)
