"""KPCA-warm multi-head self-attention (port of ``vit_tpu/prepca/attention.py``).

Q and K come from the *frozen* Nyström-KPCA features of the input
(``Z = KPCA.transform(x)``) through small trainable adapters initialised
near identity; V and the output projection are standard. Library code, as
in ``vit_tpu`` and the reference: exported, not wired into the ViT.

The KPCA state's landmarks, ``A``, row means and ``K_mean`` are
non-persistent buffers (constants of the module, as the state is an
attribute of the flax module), so ``state_dict()`` holds the four
``nn.Linear``s alone and loads strictly from
:func:`vit_tpu_torch.train.torch_bridge.from_flax_kpca_attention`.
Gradients reach ``x`` through the features, as under ``jax.grad``. The
scores are float32 and the attention is plain PyTorch, as ``vit_tpu``'s
is plain einsum + softmax (no Pallas kernel); it also returns the
probabilities on ``need_weights``, which K1 does not.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from vit_tpu_torch.prepca.pipeline import KernelPCAState, kpca_features
from vit_tpu_torch.serve import resolve_device

__all__ = ["KPCAWarmSelfAttention"]


def _near_identity_init(num_heads: int, d_k: int, in_dim: int) -> np.ndarray:
    """The strided near-identity adapter weight, torch layout
    (num_heads * d_k, in_dim): row (h, i) picks input ``min(i * step, in_dim - 1)``."""
    W = np.zeros((num_heads, d_k, in_dim), dtype=np.float32)
    step = max(1, in_dim // d_k)
    for h in range(num_heads):
        for i in range(d_k):
            W[h, i, min(i * step, in_dim - 1)] = 1.0
    return W.reshape(num_heads * d_k, in_dim)


def _lecun_normal_(w: torch.Tensor, g: Optional[torch.Generator]) -> None:
    """flax's default Dense kernel init: a normal truncated at two standard
    deviations, scaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g).mul_(std)


class KPCAWarmSelfAttention(nn.Module):
    """MHSA with Q/K from frozen KPCA features through trainable adapters.

    The module is built on ``device`` (the card unless ``"cpu"`` is asked
    for; raises without CUDA). ``kpca_state``'s rbf gamma is resolved once,
    on the state's device, if it is None. ``generator`` seeds the V and
    output projections' init."""

    def __init__(self, dim: int, num_heads: int, kpca_state: KernelPCAState,
                 qk_dim: Optional[int] = None, use_bias: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        self.dim = dim
        self.num_heads = num_heads
        r = kpca_state.r
        self.d_k = qk_dim if qk_dim is not None else max(1, (r + num_heads - 1) // num_heads)
        self.kernel = dict(kernel_name=kpca_state.kernel_name, gamma=kpca_state.resolve_gamma(),
                           degree=kpca_state.degree, coef0=kpca_state.coef0)
        for name, t in kpca_state.tensors("cpu").items():
            self.register_buffer(name, t, persistent=False)
        self.register_buffer("K_mean", torch.tensor(kpca_state.K_mean, dtype=torch.float32),
                             persistent=False)
        width = num_heads * self.d_k
        self.q_adapter = nn.Linear(r, width, bias=use_bias)
        self.k_adapter = nn.Linear(r, width, bias=use_bias)
        self.v_proj = nn.Linear(dim, width, bias=use_bias)
        self.out_proj = nn.Linear(width, dim, bias=use_bias)
        ident = torch.from_numpy(_near_identity_init(num_heads, self.d_k, r))
        with torch.no_grad():
            self.q_adapter.weight.copy_(ident)
            self.k_adapter.weight.copy_(ident)
        _lecun_normal_(self.v_proj.weight, generator)
        _lecun_normal_(self.out_proj.weight, generator)
        for lin in (self.q_adapter, self.k_adapter, self.v_proj, self.out_proj):
            if lin.bias is not None:
                nn.init.zeros_(lin.bias)
        self.to(dev)

    def forward(self, x: torch.Tensor, need_weights: bool = False):
        batch, length, _ = x.shape
        H, d_k = self.num_heads, self.d_k
        z = kpca_features(x.reshape(-1, x.shape[-1]), self.landmarks, self.A, self.row_means,
                          self.K_mean, **self.kernel).reshape(batch, length, -1)

        def split(t):
            return t.reshape(batch, length, H, d_k).transpose(1, 2)

        q, k, v = split(self.q_adapter(z)), split(self.k_adapter(z)), split(self.v_proj(x))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = torch.softmax(scores / (d_k**0.5), dim=-1)
        ctx = torch.matmul(probs.to(v.dtype), v)
        out = self.out_proj(ctx.transpose(1, 2).reshape(batch, length, H * d_k))
        return (out, probs) if need_weights else out
