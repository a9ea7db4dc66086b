"""Rotary position embeddings, rotate-half layout (port of
``vit_tpu/models/rope.py``).

Plain torch: ``vit_tpu`` computes RoPE in jnp, outside any Pallas kernel,
and so does the port, in front of the attention kernels. The tables are
built in fp32 and cast to the caller's dtype before the rotation, so a
bf16 model rotates in bf16 as ``vit_tpu`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rope_tables", "apply_rope", "apply_rope_qk"]


def rope_tables(seq_len: int, dim: int, base: float = 10000.0,
                dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` of shape ``(seq_len, dim)``: frequencies
    ``base**(-2i/dim)``, each repeated twice for the rotate-half layout."""
    if dim % 2 != 0:
        raise ValueError(f"RoPE dim must be even, got {dim}")
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                               / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)  # (T, dim/2)
    emb = torch.cat([freqs, freqs], dim=-1)  # (T, dim)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., T, dim) by position; the tables broadcast over the
    leading dimensions."""
    return x * cos + _rotate_half(x) * sin


def apply_rope_qk(q: torch.Tensor, k: torch.Tensor,
                  base: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k, both (..., T, dim), with tables in q's dtype."""
    cos, sin = rope_tables(q.shape[-2], q.shape[-1], base=base, dtype=q.dtype, device=q.device)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)
