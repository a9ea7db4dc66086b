"""Multi-head self-attention (port of ``vit_tpu/models/attention.py``).

Kernel dispatch (``impl``), resolved by :func:`select_attn_impl` exactly as
in ``vit_tpu``:

* ``"xla"``   — scores by ``torch.matmul`` in fp32 (or ``softmax_dtype``),
  softmax, probabilities cast to the compute dtype before P·V. This is the
  plain path XLA computes outside any Pallas kernel.
* ``"flash"`` — :func:`vit_tpu_torch.ops.flash_attention.flash_attention`:
  the hand-written CUDA kernels for a tensor on the card.
* ``"auto"``  — flash from T >= 1024 with head_dim >= 64, else xla.

Parameter names follow the HF layout the torch bridge writes:
``attention.{query,key,value}`` and ``output.dense``.

Training (``vit_tpu/models/attention.py:180-281``): given two int32 seeds
in training mode, the flash path drops probabilities inside the kernels at
``dropout_rate``; the xla path applies :func:`hash_dropout` to the
(B, H, T, T) probabilities after their cast to the compute dtype (the 4-D
coordinate-hash stream, not the kernels' one); the projected output is
dropped at ``out_dropout_rate`` (HF drops it at the hidden rate). In eval
mode, or without seeds, dropout is the identity.

Diagnostics capture (``vit_tpu/models/attention.py:182-186,245-261``): given
a ``capture`` dict, the forward stores the batch-mean probabilities
``(H, T, T)`` in fp32 under ``attention_probs``. The flash path has no
probabilities to give, so under capture it takes the xla math, as in
``vit_tpu``; so does ``ring``.

``"ring"`` (``vit_tpu/models/attention.py:182-220``): sequence-parallel
exact attention (:func:`vit_tpu_torch.ops.ring_attention.ring_attention`)
over the active mesh's ``model`` axis (``train.sequence_parallel``), with
in-ring dropout at global coordinates (the batch rows from the
:func:`~vit_tpu_torch.ops.dropout.batch_offset` in force); it needs the
active mesh and ``seq_len % sp == 0``. ``ring_block_k`` sets its key-block
width.

Under tensor parallelism (:mod:`vit_tpu_torch.parallel.tensor`) the
projections run column-parallel and the attention itself sees whole
heads, as GSPMD gathers q, k, v in front of ``vit_tpu``'s kernel; the
fused QKV product reads its weights whole.

RoPE (``use_rope``, ``vit_tpu/models/attention.py:175-178``): q and k are
rotated after the head split and before the route is chosen, so the flash
kernels, the xla math, ``fused_qkv`` and the capture all see rotated q and
k. Positions count the CLS token as position 0; the tables are cast to q's
dtype first (:mod:`vit_tpu_torch.models.rope`).

``fast_dropout: false`` (``attention.py:283-289``): the output and the xla
route's probabilities take ``nn.Dropout`` masks from their sites' seeds
(:func:`stream_dropout`); the flash route keeps its in-kernel hash mask,
as in ``vit_tpu`` whatever ``fast_dropout`` says.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from vit_tpu_torch.models.layers import DenseHolder, Linear, dense
from vit_tpu_torch.models.rope import apply_rope, rope_tables
from vit_tpu_torch.ops.dropout import site_dropout
from vit_tpu_torch.parallel.tensor import full_param

__all__ = ["MultiHeadSelfAttention", "select_attn_impl"]

_SOFTMAX_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}


def select_attn_impl(impl: str, seq_len: int, head_dim: int) -> str:
    """Resolve ``auto`` to a concrete kernel for this shape (backend-independent).

    The crossover is ``vit_tpu``'s: flash from T=1024 with head_dim >= 64.
    """
    if impl == "auto":
        impl = "flash" if (seq_len >= 1024 and head_dim >= 64) else "xla"
    return impl


class _QKV(nn.Module):
    def __init__(self, hidden: int, bias: bool) -> None:
        super().__init__()
        self.query = Linear(hidden, hidden, bias)
        self.key = Linear(hidden, hidden, bias)
        self.value = Linear(hidden, hidden, bias)


class MultiHeadSelfAttention(nn.Module):
    """QKV projection + attention kernel + output projection."""

    def __init__(self, hidden_size: int, num_heads: int, impl: str = "auto",
                 dtype: torch.dtype = torch.float32, qkv_bias: bool = True,
                 use_rope: bool = False, softmax_dtype: Optional[str] = None,
                 fused_qkv: bool = False, dropout_rate: float = 0.0, *,
                 out_dropout_rate: float, rope_base: float = 10000.0,
                 fast_dropout: bool = True, ring_block_k: Optional[int] = None) -> None:
        super().__init__()
        if hidden_size % num_heads != 0:
            raise ValueError(f"hidden_size {hidden_size} not divisible by num_heads {num_heads}")
        self.ring_block_k = ring_block_k
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.impl = impl
        self.dtype = dtype
        self.use_rope = use_rope
        self.rope_base = float(rope_base)
        self.fast_dropout = fast_dropout
        self.softmax_dtype = None if softmax_dtype is None else _SOFTMAX_DTYPES[str(softmax_dtype)]
        self.fused_qkv = fused_qkv
        self.dropout_rate = float(dropout_rate)
        self.out_dropout_rate = float(out_dropout_rate)
        self.attention = _QKV(hidden_size, qkv_bias)
        self.output = DenseHolder(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor, seeds: Optional[Sequence[int]] = None,
                capture: Optional[dict] = None) -> torch.Tensor:
        """``seeds``: (probabilities, output) dropout seeds, used in training
        mode only. ``capture``: a dict that receives ``attention_probs``."""
        b, t, _ = x.shape
        dt = self.dtype
        p = self.attention

        def split_heads(y):  # (B, T, D) -> (B, H, T, d)
            return y.view(b, t, self.num_heads, self.head_dim).transpose(1, 2)

        if self.fused_qkv:
            w = torch.cat([full_param(lin.weight) for lin in (p.query, p.key, p.value)], dim=0)
            bias = None
            if p.query.bias is not None:
                bias = torch.cat([p.query.bias, p.key.bias, p.value.bias])
            q, k, v = (split_heads(y) for y in dense(x, w, bias, dt).split(self.hidden_size, -1))
        else:
            q, k, v = (split_heads(lin(x, dt)) for lin in (p.query, p.key, p.value))
        if self.use_rope:
            cos, sin = rope_tables(t, self.head_dim, base=self.rope_base, dtype=q.dtype,
                                   device=q.device)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)

        drop = self.training and seeds is not None
        impl = select_attn_impl(self.impl, t, self.head_dim)
        if impl == "ring" and capture is None:
            context = self._ring(q, k, v, seeds[0] if drop and self.dropout_rate > 0 else None)
        elif impl == "flash" and capture is None:
            from vit_tpu_torch.ops.flash_attention import flash_attention

            if drop and self.dropout_rate > 0:
                context = flash_attention(q, k, v, dropout_rate=self.dropout_rate,
                                          dropout_seed=seeds[0])
            else:
                context = flash_attention(q, k, v)
        elif impl in ("xla", "flash", "ring"):
            acc = self.softmax_dtype or torch.float32
            scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
            probs = torch.softmax(scores * torch.tensor(self.head_dim**-0.5, dtype=acc), dim=-1)
            if capture is not None:
                # Batch mean on the device: one layer's (B, H, T, T) is live
                # at a time, and fp32 under any softmax dtype.
                capture["attention_probs"] = probs.mean(0).float()
            probs = probs.to(dt)
            if drop:
                probs = site_dropout(probs, self.dropout_rate, seeds[0], self.fast_dropout)
            context = torch.matmul(probs, v)
        else:
            raise ValueError(f"Unknown attention impl '{impl}'")

        context = context.transpose(1, 2).reshape(b, t, self.hidden_size)
        out = self.output.dense(context, dt)
        if drop:
            out = site_dropout(out, self.out_dropout_rate, seeds[1], self.fast_dropout)
        return out

    def _ring(self, q, k, v, seed) -> torch.Tensor:
        """The ring over the active mesh's ``model`` axis, with ``vit_tpu``'s
        checks; ``seed``: the probabilities' dropout seed, or None."""
        from vit_tpu_torch.ops.ring_attention import ring_attention
        from vit_tpu_torch.parallel.mesh import active_mesh

        mesh = active_mesh()
        if mesh is None:
            raise RuntimeError(
                "attn_impl='ring' needs the training mesh: Experiment sets it; library "
                "users call vit_tpu_torch.parallel.mesh.set_active_mesh(mesh) first")
        sp = mesh.size("model")
        t = q.shape[2]
        if t % max(sp, 1) != 0:
            raise ValueError(
                f"attn_impl='ring': sequence length {t} (incl. CLS) must divide by the "
                f"'model' mesh axis ({sp}); choose image/patch/stride so num_patches+1 is a "
                "multiple of train.sequence_parallel")
        # The rank's batch rows start at the dropout batch offset in force.
        return ring_attention(q, k, v, mesh, axis="model",
                              dropout_rate=self.dropout_rate if seed is not None else 0.0,
                              dropout_seed=seed, block_k=self.ring_block_k)
