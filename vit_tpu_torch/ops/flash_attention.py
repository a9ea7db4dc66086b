"""Exact softmax attention, forward and backward: CUDA kernels and their plain versions.

Port of ``vit_tpu/ops/flash_attention.py::flash_attention`` with its
``custom_vjp``: in-kernel hash dropout on the probabilities and the flash
backward. ``q, k, v`` are (B, H, T, d) in and out, as there. The same
dispatch rule picks the kernels: T rounded up to 128 at most 512 takes the
short kernels, longer sequences the streaming ones.

* K1 forward, ``csrc/flash_fwd.cu``, replaces ``_flash_fwd_kernel``;
* K2 short forward, ``csrc/short_fwd.cu``, replaces ``_short_fwd_kernel``
  (K1 and K2 run their products on the tensor cores in bf16,
  ``csrc/attn_fwd_tc.cuh``, and on the fp32 FMA units in fp32);
* K4 + K5, the streaming backward, ``csrc/flash_bwd.cu``, replaces
  ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` with one kernel:
  in bf16 one pass over each (head, key block) that forms S, dP, the exp
  and the dropout hash once an element and sums dQ across key blocks in a
  fixed order through an fp32 workspace (``csrc/attn_bwd_fused_tc.cuh``;
  :func:`bwd_scratch` sizes it); in fp32 two passes on the FMA units;
* K6 short backward, ``csrc/short_bwd.cu``, replaces ``_short_bwd_kernel``
  (its bf16 passes on the tensor cores, ``csrc/attn_bwd_tc.cuh``).

None pads: T and d are used as they are, the kernels mask the ragged edge
themselves, and d is one of 16, 32, 64, 128. They compute what the Pallas
kernels compute: the scale folded into q in the input dtype, fp32 scores
and softmax statistics, keys at or past T at -1e30, the (dropped-out)
probabilities cast to the input dtype before P·V with fp32 accumulation,
and the per-row logsumexp returned beside O for the backward. Dropout
multiplies P by the keep mask of the global (seed, bh, row, col)
(:mod:`vit_tpu_torch.ops.dropout`) after the denominator has summed the
unmasked P. The backward forms ``delta = rowsum(dO·O)`` in fp32 with plain
torch, as XLA does outside the kernels, and the kernels re-derive P from
the lse.

Each wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its kernel for a tensor on the card; nothing else switches. The
plain versions walk the key tiles their kernels walk.

The dropout seed is a Python int or a 0-d integer tensor on the card. The
kernels read it from device memory (the Pallas kernels read ``seed_ref``
from SMEM), so no wrapper reads a seed back to the host and a captured CUDA
graph replays with whatever seed its buffer holds: an int becomes a device
scalar once, at the wrapper (:func:`~vit_tpu_torch.ops.dropout.device_seed`),
and :class:`_Attention` saves that scalar for the backward pass.

A stacked sweep (:mod:`vit_tpu_torch.opt.parallel_sweep`) runs R replicas
at once: every wrapper takes an (R,) seed vector with ``bh_per_seed``, the
heads of one replica, and head ``bh`` then hashes ``(seed[bh //
bh_per_seed], bh % bh_per_seed)``, what each replica draws alone.
:class:`_Attention` has a ``torch.func.vmap`` rule that folds the replica
axis into the heads, one launch for all replicas with their seeds; so
``vmap`` over R replicas gives what R single calls give, mask for mask.

A data-parallel rank holds rows ``[b0, b0 + B)`` of the global batch and
draws its rows of the one-device mask: every wrapper takes ``bh_offset =
b0·H``, the launch's first global head, and head ``bh`` hashes ``bh %
bh_per_seed + bh_offset`` (a kernel argument: it is fixed for a rank, so a
captured graph replays with it). :func:`flash_attention` reads ``b0`` from
:func:`~vit_tpu_torch.ops.dropout.batch_offset`.

Serving (no gradient, no ``vmap``) calls K1 and K2 through the custom
operators ``torch.ops.vit_tpu_torch.flash_fwd`` and ``short_fwd``
(``torch.library.custom_op``, with fake versions that give the output
shapes), so ``torch.export`` traces a served model with each launch as one
opaque node (:mod:`vit_tpu_torch.export`). Their CUDA implementation is
the launch, their CPU implementation the plain version; a process that
loads an exported program imports this module to register them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vit_tpu_torch.func_internals import is_batched
from vit_tpu_torch.ops._build import KERNELS
from vit_tpu_torch.ops.dropout import (
    attention_keep_mask,
    current_batch_offset,
    device_seed,
    keep_params,
)

__all__ = [
    "flash_attention",
    "flash_fwd",
    "short_fwd",
    "flash_bwd",
    "short_bwd",
    "flash_fwd_plain",
    "short_fwd_plain",
    "flash_bwd_plain",
    "short_bwd_plain",
    "bwd_scratch",
    "SHORT_T_MAX",
]

NEG_INF = -1e30
SHORT_T_MAX = 512  # padded lengths up to this take the short kernels
FLASH_BLOCK_K = 64  # key tile of flash_fwd.cu; the plain version walks the same tiles
BWD_BLOCK_K = 64  # key tile of the backward's sums; flash_bwd_plain walks these
BWD_BLOCK_Q = 64  # query tile of the bf16 flash backward: its dQ workspace rows and counters
HEAD_DIMS = (16, 32, 64, 128)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale in q's dtype (rounded there, as the Pallas kernels do)."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _keep(bh: int, rows: Tuple[int, int], cols: Tuple[int, int], seed, rate: float,
          device, bh_per_seed: int = 0, bh_offset: int = 0) -> torch.Tensor:
    """(BH, rows, cols) fp32 keep factors at global coordinates; with an (R,)
    ``seed``, head ``i`` takes seed ``i // bh_per_seed`` and hashes
    ``i % bh_per_seed``; every head hashes ``bh_offset`` more."""
    r = torch.arange(*rows, dtype=torch.int64, device=device)[None, :, None]
    c = torch.arange(*cols, dtype=torch.int64, device=device)[None, None, :]
    heads = torch.arange(bh, dtype=torch.int64, device=device)[:, None, None]
    if isinstance(seed, torch.Tensor) and seed.dim() == 1:
        per = bh_per_seed or bh
        seed, heads = seed.to(device)[heads // per], heads % per
    return attention_keep_mask(r, c, heads + bh_offset, seed, rate)


def short_fwd_plain(q, k, v, scale: float, rate: float = 0.0, seed=0,
                    bh_per_seed: int = 0, bh_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass softmax attention over the whole row: (o (BH,T,d), lse (BH,T))."""
    bh, t, _ = q.shape
    s = torch.matmul(_scaled_q(q, scale).float(), k.float().transpose(1, 2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        p = p * _keep(bh, (0, t), (0, t), seed, rate, q.device, bh_per_seed, bh_offset)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_fwd_plain(q, k, v, scale: float, rate: float = 0.0, seed=0,
                    bh_per_seed: int = 0, bh_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online softmax over key tiles of ``FLASH_BLOCK_K``, as the kernel walks
    them: (o (BH,T,d), lse (BH,T))."""
    bh, t, d = q.shape
    qs = _scaled_q(q, scale).float()
    m = torch.full((bh, t, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, t, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, t, d), dtype=torch.float32, device=q.device)
    for j0 in range(0, t, FLASH_BLOCK_K):
        j1 = min(t, j0 + FLASH_BLOCK_K)
        s = torch.matmul(qs, k[:, j0:j1].float().transpose(1, 2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)  # unmasked P
        if rate > 0.0:
            p = p * _keep(bh, (0, t), (j0, j1), seed, rate, q.device, bh_per_seed, bh_offset)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), v[:, j0:j1].float())
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _bwd_tile(q, k, v, do, lse, delta, scale, rate, seed, j0, j1, bh_per_seed=0, bh_offset=0):
    """(P*M/keep, ds) of key columns [j0, j1) for every row, fp32."""
    s = torch.matmul(_scaled_q(q, scale).float(), k[:, j0:j1].float().transpose(1, 2))
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), v[:, j0:j1].float().transpose(1, 2))
    pm = p
    if rate > 0.0:
        keep = _keep(q.shape[0], (0, q.shape[1]), (j0, j1), seed, rate, q.device, bh_per_seed,
                     bh_offset)
        pm, dp = p * keep, dp * keep
    return pm, p * (dp - delta[..., None])


def flash_bwd_plain(q, k, v, do, lse, delta, scale: float, rate: float = 0.0, seed=0,
                    bh_per_seed: int = 0, bh_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 and K5's function: (dq, dk, dv) over key tiles of ``BWD_BLOCK_K``.
    dK is scale * ds^T q with q as it is (``_flash_bwd_dkv_kernel``)."""
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for j0 in range(0, q.shape[1], BWD_BLOCK_K):
        j1 = min(q.shape[1], j0 + BWD_BLOCK_K)
        pm, ds = _bwd_tile(q, k, v, do, lse, delta, scale, rate, seed, j0, j1, bh_per_seed,
                           bh_offset)
        dq_acc = dq_acc + torch.matmul(ds.to(k.dtype).float(), k[:, j0:j1].float())
        dv[:, j0:j1] = torch.matmul(pm.to(do.dtype).float().transpose(1, 2), do.float())
        dk[:, j0:j1] = torch.matmul(ds.to(q.dtype).float().transpose(1, 2), q.float()) * scale
    return (dq_acc * scale).to(q.dtype), dk, dv


def short_bwd_plain(q, k, v, do, lse, delta, scale: float, rate: float = 0.0, seed=0,
                    bh_per_seed: int = 0, bh_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 over the whole row: (dq, dk, dv), with dK = ds^T (q*scale rounded)
    and no final scale (``_short_bwd_kernel``)."""
    t = q.shape[1]
    pm, ds = _bwd_tile(q, k, v, do, lse, delta, scale, rate, seed, 0, t, bh_per_seed, bh_offset)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    dv = torch.matmul(pm.to(do.dtype).float().transpose(1, 2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(1, 2), _scaled_q(q, scale).float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(q, k, v) -> None:
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"q, k, v must share one (BH, T, d) shape: {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must all be float32 or bfloat16: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} is not one of {HEAD_DIMS}")


def _check_bwd(q, do, lse, delta) -> None:
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dout must match q: {do.shape} {do.dtype}, {q.shape} {q.dtype}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != q.shape[:2] or x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"{name} must be float32 (BH, T) beside q: {x.shape} {x.dtype}")
    if not (do.is_contiguous() and lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError("dout, lse and delta must be contiguous")


def _dropout_args(rate: float, seed: Optional[torch.Tensor], bh: int,
                  bh_per_seed: int, bh_offset: int) -> tuple:
    """(on, seed pointer, heads per seed, first global head, threshold,
    1/keep) for the kernels; ``seed`` the device seeds of :func:`_kernel_seed`
    (None without dropout)."""
    if rate <= 0.0:
        return 0, None, 0, 0, 0, 1.0
    threshold, inv_keep = keep_params(rate)
    return 1, seed.data_ptr(), bh_per_seed or bh, int(bh_offset), threshold, inv_keep


def _kernel_seed(seed, rate: float, device, bh: int,
                 bh_per_seed: int) -> Optional[torch.Tensor]:
    """The int32 device seeds the kernels read (None without dropout): a
    scalar, or one per ``bh_per_seed`` heads."""
    if rate <= 0.0:
        return None
    seed = device_seed(seed, device)
    if seed.device != torch.device(device):
        raise ValueError(f"the dropout seed lies on {seed.device}, the inputs on {device}")
    if seed.numel() * (bh_per_seed or bh) != bh:
        raise ValueError(f"{seed.numel()} seeds of {bh_per_seed or bh} heads each for "
                         f"{bh} heads")
    return seed


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it if its data is not 16-byte aligned (the bf16
    kernels read their inputs through TMA, which needs that)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_fwd(name: str, q, k, v, scale: float, rate: float, seed,
                bh_per_seed: int = 0, bh_offset: int = 0):
    bh, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    q, k, v = (_aligned(x) for x in (q, k, v))
    # The kernels fold scale into q in q's dtype: pass it already rounded there.
    scale_t = float(torch.tensor(scale, dtype=q.dtype))
    seed = _kernel_seed(seed, rate, q.device, bh, bh_per_seed)
    KERNELS[name].launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, t, d, scale_t, int(q.dtype == torch.bfloat16),
        *_dropout_args(rate, seed, bh, bh_per_seed, bh_offset), _stream(q),
    )
    return o, lse


def _launch_bwd(name: str, outs, q, k, v, do, lse, delta, scale: float, rate: float,
                seed, bh_per_seed: int = 0, bh_offset: int = 0) -> None:
    """Launch ``name`` once; ``outs`` its output and scratch tensors in the
    entry's order, None for a null pointer."""
    bh, t, d = q.shape
    if q.numel() == 0:
        return
    seed = _kernel_seed(seed, rate, q.device, bh, bh_per_seed)
    KERNELS[name].launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(0 if o is None else o.data_ptr() for o in outs), bh, t, d,
        float(scale),
        int(q.dtype == torch.bfloat16), *_dropout_args(rate, seed, bh, bh_per_seed, bh_offset),
        _stream(q),
    )


def _on_cpu(q) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {q.device}")


def flash_fwd(q, k, v, scale: float, rate: float = 0.0, seed=0,
              bh_per_seed: int = 0, bh_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming forward (K1): (BH, T, d) x3 -> (o, lse (BH, T) fp32).
    ``seed``: one int32, or (R,) of them with ``bh_per_seed`` = BH / R;
    ``bh_offset``: the first head's global index (module doc)."""
    _check_qkv(q, k, v)
    if _on_cpu(q):
        return flash_fwd_plain(q, k, v, scale, rate, seed, bh_per_seed, bh_offset)
    return _launch_fwd("flash_fwd", q, k, v, scale, rate, seed, bh_per_seed, bh_offset)


def short_fwd(q, k, v, scale: float, rate: float = 0.0, seed=0,
              bh_per_seed: int = 0, bh_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Short-sequence forward (K2), for T up to 512: same in and out as
    :func:`flash_fwd`."""
    if q.dim() == 3 and q.shape[1] > SHORT_T_MAX:
        raise ValueError(f"short_fwd takes T <= {SHORT_T_MAX}, got {q.shape[1]}")
    _check_qkv(q, k, v)
    if _on_cpu(q):
        return short_fwd_plain(q, k, v, scale, rate, seed, bh_per_seed, bh_offset)
    return _launch_fwd("short_fwd", q, k, v, scale, rate, seed, bh_per_seed, bh_offset)


def bwd_scratch(bh: int, t: int, d: int, dtype) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """Shapes of the bf16 flash backward's scratch, None for fp32 (which
    needs none): the fp32 dQ workspace (BH, T_pad, d), T_pad = T rounded up
    to ``BWD_BLOCK_Q``, which key block 0 of each query tile stores before
    the others add to it, and the int32 counters (BH, T_pad / BWD_BLOCK_Q),
    zero at the launch, that order those adds."""
    if dtype != torch.bfloat16:
        return None
    n_qt = -(-t // BWD_BLOCK_Q)
    return (bh, n_qt * BWD_BLOCK_Q, d), (bh, n_qt)


def flash_bwd(q, k, v, do, lse, delta, scale: float, rate: float = 0.0, seed=0,
              bh_per_seed: int = 0, bh_offset: int = 0):
    """Streaming backward, K4 and K5 as one launch: (dq, dk, dv). ``do``
    like q; ``lse`` from the forward and ``delta = rowsum(do*o)``, both
    (BH, T) fp32."""
    _check_qkv(q, k, v)
    _check_bwd(q, do, lse, delta)
    if _on_cpu(q):
        return flash_bwd_plain(q, k, v, do, lse, delta, scale, rate, seed, bh_per_seed,
                               bh_offset)
    q, k, v, do = (_aligned(x) for x in (q, k, v, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws = counters = None
    scratch = bwd_scratch(*q.shape, q.dtype)
    if scratch is not None:
        ws = torch.empty(scratch[0], dtype=torch.float32, device=q.device)
        counters = torch.zeros(scratch[1], dtype=torch.int32, device=q.device)
    _launch_bwd("flash_bwd", (dq, dk, dv, ws, counters), q, k, v, do, lse, delta, scale, rate,
                seed, bh_per_seed, bh_offset)
    return dq, dk, dv


def short_bwd(q, k, v, do, lse, delta, scale: float, rate: float = 0.0, seed=0,
              bh_per_seed: int = 0, bh_offset: int = 0):
    """Short-sequence backward (K6), T up to 512: as :func:`flash_bwd`."""
    if q.dim() == 3 and q.shape[1] > SHORT_T_MAX:
        raise ValueError(f"short_bwd takes T <= {SHORT_T_MAX}, got {q.shape[1]}")
    _check_qkv(q, k, v)
    _check_bwd(q, do, lse, delta)
    if _on_cpu(q):
        return short_bwd_plain(q, k, v, do, lse, delta, scale, rate, seed, bh_per_seed,
                               bh_offset)
    q, k, v, do = (_aligned(x) for x in (q, k, v, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("short_bwd", (dq, dk, dv), q, k, v, do, lse, delta, scale, rate, seed,
                bh_per_seed, bh_offset)
    return dq, dk, dv


@torch.library.custom_op("vit_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, rate: float,
                  seed: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as an opaque operator (the served forward): :func:`flash_fwd`."""
    return flash_fwd(q, k, v, scale, rate=rate, seed=seed)


@torch.library.custom_op("vit_tpu_torch::short_fwd", mutates_args=())
def _short_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, rate: float,
                  seed: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 as an opaque operator (the served forward): :func:`short_fwd`."""
    return short_fwd(q, k, v, scale, rate=rate, seed=seed)


@_flash_fwd_op.register_fake
@_short_fwd_op.register_fake
def _attention_fwd_fake(q, k, v, scale, rate, seed):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


def replica_first(x: torch.Tensor, dim: Optional[int], n: int) -> torch.Tensor:
    """A ``torch.func.vmap`` rule's input with its replica axis (``dim``,
    None: unbatched, so repeated) first."""
    return x.movedim(dim, 0) if dim is not None else x.expand(n, *x.shape)


class _Attention(torch.autograd.Function):
    """The kernels' forward and backward as one differentiable op on
    (BH, T, d) tensors; saves q, k, v, o, lse (``_core_fwd``) and the
    seeds' device tensor.

    Under ``torch.func.vmap`` over R replicas, :meth:`vmap` folds the replica
    axis into the heads, (R·BH, T, d), and applies this op once with the R
    replicas' seeds and ``bh_per_seed = BH``: one launch of each kernel for
    all replicas, forward and backward, each replica's masks its own."""

    @staticmethod
    def forward(q, k, v, scale: float, rate: float, seed: Optional[torch.Tensor],
                short: bool, bh_per_seed: int = 0, bh_offset: int = 0):
        return (short_fwd if short else flash_fwd)(q, k, v, scale, rate=rate, seed=seed,
                                                   bh_per_seed=bh_per_seed, bh_offset=bh_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale, rate, seed, short, bh_per_seed, bh_offset = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse, seed)
        ctx.cfg = (scale, rate, short, bh_per_seed, bh_offset)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, seed = ctx.saved_tensors
        scale, rate, short, bh_per_seed, bh_offset = ctx.cfg
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)  # XLA's D, outside the kernels
        bwd = short_bwd if short else flash_bwd
        dq, dk, dv = bwd(q, k, v, do, lse, delta, scale, rate, seed, bh_per_seed, bh_offset)
        return dq, dk, dv, None, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, scale, rate, seed, short, bh_per_seed, bh_offset):
        n = info.batch_size
        q, k, v = (replica_first(x, d, n) for x, d in zip((q, k, v), in_dims[:3]))
        r, bh, t, d = q.shape
        if seed is not None:
            if bh_per_seed or seed.dim() - (in_dims[5] is not None) != 0:
                raise ValueError("under vmap, each replica takes one 0-d dropout seed")
            seed = replica_first(seed, in_dims[5], n).contiguous()
        fold = [x.reshape(r * bh, t, d) for x in (q, k, v)]
        o, lse = _Attention.apply(*fold, scale, rate, seed, short, bh if seed is not None else 0,
                                  bh_offset)
        return (o.view(r, bh, t, d), lse.view(r, bh, t)), (0, 0)


def flash_attention(q, k, v, dropout_rate: float = 0.0,
                    dropout_seed=None) -> torch.Tensor:
    """Exact attention with scale ``d**-0.5``: (B, H, T, d) -> (B, H, T, d),
    differentiable through the backward kernels.

    ``dropout_rate > 0`` drops softmax probabilities in the kernels with the
    counter-based mask of ``dropout_seed`` (an int32, as an int or a 0-d
    tensor on q's device; required then): the same (seed, rate) always draws
    the same mask, as in ``vit_tpu``. Batch row ``i`` hashes as global row
    ``i + b0``, ``b0`` the :func:`~vit_tpu_torch.ops.dropout.batch_offset`
    in force.
    """
    rate = float(dropout_rate)
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    seed = device_seed(dropout_seed, q.device) if rate > 0.0 else None
    b, h, t, d = q.shape
    args = [x.reshape(b * h, t, d).contiguous() for x in (q, k, v)]
    short = _round_up(t, 128) <= SHORT_T_MAX
    bh_offset = current_batch_offset() * h if rate > 0.0 else 0
    if (torch.is_grad_enabled() and any(x.requires_grad for x in args)) or bh_offset or any(
            is_batched(x) for x in (*args, seed)):
        o, _ = _Attention.apply(*args, d**-0.5, rate, seed, short, 0, bh_offset)
    else:
        o, _ = (_short_fwd_op if short else _flash_fwd_op)(*args, d**-0.5, rate, seed)
    return o.view(b, h, t, d)
