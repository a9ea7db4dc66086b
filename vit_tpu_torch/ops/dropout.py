"""Counter-based hash dropout, bit for bit as ``vit_tpu`` draws it.

Port of ``vit_tpu/ops/dropout.py`` (``_coord_hash``, ``hash_keep_mask``,
``hash_dropout``) and of the attention mask of
``vit_tpu/ops/flash_attention.py`` (``_keep_threshold``, ``_fmix32``,
``_hash_bits``, ``hash_dropout_mask`` and its constants). A keep-mask is a
pure function of an int32 seed and each element's coordinates: the same
seed gives the same mask on the CPU, on the card and in ``vit_tpu``, and
a recomputed forward (activation checkpointing) draws it again exactly.

torch has no full uint32 arithmetic, so the hash runs in int64 masked to
32 bits after every step that can carry past bit 31. A product of two
32-bit values may overflow int64, but it wraps modulo 2**64 and its low 32
bits, the only ones kept, are those of the uint32 product. A negative int32
seed becomes ``seed & 0xFFFFFFFF``, as ``convert_element_type`` makes it.

A seed is a Python int or a 0-d integer tensor (a device scalar, as the
fused epoch hands them over): the tensor form runs the same arithmetic in
tensor operations, never reading the seed back to the host, and gives the
same bits. Under ``torch.func.vmap`` (the stacked sweep of
:mod:`vit_tpu_torch.opt.parallel_sweep`) a replica's seed is a 0-d tensor
and each of these functions is already per replica. An (R,) integer tensor,
one seed per replica, is that same path: :func:`_per_replica` maps the 0-d
form over it, so the masks gain a leading replica axis and replica ``r``'s
mask is the one seed ``r`` draws alone at its own coordinates, which is
what ``vit_tpu`` computes under ``jax.vmap``. The keep threshold and ``1/keep``
depend on the rate only; they are computed here on the host, once, exactly
as ``_keep_threshold`` does, and the CUDA kernels receive them as arguments
(:func:`keep_params`).

:func:`stream_dropout` is the other kind, ``nn.Dropout``'s (``model.
fast_dropout: false``): each element is kept where a uniform draw in
[0, 1) falls below ``1 - rate``. The draw is counter-based too, a function
of the call site's seed and the element's coordinates computed in tensor
operations (:func:`stream_uniform`), on a stream of its own: the start
mixes the seed with another multiplier and a salt, so the same seed gives
other bits than :func:`hash_dropout`'s. As the seed never leaves the
device, the per-step path, the fused epoch's CUDA graph, a replica of the
vmapped sweep (a 0-d seed under ``torch.func.vmap``) and remat's recompute
draw the same mask bit for bit. Its stream is the port's, not
``vit_tpu``'s: the two agree in distribution (keep rate, ``1/(1-rate)``
scaling in x's dtype), not bit for bit.
:func:`site_dropout` picks one of the two by ``fast``.

On the card :func:`hash_dropout` is one hand-written kernel,
``csrc/hash_dropout.cu``: it reads x once and writes ``x * m`` once, the
hash computed in uint32 registers, bit for bit the plain version's (the
keep factor rounded to x's dtype, the product rounded as torch rounds
``x * mask``). Its backward runs it on the incoming gradient with the same
seed, rate and offsets, so no mask is saved and remat's recompute draws it
again. It takes a CUDA tensor of 1 to 6 hashed axes in fp32, bf16 or fp16,
with an int seed (a kernel argument) or a 0-d device seed (read by the
kernel from device memory, so a captured CUDA graph replays with the seed
its buffer holds). The stacked sweep's replicas take it too, in one launch for all of
them: an (R,) seed vector, and a call under ``torch.func.vmap``
(``_HashDropout.vmap`` puts the replica axis first), hash each replica's
elements from its own seed. A CUDA tensor of another dtype or rank raises;
a CPU tensor takes the torch ops.

A data-parallel rank holds rows ``[r·B/dp, (r+1)·B/dp)`` of the global
batch. ``vit_tpu`` runs its hash masks under GSPMD, so every element is
hashed at its global coordinates and a sharded step draws the one-device
step's masks. The port's ranks compute local tensors: within
:func:`batch_offset` the model's dropout sites (:func:`site_dropout`, the
MoE jitter's :func:`stream_uniform`, the attention kernels) shift their
batch coordinate by the rank's first row, so each rank draws its rows of
the global mask. The offset is read when a site runs; a recomputed forward
(:func:`~vit_tpu_torch.models.vit.remat`) and the attention backward keep
the value their forward read.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Iterator, Optional, Sequence, Tuple

import torch

from vit_tpu_torch.func_internals import is_batched
from vit_tpu_torch.ops._build import KERNELS
from vit_tpu_torch.tracing import span

__all__ = [
    "hash_dropout",
    "hash_keep_mask",
    "hash_dropout_mask",
    "keep_params",
    "attention_keep_mask",
    "seed_u32",
    "device_seed",
    "stream_uniform",
    "stream_dropout",
    "site_dropout",
    "batch_offset",
    "current_batch_offset",
    "batch_offsets",
]

_U32 = 0xFFFFFFFF

# vit_tpu/ops/flash_attention.py:66-72: the attention mask's multipliers.
_H_ROW = 0x9E3779B1
_H_COL = 0x85EBCA6B
_H_BH = 0xC2B2AE35
_H_SEED = 0x27D4EB2F
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35

# vit_tpu/ops/dropout.py:37-39: one odd multiplier per axis, and the seed's.
_AXIS_MULTS = (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0xD3A2646D)
_SEED_MULT = 0x7FEB352D
# The nn.Dropout stream's start: the seed under another odd multiplier, plus
# a salt, so its bits are not hash_dropout's for the same seed.
_STREAM_SEED_MULT = 0x846CA68B
_STREAM_SALT = 0x5BD1E995


# The kernel's dtypes, by its dtype code, and its axes: the hashed ones and a
# replica axis.
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KERNEL_AXES = len(_AXIS_MULTS) + 1


# The first global batch row of the tensors the model's dropout sites see.
_BATCH_OFFSET: contextvars.ContextVar = contextvars.ContextVar("batch_offset", default=0)


@contextlib.contextmanager
def batch_offset(rows: int) -> Iterator[None]:
    """Within the context, the dropout sites hash batch row ``i`` as global
    row ``rows + i`` (a data-parallel rank's first row of the global batch)."""
    token = _BATCH_OFFSET.set(int(rows))
    try:
        yield
    finally:
        _BATCH_OFFSET.reset(token)


def current_batch_offset() -> int:
    return _BATCH_OFFSET.get()


def batch_offsets(ndim: int) -> Optional[Tuple[int, ...]]:
    """The coordinate offsets of a site's ``ndim``-D tensor (batch first), or
    None at offset 0."""
    rows = _BATCH_OFFSET.get()
    return None if rows == 0 else (rows,) + (0,) * (ndim - 1)


def seed_u32(seed):
    """An int32 seed as the uint32 it becomes: a Python int for an int, an
    int64 tensor (no host read) for a tensor."""
    if isinstance(seed, torch.Tensor):
        return seed.long() & _U32
    return int(seed) & _U32


def device_seed(seed, device) -> torch.Tensor:
    """A seed as the int32 device tensor the attention kernels read: a 0-d
    scalar, or an (R,) vector of one seed per replica. A tensor is cast on
    its own device (no host read); an int becomes a filled scalar on
    ``device`` (a fill, not a host-to-device copy)."""
    if isinstance(seed, torch.Tensor):
        if (seed.numel() == 0 or seed.dim() > 1 or seed.dtype.is_floating_point
                or seed.dtype == torch.bool):
            raise ValueError("a seed tensor holds one integer, or one per replica (R,): "
                             f"{seed.shape} {seed.dtype}")
        if seed.numel() > 1:
            return seed.to(torch.int32)
        return seed.reshape(()).to(torch.int32)
    value = int(seed) & _U32
    return torch.full((), value - (1 << 32) if value >= 1 << 31 else value,
                      dtype=torch.int32, device=device)


def keep_params(rate: float) -> Tuple[int, float]:
    """(uint32 threshold with P(bits < threshold) = 1 - rate, 1/keep), as
    ``_keep_threshold`` and ``1.0 / keep`` compute them."""
    keep = 1.0 - float(rate)
    return min(_U32, int(round(keep * 2.0**32))), 1.0 / keep


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * _M1) & _U32
    x = x ^ (x >> 13)
    x = (x * _M2) & _U32
    return x ^ (x >> 16)


def _hash_bits(rows, cols, bh, seed) -> torch.Tensor:
    """uint32 hash of (seed, bh, row, col), held in int64 (``_hash_bits``)."""
    x = ((rows * _H_ROW) & _U32) ^ ((cols * _H_COL) & _U32)
    # Python-int terms are reduced mod 2**32 first so no sum leaves int64.
    bh_term = (bh * _H_BH) & _U32 if isinstance(bh, torch.Tensor) else (int(bh) * _H_BH) & _U32
    x = (x + bh_term + ((seed_u32(seed) * _H_SEED) & _U32)) & _U32
    return _fmix32(x)


def _is_vector(seed) -> bool:
    return isinstance(seed, torch.Tensor) and seed.dim() == 1


def _per_replica(fn, seed, *args):
    """``fn(seed_r, *args_r)`` for each seed of an (R,) vector, stacked on a
    new leading axis (``args`` mapped along their first axis): the 0-d seed
    path under ``torch.func.vmap``, as the stacked sweep runs it."""
    return torch.func.vmap(fn)(seed, *args)


def attention_keep_mask(rows: torch.Tensor, cols: torch.Tensor, bh, seed,
                        rate: float) -> torch.Tensor:
    """fp32 keep mask (0 or 1/keep) at broadcast global (rows, cols, bh):
    what the attention kernels multiply P by. An (R,) ``seed`` adds a
    leading replica axis (``bh`` then counts within a replica)."""
    if _is_vector(seed):
        return _per_replica(lambda s: attention_keep_mask(rows, cols, bh, s, rate), seed)
    threshold, inv_keep = keep_params(rate)
    bits = _hash_bits(rows.long(), cols.long(), bh, seed)
    return torch.where(bits < threshold, inv_keep, 0.0).to(torch.float32)


def hash_dropout_mask(t_q: int, t_k: int, bh, seed, rate: float,
                      device=None) -> torch.Tensor:
    """The exact (t_q, t_k) keep-mask the attention kernels draw; ``bh`` a
    scalar, or a (BH,) tensor that adds a leading dimension; an (R,) seed
    adds a replica dimension before it."""
    rows = torch.arange(t_q, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(t_k, dtype=torch.int64, device=device)[None, :]
    if isinstance(bh, torch.Tensor) and bh.dim() == 1:
        return attention_keep_mask(rows[None], cols[None], bh.long().to(device)[:, None, None],
                                   seed, rate)
    return attention_keep_mask(rows, cols, int(bh), seed, rate)


def _coord_hash(shape: Sequence[int], seed, offsets: Optional[Sequence] = None,
                device=None, seed_mult: int = _SEED_MULT, salt: int = 0) -> torch.Tensor:
    """uint32 hash (in int64) of each element's coordinates mixed with
    ``seed``; ``offsets`` shifts each axis's coordinates (int32 each).
    ``seed_mult`` and ``salt`` set the start (``vit_tpu``'s by default)."""
    if len(shape) > len(_AXIS_MULTS):
        raise ValueError(f"hash_dropout supports up to {len(_AXIS_MULTS)} dims")
    # A 0-d start that each axis's coordinates broadcast against: the first
    # axes' steps run on small tensors and only the last axis's at full size
    # (the same bits as a full-size start).
    x = seed_u32(seed) * seed_mult
    x = (x + salt if salt else x) & _U32  # no extra kernel on hash_dropout's path
    if not isinstance(x, torch.Tensor):
        x = torch.full((), x, dtype=torch.int64, device=device)
    for axis, mult in zip(range(len(shape)), _AXIS_MULTS):
        view = [1] * len(shape)
        view[axis] = shape[axis]
        idx = torch.arange(shape[axis], dtype=torch.int64, device=device).view(view)
        if offsets is not None and offsets[axis] is not None:
            # int32 addition, then the uint32 view: both wrap modulo 2**32
            idx = idx + int(offsets[axis])
        x = (x + ((idx & _U32) * mult)) & _U32
        x = x ^ (x >> 15)
        x = (x * _M1) & _U32
    return _fmix32(x)


def hash_keep_mask(shape: Sequence[int], rate: float, seed,
                   offsets: Optional[Sequence] = None, device=None) -> torch.Tensor:
    """Inverted-dropout keep mask (``1/(1-rate)`` or 0), fp32, for a block
    at ``offsets`` of a logically larger tensor; an (R,) ``seed`` draws
    each replica's block along ``shape[0]``, ``offsets`` then describing
    ``shape[1:]``."""
    if _is_vector(seed):
        if shape[0] != seed.numel():
            raise ValueError(f"{seed.numel()} replica seeds for a leading axis of {shape[0]}")
        return _per_replica(lambda s: hash_keep_mask(shape[1:], rate, s, offsets, device), seed)
    threshold, inv_keep = keep_params(rate)
    bits = _coord_hash(shape, seed, offsets, device)
    return torch.where(bits < threshold, inv_keep, 0.0).to(torch.float32)


def hash_dropout(x: torch.Tensor, rate: float, seed,
                 offsets: Optional[Sequence] = None) -> torch.Tensor:
    """Inverted dropout with the counter-based mask; ``seed``: an int32 (int
    or 0-d tensor), or (R,) seeds for the R replicas along ``x``'s first
    axis. ``offsets``: x's coordinates in a larger tensor (of the replica's
    axes, with replicas), as for :func:`hash_keep_mask`. On the card, the
    kernel (module doc)."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if not _on_card(x):
        if _is_vector(seed):
            return _per_replica(lambda s, xr: hash_dropout(xr, rate, s, offsets), seed, x)
        return x * hash_keep_mask(x.shape, rate, seed, offsets, device=x.device).to(x.dtype)
    rep = int(_is_vector(seed))
    hashed = x.dim() - rep
    if x.dtype not in _KERNEL_DTYPES or not 1 <= hashed <= len(_AXIS_MULTS):
        raise ValueError(f"hash_dropout on the card takes fp32, bf16 or fp16 with 1 to "
                         f"{len(_AXIS_MULTS)} hashed axes, not {x.dtype} {tuple(x.shape)}"
                         + (" (its first axis the replicas')" if rep else ""))
    if rep and x.shape[0] != seed.numel():
        raise ValueError(f"{seed.numel()} replica seeds for a leading axis of {x.shape[0]}")
    if isinstance(seed, torch.Tensor) and (rep or seed.device.type != "cpu" or is_batched(seed)):
        value, seed_t = 0, device_seed(seed, x.device).to(x.device).contiguous()
    else:
        value, seed_t = seed_u32(int(seed)), None
    offs = None
    if offsets is not None:
        if len(offsets) < hashed:
            raise ValueError(f"{len(offsets)} offsets for {hashed} axes")
        offs = (0,) * rep + tuple(0 if o is None else int(o) for o in offsets[:hashed])
    return _HashDropout.apply(x, float(rate), value, seed_t, offs, rep)


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


class _HashDropout(torch.autograd.Function):
    """:func:`hash_dropout` on the card as a differentiable op: the backward
    is the same dropout of the incoming gradient (the same seeds, rate and
    offsets), so nothing is saved but the seeds; under non-reentrant
    checkpointing the recompute draws the mask again and the backward keeps
    the offsets its forward read. ``rep`` 1: x's first axis holds replicas,
    one seed each in ``seed_t``.

    Under ``torch.func.vmap`` over R replicas, :meth:`vmap` puts the replica
    axis first and applies this op once with the replicas' seeds (one seed
    repeated where the seed is not mapped): one launch for all replicas,
    forward and backward, each replica's mask its own."""

    @staticmethod
    def forward(x, rate: float, seed: int, seed_t: Optional[torch.Tensor],
                offsets: Optional[Tuple[int, ...]], rep: int):
        return _launch(x, rate, seed, seed_t, offsets, rep)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        return _HashDropout.apply(grad, *ctx.args), None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, rate, seed, seed_t, offsets, rep):
        from vit_tpu_torch.ops.flash_attention import replica_first

        if rep:
            raise ValueError("hash_dropout takes one replica axis: (R,) seeds under vmap")
        n = info.batch_size
        x = replica_first(x, in_dims[0], n)
        seeds = (device_seed(seed, x.device).expand(n) if seed_t is None
                 else replica_first(seed_t, in_dims[3], n)).contiguous()
        offs = None if offsets is None else (0,) + offsets
        return _HashDropout.apply(x, rate, 0, seeds, offs, 1), 0


@functools.lru_cache(maxsize=None)
def _kernel_keep(rate: float, dtype: torch.dtype) -> Tuple[int, float]:
    """(threshold, keep factor): 1/keep rounded to fp32 (``torch.where``'s
    mask) and then to ``dtype`` (``mask.to(x.dtype)``)."""
    threshold, inv_keep = keep_params(rate)
    return threshold, float(torch.tensor(inv_keep, dtype=torch.float32).to(dtype))


def _launch(x, rate, seed, seed_t, offsets, rep) -> torch.Tensor:
    """One launch of the kernel on ``x`` (on the card): ``seed`` the int
    seed's uint32, or ``seed_t`` an int32 device seed (``rep`` 1: one a
    replica, x's first axis); ``offsets`` ints, one an axis of x, or None."""
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel's 16-byte loads
        x = x.clone()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    threshold, scale = _kernel_keep(rate, x.dtype)
    pad = (0,) * (_KERNEL_AXES - x.dim())
    offs = (0,) * x.dim() if offsets is None else tuple(o & _U32 for o in offsets)
    KERNELS["hash_dropout"].launch(
        x.data_ptr(), y.data_ptr(), x.numel(), x.dim(), rep, *x.shape, *pad, *offs, *pad, seed,
        None if seed_t is None else seed_t.data_ptr(), threshold, scale,
        _KERNEL_DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    return y


def stream_uniform(shape: Sequence[int], seed, device=None,
                   offsets: Optional[Sequence] = None) -> torch.Tensor:
    """fp32 uniforms in [0, 1), one per element of ``shape``: the top 24
    bits of the coordinate hash on the stream's own start, times 2**-24.
    ``seed``: an int32, as an int or a 0-d tensor (never read back);
    ``offsets`` as for :func:`hash_keep_mask`."""
    bits = _coord_hash(shape, seed, offsets, device=device, seed_mult=_STREAM_SEED_MULT,
                       salt=_STREAM_SALT)
    return (bits >> 8).to(torch.float32) * 2.0**-24


def stream_dropout(x: torch.Tensor, rate: float, seed,
                   offsets: Optional[Sequence] = None) -> torch.Tensor:
    """``nn.Dropout``: keep each element with probability ``1 - rate`` and
    divide it by ``1 - rate`` (in ``x``'s dtype, as flax does); the mask
    keeps the elements whose :func:`stream_uniform` of ``seed`` (an int32)
    lies below ``1 - rate``."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = stream_uniform(x.shape, seed, device=x.device, offsets=offsets) < keep_prob
    # flax divides by keep_prob in x's dtype (0.8984375 for 0.9 in bf16)
    scale = float(torch.tensor(keep_prob, dtype=x.dtype))
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def site_dropout(x: torch.Tensor, rate: float, seed, fast: bool = True) -> torch.Tensor:
    """One dropout call site of the model (``x`` batch first, at the
    :func:`batch_offset` in force): :func:`hash_dropout` (``fast``,
    ``vit_tpu``'s default) or :func:`stream_dropout`."""
    with span("vtt.op.site_dropout"):
        offsets = batch_offsets(x.dim())
        return (hash_dropout(x, rate, seed, offsets) if fast
                else stream_dropout(x, rate, seed, offsets))
