"""The port's one collective wrapper, and the autograd pieces built on it.

Every collective of the parallel paths goes through this module, on one
``torch.distributed`` process group per mesh axis
(:class:`~vit_tpu_torch.parallel.mesh.Mesh`). A ``None`` group is an axis of
size 1: each call is then the identity.

NCCL takes CUDA tensors; gloo takes CPU tensors. Two ranks of one NCCL
communicator cannot share a card, so where several ranks share one card
they run gloo, and this wrapper stages a CUDA tensor through the host for
gloo: a copy to the CPU, the collective, a copy back. That happens here
alone, and is counted (:data:`STATS`: ``staged_bytes`` both ways). NCCL
is never swapped for gloo and the card's tensors never stay on the CPU.

:data:`STATS` also counts the calls and the host seconds spent inside them
(a staged collective waits for its copies; an NCCL call returns once it is
queued), and under any backend each collective's calls and bytes
(``STATS["ops"][op]``): the tensor's bytes for :func:`all_reduce` and
:func:`broadcast`, the gathered result's for :func:`all_gather`, the bytes
sent and received for :func:`exchange` (:func:`all_gather_object`: calls
only). Each call is a ``vtt.comm.<op>`` span (:mod:`vit_tpu_torch.tracing`),
:func:`broadcast_bucket`'s around its :func:`broadcast`'s. A ``None`` group
returns before any of this, so a one-rank run counts and records nothing.

The autograd pieces (Megatron's f and g, and a gather/slice pair) hold
where every rank of the group computes the same replicated tensors around
them, so the gradient arriving at a replicated output is the same on every
rank:

* :func:`reduce_grad` (f): identity forward, all-reduce (sum) of the
  gradient; in front of a product that uses only this rank's part of a
  replicated input;
* :func:`reduce_sum` (g): all-reduce (sum) forward, identity backward;
  partial results into their replicated sum;
* :func:`gather` : the group's chunks concatenated along ``dim``, backward
  this rank's chunk of the gradient;
* :func:`scatter`: this rank's chunk along ``dim``, backward the group's
  gradient chunks concatenated.
"""

from __future__ import annotations

import time
from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist

from vit_tpu_torch.tracing import span

__all__ = ["STATS", "reset_stats", "all_reduce", "all_gather", "broadcast", "broadcast_bucket",
           "exchange", "all_gather_object", "group_rank", "group_size", "reduce_grad",
           "reduce_sum", "gather", "scatter"]

STATS = {"calls": 0, "staged_bytes": 0, "seconds": 0.0, "bucket_bytes": 0, "bucket_seconds": 0.0,
         "ops": {}}


def reset_stats() -> None:
    STATS.update(calls=0, staged_bytes=0, seconds=0.0, bucket_bytes=0, bucket_seconds=0.0,
                 ops={})


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(group, t: torch.Tensor) -> bool:
    """True where the tensor goes through the host: gloo and a CUDA tensor."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


class _Timed:
    """One collective ``op`` moving ``nbytes``: its span, its call and bytes
    in ``STATS["ops"]``, and its host seconds."""

    def __init__(self, op: str, nbytes: int = 0) -> None:
        self.op, self.nbytes = op, nbytes
        self.span = span(f"vtt.comm.{op}")

    def __enter__(self):
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        STATS["calls"] += 1
        STATS["seconds"] += time.perf_counter() - self.t0
        op = STATS["ops"].setdefault(self.op, {"calls": 0, "bytes": 0})
        op["calls"] += 1
        op["bytes"] += self.nbytes
        return self.span.__exit__(*exc)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host(t: torch.Tensor) -> torch.Tensor:
    STATS["staged_bytes"] += t.numel() * t.element_size()
    return t.detach().cpu()


def _back(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    STATS["staged_bytes"] += src.numel() * src.element_size()
    return dst.copy_(src)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place; returns ``x``. Under gloo a 16-bit
    float sums in fp32 and rounds once (two ranks: NCCL's one rounding)."""
    if group is None:
        return x
    with _Timed("all_reduce", _nbytes(x)):
        staged = _staged(group, x)
        if staged or (x.dtype in (torch.bfloat16, torch.float16)
                      and dist.get_backend(group) == "gloo"):
            h = (_host(x) if staged else x.detach()).float()
            dist.all_reduce(h, group=group)
            if staged:
                _back(x, h.to(x.dtype))
            else:
                x.copy_(h)
        else:
            dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's equal-shaped ``x`` concatenated along ``dim``, in group
    rank order."""
    if group is None:
        return x
    n = group_size(group)
    with _Timed("all_gather", n * _nbytes(x)):
        if _staged(group, x):
            h = _host(x).contiguous()
            parts = [torch.empty_like(h) for _ in range(n)]
            dist.all_gather(parts, h, group=group)
            out = torch.cat(parts, dim=dim)
            return _back(torch.empty(out.shape, dtype=x.dtype, device=x.device), out)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` from global rank ``src`` to every rank of ``group``, in place
    (staged: only ``src`` copies its ``x`` to the host)."""
    if group is None:
        return x
    with _Timed("broadcast", _nbytes(x)):
        if _staged(group, x):
            h = (_host(x).contiguous() if dist.get_rank() == src
                 else torch.empty(x.shape, dtype=x.dtype))
            dist.broadcast(h, src, group=group)
            _back(x, h)
        else:
            dist.broadcast(x, src, group=group)
    return x


def broadcast_bucket(tensors: Sequence[torch.Tensor], src: int, group) -> None:
    """The ``tensors`` (of one dtype) of global rank ``src`` to every rank of
    ``group``, in place, as one flat bucket: one :func:`broadcast` (counted
    as any call), its bytes and host seconds also in ``bucket_bytes`` and
    ``bucket_seconds``. The other ranks' tensors are only written."""
    if group is None or not tensors:
        return
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError("broadcast_bucket takes tensors of one dtype")
    t0 = time.perf_counter()
    with span("vtt.comm.broadcast_bucket"):
        mine = dist.get_rank() == src
        if mine:
            flat = torch.cat([t.reshape(-1) for t in tensors])
        else:
            flat = torch.empty(sum(t.numel() for t in tensors), dtype=tensors[0].dtype,
                               device=tensors[0].device)
        broadcast(flat, src, group)
        if not mine:
            at = 0
            for t in tensors:
                t.copy_(flat[at:at + t.numel()].view(t.shape))
                at += t.numel()
    STATS["bucket_bytes"] += _nbytes(flat)
    STATS["bucket_seconds"] += time.perf_counter() - t0


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]], group) -> None:
    """Point-to-point: each ``(tensor, global rank)`` of ``sends`` is sent
    there and each buffer of ``recvs`` filled from there, all posted at once
    (``batch_isend_irecv``) and waited for."""
    with _Timed("exchange", sum(_nbytes(t) for t, _ in (*sends, *recvs))):
        staged = any(_staged(group, t) for t, _ in (*sends, *recvs))
        send_bufs = [(_host(t).contiguous() if staged else t.contiguous(), r) for t, r in sends]
        recv_bufs = [(torch.empty(t.shape, dtype=t.dtype) if staged else t, r)
                     for t, r in recvs]
        ops = [dist.P2POp(dist.isend, t, r, group) for t, r in send_bufs]
        ops += [dist.P2POp(dist.irecv, t, r, group) for t, r in recv_bufs]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged:
            for (dst, _), (src, _) in zip(recvs, recv_bufs):
                _back(dst, src)


def all_gather_object(obj: Any, group) -> List[Any]:
    """Each rank's picklable ``obj``, in group rank order (host objects)."""
    if group is None:
        return [obj]
    out: List[Any] = [None] * group_size(group)
    with _Timed("all_gather_object"):
        dist.all_gather_object(out, obj, group=group)
    return out


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, r = group_size(ctx.group), group_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[r].contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, r = group_size(group), group_rank(group)
        return x.chunk(n, dim=dim)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceGrad.apply(x, group)


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceSum.apply(x, group)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else _Gather.apply(x, group, dim)


def scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else _Scatter.apply(x, group, dim)

