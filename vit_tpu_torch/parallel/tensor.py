"""Tensor and expert parallelism over the ``model`` axis, and the gradient
reductions every parallel mode shares.

``vit_tpu`` seeds GSPMD with the column-parallel layout of
:func:`~vit_tpu_torch.parallel.mesh.infer_param_shardings` and lets XLA
place the collectives. The port writes out what GSPMD inserts:

* :func:`shard_module` keeps, of each parameter the rule splits, this
  rank's block, and tags it (``_shard``: the split dim and the ``model``
  group). Parameters and optimizer moments are then 1/TP a rank.
* A split ``Linear`` runs column-parallel (:func:`column_parallel`): this
  rank's output features from its weight block, then the group's blocks
  gathered, so the next layer sees the whole activation. The bias (whole)
  is added after the gather, where ``nn.Dense`` adds it, so the output is
  rounded as the unsplit layer rounds it.
* Anything else that reads a split parameter whole (the CLS token, the
  position table, the head, the fused-MLP and fused-QKV kernels, which GSPMD
  cannot split either) reads :func:`full_param`: the blocks gathered.
* MoE expert leaves split their expert dim: each rank runs E/TP experts on
  the (replicated) dispatch and the outputs are summed over ``model``
  (:meth:`~vit_tpu_torch.models.moe.MoEMLP.forward`).

Everything else runs replicated over ``model``, so the gradients of whole
parameters agree on every rank of the group and a split parameter's
gradient is its own block.

The step's gradient reductions (:func:`sync_gradients`,
:func:`global_grad_norm`): gradients are averaged over ``data`` before the
clip, and the global norm sums each block once (a parameter split over
``model``, or owned by one pipeline stage, adds its sum of squares over
that axis's group).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from vit_tpu_torch.parallel import comm
from vit_tpu_torch.parallel.mesh import Mesh, infer_param_shardings

__all__ = ["Shard", "shard_module", "full_param", "column_parallel", "expert_block",
           "split_axes", "sync_gradients", "global_grad_norm", "full_tensor"]


@dataclasses.dataclass(frozen=True)
class Shard:
    """A parameter held as block ``rank`` of ``size`` along ``dim`` (``size``
    the group's ranks); ``full``: the whole tensor's length there."""

    dim: int
    group: object
    rank: int
    size: int
    full: int


def _shard_of(t: torch.Tensor) -> Optional[Shard]:
    return getattr(t, "_shard", None)


def shard_module(module: nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Split ``module``'s parameters over ``mesh``'s ``model`` axis in place
    (:func:`~vit_tpu_torch.parallel.mesh.infer_param_shardings`); returns
    name -> split dim of those it split."""
    group = mesh.group("model")
    if group is None:
        return {}
    named = dict(module.named_parameters())
    split = {}
    for name, sharding in infer_param_shardings(named, mesh).items():
        if "model" not in sharding.spec:
            continue
        p = named[name]
        dim = sharding.spec.index("model")
        full = p.shape[dim]
        with torch.no_grad():
            p.data = sharding.shard(p.data).contiguous().clone()
        p._shard = Shard(dim, group, mesh.coord("model"), mesh.size("model"), full)
        p._split_axes = ("model",)
        split[name] = dim
    return split


def full_param(p: torch.Tensor) -> torch.Tensor:
    """The whole parameter: its blocks gathered over ``model`` (gradient:
    this rank's block) if it is split, else ``p``."""
    sh = _shard_of(p)
    return p if sh is None else comm.gather(p, sh.group, sh.dim)


def full_tensor(p: torch.Tensor) -> torch.Tensor:
    """As :func:`full_param`, outside autograd (checkpoints)."""
    sh = _shard_of(p)
    return p.detach() if sh is None else comm.all_gather(p.detach(), sh.group, sh.dim)


def column_parallel(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                    dtype: torch.dtype, in_features: int) -> torch.Tensor:
    """``x @ W.T + b`` with ``W`` split on its output features: this rank's
    columns, gathered; the whole bias added after, in ``dtype``."""
    sh = _shard_of(weight)
    x = comm.reduce_grad(x, sh.group)  # each rank's product uses x in part
    y = torch.matmul(x.to(dtype), weight.reshape(-1, in_features).to(dtype).t())
    y = comm.gather(y, sh.group, y.dim() - 1)
    return y if bias is None else y + bias.to(dtype)


def expert_block(w: torch.Tensor) -> Tuple[int, int, object]:
    """(first expert, expert count, ``model`` group) of this rank's block of
    an expert leaf; (0, E, None) when it is whole."""
    sh = _shard_of(w)
    if sh is None:
        return 0, w.shape[0], None
    return sh.rank * w.shape[0], w.shape[0], sh.group


def split_axes(p: torch.Tensor) -> tuple:
    """The mesh axes over which ``p`` is split (``model``) or owned by one
    rank (``pipe``): its gradient is summed over them for the norm."""
    return getattr(p, "_split_axes", ())


@torch.no_grad()
def sync_gradients(params: Iterable[torch.Tensor], mesh: Mesh,
                   extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Average the gradients over ``data`` (one flat fp32 all-reduce), and
    ``extra`` (the step's loss) with them; returns the averaged ``extra``."""
    group = mesh.group("data")
    if group is None:
        return extra
    grads = [p.grad for p in params if p.grad is not None]
    tensors = grads + ([extra.reshape(1)] if extra is not None else [])
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    comm.all_reduce(flat, group)
    flat.mul_(1.0 / mesh.size("data"))
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return extra


# Every key global_grad_norm may meet, in one order on every rank.
_NORM_KEYS = ((), ("model",), ("pipe",), ("model", "pipe"))


@torch.no_grad()
def global_grad_norm(params: Iterable[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The global L2 norm of the step's gradients, each block counted once:
    a gradient split or owned over mesh axes sums its squares over their
    groups. A layer of the replicated pipeline (``_pipe_owner``, held by
    every rank) is counted at its own stage and summed over ``pipe``, as
    the stage-resident layout counts it."""
    parts: Dict[tuple, List[torch.Tensor]] = {k: [] for k in _NORM_KEYS}
    device = None
    for p in params:
        if p.grad is not None:
            device = p.grad.device
            axes = split_axes(p)
            owner = getattr(p, "_pipe_owner", None)
            if owner is not None:
                if owner != mesh.coord("pipe"):
                    continue
                axes = axes + ("pipe",)
            parts[axes].append(p.grad.float().square().sum())
    total = torch.zeros((), device=device)
    for axes in _NORM_KEYS:
        s = torch.stack(parts[axes]).sum() if parts[axes] else torch.zeros((), device=device)
        for axis in axes:
            if mesh.size(axis) > 1:
                comm.all_reduce(s, mesh.group(axis))
        total = total + s
    return torch.sqrt(total)
