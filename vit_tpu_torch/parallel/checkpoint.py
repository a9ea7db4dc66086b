"""Checkpoints in the canonical layout under any mesh.

A checkpoint holds the one-rank model's ``state_dict`` and its optimizer's
``state_dict``, whatever the run's mesh, as ``vit_tpu``'s checkpoints hold
the canonical per-layer tree: it loads ``strict=True`` into a one-rank
model, and any mesh resumes from it.

* Tensor/expert parallelism: a split parameter, and each optimizer moment
  of its shape, is gathered over ``model`` to save, and this rank's block
  is taken to load.
* Pipeline, stage-resident: a stage holds its layers only; the stages'
  entries are gathered over ``pipe`` to save (host objects), and each
  stage takes its own to load. The replicated layout holds every layer on
  every rank: its entries are the canonical ones as they stand.
* ZeRO-1 gathers and splits its moments itself
  (:class:`~vit_tpu_torch.train.optim.Zero1Optimizer`).

Every rank of the mesh takes part in a save; rank 0 writes it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn

from vit_tpu_torch.parallel import comm
from vit_tpu_torch.parallel.mesh import Mesh
from vit_tpu_torch.parallel.tensor import full_tensor

__all__ = ["canonical_state_dict", "local_state_dict", "canonical_optimizer_state",
           "local_optimizer_state", "canonical_grads"]


def _block(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """This rank's block of the whole ``t`` for parameter ``p``."""
    sh = getattr(p, "_shard", None)
    return t if sh is None else t.chunk(sh.size, dim=sh.dim)[sh.rank].clone()


def _whole(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A moment of ``p``'s block made whole as ``p`` is."""
    sh = getattr(p, "_shard", None)
    return t.detach() if sh is None else comm.all_gather(t.detach(), sh.group, sh.dim)


def _stage_resident(module: nn.Module, mesh: Mesh) -> bool:
    """True where this rank holds its pipeline stage's layers only."""
    return mesh.size("pipe") > 1 and module.vit.encoder.pipeline.resident


def _merge_stages(entries: Dict[str, object], mesh: Mesh) -> Dict[str, object]:
    merged: Dict[str, object] = {}
    for part in comm.all_gather_object(entries, mesh.group("pipe")):
        merged.update(part)
    return merged


def canonical_state_dict(module: nn.Module, mesh: Mesh,
                         names: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The one-rank ``state_dict`` (on the host, keys ``names`` in order)."""
    sd = {k: full_tensor(v).cpu() for k, v in module.state_dict(keep_vars=True).items()}
    if _stage_resident(module, mesh):
        sd = _merge_stages(sd, mesh)
    return {k: sd[k] for k in names}


def canonical_grads(module: nn.Module, mesh: Mesh,
                    names: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The parameters' gradients in the one-rank layout (on the host; the
    step's, after its reductions), keyed as ``names``."""
    grads = {n: _whole(p.grad, p).cpu() for n, p in module.named_parameters()
             if p.grad is not None}
    if _stage_resident(module, mesh):
        grads = _merge_stages(grads, mesh)
    return {k: grads[k] for k in names if k in grads}


def local_state_dict(module: nn.Module, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's entries of a one-rank ``state_dict``, in its layout."""
    return {k: _block(full[k], v) for k, v in module.state_dict(keep_vars=True).items()}


def canonical_optimizer_state(optimizer, module: nn.Module, mesh: Mesh,
                              param_names: Sequence[str]) -> dict:
    """The one-rank optimizer ``state_dict`` (a single parameter group over
    ``param_names``, the one-rank model's parameters in order)."""
    sd = optimizer.state_dict()
    named_params = list(module.named_parameters())
    if len(sd["param_groups"]) != 1:
        raise ValueError("a parallel checkpoint takes one optimizer parameter group")
    named: Dict[str, dict] = {}
    for i, st in sd["state"].items():
        name, p = named_params[int(i)]
        named[name] = {k: (_whole(t, p).cpu()
                           if isinstance(t, torch.Tensor) and t.shape == p.shape else t)
                       for k, t in st.items()}
    if _stage_resident(module, mesh):
        named = _merge_stages(named, mesh)
    group = dict(sd["param_groups"][0])
    group["params"] = list(range(len(param_names)))
    return {"state": {j: named[n] for j, n in enumerate(param_names) if n in named},
            "param_groups": [group]}


def local_optimizer_state(state_dict: dict, module: nn.Module,
                          param_names: Sequence[str]) -> dict:
    """This rank's optimizer ``state_dict`` from a one-rank one: its
    parameters' entries, in its order, each moment cut to its block."""
    index = {n: j for j, n in enumerate(param_names)}
    state: Dict[int, dict] = {}
    mine: List[int] = []
    for i, (name, p) in enumerate(module.named_parameters()):
        mine.append(i)
        st = state_dict["state"].get(index[name], state_dict["state"].get(str(index[name])))
        if st is None:
            continue
        full_shape = _full_shape(p)
        state[i] = {k: (_block(t, p) if isinstance(t, torch.Tensor) and t.shape == full_shape
                        else t) for k, t in st.items()}
    group = dict(state_dict["param_groups"][0])
    group["params"] = mine
    return {"state": state, "param_groups": [group]}


def _full_shape(p: torch.Tensor) -> torch.Size:
    sh = getattr(p, "_shard", None)
    if sh is None:
        return p.shape
    shape = list(p.shape)
    shape[sh.dim] = sh.full
    return torch.Size(shape)

