"""Mesh construction and sharding rules (port of ``vit_tpu/parallel/mesh.py``).

``vit_tpu`` is single-controller: one process sees every device, builds a
``jax.sharding.Mesh`` and lets GSPMD place the tensors and insert the
collectives. The port is multi-controller, as ``torch.distributed`` is:
one process a rank, each with its own device (``cuda:LOCAL_RANK``, or the
CPU), all running the same program. A "device" of ``vit_tpu``'s mesh is a
rank here.

* :class:`Mesh` places the ranks in a ``(data, model[, pipe])`` grid in
  enumeration order (``vit_tpu``'s non-TPU branch of ``device_grid``,
  :120-122) and makes one process group per axis line
  (``dist.new_group``), what ``DeviceMesh`` would make; a single process
  (no process group) is the one-rank mesh, with no groups.
* :func:`maybe_initialize_distributed` joins a ``torchrun`` launch. It
  reads ``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` where
  ``vit_tpu`` reads ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
  ``JAX_PROCESS_ID``; without them it does nothing.
* The layout rules return :class:`Sharding` (a mesh and a spec, one mesh
  axis name or None per tensor dimension, as ``PartitionSpec``):
  :func:`batch_sharding`, :func:`replicated_sharding`,
  :func:`zero1_shard_opt_state` and :func:`infer_param_shardings`. The
  latter keys them by the port's ``state_dict()`` names, in the port's
  layouts: a ``Linear`` weight is (out, *in), so ``vit_tpu``'s last kernel
  axis (its output features) is the port's first.

The collectives themselves are in :mod:`vit_tpu_torch.parallel.comm`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "Sharding",
    "device_grid",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "maybe_initialize_distributed",
    "num_data_shards",
    "zero1_shard_opt_state",
    "infer_param_shardings",
    "set_active_mesh",
    "active_mesh",
    "active_mesh_scope",
    "world",
]

_MOE_EXPERT_LEAVES = ("wi", "wi_bias", "wo", "wo_bias")


def world() -> tuple:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Ranks in a named grid, with this rank's coordinates and the process
    group of each axis line it sits on.

    ``shape``: axis name -> size, in axis order. ``coords``: axis name ->
    this rank's index along it, or None for a rank outside the grid (the
    batch-divisibility shrink can leave ranks out). ``group(axis)``: the
    process group of the ranks that share this rank's other coordinates
    (None for an axis of size 1, or outside the grid); ``group_ranks(axis)``
    their global ranks, in axis order."""

    def __init__(self, grid: np.ndarray, axis_names: Sequence[str]) -> None:
        self.devices = np.asarray(grid, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"grid of {self.devices.ndim} dims for axes {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.devices.shape))
        self.rank, self.world_size = world()
        where = np.argwhere(self.devices == self.rank)
        self.coords = (dict(zip(self.axis_names, (int(c) for c in where[0])))
                       if len(where) else None)
        self._groups: Dict[str, object] = {}
        self._group_ranks: Dict[str, list] = {}
        # Without a process group a mesh only describes layouts (no groups).
        grouped = self.world_size > 1
        for i, axis in enumerate(self.axis_names):
            for line in np.moveaxis(self.devices, i, -1).reshape(-1, self.devices.shape[i]):
                ranks = [int(r) for r in line]
                # every process makes every group, in one order (new_group's rule)
                group = dist.new_group(ranks) if grouped and len(ranks) > 1 else None
                if self.rank in ranks:
                    self._groups[axis], self._group_ranks[axis] = group, ranks
        members = sorted(int(r) for r in self.devices.ravel())
        # The mesh's own ranks, for what all of them decide together.
        self.world_group = dist.new_group(members) if grouped and len(members) > 1 else None
        self.backend = dist.get_backend() if grouped else None

    @property
    def member(self) -> bool:
        return self.coords is not None

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return 0 if self.coords is None else self.coords.get(axis, 0)

    def group(self, axis: str):
        return self._groups.get(axis)

    def group_ranks(self, axis: str) -> list:
        return self._group_ranks.get(axis, [self.rank])


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout over ``mesh``: ``spec`` names the mesh axis each
    dimension is split over (None or a missing trailing entry: whole)."""

    mesh: Mesh
    spec: tuple = ()

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``x``."""
        for dim, axis in enumerate(self.spec):
            if axis is not None and self.mesh.size(axis) > 1:
                n = self.mesh.size(axis)
                if x.shape[dim] % n:
                    raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide by the "
                                     f"'{axis}' axis size {n}")
                x = x.chunk(n, dim=dim)[self.mesh.coord(axis)]
        return x


# The mesh the current Experiment (or test) runs under: ring attention and
# the pipeline read it when they run, as vit_tpu's kernels read it at trace
# time. Experiment.fit/test scope it (active_mesh_scope).
_ACTIVE_MESH: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


@contextlib.contextmanager
def active_mesh_scope(mesh: Optional[Mesh]):
    """Scope the active mesh to a block, restoring the previous value."""
    prev = active_mesh()
    set_active_mesh(mesh)
    try:
        yield mesh
    finally:
        set_active_mesh(prev)


def maybe_initialize_distributed(device="cuda") -> None:
    """Join a ``torchrun`` launch: with ``MASTER_ADDR`` and ``WORLD_SIZE`` in
    the environment (and ``RANK``, ``MASTER_PORT``), initialise the default
    process group from it, NCCL for a CUDA ``device`` and gloo for the CPU,
    and take ``cuda:LOCAL_RANK``. No-op without them, or when a group
    already exists."""
    if not (os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE")):
        return
    if dist.is_initialized():
        return
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")


def device_grid(devs: Sequence, shape: Sequence[int]) -> np.ndarray:
    """``devs`` in a ``shape`` grid, in enumeration order: the numerics do
    not depend on the placement, only the collectives' latency does."""
    return np.asarray(list(devs)).reshape(tuple(shape))


def make_mesh(num_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data", "model"),
              pipeline_parallel: int = 1) -> Mesh:
    """A ``(data, model[, pipe])`` mesh over the ranks (``devices``: global
    ranks, default all of them), ``vit_tpu``'s ``make_mesh``: ``num_devices``
    caps how many take part; ``model_parallel`` splits off the ``model``
    axis; ``pipeline_parallel > 1`` appends ``pipe``."""
    devs = list(devices) if devices is not None else list(range(world()[1]))
    if num_devices is not None and num_devices > 0:
        devs = devs[: int(num_devices)]
    n = len(devs)
    pp = int(pipeline_parallel)
    if model_parallel < 1 or pp < 1 or n % (model_parallel * pp) != 0:
        raise ValueError(
            f"model_parallel={model_parallel} x pipeline_parallel={pp} "
            f"must divide device count {n}"
        )
    if pp > 1:
        shape = (n // (model_parallel * pp), model_parallel, pp)
        return Mesh(device_grid(devs, shape), tuple(axis_names) + ("pipe",))
    return Mesh(device_grid(devs, (n // model_parallel, model_parallel)), tuple(axis_names))


def num_data_shards(mesh: Mesh) -> int:
    return mesh.size("data")


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) axis over ``data``: a rank's rows of the global
    batch; the rest whole."""
    return Sharding(mesh, ("data",))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def zero1_shard_opt_state(opt_state, mesh: Mesh):
    """ZeRO-1 layout of an optimizer state (a tensor, or a dict, list or
    tuple of them): a leaf's leading dim over ``data`` where it divides by
    the data-parallel degree, else replicated (scalar step counts among
    them). ``vit_tpu``'s rule, :196-215."""
    dp = mesh.size("data")

    def rule(x):
        if isinstance(x, Mapping):
            return {k: rule(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rule(v) for v in x)
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] % dp == 0:
            return Sharding(mesh, ("data",) + (None,) * (x.ndim - 1))
        return Sharding(mesh, ())

    return rule(opt_state)


def _leaf_rule(name: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The port-layout dim of ``name`` split over ``model`` (None: whole).

    MoE expert leaves split their expert dim (dim 0). Otherwise a tensor of
    two or more dims splits ``vit_tpu``'s last kernel axis where it divides
    by the TP degree and is at least twice it: a ``Linear`` weight's output
    features (dim 0 of the port's (out, *in)), the last dim of the CLS token
    and the position table. Biases and LayerNorm scales stay whole, as a
    preprocessor's parameters do (it runs before the embeddings, outside
    the tensor-parallel layers)."""
    if tp <= 1 or name.startswith("preprocessor."):
        return None
    leaf = name.rsplit(".", 1)[-1]
    if ".moe." in f".{name}" and leaf in _MOE_EXPERT_LEAVES:
        return 0 if shape[0] % tp == 0 else None
    if len(shape) < 2:
        return None
    dim = 0 if leaf == "weight" else len(shape) - 1
    return dim if shape[dim] % tp == 0 and shape[dim] >= 2 * tp else None


def infer_param_shardings(params: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, Sharding]:
    """Column-parallel layout over ``model`` of ``params`` (a ``state_dict``
    or ``dict(named_parameters())``), keyed by the same names: ``vit_tpu``'s
    rule, :218-262 (:func:`_leaf_rule`). With ``model`` of size 1 every
    tensor is whole (pure data parallelism)."""
    tp = mesh.size("model")
    out = {}
    for name, t in params.items():
        dim = _leaf_rule(name, tuple(t.shape), tp)
        out[name] = Sharding(mesh, () if dim is None else (None,) * dim + ("model",))
    return out
