"""Meshes, layouts and collectives on ``torch.distributed``: data parallel
with ZeRO-1, tensor and expert parallel, the GPipe pipeline (port of
``vit_tpu/parallel``)."""

from vit_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicated_sharding,
)
