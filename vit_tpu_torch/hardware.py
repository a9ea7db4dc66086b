"""Hardware detection and input-pipeline tuning (port of ``vit_tpu/hardware.py``).

The accelerators come from ``torch.cuda`` and the world size from
``torch.distributed``. Two differences from ``vit_tpu`` are declared:

* :func:`select_accelerator_and_devices` takes ``device=`` (default
  ``"cuda"``) and raises without CUDA unless ``"cpu"`` is asked for, where
  ``vit_tpu`` picks TPU > GPU > CPU by itself (a hidden fallback here);
* :func:`enable_compilation_cache` has no XLA cache to switch on: it reports
  the directory the CUDA kernels are built into and loaded from on later
  runs (:func:`vit_tpu_torch.ops._build.build_dir`), or None when the
  config or ``$VIT_TPU_NO_CACHE`` turns the cache off, and changes nothing.

:func:`get_prefetch_depth` is ``vit_tpu``'s rule unchanged: ``$NUM_WORKERS``,
else ``train.num_workers``, each clipped to [1, 8], else 2.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple, Union

import torch

__all__ = [
    "detect_accelerators",
    "select_accelerator_and_devices",
    "get_training_strategy",
    "get_prefetch_depth",
    "enable_compilation_cache",
]


def enable_compilation_cache(config: Optional[dict] = None) -> Optional[str]:
    """The kernels' persistent build directory, or None when
    ``train.compilation_cache: false`` or ``$VIT_TPU_NO_CACHE`` is set."""
    train_cfg = (config or {}).get("train", {}) or {}
    if not bool(train_cfg.get("compilation_cache", True)):
        return None
    if os.environ.get("VIT_TPU_NO_CACHE"):
        return None
    from vit_tpu_torch.ops._build import build_dir

    return build_dir()


def _world_size() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def detect_accelerators() -> Dict[str, object]:
    """The attached cards: backend, count, name, memory of card 0 in bytes
    (None without a card) and the process count."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "backend": "cuda" if count else "cpu",
        "device_count": count,
        "device_kind": torch.cuda.get_device_name(0) if count else "none",
        "memory_bytes": torch.cuda.get_device_properties(0).total_memory if count else None,
        "process_count": _world_size(),
        "local_device_count": count,
    }


def select_accelerator_and_devices(num_devices: Optional[int] = None,
                                   device: Union[str, torch.device] = "cuda",
                                   ) -> Tuple[str, List[torch.device]]:
    """(backend name, devices): every card (the first ``num_devices``) for
    ``device="cuda"``, the CPU for ``device="cpu"``; raises for CUDA
    without a card."""
    from vit_tpu_torch.serve import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type, [dev]
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if num_devices is not None and num_devices > 0:
        devices = devices[: int(num_devices)]
    return "cuda", devices


def get_training_strategy(num_devices: int) -> str:
    """'data_parallel' iff more than one device, else 'single'."""
    return "data_parallel" if num_devices > 1 else "single"


def get_prefetch_depth(config: Optional[dict] = None) -> int:
    """Host-to-device prefetch depth: ``$NUM_WORKERS``, else
    ``train.num_workers``, clipped to [1, 8]; 2 when neither is set."""
    env = os.environ.get("NUM_WORKERS")
    if env is not None:
        return max(1, min(8, int(env)))
    cfg = ((config or {}).get("train", {}) or {}).get("num_workers")
    if cfg is not None:
        return max(1, min(8, int(cfg)))
    return 2
