"""Seeding, parameter counting and the covariance-stats cache (port of part
of ``vit_tpu/utils.py``).

The covariance cache (``load_cov_stats`` / ``clear_cov_cache``,
``vit_tpu/utils.py:40-122``) is process-global and keyed by the resolved
path; it checks the required keys ``{mean, cov, eigvals, eigvecs}``.
Artifacts are ``.npz`` or the reference's torch ``.pt``; values come back
as numpy arrays. :func:`load_patch_pca_stats` (``vit_tpu/utils.py:82``)
reads the image family's patch-PCA artifact.
"""

from __future__ import annotations

import os
import random
from typing import Dict

import numpy as np
import torch

__all__ = [
    "seed_everything",
    "count_params",
    "load_cov_stats",
    "clear_cov_cache",
    "save_cov_stats",
    "load_patch_pca_stats",
    "to_device",
]

_COV_REQUIRED_KEYS = ("mean", "cov", "eigvals", "eigvecs")
_cov_cache: Dict[str, dict] = {}


def seed_everything(seed: int = 42) -> int:
    """Seed Python's, numpy's and torch's global generators. The port's own
    randomness (weights, dropout seeds, noise) comes from explicit
    ``torch.Generator``s; this covers library code that draws globally."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed


def count_params(module: torch.nn.Module) -> int:
    """Total number of scalar parameters."""
    return sum(p.numel() for p in module.parameters())


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_device(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (a numpy array, anything ``np.asarray`` takes, or a tensor on
    any device) as a ``dtype`` tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.detach().to(device=device, dtype=dtype)


def _resolve(path: str) -> str:
    return os.path.realpath(os.path.expanduser(os.path.expandvars(str(path))))


def _load_stats_file(path: str) -> dict:
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    if path.endswith((".pt", ".pth")):
        raw = torch.load(path, map_location="cpu", weights_only=True)
        return {k: _to_numpy(v) for k, v in raw.items()}
    raise ValueError(f"Unsupported covariance stats format: {path} (use .npz or .pt)")


def load_cov_stats(path: str, use_cache: bool = True) -> dict:
    """Covariance statistics ``{mean, cov, eigvals, eigvecs, ...}`` as numpy
    arrays, cached per resolved path. Raises ``KeyError`` naming the
    required keys that are missing."""
    resolved = _resolve(path)
    if use_cache and resolved in _cov_cache:
        return _cov_cache[resolved]
    if not os.path.exists(resolved):
        raise FileNotFoundError(f"Covariance stats file not found: {resolved}")
    stats = _load_stats_file(resolved)
    missing = [k for k in _COV_REQUIRED_KEYS if k not in stats]
    if missing:
        raise KeyError(
            f"Covariance stats at {resolved} missing required keys {missing}; "
            f"found {sorted(stats.keys())}"
        )
    stats = {k: _to_numpy(v) for k, v in stats.items()}
    if use_cache:
        _cov_cache[resolved] = stats
    return stats


def clear_cov_cache() -> None:
    """Drop the process-global covariance cache."""
    _cov_cache.clear()


def load_patch_pca_stats(path: str) -> dict:
    """A patch-PCA artifact ``{components|eigvecs|V, mean, ...}`` (``.npz``
    or ``.pt``, the schema of :func:`~vit_tpu_torch.prepca.pipeline.
    compute_patch_pca_images`), numpy arrays, with the basis under
    ``components``: (patch_dim, k) fp32, columns the principal directions."""
    resolved = _resolve(path)
    if not os.path.exists(resolved):
        raise FileNotFoundError(f"Patch-PCA stats file not found: {resolved}")
    stats = {k: _to_numpy(v) for k, v in _load_stats_file(resolved).items()}
    basis = next((stats[k] for k in ("components", "eigvecs", "V") if k in stats), None)
    if basis is None:
        raise KeyError(f"Patch-PCA stats at {resolved} need one of components/eigvecs/V; "
                       f"found {sorted(stats.keys())}")
    stats["components"] = np.asarray(basis, np.float32)
    return stats


def save_cov_stats(stats: dict, path: str) -> str:
    """Save covariance statistics: ``.npz``, or ``.pt`` for the reference."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in stats.items()}
    if path.endswith(".npz"):
        np.savez(path, **arrays)
    elif path.endswith((".pt", ".pth")):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()},
                   path)
    else:
        raise ValueError(f"Unsupported covariance stats format: {path}")
    return path
