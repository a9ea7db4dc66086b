"""CKA between two sets of representations and the image family's patch
PCA (ports of ``compute_cka`` and ``compute_patch_pca_images`` from
``vit_tpu/prepca/pipeline.py``).

CKA is host code in numpy float64, as in ``vit_tpu``. The patch PCA runs
with ``torch.linalg`` on ``device`` (the card unless asked otherwise): the
patches' fp32 mean, then the covariance of the centred patches and its
eigendecomposition in float64. The rest of the offline statistics (PCA,
KPCA, ZCA, PCP and their CLIs) is not ported yet; the covariance statistics
the spectra preprocessors read are in :mod:`.stats`.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

__all__ = ["compute_cka", "compute_patch_pca_images"]


def _as_np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pairwise_sq_dists(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    x2 = (x * x).sum(axis=1, keepdims=True)
    y2 = (y * y).sum(axis=1, keepdims=True).T
    return np.clip(x2 + y2 - 2.0 * (x @ y.T), 0.0, None)


def _center_gram(G: np.ndarray) -> np.ndarray:
    n = G.shape[0]
    H = np.eye(n) - np.full((n, n), 1.0 / n)
    return H @ G @ H


def compute_cka(A, B, *, kernel: str = "linear", debiased: bool = True) -> float:
    """HSIC-normalised (linear or rbf) CKA, with the reference's debias
    factor 1 - 2/(n - 1) when ``debiased``."""
    A, B = _as_np(A).astype(np.float64), _as_np(B).astype(np.float64)
    if A.shape[0] != B.shape[0]:
        raise ValueError("CKA requires both inputs to have the same number of samples")
    if kernel == "linear":
        GA, GB = _center_gram(A @ A.T), _center_gram(B @ B.T)
    elif kernel == "rbf":
        GA = _center_gram(np.exp(-_pairwise_sq_dists(A, A)))
        GB = _center_gram(np.exp(-_pairwise_sq_dists(B, B)))
    else:
        raise ValueError("kernel must be 'linear' or 'rbf'")
    hsic = float((GA * GB).sum())
    cka = hsic / (np.linalg.norm(GA) * np.linalg.norm(GB) + 1e-12)
    if not debiased:
        return float(cka)
    n = A.shape[0]
    return float(cka * (1.0 - 2.0 / (n - 1)))


def compute_patch_pca_images(images, *, patch_size: int, limit: Optional[int] = None,
                             device: Union[str, torch.device] = "cuda") -> Dict[str, np.ndarray]:
    """Patch-level PCA over the non-overlapping ``P x P x C`` patches of
    (N, H, W, C) images (uint8 scaled to [0, 1]); patches flatten row-major
    over (P, P, C), as :class:`~vit_tpu_torch.models.preprocessor.
    PatchPCAProjector` reads them. Returns ``vit_tpu``'s artifact schema:
    ``components`` (patch_dim, patch_dim), columns the directions by
    decreasing variance (each column's sign is ``torch.linalg.eigh``'s),
    ``singular_values``, ``mean``, ``explained_variance_ratio``,
    ``patch_size``, ``num_channels``, ``num_patches``."""
    from vit_tpu_torch.serve import resolve_device

    dev = resolve_device(device)
    images = _as_np(images)
    if images.ndim != 4:
        raise ValueError(f"Expected (N, H, W, C) images, got {images.shape}")
    if limit is not None and 0 < limit < images.shape[0]:
        images = images[:limit]
    x = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    n, hgt, wid, c = x.shape
    p = int(patch_size)
    if hgt % p or wid % p:
        raise ValueError(f"image {hgt}x{wid} not tileable by patch {p}")
    patches = x.reshape(n, hgt // p, p, wid // p, p, c).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(-1, p * p * c)
    mean = patches.mean(dim=0)
    centered = (patches - mean).double()
    dof = max(1, centered.shape[0] - 1)
    cov = centered.T @ centered / dof
    eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
    eigvals, eigvecs = eigvals.flip(0).clamp_min(0.0), eigvecs.flip(1)
    total = float(eigvals.sum())
    evr = eigvals / total if total > 0 else eigvals
    return {
        "components": eigvecs.float().cpu().numpy(),
        "singular_values": torch.sqrt(eigvals * dof).float().cpu().numpy(),
        "mean": mean.cpu().numpy(),
        "explained_variance_ratio": evr.float().cpu().numpy(),
        "patch_size": np.asarray(p),
        "num_channels": np.asarray(c),
        "num_patches": np.asarray(patches.shape[0]),
    }
