"""CKA between two sets of representations (port of ``compute_cka`` and its
helpers from ``vit_tpu/prepca/pipeline.py``).

Host code in numpy float64, as in ``vit_tpu``. The rest of the offline
statistics (PCA, KPCA, ZCA, PCP and their CLIs) is not ported yet; the
covariance statistics the preprocessors read are in :mod:`.stats`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["compute_cka"]


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
