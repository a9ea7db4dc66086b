"""Covariance statistics with diagnostics and self-checks (port of
``vit_tpu/prepca/stats.py``).

* :class:`CovarianceStats`, the container of mean, unbiased covariance,
  sample count and the eigen-decomposition;
* :func:`compute_covariance_stats`: mean and ``Xc^T Xc / (n - 1)`` with the
  product on ``device`` in fp32 (TF32 is left off: whitening matrices are
  ill-conditioned), then the symmetrised float64 ``eigh`` on the host,
  negative eigenvalues clipped to 0, sorted descending; optionally saved
  with a covariance heatmap and an eigenvalue-spectrum PNG, whose failure
  never fails the factory;
* :func:`load_or_compute_covariance` and :func:`ensure_covariance`;
* :func:`zca_self_check`: ``P^T (Sigma + eps I) P`` within 10% of the
  identity, the reference's numerical gate.

Artifacts are ``.npz`` or ``.pt`` and load with
:func:`vit_tpu_torch.utils.load_cov_stats`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from vit_tpu_torch.utils import load_cov_stats, save_cov_stats

__all__ = [
    "CovarianceStats",
    "compute_covariance_stats",
    "load_covariance_stats",
    "load_or_compute_covariance",
    "ensure_covariance",
    "zca_self_check",
]


@dataclasses.dataclass
class CovarianceStats:
    mean: np.ndarray
    cov: np.ndarray
    num_samples: int
    eigvals: np.ndarray
    eigvecs: np.ndarray
    source_path: Optional[str] = None

    def as_dict(self) -> dict:
        return {
            "mean": self.mean,
            "cov": self.cov,
            "num_samples": np.asarray(self.num_samples),
            "eigvals": self.eigvals,
            "eigvecs": self.eigvecs,
        }


def _sorted_eigh_sym(cov: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetrise, ``eigh`` in float64, clip negative eigenvalues, sort descending."""
    cov_sym = 0.5 * (cov + cov.T)
    eigvals, eigvecs = np.linalg.eigh(cov_sym.astype(np.float64))
    eigvals = np.clip(eigvals, 0.0, None)
    order = np.argsort(eigvals)[::-1]
    return eigvals[order], eigvecs[:, order], cov_sym


def _device_covariance(data: np.ndarray, device) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and unbiased covariance; the ``Xc^T Xc`` product runs on ``device``."""
    from vit_tpu_torch.serve import resolve_device

    x = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(resolve_device(device))
    mean = x.mean(dim=0)
    c = x - mean
    cov = torch.matmul(c.t(), c) / (x.shape[0] - 1)
    return mean.cpu().numpy(), cov.cpu().numpy()


def compute_covariance_stats(
    data: np.ndarray,
    save_path: Optional[str] = None,
    wave: Optional[np.ndarray] = None,
    src_path: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> CovarianceStats:
    """mean/cov/eigvals/eigvecs of ``data`` (N, D); optionally saved with
    its two diagnostic plots."""
    data = np.asarray(data, dtype=np.float32)
    mean, cov = _device_covariance(data, device)
    eigvals, eigvecs, cov = _sorted_eigh_sym(cov)
    stats = CovarianceStats(
        mean=mean.astype(np.float32),
        cov=cov.astype(np.float32),
        num_samples=int(data.shape[0]),
        eigvals=eigvals.astype(np.float32),
        eigvecs=eigvecs.astype(np.float32),
        source_path=save_path,
    )
    if save_path is not None:
        save_cov_stats(stats.as_dict(), str(save_path))
        print(f"Saved covariance statistics to {save_path}")
        base, _ = os.path.splitext(str(save_path))
        try:
            plot_covariance_heatmap(stats.cov, f"{base}_heatmap.png", wave=wave,
                                    src_path=src_path)
            plot_eigenvalue_spectrum(stats.eigvals, f"{base}_eigenvalues.png",
                                     num_samples=stats.num_samples)
        except Exception as e:  # diagnostics must not fail the factory
            print(f"[stats] diagnostic plots skipped: {e}")
    return stats


def load_covariance_stats(path: str) -> CovarianceStats:
    raw = load_cov_stats(str(path), use_cache=False)
    n = raw.get("num_samples")
    return CovarianceStats(
        mean=raw["mean"],
        cov=raw["cov"],
        num_samples=int(np.asarray(n)) if n is not None else -1,
        eigvals=raw["eigvals"],
        eigvecs=raw["eigvecs"],
        source_path=str(path),
    )


def load_or_compute_covariance(
    cov_path: Optional[str],
    data: Optional[np.ndarray] = None,
    save_path: Optional[str] = None,
    wave: Optional[np.ndarray] = None,
    src_path: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> CovarianceStats:
    """Load ``cov_path`` if it exists, else compute from ``data`` and save."""
    if cov_path is not None and os.path.exists(str(cov_path)):
        return load_covariance_stats(str(cov_path))
    if data is None:
        raise ValueError(
            "Data must be provided when covariance file doesn't exist or cov_path is None"
        )
    target = save_path or cov_path or "data/pca/covariance_stats.npz"
    os.makedirs(os.path.dirname(os.path.abspath(str(target))), exist_ok=True)
    print("Computing covariance statistics from data...")
    return compute_covariance_stats(data, save_path=str(target), wave=wave, src_path=src_path,
                                    device=device)


def ensure_covariance(
    cov_path: str,
    data: Optional[np.ndarray] = None,
    compute_if_missing: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> dict:
    """Dict-format covariance loader."""
    if os.path.exists(cov_path):
        return load_covariance_stats(cov_path).as_dict()
    if not compute_if_missing:
        raise FileNotFoundError(
            f"Covariance file {cov_path} not found and computation disabled"
        )
    return load_or_compute_covariance(cov_path, data=data, device=device).as_dict()


def zca_self_check(
    P: np.ndarray,
    cov_hat: np.ndarray,
    *,
    eps: float = 0.0,
    lowrank: bool = False,
    Vr: Optional[np.ndarray] = None,
) -> Tuple[float, float, float]:
    """Assert ``P^T (Sigma + eps I) P ≈ I`` (Frobenius relative error under
    10%); returns (rel_err, cond_before, cond_after), raises AssertionError
    on failure."""
    P = np.asarray(P, np.float64)
    cov_hat = np.asarray(cov_hat, np.float64)
    Ihat = P.T @ (cov_hat + eps * np.eye(cov_hat.shape[0])) @ P
    if lowrank:
        if Vr is None:
            raise ValueError("Vr basis must be provided for low-rank checks")
        Vr = np.asarray(Vr, np.float64)
        Ihat = Vr.T @ Ihat @ Vr
        I = np.eye(Vr.shape[1])  # noqa: E741
    else:
        I = np.eye(P.shape[0])  # noqa: E741
    rel = float(np.linalg.norm(Ihat - I) / np.linalg.norm(I))
    if rel >= 0.1:
        raise AssertionError(f"ZCA self-check failed: rel={rel:.3e}")
    lam = np.clip(np.linalg.eigvalsh(cov_hat), 1e-18, None)
    cond_before = float(lam.max() / lam.min())
    lam2 = np.clip(np.linalg.eigvalsh(0.5 * (Ihat + Ihat.T)), 1e-18, None)
    cond_after = float(lam2.max() / lam2.min())
    if abs(cond_after) - 1 >= 0.1:
        raise AssertionError(f"ZCA self-check failed: cond_after={cond_after:.3e}")
    return rel, cond_before, cond_after


def plot_covariance_heatmap(
    cov: np.ndarray,
    path: str,
    wave: Optional[np.ndarray] = None,
    src_path: Optional[str] = None,
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 6))
    extent = None
    if wave is not None and len(wave) == cov.shape[0]:
        extent = [wave[0], wave[-1], wave[-1], wave[0]]
    im = ax.imshow(cov, aspect="auto", cmap="RdBu_r", extent=extent)
    title = f"Covariance matrix ({cov.shape[0]}x{cov.shape[1]})"
    if src_path:
        title += f"\n{os.path.basename(str(src_path))}"
    ax.set_title(title)
    ax.set_xlabel("wavelength" if extent else "pixel")
    ax.set_ylabel("wavelength" if extent else "pixel")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_eigenvalue_spectrum(eigvals: np.ndarray, path: str, num_samples: int = -1) -> None:
    """Three panels: the spectrum, the shrinkage's effect, the whitening weights."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    eigvals = np.asarray(eigvals, np.float64)
    pos = np.clip(eigvals, 1e-18, None)
    fig, axes = plt.subplots(1, 3, figsize=(16, 4.5))

    ax = axes[0]
    ax.semilogy(pos, lw=1)
    ax.set_title(f"Eigenvalue spectrum (n={num_samples})")
    ax.set_xlabel("component")
    ax.set_ylabel("eigenvalue")

    ax = axes[1]
    for shrink in (0.0, 0.1, 0.3):
        lam_hat = (1 - shrink) * eigvals + shrink * eigvals.mean()
        ax.semilogy(np.clip(lam_hat, 1e-18, None), lw=1, label=f"shrinkage={shrink}")
    ax.set_title("Shrinkage toward mean")
    ax.set_xlabel("component")
    ax.legend()

    ax = axes[2]
    for eps in (1e-5, 1e-3):
        ax.semilogy(1.0 / np.sqrt(pos + eps), lw=1, label=f"eps={eps}")
    ax.set_title("Whitening weights 1/sqrt(lam+eps)")
    ax.set_xlabel("component")
    ax.legend()

    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
