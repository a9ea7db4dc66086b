"""Shared viz helpers (port of ``vit_tpu/viz/viz_utils.py``): label
denormalisation, per-output metrics, the axis-level plot primitives and the
multi-output 3-row figure. Host-side numpy and matplotlib; matplotlib is
imported only by the functions that draw.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "denormalize",
    "calculate_metrics",
    "plot_scatter_axis",
    "plot_residual_axis",
    "plot_error_vs_true_axis",
    "label_axis_bounds",
    "multi_output_figure",
]


def denormalize(
    y: np.ndarray,
    label_norm: str = "none",
    label_mean: Optional[np.ndarray] = None,
    label_std: Optional[np.ndarray] = None,
    label_min: Optional[np.ndarray] = None,
    label_max: Optional[np.ndarray] = None,
    eps: float = 1e-8,
) -> np.ndarray:
    """Invert 'standard'/'zscore' or 'minmax' label normalisation."""
    y = np.asarray(y, np.float64)
    kind = (label_norm or "none").lower()
    if kind in ("standard", "zscore") and label_mean is not None and label_std is not None:
        std = np.where(np.abs(label_std) < eps, 1.0, label_std)
        return y * std + label_mean
    if kind == "minmax" and label_min is not None and label_max is not None:
        denom = label_max - label_min
        denom = np.where(np.abs(denom) < eps, 1.0, denom)
        return y * denom + label_min
    return y


def calculate_metrics(preds: np.ndarray, labels: np.ndarray) -> List[Dict[str, float]]:
    """Per-output MAE / RMSE / R2 / mean / std of the residuals."""
    preds = preds.reshape(preds.shape[0], -1).astype(np.float64)
    labels = labels.reshape(labels.shape[0], -1).astype(np.float64)
    out = []
    for j in range(preds.shape[1]):
        resid = preds[:, j] - labels[:, j]
        ss_tot = ((labels[:, j] - labels[:, j].mean()) ** 2).sum()
        r2 = 1.0 - (resid**2).sum() / max(ss_tot, 1e-30)
        out.append({"mae": float(np.abs(resid).mean()),
                    "rmse": float(np.sqrt((resid**2).mean())),
                    "r2": float(r2),
                    "mean": float(resid.mean()),
                    "std": float(resid.std())})
    return out


def plot_scatter_axis(ax, labels, preds, name: str = "", lim=None) -> None:
    """Pred-vs-true scatter with the identity line and a metrics inset."""
    m = calculate_metrics(preds[:, None], labels[:, None])[0]
    ax.scatter(labels, preds, s=6, alpha=0.4, edgecolors="none")
    lo = min(labels.min(), preds.min()) if lim is None else lim[0]
    hi = max(labels.max(), preds.max()) if lim is None else lim[1]
    ax.plot([lo, hi], [lo, hi], "k--", lw=1)
    ax.set_xlim(lo, hi)
    ax.set_ylim(lo, hi)
    ax.set_xlabel(f"true {name}")
    ax.set_ylabel(f"pred {name}")
    ax.text(0.03, 0.97, f"MAE={m['mae']:.4f}\nRMSE={m['rmse']:.4f}\nR2={m['r2']:.4f}",
            transform=ax.transAxes, va="top", fontsize=8,
            bbox=dict(facecolor="white", alpha=0.7, edgecolor="none"))


def plot_residual_axis(ax, labels, preds, name: str = "", bins: int = 40) -> None:
    resid = preds - labels
    ax.hist(resid, bins=bins, alpha=0.75)
    ax.axvline(0.0, color="k", ls="--", lw=1)
    ax.axvline(float(np.median(resid)), color="r", ls="-", lw=1, label="median")
    ax.set_xlabel(f"residual {name}")
    ax.set_ylabel("count")
    ax.legend(fontsize=7)


def plot_error_vs_true_axis(ax, labels, preds, name: str = "", xlim=None) -> None:
    err = np.abs(preds - labels)
    ax.scatter(labels, err, s=6, alpha=0.4, edgecolors="none")
    order = np.argsort(labels)  # binned trend
    n_bins = min(20, max(2, len(labels) // 20))
    splits = np.array_split(order, n_bins)
    xs = [labels[s].mean() for s in splits if len(s)]
    ys = [err[s].mean() for s in splits if len(s)]
    ax.plot(xs, ys, "r-", lw=1.5, label="binned mean")
    if xlim is not None:
        ax.set_xlim(xlim[0], xlim[1])
    ax.set_xlabel(f"true {name}")
    ax.set_ylabel("|error|")
    ax.legend(fontsize=7)


def label_axis_bounds(labels: np.ndarray, label_norm=None, label_min=None,
                      label_max=None) -> List[tuple]:
    """Fixed per-output axis bounds, so figures and GIF frames compare across
    epochs and runs: the ORIGINAL parameter ranges when minmax label stats
    exist, else the data range with a 5% margin."""
    labels = np.reshape(np.asarray(labels, np.float64), (len(labels), -1))
    n = labels.shape[1]
    if (label_norm == "minmax" and label_min is not None and label_max is not None
            and np.size(label_min) >= n):
        lo = np.ravel(np.asarray(label_min, np.float64))
        hi = np.ravel(np.asarray(label_max, np.float64))
        return [(float(lo[j]), float(hi[j])) for j in range(n)]
    out = []
    for j in range(n):
        lo, hi = float(labels[:, j].min()), float(labels[:, j].max())
        margin = (hi - lo) * 0.05
        out.append((lo - margin, hi + margin))
    return out


def multi_output_figure(preds: np.ndarray, labels: np.ndarray, names: List[str],
                        title: str = "", bounds=None):
    """3-row (scatter / residual / error-vs-true) x n-output summary figure;
    ``bounds`` (per-output (lo, hi)) pins the true/pred axes."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    preds = preds.reshape(preds.shape[0], -1)
    labels = labels.reshape(labels.shape[0], -1)
    n = preds.shape[1]
    fig, axes = plt.subplots(3, n, figsize=(4.2 * n, 11), squeeze=False)
    for j in range(n):
        name = names[j] if j < len(names) else str(j)
        lim = bounds[j] if bounds is not None and j < len(bounds) else None
        plot_scatter_axis(axes[0][j], labels[:, j], preds[:, j], name, lim=lim)
        plot_residual_axis(axes[1][j], labels[:, j], preds[:, j], name)
        plot_error_vs_true_axis(axes[2][j], labels[:, j], preds[:, j], name, xlim=lim)
    if title:
        fig.suptitle(title, fontsize=11)
    fig.tight_layout()
    return fig
