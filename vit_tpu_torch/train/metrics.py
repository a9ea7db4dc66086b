"""Metrics (port of ``vit_tpu/train/metrics.py``: host-side numpy, computed
from collected predictions).

Replaces torchmetrics (reference `src/vit.py:66-73`) and the
regression extras computed at validation-epoch end
(reference `src/vit.py:157-187`):

* cls: ``acc`` (multiclass accuracy).
* reg: ``mae``, ``mse``, ``r2`` (uniform average over outputs, torchmetrics
  default), plus per-output ``bias_median`` (median residual), ``p90``
  (90th percentile of |residual|), ``beta`` (slope of the pred-vs-label
  linear fit).

Eval batches are padded to static shapes; callers pass only the real rows
(the Batcher's ``mask`` selects them before collection), so these are exact.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "classification_metrics",
    "regression_metrics",
    "regression_extras",
    "monitor_for_task",
]


def monitor_for_task(task_type: str):
    """(metric_key, mode): cls -> ('acc','max'); reg -> ('mae','min')."""
    if task_type == "cls":
        return "acc", "max"
    return "mae", "min"


def classification_metrics(logits: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    preds = np.argmax(logits, axis=-1)
    return {"acc": float((preds == labels.astype(preds.dtype)).mean())}


def regression_metrics(preds: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    preds = preds.reshape(preds.shape[0], -1).astype(np.float64)
    labels = labels.reshape(labels.shape[0], -1).astype(np.float64)
    err = preds - labels
    mae = float(np.abs(err).mean())
    mse = float((err**2).mean())
    # R^2 per output, uniform average (torchmetrics R2Score default)
    ss_res = (err**2).sum(axis=0)
    ss_tot = ((labels - labels.mean(axis=0)) ** 2).sum(axis=0)
    r2 = np.where(ss_tot > 0, 1.0 - ss_res / np.maximum(ss_tot, 1e-30), 0.0)
    return {"mae": mae, "mse": mse, "r2": float(r2.mean())}


def regression_extras(
    preds: np.ndarray,
    labels: np.ndarray,
    param_names: Optional[List[str]] = None,
) -> Dict[str, float]:
    """Per-output robust diagnostics: bias_median, p90, beta."""
    preds = preds.reshape(preds.shape[0], -1).astype(np.float64)
    labels = labels.reshape(labels.shape[0], -1).astype(np.float64)
    n_out = preds.shape[1]
    names = param_names if param_names and len(param_names) == n_out else [
        str(i) for i in range(n_out)
    ]
    out: Dict[str, float] = {}
    for j, name in enumerate(names):
        resid = preds[:, j] - labels[:, j]
        suffix = "" if n_out == 1 else f"_{name}"
        out[f"bias_median{suffix}"] = float(np.median(resid))
        out[f"p90{suffix}"] = float(np.percentile(np.abs(resid), 90))
        var = np.var(labels[:, j])
        if var > 1e-30:
            beta = float(np.cov(labels[:, j], preds[:, j])[0, 1] / var)
        else:
            beta = 0.0
        out[f"beta{suffix}"] = beta
    return out
