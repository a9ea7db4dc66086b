"""Test-time regression report (port of ``vit_tpu/viz/plotter.py``).

``RegressionPlotter`` denormalises predictions and labels, then draws
pred-vs-true scatters with an MAE/RMSE/R2 inset, residual histograms,
|error|-vs-true, per-parameter metric bars, the residual-correlation
heatmap, Q-Q plots and a 3xN summary, and prints a percentile table
(50/75/90/95/99) of |residual|. Figures go to W&B images when a live
logger exists, else to PNGs under ``$PLOT_DIR`` (default
``./results/plots``). Host-side numpy, scipy and matplotlib.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from vit_tpu_torch.viz.viz_utils import (
    calculate_metrics,
    multi_output_figure,
    plot_error_vs_true_axis,
    plot_residual_axis,
    plot_scatter_axis,
)

__all__ = ["RegressionPlotter"]


def _plot_dir() -> str:
    return os.environ.get("PLOT_DIR", "./results/plots")


class RegressionPlotter:
    def __init__(
        self,
        param_names: Optional[List[str]] = None,
        denormalize: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        model_name: str = "model",
        quick_mode: bool = False,
        label_bounds: Optional[List[tuple]] = None,
    ) -> None:
        self.param_names = param_names or []
        self.denormalize = denormalize or (lambda y: y)
        self.model_name = model_name
        self.quick_mode = quick_mode
        # fixed per-output (lo, hi) axis bounds in denormalised units: the
        # original parameter ranges, so reports compare across runs; when
        # None they fall back to the data range + 5% margin
        self.label_bounds = label_bounds

    # -- output routing ---------------------------------------------------
    def _emit(self, fig, name: str, logger=None) -> None:
        import matplotlib.pyplot as plt

        wandb_run = getattr(logger, "_wandb", None) if logger is not None else None
        if wandb_run is not None:
            import wandb

            wandb_run.log({f"test/{name}": wandb.Image(fig)})
        else:
            out_dir = os.path.join(_plot_dir(), self.model_name)
            os.makedirs(out_dir, exist_ok=True)
            fig.savefig(os.path.join(out_dir, f"{name}.png"), dpi=120)
        plt.close(fig)

    # -- figures -----------------------------------------------------------
    def generate_all_plots(self, preds: np.ndarray, labels: np.ndarray, logger=None) -> dict:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        preds = self.denormalize(np.asarray(preds, np.float64).reshape(len(preds), -1))
        labels = self.denormalize(np.asarray(labels, np.float64).reshape(len(labels), -1))
        n_out = preds.shape[1]
        names = [
            self.param_names[j] if j < len(self.param_names) else str(j)
            for j in range(n_out)
        ]
        metrics = calculate_metrics(preds, labels)
        from vit_tpu_torch.viz.viz_utils import label_axis_bounds

        bounds = self.label_bounds or label_axis_bounds(labels)

        # 1. pred-vs-true scatter grid
        fig, axes = plt.subplots(1, n_out, figsize=(4.5 * n_out, 4.2), squeeze=False)
        for j in range(n_out):
            lim = bounds[j] if j < len(bounds) else None
            plot_scatter_axis(axes[0][j], labels[:, j], preds[:, j], names[j], lim=lim)
        fig.suptitle(f"{self.model_name}: predictions")
        fig.tight_layout()
        self._emit(fig, "pred_vs_true", logger)

        # 2. residual histograms
        fig, axes = plt.subplots(1, n_out, figsize=(4.5 * n_out, 3.6), squeeze=False)
        for j in range(n_out):
            plot_residual_axis(axes[0][j], labels[:, j], preds[:, j], names[j])
        fig.tight_layout()
        self._emit(fig, "residual_hist", logger)

        if not self.quick_mode:
            # 3. |error| vs true
            fig, axes = plt.subplots(1, n_out, figsize=(4.5 * n_out, 3.6), squeeze=False)
            for j in range(n_out):
                plot_error_vs_true_axis(
                    axes[0][j], labels[:, j], preds[:, j], names[j],
                    xlim=bounds[j] if j < len(bounds) else None,
                )
            fig.tight_layout()
            self._emit(fig, "error_vs_true", logger)

            # 4. per-parameter metric bars
            fig, ax = plt.subplots(figsize=(1.6 * max(3, n_out) + 2, 3.6))
            width = 0.35
            x = np.arange(n_out)
            ax.bar(x - width / 2, [m["mae"] for m in metrics], width, label="MAE")
            ax.bar(x + width / 2, [m["rmse"] for m in metrics], width, label="RMSE")
            ax.set_xticks(x)
            ax.set_xticklabels(names)
            ax.set_title("per-parameter error")
            ax.legend()
            fig.tight_layout()
            self._emit(fig, "metric_bars", logger)

            # 5. residual correlation heatmap (multi-output only)
            if n_out > 1:
                resid = preds - labels
                corr = np.corrcoef(resid.T)
                fig, ax = plt.subplots(figsize=(1.2 * n_out + 2, 1.0 * n_out + 2))
                im = ax.imshow(corr, vmin=-1, vmax=1, cmap="RdBu_r")
                ax.set_xticks(range(n_out))
                ax.set_xticklabels(names, rotation=45)
                ax.set_yticks(range(n_out))
                ax.set_yticklabels(names)
                for a in range(n_out):
                    for b in range(n_out):
                        ax.text(b, a, f"{corr[a, b]:.2f}", ha="center", va="center", fontsize=8)
                fig.colorbar(im, ax=ax)
                ax.set_title("residual correlation")
                fig.tight_layout()
                self._emit(fig, "residual_corr", logger)

            # 6. Q-Q plots of residuals
            from scipy import stats as sstats

            fig, axes = plt.subplots(1, n_out, figsize=(4.0 * n_out, 3.6), squeeze=False)
            for j in range(n_out):
                sstats.probplot(preds[:, j] - labels[:, j], dist="norm", plot=axes[0][j])
                axes[0][j].set_title(f"Q-Q {names[j]}", fontsize=9)
            fig.tight_layout()
            self._emit(fig, "qq_residuals", logger)

        # 7. comprehensive 3xN summary
        fig = multi_output_figure(
            preds, labels, names, title=self.model_name, bounds=bounds
        )
        self._emit(fig, "summary", logger)

        # console percentile table
        print(f"\n[{self.model_name}] |residual| percentiles:")
        header = f"{'param':>10s} " + " ".join(f"p{p:<4d}" for p in (50, 75, 90, 95, 99))
        print(header)
        for j in range(n_out):
            ae = np.abs(preds[:, j] - labels[:, j])
            row = " ".join(f"{np.percentile(ae, p):.4f}" for p in (50, 75, 90, 95, 99))
            print(f"{names[j]:>10s} {row}")

        return {names[j]: metrics[j] for j in range(n_out)}
