"""Viz monitors from the ``viz`` config section (port of
``vit_tpu/viz/callback_factory.py``): the GIF diagnostics, and the CKA
monitor when ``viz.compute_cka`` (default true), with their epoch or step
frequency. Local artifacts follow ``train.save`` unless ``viz.save_local``
says otherwise.
"""

from __future__ import annotations

from typing import Optional, Tuple

from vit_tpu_torch.viz.diagnostics import CKAMonitor, VizDiagnostics

__all__ = ["create_viz_callbacks"]


def create_viz_callbacks(
    viz_cfg: Optional[dict],
    save_enabled: bool = True,
    model_name: str = "model",
    param_names: Optional[list] = None,
    denormalize=None,
    label_bounds: Optional[list] = None,
) -> Tuple[Optional[VizDiagnostics], Optional[CKAMonitor], int, int]:
    """Returns (viz, cka, log_every_n_epochs, log_every_n_steps).

    ``(None, None, 0, 0)`` when disabled. The step frequency takes
    precedence when set: the loop captures diagnostics every N optimizer
    steps.
    """
    viz_cfg = viz_cfg or {}
    if not viz_cfg.get("enable", False):
        return None, None, 0, 0
    every = int(viz_cfg.get("log_every_n_epochs", 1) or 1)
    every_steps = int(viz_cfg.get("log_every_n_steps", 0) or 0)
    viz = VizDiagnostics(
        viz_cfg,
        model_name=model_name,
        param_names=param_names,
        denormalize=denormalize,
        label_bounds=label_bounds,
        # viz.save_local overrides the train.save default; without either,
        # artifacts go to W&B only (or nowhere when no run is live).
        save_enabled=bool(viz_cfg.get("save_local", save_enabled)),
    )
    cka = CKAMonitor() if viz_cfg.get("compute_cka", True) else None
    return viz, cka, every, every_steps
