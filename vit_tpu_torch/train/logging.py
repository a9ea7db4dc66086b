"""Experiment logging: the console always, W&B when asked for and available
(port of ``vit_tpu/train/logging.py``).

The metric key names are ``vit_tpu``'s (``train_loss``, ``val_mae``,
``lr``, ``num_params(M)``, ...), one console line per epoch. With
``use_wandb`` the run is also logged to W&B:
``wandb.init(project, name, dir=$WANDB_DIR, config, reinit=True)``. wandb is
an optional dependency: when it is not installed, or its init fails, the
logger says so and falls back to the console, as ``vit_tpu`` does.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(self, project: str = "vit-tpu", name: str = "run", use_wandb: bool = False,
                 config: Optional[dict] = None, save_artifacts: bool = False) -> None:
        self.name = name
        self._wandb = None
        # Checkpoints go up as W&B model artifacts when saving is on.
        self.save_artifacts = bool(save_artifacts)
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=name,
                                         dir=os.environ.get("WANDB_DIR"), config=config,
                                         reinit=True)
            except ImportError:
                print("[logger] wandb not installed — console logging only")
            except Exception as e:  # offline/service failures must not kill training
                print(f"[logger] wandb init failed ({e}) — console logging only")

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        """To W&B when a run is live; non-epoch metrics (``num_params(M)``,
        step-frequency CKA) go nowhere else, as in vit_tpu."""
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_epoch(self, epoch: int, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        parts = " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in metrics.items()
        )
        print(f"[{self.name}] epoch {epoch}: {parts}", flush=True)
        self.log(metrics, step=step)

    def log_checkpoint(self, path: str, alias: str, metadata: Optional[dict] = None) -> None:
        """Upload a checkpoint directory as a W&B model artifact; a no-op
        without a live run or when artifact saving is off."""
        if self._wandb is None or not self.save_artifacts or not os.path.isdir(path):
            return
        try:
            import wandb

            art = wandb.Artifact(f"model-{self.name}", type="model", metadata=metadata)
            art.add_dir(path)
            self._wandb.log_artifact(art, aliases=[alias])
        except Exception as e:  # artifact failures must not kill training
            print(f"[logger] wandb artifact upload skipped: {e}")

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
