"""Experiment logging to the console (port of ``vit_tpu/train/logging.py``).

The metric key names are ``vit_tpu``'s (``train_loss``, ``val_mae``,
``lr``, ``num_params(M)``, ...), one line per epoch. W&B logging is not
ported: asking for it raises.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(self, project: str = "vit-tpu", name: str = "run", use_wandb: bool = False,
                 config: Optional[dict] = None, save_artifacts: bool = False) -> None:
        if use_wandb:
            raise NotImplementedError("W&B logging is not ported yet: pass use_wandb=False / -w 0")
        self.name = name

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        """Non-epoch metrics (``num_params(M)``) go to W&B only, as in vit_tpu."""

    def log_epoch(self, epoch: int, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        parts = " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in metrics.items()
        )
        print(f"[{self.name}] epoch {epoch}: {parts}", flush=True)
        self.log(metrics, step=step)

    def log_checkpoint(self, path: str, alias: str, metadata: Optional[dict] = None) -> None:
        """W&B model artifacts: nothing to upload without W&B."""

    def finish(self) -> None:
        pass
