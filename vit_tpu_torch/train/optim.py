"""Optimizer and learning-rate schedule (port of ``vit_tpu/train/optim.py``).

* :class:`OptSpec`, :func:`schedule_scale`, :class:`PlateauScheduler` and
  :class:`EarlyStopping` are ``vit_tpu``'s, as host Python: cosine (per
  epoch, periodic past ``T_max``), onecycle (per step), constant, plateau
  (a host-driven multiplicative scale), none, with the linear warmup prefix.
* :func:`build_optimizer` makes a ``torch.optim`` optimizer for ``adamw``,
  ``adam`` and ``sgd`` with optax's defaults (betas 0.9/0.999, eps 1e-8,
  the config's weight decay, 0 unless set; ``adam``/``sgd`` add it to the
  gradient as optax's ``add_decayed_weights`` does). The other optimizer
  names of ``vit_tpu`` raise ``NotImplementedError``.
* The training step sets the learning rate before each update to
  ``spec.lr * schedule(step) * plateau_scale``, with ``step`` counted
  before the update (:func:`set_learning_rate`), and clips the gradients
  by global norm with optax's rule (:func:`clip_by_global_norm`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import torch

__all__ = [
    "OptSpec",
    "build_optimizer",
    "schedule_scale",
    "set_learning_rate",
    "clip_by_global_norm",
    "PlateauScheduler",
    "EarlyStopping",
]

_PORTED = ("adamw", "adam", "sgd")
_UNPORTED = ("rmsprop", "adadelta", "adagrad", "adamax", "lbfgs", "rprop", "asgd", "sparseadam")


@dataclasses.dataclass
class OptSpec:
    """Resolved optimizer/scheduler configuration (all static)."""

    lr: float = 1e-3
    opt_type: str = "adam"
    weight_decay: float = 0.0
    # First-moment storage dtype for the adam family (``opt.moment_dtype:
    # bf16``): halves optimizer-state HBM for adam/adamw/adamax. Measured on
    # v5e ViT-B/16 bf16 (round 4): ~1.2 ms/step faster. None = fp32.
    moment_dtype: Optional[str] = None
    scheduler: Optional[str] = None  # canonical: cosine|onecycle|constant|plateau|None
    grad_clip: float = 0.5
    # scheduler params
    t_max: int = 100  # cosine period, in epochs
    eta_min: float = 0.0
    pct_start: float = 0.3
    div_factor: float = 25.0
    final_div_factor: float = 1e4
    constant_factor: float = 1.0
    constant_total_iters: int = 1
    plateau_factor: float = 0.1
    plateau_patience: int = 10
    plateau_mode: Optional[str] = None  # None -> follow the monitor's mode
    # warmup
    warmup_epochs: int = 0
    # step geometry
    steps_per_epoch: int = 1
    total_epochs: int = 100
    monitor_metric: str = "loss"

    @classmethod
    def from_config(
        cls,
        config: dict,
        steps_per_epoch: int,
        monitor_metric: str = "loss",
        has_val: bool = True,
    ) -> "OptSpec":
        """Resolve the ``opt`` (+``train``/``warmup``) sections.

        Mirrors ``OptModule.from_config`` + ``configure_optimizers``: the
        plateau scheduler is disabled when there is no validation set
        (`basemodule.py:158-166`).
        """
        opt_cfg = dict(config.get("opt", {}) or {})
        train_cfg = config.get("train", {}) or {}
        warmup_cfg = config.get("warmup", {}) or {}
        total_epochs = int(train_cfg.get("ep", 10))

        sched = opt_cfg.get("lr_sch")
        sched = None if sched is None else str(sched).lower()
        if sched in ("none", "null", ""):
            sched = None
        # canonicalize aliases (cosineannealinglr etc.)
        canonical = None
        if sched is not None:
            for key in ("cosine", "onecycle", "constant", "plateau"):
                if key in sched:
                    canonical = key
                    break
            if canonical is None:
                raise ValueError(f"Unknown scheduler: {sched}")
        if canonical == "plateau" and not has_val:
            print("[optim] no validation set — disabling plateau scheduler")
            canonical = None

        warmup_ratio = float(warmup_cfg.get("ratio", opt_cfg.get("warmup_ratio", 0.0)) or 0.0)
        warmup_epochs = warmup_cfg.get("epochs", opt_cfg.get("warmup_epochs"))
        # Reference kwarg extraction reads the OPT section only:
        # T_max -> opt.ep -> 100 (`optimizer.py:69`); train.ep does NOT
        # feed the cosine period.
        t_max = int(opt_cfg.get("T_max", opt_cfg.get("ep", 100)))
        if warmup_epochs is not None:
            warmup_epochs = int(warmup_epochs)
        elif warmup_ratio > 0:
            # reference computes warmup from T_max/epochs, default 100
            base_epochs = int(opt_cfg.get("T_max", opt_cfg.get("epochs", 100)))
            warmup_epochs = max(1, int(base_epochs * warmup_ratio))
        else:
            warmup_epochs = 0
        if canonical == "onecycle":
            warmup_epochs = 0  # onecycle has built-in warmup

        return cls(
            lr=float(opt_cfg.get("lr", 1e-3)),
            opt_type=str(opt_cfg.get("type", "adam")).lower(),
            weight_decay=float(opt_cfg.get("weight_decay", 0.0) or 0.0),
            moment_dtype=opt_cfg.get("moment_dtype"),
            scheduler=canonical,
            grad_clip=float(train_cfg.get("grad_clip", 0.5)),
            t_max=t_max,
            eta_min=float(opt_cfg.get("eta_min", 0.0)),
            pct_start=float(opt_cfg.get("pct_start", 0.3)),
            div_factor=float(opt_cfg.get("div_factor", 25.0)),
            final_div_factor=float(opt_cfg.get("final_div_factor", 1e4)),
            constant_factor=float(opt_cfg.get("factor", 1.0)),
            constant_total_iters=int(opt_cfg.get("total_iters", 1)),
            plateau_factor=float(opt_cfg.get("factor", 0.1)),
            plateau_patience=int(opt_cfg.get("patience", 10)),
            plateau_mode=opt_cfg.get("mode"),
            warmup_epochs=warmup_epochs,
            steps_per_epoch=max(1, int(steps_per_epoch)),
            total_epochs=total_epochs,
            monitor_metric=monitor_metric,
        )


def _clip(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def schedule_scale(spec: OptSpec) -> Callable[[int], float]:
    """Return ``f(step) -> scale`` (a float), LR = base_lr * scale.

    Epoch-granularity for cosine/constant (+warmup), per-step for onecycle
    — matching the Lightning ``interval`` settings (`optimizer.py:150-172`).
    Host Python in float64 where ``vit_tpu`` traces float32.
    """
    spe = spec.steps_per_epoch
    warm = spec.warmup_epochs

    def f(step):
        step = float(step)
        epoch = math.floor(step / spe)

        if spec.scheduler == "onecycle":
            # torch OneCycleLR phase geometry: the up phase spans
            # float(pct_start * total_steps) - 1 steps (peak at that step),
            # the down phase the remaining total - up - 1.
            total_steps = float(spec.total_epochs * spe)
            init_scale = 1.0 / spec.div_factor
            final_scale = init_scale / spec.final_div_factor
            up = spec.pct_start * total_steps - 1.0
            down = total_steps - up - 1.0
            pct_up = _clip(step / max(up, 1.0))
            scale_up = init_scale + (1.0 - init_scale) * 0.5 * (1 - math.cos(math.pi * pct_up))
            pct_down = _clip((step - up) / max(down, 1.0))
            scale_down = final_scale + (1.0 - final_scale) * 0.5 * (1 + math.cos(math.pi * pct_down))
            return scale_up if step <= up else scale_down

        # epoch-based schedulers, with optional linear warmup prefix
        main_epoch = max(epoch - warm, 0.0)
        if spec.scheduler == "cosine":
            # torch CosineAnnealingLR is PERIODIC: T_cur keeps advancing past
            # T_max and the cosine swings the LR back up (no clamp).
            eta_ratio = spec.eta_min / spec.lr if spec.lr else 0.0
            main = eta_ratio + (1.0 - eta_ratio) * 0.5 * (
                1 + math.cos(math.pi * main_epoch / spec.t_max)
            )
        elif spec.scheduler == "constant":
            main = spec.constant_factor if main_epoch < spec.constant_total_iters else 1.0
        else:  # none / plateau (plateau scale handled by the host)
            main = 1.0

        if warm > 0:
            # torch LinearLR(start_factor=0.1): 0.1 + 0.9 * min(e, warm)/warm
            wfac = 0.1 + 0.9 * _clip(epoch / warm)
            return wfac if epoch < warm else main
        return main

    return f


def build_optimizer(spec: OptSpec, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The core optimizer of ``spec`` over ``params``; its learning rate is
    set every step by :func:`set_learning_rate`."""
    name = spec.opt_type
    if name in _UNPORTED:
        raise NotImplementedError(f"optimizer '{name}' is not ported yet (adamw, adam, sgd are)")
    if name not in _PORTED:
        raise ValueError(f"Unknown optimizer type '{name}'")
    if spec.moment_dtype is not None and str(spec.moment_dtype).lower() not in (
            "f32", "fp32", "float32", "32"):
        raise NotImplementedError("opt.moment_dtype other than fp32 is not ported yet")
    params = list(params)
    wd = spec.weight_decay
    if name == "adamw":
        return torch.optim.AdamW(params, lr=spec.lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=wd)
    if name == "adam":
        return torch.optim.Adam(params, lr=spec.lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=wd)
    return torch.optim.SGD(params, lr=spec.lr, momentum=0.0, weight_decay=wd)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: each gradient becomes
    ``g / norm * max_norm`` when the global L2 norm reaches ``max_norm``
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). Returns the
    norm, on the gradients' device, without a host sync."""
    grads = [g for g in grads if g is not None]
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


class PlateauScheduler:
    """Host-side ReduceLROnPlateau (torch semantics, threshold 1e-4 rel).

    Produces a multiplicative ``scale`` consumed by the train step; calling
    :meth:`step` after each validation epoch updates it.
    """

    def __init__(self, factor: float = 0.1, patience: int = 10, mode: str = "min"):
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.threshold = 1e-4
        self.best: Optional[float] = None
        self.num_bad = 0
        self.scale = 1.0

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best * (1 - self.threshold)
        return value > self.best * (1 + self.threshold)

    def step(self, value: float) -> float:
        if value is None:
            return self.scale
        if not math.isfinite(value):
            # torch ReduceLROnPlateau: NaN fails is_better -> counts as a
            # bad epoch and eventually reduces the LR (which can rescue a
            # diverged run long before the 500-epoch early stop).
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale *= self.factor
                self.num_bad = 0
                print(f"[plateau] reducing LR scale to {self.scale:.3e}")
            return self.scale
        if self._improved(value):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale *= self.factor
                self.num_bad = 0
                print(f"[plateau] reducing LR scale to {self.scale:.3e}")
        return self.scale

    def state_dict(self) -> dict:
        """Persisted in ckpt meta so ``--ckpt`` resume keeps LR reductions
        (torch restores ReduceLROnPlateau state on resume)."""
        return {"best": self.best, "num_bad": self.num_bad, "scale": self.scale}

    def load_state_dict(self, d: dict) -> None:
        self.best = d.get("best")
        self.num_bad = int(d.get("num_bad", 0))
        self.scale = float(d.get("scale", 1.0))


class EarlyStopping:
    """Host-side early stopping on the monitored metric.

    Reference patience: 500 (run) / 100 (sweep), optional divergence
    threshold (`vit.py:364-365,417-425`).
    """

    def __init__(
        self,
        patience: int = 500,
        mode: str = "min",
        divergence_threshold: Optional[float] = None,
    ):
        self.patience = patience
        self.mode = mode
        self.divergence_threshold = divergence_threshold
        self.best: Optional[float] = None
        self.num_bad = 0

    def step(self, value: float) -> bool:
        """Returns True when training should stop."""
        if value is None or not math.isfinite(value):
            self.num_bad += 1
            return self.num_bad >= self.patience
        if self.divergence_threshold is not None:
            diverged = (
                value > self.divergence_threshold
                if self.mode == "min"
                else value < self.divergence_threshold
            )
            if diverged:
                print(f"[early-stop] metric {value:.4g} crossed divergence threshold")
                return True
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best)
            or (self.mode == "max" and value > self.best)
        )
        if improved:
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
        return self.num_bad >= self.patience

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.best = d.get("best")
        self.num_bad = int(d.get("num_bad", 0))
