"""The training loop and the ``Experiment`` facade (port of
``vit_tpu/train/loop.py``, single device).

One training step (``_make_grads_fn`` :168 and ``_make_step_body`` :242):

* draw the step's dropout seeds on the host, one int32 per dropout call
  site (and per micro-batch), from the Experiment's CPU
  ``torch.Generator`` seeded from ``seed``; they reach the kernels as
  arguments, so the CPU and the card draw the same masks for the same step
  and a resumed run draws what the uninterrupted one would;
* optional noise injection ``x + randn * error * noise_level``, the normal
  draws from a second CPU generator;
* loss and gradients, over ``train.accumulate_steps`` micro-batches whose
  gradients are summed and scaled by 1/A;
* global-norm clip (``train.grad_clip``, 0.5) with optax's rule;
* the update at learning rate ``spec.lr * schedule(step) * plateau_scale``
  with ``step`` counted before the update.

``Experiment.fit`` runs epochs of such steps over ``Batcher`` batches
copied ahead to the device, evaluates the validation split in masked
fixed-size batches, steps ReduceLROnPlateau and early stopping (patience
500, 100 in a sweep) on ``val_<monitor>``, and writes best/last
checkpoints; ``--ckpt`` resumes the optimizer, step, plateau scale,
generators and host scheduler states. ``test`` evaluates a checkpoint on
the test split.

Runs on the card unless ``device="cpu"`` is given. ``fused_epoch``,
``epochs_per_dispatch`` and ``epoch_gather`` are TPU dispatch strategies
that equal this per-step path by ``vit_tpu``'s own invariant (:242-246),
so they are ignored with a note. Multi-device training, model/sequence/
pipeline parallelism, optimizer-state sharding, ``log_mfu``/``profile``,
diagnostics capture (``viz.enable``), MoE and preprocessors raise.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vit_tpu_torch.data.datasets import RegSpecDataset, SpecDataModule, parse_param_list
from vit_tpu_torch.data.pipeline import Batcher, prefetch_to_device
from vit_tpu_torch.models.builder import get_model
from vit_tpu_torch.models.vit import compute_loss
from vit_tpu_torch.serve import resolve_device
from vit_tpu_torch.train.checkpoint import CheckpointManager, default_ckpt_dir
from vit_tpu_torch.train.logging import MetricLogger
from vit_tpu_torch.train.metrics import (
    classification_metrics,
    monitor_for_task,
    regression_extras,
    regression_metrics,
)
from vit_tpu_torch.train.optim import (
    EarlyStopping,
    OptSpec,
    PlateauScheduler,
    build_optimizer,
    clip_by_global_norm,
    schedule_scale,
    set_learning_rate,
)
from vit_tpu_torch.utils import count_params, seed_everything

__all__ = ["Experiment", "loss_and_grads", "draw_seeds"]

SEED_HIGH = 2**31 - 1  # seeds are drawn in [0, int32 max), as vit_tpu's randint

_IGNORED = ("fused_epoch", "epochs_per_dispatch", "epoch_gather")


def draw_seeds(gen: torch.Generator, micro_batches: int, sites: int) -> List[List[int]]:
    """One int32 dropout seed per (micro-batch, call site), on the host."""
    return torch.randint(0, SEED_HIGH, (micro_batches, sites), generator=gen).tolist()


def loss_and_grads(module: torch.nn.Module, batch: Dict[str, torch.Tensor], task: str,
                   loss_name: str, seeds: List[List[int]], noise_level: float = 0.0,
                   noise_gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """The step's loss (a 0-d tensor on the batch's device), with the
    gradients of the mean over ``len(seeds)`` equal micro-batches left in
    the parameters' ``.grad`` (zeroed first). ``_make_grads_fn``."""
    for p in module.parameters():
        p.grad = None
    x, y = batch["x"], batch["label"]
    accum = len(seeds)
    if x.shape[0] % accum != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by accumulate_steps {accum}")
    mb = x.shape[0] // accum
    total = None
    for a in range(accum):
        xa = x[a * mb:(a + 1) * mb]
        if noise_level > 0 and "error" in batch:
            noise = torch.randn(xa.shape, generator=noise_gen).to(xa.device)
            xa = xa + noise * batch["error"][a * mb:(a + 1) * mb] * noise_level
        loss = compute_loss(module(xa, dropout_seeds=seeds[a]), y[a * mb:(a + 1) * mb],
                            task, loss_name)
        loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    if accum > 1:
        for p in module.parameters():
            if p.grad is not None:
                p.grad.mul_(1.0 / accum)
        return total * (1.0 / accum)
    return total


def _host_loss(logits: np.ndarray, labels: np.ndarray, task: str, loss_name: str) -> float:
    if task == "cls":
        z = logits - logits.max(axis=-1, keepdims=True)
        logp = z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
        return float(-logp[np.arange(len(labels)), labels.astype(int)].mean())
    diff = logits.reshape(len(logits), -1) - labels.reshape(len(labels), -1)
    if "l1" in (loss_name or "l2").lower():
        return float(np.abs(diff).mean())
    return float((diff**2).mean())


def _reject_unported(config: dict, use_wandb: bool, num_devices: Optional[int]) -> None:
    t = config.get("train", {}) or {}
    gpus = num_devices if num_devices is not None else t.get("gpus")
    asked = {
        "multi-device training (gpus > 1)": gpus not in (None, 0, 1),
        "train.model_parallel": int(t.get("model_parallel", 1) or 1) > 1,
        "train.sequence_parallel": int(t.get("sequence_parallel", 1) or 1) > 1,
        "train.pipeline_parallel": int(t.get("pipeline_parallel", 1) or 1) > 1,
        "train.opt_state_sharding": bool(t.get("opt_state_sharding", False)),
        "train.log_mfu": bool(t.get("log_mfu", False)),
        "train.profile": bool(t.get("profile")),
        "viz.enable (diagnostics capture)": bool((config.get("viz", {}) or {}).get("enable")),
        "W&B logging": bool(use_wandb),
    }
    for what, on in asked.items():
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


class Experiment:
    """Build model, data and optimizer, then ``fit`` / ``test`` / ``run``.

    ``datamodule``: an already built :class:`SpecDataModule` (e.g. over
    in-memory spectra) in place of the one the config's paths describe.
    """

    def __init__(self, config: dict, use_wandb: bool = False, sweep: bool = False,
                 ckpt_path: Optional[str] = None, num_devices: Optional[int] = None,
                 seed: int = 42, device="cuda",
                 datamodule: Optional[SpecDataModule] = None) -> None:
        self.device = resolve_device(device)
        _reject_unported(config, use_wandb, num_devices)
        self.config = config
        self.sweep = sweep
        self.ckpt_path = ckpt_path
        self.seed = seed
        seed_everything(seed)
        train_cfg = config.get("train", {}) or {}
        ignored = [k for k in _IGNORED if k in train_cfg]
        if ignored:
            print(f"[experiment] train.{', train.'.join(ignored)} ignored: a TPU dispatch "
                  "strategy; the port runs the per-step path it equals")
        self.bundle = get_model(config, generator=torch.Generator().manual_seed(seed))
        self.module = self.bundle.module.to(self.device)
        self.datamodule = datamodule if datamodule is not None else SpecDataModule.from_config(config)
        self.max_epochs = int(train_cfg.get("ep", 10))
        self.debug = bool(train_cfg.get("debug", 0))
        self.save = bool(train_cfg.get("save", False))
        self.batch_size = int(train_cfg.get("batch_size", 64))
        self.noise_level = float((config.get("noise", {}) or {}).get("noise_level", 0) or 0)
        self.accum_steps = int(train_cfg.get("accumulate_steps", 1) or 1)
        if self.batch_size % self.accum_steps != 0:
            raise ValueError(f"train.batch_size {self.batch_size} must divide by "
                             f"train.accumulate_steps {self.accum_steps}")
        self.prefetch_depth = max(1, min(8, int(train_cfg.get("num_workers", 2) or 2)))
        self.monitor, self.monitor_mode = monitor_for_task(self.bundle.vit_config.task_type)
        self.logger = MetricLogger(project=config.get("project", "vit-tpu"),
                                   name=self.bundle.model_name, use_wandb=use_wandb,
                                   config=config, save_artifacts=self.save)
        self.ckpt = CheckpointManager(default_ckpt_dir(), self.bundle.model_name,
                                      monitor=self.monitor, mode=self.monitor_mode,
                                      enabled=self.save)
        # Host generators: dropout seeds and injected noise (see module doc).
        self.dropout_gen = torch.Generator().manual_seed(seed)
        self.noise_gen = torch.Generator().manual_seed(seed + 1)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.plateau_scale = 1.0
        self.plateau: Optional[PlateauScheduler] = None
        self.early: Optional[EarlyStopping] = None
        self.callback_metrics: Dict[str, float] = {}
        self.epoch_losses: Optional[np.ndarray] = None  # the last epoch's step losses

    # -- the step --------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor], spec: OptSpec,
                   schedule) -> Tuple[torch.Tensor, float]:
        """One optimizer step; returns (loss tensor, learning rate)."""
        vc = self.bundle.vit_config
        seeds = draw_seeds(self.dropout_gen, self.accum_steps, self.module.num_dropout_sites)
        loss = loss_and_grads(self.module, batch, vc.task_type, self.bundle.loss_name, seeds,
                              self.noise_level, self.noise_gen)
        params = [p for p in self.module.parameters() if p.grad is not None]
        if spec.grad_clip and spec.grad_clip > 0:
            clip_by_global_norm([p.grad for p in params], spec.grad_clip)
        lr = spec.lr * schedule(self.step) * self.plateau_scale
        set_learning_rate(self.optimizer, lr)
        self.optimizer.step()
        self.step += 1
        return loss, lr

    # -- state -------------------------------------------------------------
    def _state(self) -> Dict[str, Any]:
        return {
            "state_dict": {k: v.detach().cpu() for k, v in self.module.state_dict().items()},
            "optimizer": self.optimizer.state_dict() if self.optimizer is not None else None,
            "step": self.step,
            "plateau_scale": self.plateau_scale,
            "plateau": self.plateau.state_dict() if self.plateau is not None else None,
            "early_stop": self.early.state_dict() if self.early is not None else None,
            "dropout_rng": self.dropout_gen.get_state(),
            "noise_rng": self.noise_gen.get_state(),
        }

    def _restore(self, spec: str, training: bool) -> None:
        """Load ``best | last | path``: the weights, and for a resumed fit the
        optimizer, step, plateau scale, generators and scheduler states."""
        state = torch.load(self.ckpt.resolve(spec), map_location="cpu", weights_only=True)
        self.module.load_state_dict(state["state_dict"], strict=True)
        if not training:
            return
        if self.optimizer is not None and state.get("optimizer") is not None:
            self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.plateau_scale = float(state["plateau_scale"])
        self.dropout_gen.set_state(state["dropout_rng"])
        self.noise_gen.set_state(state["noise_rng"])
        if self.plateau is not None and state.get("plateau") is not None:
            self.plateau.load_state_dict(state["plateau"])
        if self.early is not None and state.get("early_stop") is not None:
            self.early.load_state_dict(state["early_stop"])

    # -- evaluation ------------------------------------------------------------
    @torch.no_grad()
    def _run_eval(self, dataset, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """Forward the dataset in fixed-size masked batches; (logits, labels)
        of the real rows."""
        was_training = self.module.training
        self.module.eval()
        cols = {k: v for k, v in dataset.arrays().items() if k in ("x", "label")}
        host = list(Batcher(cols, batch_size, eval_mode=True))
        if self.debug:
            host = host[:1]  # fast-dev-run: one eval batch
        logits_all, labels_all = [], []
        xs = prefetch_to_device(({"x": b["x"]} for b in host), self.device, self.prefetch_depth)
        for hb, db in zip(host, xs):
            logits = self.module(db["x"]).float().cpu().numpy()
            logits_all.append(logits[hb["mask"]])
            labels_all.append(hb["label"][hb["mask"]])
        self.module.train(was_training)
        return np.concatenate(logits_all), np.concatenate(labels_all)

    def _metrics_from_arrays(self, logits: np.ndarray, labels: np.ndarray,
                             prefix: str) -> Dict[str, float]:
        task = self.bundle.vit_config.task_type
        out = {f"{prefix}_loss": _host_loss(logits, labels, task, self.bundle.loss_name)}
        if task == "cls":
            m = classification_metrics(logits, labels)
        else:
            m = regression_metrics(logits, labels)
            names = parse_param_list((self.config.get("data", {}) or {}).get("param"))
            m.update(regression_extras(logits, labels, names))
        out.update({f"{prefix}_{k}": v for k, v in m.items()})
        return out

    def _eval_metrics(self, dataset, prefix: str, batch_size: int) -> Dict[str, float]:
        return self._metrics_from_arrays(*self._run_eval(dataset, batch_size), prefix)

    # -- fit ---------------------------------------------------------------
    def fit(self) -> Dict[str, float]:
        self.datamodule.setup("fit")
        train_ds = self.datamodule.train
        steps_per_epoch = max(1, -(-len(train_ds) // self.batch_size))
        has_val = self.datamodule.val is not None and len(self.datamodule.val) > 0
        # The plateau scheduler needs an explicit data.val_path (reference parity).
        explicit_val = bool((self.config.get("data", {}) or {}).get("val_path"))
        spec = OptSpec.from_config(self.config, steps_per_epoch, monitor_metric=self.monitor,
                                   has_val=explicit_val)
        schedule = schedule_scale(spec)
        if self.optimizer is None:
            self.optimizer = build_optimizer(spec, self.module.parameters())
        self.plateau = (PlateauScheduler(spec.plateau_factor, spec.plateau_patience,
                                         mode=spec.plateau_mode or self.monitor_mode)
                        if spec.scheduler == "plateau" else None)
        self.early = EarlyStopping(
            patience=100 if self.sweep else 500, mode=self.monitor_mode,
            divergence_threshold=(self.config.get("train", {}) or {}).get("divergence_threshold"))

        start_epoch = 0
        if self.ckpt_path:
            self.ckpt.load_best_from_meta()
            self._restore(self.ckpt_path, training=True)
            start_epoch = self.step // steps_per_epoch
            print(f"[experiment] resumed from {self.ckpt_path} at epoch {start_epoch}")

        n_params = count_params(self.module)
        self.logger.log({"num_params(M)": n_params / 1e6}, step=0)
        print(f"[experiment] {self.bundle.model_name}: {n_params / 1e6:.3f}M params, "
              f"{steps_per_epoch} steps/epoch, device={self.device}")

        need = ("x", "error", "label") if self.noise_level > 0 else ("x", "label")
        train_cols = {k: v for k, v in train_ds.arrays().items() if k in need}
        batcher = Batcher(train_cols, self.batch_size, shuffle=not self.debug, seed=self.seed)
        max_epochs = 1 if self.debug else self.max_epochs
        monitor_key = f"val_{self.monitor}"
        ckpt_extra: Dict[str, Any] = {}
        if isinstance(train_ds, RegSpecDataset):
            ckpt_extra = {"label_norm": train_ds.label_norm,
                          "label_norm_stats": {k: (None if v is None else np.asarray(v).tolist())
                                               for k, v in train_ds.norm_stats().items()}}

        epoch_metrics: Dict[str, float] = {}
        self.module.train()
        for epoch in range(start_epoch, max_epochs):
            batcher.set_epoch(epoch)
            t0 = time.perf_counter()
            losses, last_lr = [], spec.lr
            for i, batch in enumerate(prefetch_to_device(iter(batcher), self.device,
                                                         self.prefetch_depth)):
                loss, last_lr = self.train_step(batch, spec, schedule)
                losses.append(loss)
                if self.debug and i == 0:
                    break
            self.epoch_losses = torch.stack(losses).float().cpu().numpy()  # per step
            train_loss = float(np.mean(self.epoch_losses))
            dt = time.perf_counter() - t0
            epoch_metrics = {"train_loss": train_loss, "lr": float(last_lr),
                             "epoch_time_s": dt,
                             "samples_per_s": len(losses) * self.batch_size / max(dt, 1e-9)}
            mon, stop = None, False
            if has_val:
                val = self._eval_metrics(self.datamodule.val, "val",
                                         self.datamodule.val_batch_size)
                epoch_metrics.update(val)
                mon = val.get(monitor_key)
                if self.plateau is not None:
                    self.plateau_scale = self.plateau.step(mon)
                stop = self.early.step(mon)
            extra = dict(ckpt_extra, early_stop_state=self.early.state_dict())
            if self.plateau is not None:
                extra["plateau_state"] = self.plateau.state_dict()
            self.ckpt.on_epoch_end(self._state(), epoch, mon, config=self.config, extra=extra)
            self.logger.log_epoch(epoch, epoch_metrics, step=(epoch + 1) * steps_per_epoch)
            if stop:
                print(f"[experiment] early stopping at epoch {epoch}")
                break
        self.callback_metrics = dict(epoch_metrics)
        return epoch_metrics

    # -- test ----------------------------------------------------------------
    def test(self, ckpt: Optional[str] = None) -> Dict[str, float]:
        """Metrics on the test split, of ``ckpt`` (``best | last | path``) if given."""
        self.datamodule.setup("test")
        if ckpt:
            self._restore(ckpt, training=False)
        metrics = self._eval_metrics(self.datamodule.test, "test", self.batch_size)
        self.logger.log_epoch(-1, metrics)
        self.callback_metrics.update(metrics)
        return metrics

    def run(self) -> Dict[str, float]:
        """``fit`` then ``test`` of the best checkpoint when one was saved."""
        self.fit()
        ckpt = "best" if (self.save and self.ckpt.best_epoch is not None) else None
        metrics = self.test(ckpt=ckpt)
        self.logger.finish()
        return metrics
