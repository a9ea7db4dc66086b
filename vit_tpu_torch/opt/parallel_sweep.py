"""LR and scheduler grid search (port of ``vit_tpu/opt/parallel_sweep.py``):
``python -m vit_tpu_torch lr <base_config> [--engine vmap|sequential]``.

The grid, its ``SweepConfig``/``SweepResult`` records and the artifacts
``launch.sh lr`` reads (``summary.yaml``, ``best_config.yaml``) are
``vit_tpu``'s, schema for schema. Two engines run the trials:

* ``vmap`` (the default, ``_VmapSweepEngine``, ``vit_tpu`` :224-657): every
  trial at once, as R replicas stacked on a leading axis of the parameters
  and optimizer state, one step of all of them through ``torch.func.vmap``
  (:class:`~vit_tpu_torch.train.fused.ReplicaEpochs`, a CUDA graph of that
  step on the card). Each replica has its own init (seed ``seed + idx``, as
  the sequential engine's Experiment draws it), dropout and noise streams
  (host generators seeded ``10_000 + seed + idx`` and ``20_000 + seed +
  idx``), shuffle (``epoch_permutation`` with ``seed + idx``), learning rate
  (``base_lr * sweep_epoch_scales``: warmup, cosine, the host plateau
  scale) and early stopping (patience 100); a stopped or diverged replica's
  state is held by an ``active`` mask. ``attn_impl: ring`` sweeps as
  ``xla`` and ``train.pipeline_parallel`` as 1, with ``vit_tpu``'s lines.
  ``model.fast_dropout: false`` draws each replica's ``nn.Dropout`` masks
  from its 0-d site seeds on the device, and ``opt.type: lbfgs`` keeps one
  flat vector and memory a replica (:class:`~vit_tpu_torch.train.optim.
  ReplicaOptimizer`).
* ``sequential`` (``_SequentialSweepEngine``, ``vit_tpu`` :160-222): one full
  :class:`~vit_tpu_torch.train.loop.Experiment` after another on one card,
  each with seed ``seed + idx``, ``train.save`` and ``viz.enable`` off and
  project ``vit-opt-sweep`` unless set, a failure isolated as
  ``status='error'``, and as its metric the last monitored value of its fit.
  Each trial trains through the fused epoch when its config allows it
  (``train.fused_epoch: auto``).

``--gpus`` is recorded in ``summary.yaml`` as in ``vit_tpu``.

The runner and the engine take an optional ``datamodule`` factory, called
with each trial's config, for data that does not come from the config's
paths (in-memory spectra).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import math
import os
import time
from datetime import datetime
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from vit_tpu_torch.data.pipeline import epoch_permutation

__all__ = ["DEFAULT_LRS", "SweepConfig", "SweepResult", "ParallelSweepRunner",
           "sweep_epoch_scales", "main"]

DEFAULT_LRS = [1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2]
GENERATOR = "vit_tpu_torch.opt.parallel_sweep"


@dataclasses.dataclass
class SweepConfig:
    idx: int
    lr: float
    scheduler: Optional[str] = None
    factor: Optional[float] = None
    patience: Optional[int] = None
    T_max: Optional[int] = None
    eta_min: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}

    def to_opt_config(self) -> Dict[str, Any]:
        opt: Dict[str, Any] = {"lr": self.lr}
        if self.scheduler and self.scheduler != "none":
            opt["lr_sch"] = self.scheduler
            if self.scheduler == "plateau":
                if self.factor is not None:
                    opt["factor"] = self.factor
                if self.patience is not None:
                    opt["patience"] = self.patience
            elif self.scheduler == "cosine":
                if self.T_max is not None:
                    opt["T_max"] = self.T_max
                if self.eta_min is not None:
                    opt["eta_min"] = self.eta_min
        return opt


@dataclasses.dataclass
class SweepResult:
    config: SweepConfig
    metric: Optional[float]
    duration_sec: float
    status: str = "ok"
    message: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "config": self.config.to_dict(),
            "metric": self.metric,
            "duration_sec": self.duration_sec,
            "status": self.status,
            "message": self.message,
        }


def _replica_devices(n_replicas: int, n_devices: int) -> int:
    """Largest divisor of the replica count that fits the device count
    (``vit_tpu/opt/parallel_sweep.py:109-117``): one replica a device when
    R <= n_devices."""
    return max(d for d in range(1, min(n_replicas, n_devices) + 1) if n_replicas % d == 0)


def _cosine_scale(epoch: int, t_max: int, eta_ratio: float) -> float:
    # torch CosineAnnealingLR is periodic past T_max (no clamp).
    return eta_ratio + (1.0 - eta_ratio) * 0.5 * (1 + math.cos(math.pi * epoch / t_max))


def sweep_epoch_scales(configs: List[SweepConfig], epoch: int, warmup_epochs: int,
                       plateau_scales: Dict[int, float], max_epochs: int) -> np.ndarray:
    """Per-trial LR scale at ``epoch``: the training step's linear-warmup
    prefix (0.1-start ramp; the main scheduler's clock starts after it),
    then the trial's scheduler, times its host plateau scale."""
    scales = np.ones(len(configs), np.float32)
    warm = int(warmup_epochs or 0)
    for i, c in enumerate(configs):
        if warm > 0 and epoch < warm:
            s = 0.1 + 0.9 * min(epoch / warm, 1.0)
        elif c.scheduler == "cosine":
            t_max = int(c.T_max or max_epochs)
            eta_ratio = (c.eta_min or 0.0) / c.lr if c.lr else 0.0
            s = _cosine_scale(max(epoch - warm, 0), t_max, eta_ratio)
        else:
            s = 1.0
        if c.scheduler == "plateau":
            s *= plateau_scales.get(i, 1.0)
        scales[i] = s
    return scales


class _SequentialSweepEngine:
    """One full :class:`Experiment` per trial, one after another (module doc)."""

    def __init__(self, base_config: dict, configs: List[SweepConfig], metric_name: str,
                 metric_goal: str, seed: int, skip_test: bool = True, device="cuda",
                 datamodule: Optional[Callable[[dict], Any]] = None) -> None:
        self.base_config = base_config
        self.configs = configs
        self.metric_name = metric_name
        self.metric_goal = metric_goal
        self.seed = seed
        self.skip_test = skip_test
        self.device = device
        self.datamodule = datamodule

    def trial_config(self, c: SweepConfig) -> dict:
        """The config trial ``c`` trains."""
        cfg = copy.deepcopy(self.base_config)
        cfg.setdefault("train", {})["save"] = False
        cfg.setdefault("project", "vit-opt-sweep")
        cfg.setdefault("viz", {})["enable"] = False
        cfg.setdefault("opt", {}).update(c.to_opt_config())
        return cfg

    def run(self) -> List[SweepResult]:
        from vit_tpu_torch.train.loop import Experiment

        results: List[SweepResult] = []
        for c in self.configs:
            cfg = self.trial_config(c)
            t0 = time.perf_counter()
            try:
                dm = self.datamodule(cfg) if self.datamodule is not None else None
                exp = Experiment(cfg, seed=self.seed + c.idx, device=self.device, datamodule=dm)
                metric = exp.fit().get(self.metric_name)
                metric = float(metric) if metric is not None else None
                status, msg = "ok", None
                if metric is None or not math.isfinite(metric):
                    status, msg = "error", (f"{self.metric_name} is "
                                            f"{'missing' if metric is None else 'non-finite'}")
            except Exception as e:  # isolate per-trial failures
                metric, status, msg = None, "error", f"{type(e).__name__}: {e}"
            results.append(SweepResult(config=c, metric=metric,
                                       duration_sec=time.perf_counter() - t0,
                                       status=status, message=msg))
        return results


def _metric_key(metric_name: str, task: str, mode: str):
    """(key of the host metrics, mode) that ranks the replicas, resolved
    against what the task produces (``vit_tpu`` :456-476)."""
    metric_key = metric_name.replace("val_", "")
    available = ("acc",) if task == "cls" else ("mae", "mse", "r2")
    if metric_key not in available:
        if task == "cls" and metric_key == "mae":
            print("[sweep] metric val_mae unavailable for cls; ranking by val_acc (maximize)")
            return "acc", "max"
        raise ValueError(f"metric '{metric_name}' is not produced by task '{task}' "
                         f"(available: {', '.join('val_' + a for a in available)})")
    return metric_key, mode


class _VmapSweepEngine:
    """Train every SweepConfig at once as stacked replicas (module doc)."""

    def __init__(self, base_config: dict, configs: List[SweepConfig], metric_name: str,
                 metric_goal: str, seed: int, skip_test: bool = True, device="cuda",
                 datamodule: Optional[Callable[[dict], Any]] = None) -> None:
        self.base_config = base_config
        self.configs = configs
        self.metric_name = metric_name
        self.metric_goal = metric_goal
        self.seed = seed
        self.skip_test = skip_test
        self.device = device
        self.datamodule = datamodule
        self.epochs: Optional[Any] = None  # the ReplicaEpochs of the last run

    def sweep_config(self) -> dict:
        """The base config as every replica trains it, with ``vit_tpu``'s
        substitutions printed (:262-284)."""
        cfg = copy.deepcopy(self.base_config)
        cfg.setdefault("train", {}).setdefault("save", False)
        cfg.setdefault("project", "vit-opt-sweep")
        cfg.setdefault("viz", {})["enable"] = False
        if (cfg.get("model", {}) or {}).get("attn_impl") == "ring":
            print("[sweep] attn_impl: ring -> xla for the vmapped sweep "
                  "(identical math deterministically; dropout mask streams "
                  "differ; the final run trains with ring)")
            cfg["model"]["attn_impl"] = "xla"
        if int((cfg.get("train", {}) or {}).get("pipeline_parallel", 1) or 1) > 1:
            print("[sweep] train.pipeline_parallel -> 1 for the vmapped "
                  "sweep (identical math; the final run trains pipelined)")
            cfg["train"]["pipeline_parallel"] = 1
        return cfg

    def init_replica(self, cfg: dict, c: SweepConfig):
        """Trial ``c``'s model, its weights drawn from seed ``seed + idx`` as
        the sequential engine's Experiment draws them."""
        from vit_tpu_torch.models.builder import get_model

        return get_model(copy.deepcopy(cfg),
                         generator=torch.Generator().manual_seed(self.seed + c.idx)).module

    def _datamodule(self, cfg: dict, input_kind: str):
        if self.datamodule is not None:
            return self.datamodule(cfg)
        if input_kind == "image":
            from vit_tpu_torch.data.images import ImageDataModule

            return ImageDataModule.from_config(cfg)
        from vit_tpu_torch.data.datasets import SpecDataModule

        return SpecDataModule.from_config(cfg)

    def run(self) -> List[SweepResult]:
        from vit_tpu_torch.models.builder import get_model
        from vit_tpu_torch.models.vit import compute_loss
        from vit_tpu_torch.serve import resolve_device
        from vit_tpu_torch.train.fused import SEED_HIGH, ReplicaEpochs
        from vit_tpu_torch.train.metrics import classification_metrics, regression_metrics
        from vit_tpu_torch.train.optim import (
            EarlyStopping,
            OptSpec,
            PlateauScheduler,
            build_replica_optimizer,
        )
        from vit_tpu_torch.train.preempt import PreemptionGuard
        from vit_tpu_torch.utils import seed_everything

        t_start = time.perf_counter()
        device = resolve_device(self.device)
        cfg = self.sweep_config()
        seed_everything(self.seed)
        bundle = get_model(copy.deepcopy(cfg))
        vc = bundle.vit_config
        task = vc.task_type
        dm = self._datamodule(cfg, vc.input_kind)
        dm.setup("fit")
        if dm.val is None or len(dm.val) == 0:
            raise RuntimeError("LR sweep requires a validation set (data.val_path)")

        R = len(self.configs)
        train_cfg = cfg.get("train", {}) or {}
        batch_size = int(train_cfg.get("batch_size", 64))
        max_epochs = int(train_cfg.get("ep", 10))
        noise_level = float((cfg.get("noise", {}) or {}).get("noise_level", 0) or 0)
        n_train = len(dm.train)
        steps_per_epoch = max(1, -(-n_train // batch_size))

        # vit_tpu shards the replica axis over _replica_devices(R, n) devices
        # (:278-312); the port stacks every replica on this one device.
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        dp = _replica_devices(R, n_dev)
        if dp > 1:
            print(f"[sweep] {R} replicas on {device} (vit_tpu spreads them over {dp} of "
                  f"{n_dev} devices; the port's vmapped engine holds them on one)")
        # Stacked replicas: trial idx's weights in row idx of every parameter.
        replicas = [self.init_replica(cfg, c) for c in self.configs]
        names = [n for n, _ in replicas[0].named_parameters()]
        params = {n: torch.stack([dict(m.named_parameters())[n].detach() for m in replicas])
                  .to(device).requires_grad_(True) for n in names}
        module = replicas[0].to(device).train()
        del replicas

        # vit_tpu's OptSpec with the trial-varied pieces neutralised: lr 1
        # (the replicas' rates come in every epoch) and no scheduler (the
        # host's sweep_epoch_scales), lr_sch stripped before resolution.
        cfg_for_spec = copy.deepcopy(cfg)
        (cfg_for_spec.get("opt", {}) or {}).pop("lr_sch", None)
        spec = OptSpec.from_config(cfg_for_spec, steps_per_epoch,
                                   monitor_metric=self.metric_name, has_val=True)
        spec = dataclasses.replace(spec, lr=1.0, scheduler=None, total_epochs=max_epochs)
        warmup_epochs = int(spec.warmup_epochs or 0)
        optimizer = build_replica_optimizer(spec, params.values(), R)
        has_preproc = bundle.has_preprocessor
        frozen_names = [n for n in names if n.startswith("preprocessor.")] if has_preproc else []

        def frozen_flag(epoch: int) -> float:
            fe = bundle.freeze_epochs
            if not has_preproc or fe == 0:
                return 0.0
            return 1.0 if (fe == -1 or epoch < fe) else 0.0

        base_lrs = np.asarray([c.lr for c in self.configs], np.float32)
        metric_key, mode = _metric_key(self.metric_name, task,
                                       "min" if self.metric_goal == "minimize" else "max")
        plateaus = {i: PlateauScheduler(c.factor or 0.1, c.patience or 10, mode=mode)
                    for i, c in enumerate(self.configs) if c.scheduler == "plateau"}

        def epoch_lrs(epoch: int) -> np.ndarray:
            return base_lrs * sweep_epoch_scales(
                self.configs, epoch, warmup_epochs, {i: p.scale for i, p in plateaus.items()},
                max_epochs)

        need = ("x", "error", "label") if noise_level > 0 else ("x", "label")
        train_cols = {k: v for k, v in dm.train.arrays().items() if k in need}
        val_arrays = dm.val.arrays()
        vbs = min(batch_size, len(dm.val))
        epochs = ReplicaEpochs(
            module, params, optimizer,
            lambda logits, y: compute_loss(logits, y, task, bundle.loss_name),
            train_cols, steps_per_epoch, batch_size, noise_level, spec.grad_clip,
            frozen_names, val_arrays["x"], vbs)
        self.epochs = epochs
        val_labels = np.asarray(val_arrays["label"])
        dropout_gens = [torch.Generator().manual_seed(10_000 + self.seed + c.idx)
                        for c in self.configs]
        noise_gens = [torch.Generator().manual_seed(20_000 + self.seed + c.idx)
                      for c in self.configs]
        sites = module.num_dropout_sites
        noise_shape = (steps_per_epoch, batch_size) + tuple(train_cols["x"].shape[1:])

        early = [EarlyStopping(patience=100, mode=mode) for _ in range(R)]
        last_metrics = np.full(R, np.nan, np.float64)
        active = np.ones(R, np.float32)
        statuses = ["ok"] * R
        messages: List[Optional[str]] = [None] * R
        durations = np.zeros(R, np.float64)
        dispatch_failed = False

        def _deactivate(i: int, status: str, message: Optional[str]) -> None:
            active[i] = 0.0
            statuses[i] = status
            messages[i] = message
            durations[i] = time.perf_counter() - t_start

        def metrics_of(logits: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
            return (classification_metrics(logits, labels) if task == "cls"
                    else regression_metrics(logits, labels))

        # The first SIGTERM stops the sweep at the next epoch boundary and the
        # artifacts are written from the epochs that completed; a caller may
        # set ``preempt_guard`` to a guard of its own.
        guard = getattr(self, "preempt_guard", None)
        if guard is None:
            guard = PreemptionGuard(enabled=bool(train_cfg.get("handle_preemption", True)))
        guard.install()
        try:
            for epoch in range(max_epochs):
                perms = np.stack([epoch_permutation(n_train, batch_size, steps_per_epoch,
                                                    self.seed + c.idx, epoch)
                                  for c in self.configs])
                seeds = torch.stack([torch.randint(0, SEED_HIGH, (steps_per_epoch, sites),
                                                   generator=g) for g in dropout_gens])
                noise = (torch.stack([torch.randn(noise_shape, generator=g) for g in noise_gens])
                         if epochs.noise is not None else None)
                epochs.prepare(perms, seeds, noise, epoch_lrs(epoch), active,
                               frozen_flag(epoch))
                _losses, logits = epochs.run_epoch()
                for i in range(R):
                    if active[i] == 0.0:
                        continue  # held state: its metric cannot change
                    last_metrics[i] = metrics_of(logits[i], val_labels).get(metric_key, np.nan)
                    if not math.isfinite(float(last_metrics[i])):
                        _deactivate(i, "error", "non-finite metric (diverged)")
                        continue
                    if i in plateaus:
                        plateaus[i].step(float(last_metrics[i]))
                    if early[i].step(float(last_metrics[i])):
                        _deactivate(i, "ok", f"early-stopped at epoch {epoch}")
                finite = np.where(np.isfinite(last_metrics), last_metrics, np.nan)
                if not np.all(np.isnan(finite)):
                    best_i = int(np.nanargmin(finite) if mode == "min" else np.nanargmax(finite))
                    print(f"[sweep] epoch {epoch}: {self.metric_name} "
                          f"min={np.nanmin(finite):.5f} max={np.nanmax(finite):.5f} "
                          f"best=replica {best_i} (lr={self.configs[best_i].lr:.1e}) "
                          f"active={int(active.sum())}/{R}", flush=True)
                if not active.any():
                    print(f"[sweep] all replicas stopped at epoch {epoch}")
                    break
                if guard.triggered:
                    for i in range(R):
                        if active[i] > 0:
                            _deactivate(i, "ok", f"preemption stop at epoch {epoch}")
                    print(f"[sweep] preemption stop at epoch {epoch} — "
                          "writing artifacts from completed epochs")
                    break
        except Exception as e:  # noqa: BLE001 — per-trial isolation
            # Stopped replicas keep their results; only the active ones fail,
            # and the state a failed step left is not evaluated below.
            dispatch_failed = True
            print(f"[sweep] epoch dispatch failed: {e}")
            for i in range(R):
                if active[i] > 0:
                    _deactivate(i, "error", f"{type(e).__name__}: {e}")
        finally:
            guard.uninstall()

        # --run-test: each ok replica's test metric, reported, never ranked.
        test_msgs: List[Optional[str]] = [None] * R
        if not self.skip_test and not dispatch_failed and any(s == "ok" for s in statuses):
            dm.setup("test")
            if dm.test is not None and len(dm.test) > 0:
                arrays = dm.test.arrays()
                tbs = min(batch_size, len(dm.test))
                n_test = len(dm.test)
                nb = -(-n_test // tbs)
                rows = torch.arange(nb * tbs, device=device).clamp_max(n_test - 1).view(nb, tbs)
                x = torch.from_numpy(np.ascontiguousarray(arrays["x"])).to(device)
                tl = epochs.predict(x, rows)[:, :n_test].float().cpu().numpy()
                tlab = np.asarray(arrays["label"])
                for i in range(R):
                    if statuses[i] == "ok":
                        v = metrics_of(tl[i], tlab).get(metric_key, float("nan"))
                        test_msgs[i] = f"test_{metric_key}={v:.6f}"

        wall = time.perf_counter() - t_start
        results = []
        for i, c in enumerate(self.configs):
            v = float(last_metrics[i])
            ok = statuses[i] == "ok" and math.isfinite(v)
            msg = messages[i]
            if ok and test_msgs[i]:
                msg = f"{msg}; {test_msgs[i]}" if msg else test_msgs[i]
            results.append(SweepResult(
                config=c, metric=v if math.isfinite(v) else None,
                duration_sec=float(durations[i]) if durations[i] > 0 else wall,
                status="ok" if ok else "error", message=msg))
        return results


class ParallelSweepRunner:
    """Grid construction, execution, and summary/best-config artifacts."""

    def __init__(self, base_config_path: str, lr_values: Optional[List[float]] = None,
                 schedulers: Optional[List[str]] = None,
                 plateau_factors: Optional[List[float]] = None,
                 plateau_patience: Optional[List[int]] = None,
                 cosine_T_max: Optional[int] = None, cosine_eta_min: Optional[float] = None,
                 metric_name: str = "val_mae", metric_goal: str = "minimize",
                 results_dir: Optional[str] = None, gpu_ids: Optional[List[int]] = None,
                 seed: int = 42, skip_test: bool = True, engine: str = "vmap",
                 device="cuda", datamodule: Optional[Callable[[dict], Any]] = None) -> None:
        from vit_tpu_torch.config import load_config

        if engine not in ("vmap", "sequential"):
            raise ValueError(f"engine must be 'vmap' or 'sequential', got {engine!r}")
        self.base_config_path = base_config_path
        self.base_config = load_config(base_config_path)
        self.lr_values = [float(x) for x in (lr_values or DEFAULT_LRS)]
        self.schedulers = list(schedulers or ["none"])
        self.plateau_factors = [float(x) for x in (plateau_factors or [0.8])]
        self.plateau_patience = [int(x) for x in (plateau_patience or [10])]
        self.cosine_T_max = cosine_T_max or int(
            (self.base_config.get("train", {}) or {}).get("ep", 10))
        self.cosine_eta_min = cosine_eta_min if cosine_eta_min is not None else 1e-7
        self.metric_name = metric_name
        self.metric_goal = metric_goal
        self.gpu_ids = gpu_ids or list(range(8))
        self.seed = seed
        self.skip_test = skip_test
        self.engine = engine
        self.device = device
        self.datamodule = datamodule

        results_root = results_dir or "./opt_runs"
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        self.run_dir = os.path.join(results_root, f"parallel_sweep_{stamp}")
        self.summary_path = os.path.join(self.run_dir, "summary.yaml")
        self.best_config_path = os.path.join(self.run_dir, "best_config.yaml")
        self.sweep_configs = self._build_sweep_configs()

    def _build_sweep_configs(self) -> List[SweepConfig]:
        configs: List[SweepConfig] = []
        for lr in self.lr_values:
            for scheduler in self.schedulers:
                if scheduler == "plateau":
                    for factor in self.plateau_factors:
                        for patience in self.plateau_patience:
                            configs.append(SweepConfig(len(configs), lr, "plateau", factor,
                                                       patience))
                elif scheduler == "cosine":
                    configs.append(SweepConfig(len(configs), lr, "cosine",
                                               T_max=self.cosine_T_max,
                                               eta_min=self.cosine_eta_min))
                else:
                    configs.append(SweepConfig(len(configs), lr,
                                               scheduler if scheduler != "none" else None))
        return configs

    def run(self, dry_run: bool = False) -> Optional[SweepResult]:
        kind = ("vmapped replicas" if self.engine == "vmap"
                else "sequential full-fidelity trials")
        print("=" * 62)
        print(f"Parallel LR sweep ({kind}): {len(self.sweep_configs)} configs")
        print(f"  base config : {self.base_config_path}")
        print(f"  metric      : {self.metric_name} ({self.metric_goal})")
        print(f"  lr values   : {self.lr_values}")
        print(f"  schedulers  : {self.schedulers}")
        print("=" * 62)
        if dry_run:
            print("\n[Dry run] Would execute the following configurations:")
            for cfg in self.sweep_configs[:10]:
                print(f"  {cfg.to_dict()}")
            if len(self.sweep_configs) > 10:
                print(f"  ... and {len(self.sweep_configs) - 10} more")
            return None

        os.makedirs(self.run_dir, exist_ok=True)
        engine_cls = _VmapSweepEngine if self.engine == "vmap" else _SequentialSweepEngine
        self.engine_run = engine_cls(self.base_config, self.sweep_configs, self.metric_name,
                                     self.metric_goal, self.seed, skip_test=self.skip_test,
                                     device=self.device, datamodule=self.datamodule)
        results = self.engine_run.run()
        for i, r in enumerate(results):
            self._print_progress(r, i + 1, len(results))
        best = self._select_best(results)
        self._write_summary(results, best)
        self._write_best_config(best)
        self._print_footer(best)
        return best

    def _print_progress(self, result: SweepResult, completed: int, total: int) -> None:
        cfg_str = f"lr={result.config.lr:.1e}"
        if result.config.scheduler:
            cfg_str += f" sch={result.config.scheduler}"
            if result.config.scheduler == "plateau":
                cfg_str += f" f={result.config.factor} p={result.config.patience}"
        metric_str = f"{result.metric:.6f}" if result.metric is not None else "N/A"
        icon = "ok" if result.status == "ok" else "XX"
        print(f"[{completed:3d}/{total:3d}] {icon} {cfg_str:40s} | "
              f"{self.metric_name}={metric_str:10s} | {result.duration_sec:5.1f}s")
        if result.message:
            print(f"    -> {result.message}")

    def _print_footer(self, best: SweepResult) -> None:
        print("\n" + "=" * 62)
        print("Sweep finished!")
        print("\nBest configuration:")
        print(f"  LR          : {best.config.lr:.6f}")
        if best.config.scheduler:
            print(f"  Scheduler   : {best.config.scheduler}")
            if best.config.scheduler == "plateau":
                print(f"  Factor      : {best.config.factor}")
                print(f"  Patience    : {best.config.patience}")
            elif best.config.scheduler == "cosine":
                print(f"  T_max       : {best.config.T_max}")
                print(f"  eta_min     : {best.config.eta_min}")
        print(f"  {self.metric_name:11s}: {best.metric:.6f}")
        print(f"\nSummary  : {self.summary_path}")
        print(f"Best cfg : {self.best_config_path}")
        print("=" * 62)

    def _select_best(self, results: List[SweepResult]) -> SweepResult:
        valid = [r for r in results
                 if r.status == "ok" and r.metric is not None and math.isfinite(r.metric)]
        if not valid:
            raise RuntimeError("All trials failed. Check logs above for details.")
        reverse = self.metric_goal == "maximize"
        return sorted(valid, key=lambda r: r.metric, reverse=reverse)[0]

    def _write_summary(self, results: List[SweepResult], best: SweepResult) -> None:
        import yaml

        data = {
            "generated_at": datetime.now().isoformat(),
            "base_config": str(self.base_config_path),
            "metric": {"name": self.metric_name, "goal": self.metric_goal},
            "search_space": {
                "lr_values": self.lr_values,
                "schedulers": self.schedulers,
                "plateau_factors": self.plateau_factors,
                "plateau_patience": self.plateau_patience,
                "cosine_T_max": self.cosine_T_max,
                "cosine_eta_min": self.cosine_eta_min,
            },
            "gpus": self.gpu_ids,
            "engine": self.engine,
            "num_configs": len(self.sweep_configs),
            "results": [r.to_dict() for r in results],
            "best": best.to_dict(),
        }
        with open(self.summary_path, "w", encoding="utf-8") as f:
            yaml.safe_dump(data, f, sort_keys=False, allow_unicode=True)

    def _write_best_config(self, best: SweepResult) -> None:
        import yaml

        best_config = copy.deepcopy(self.base_config)
        best_config.setdefault("opt", {})
        best_config["opt"].update(best.config.to_opt_config())
        best_config.setdefault("_meta", {})
        best_config["_meta"].update({
            "generator": GENERATOR,
            "metric": self.metric_name,
            "goal": self.metric_goal,
            "best_metric": best.metric,
            "search_dir": str(self.run_dir),
            "timestamp": datetime.now().isoformat(),
        })
        with open(self.best_config_path, "w", encoding="utf-8") as f:
            yaml.safe_dump(best_config, f, sort_keys=False, allow_unicode=True)


def add_arguments(parser: argparse.ArgumentParser) -> None:
    """``vit_tpu``'s sweep flags (``parallel_sweep.py:852-882``) and ``--device``."""
    parser.add_argument("base_config", help="Path to the base YAML config")
    parser.add_argument("--lr", nargs="+", type=float,
                        help="Learning rate values (default: 1e-5 ... 1e-2)")
    parser.add_argument("--schedulers", nargs="+", choices=["plateau", "cosine", "none"],
                        help="Scheduler types to search (default: none)")
    parser.add_argument("--plateau-factor", nargs="+", type=float,
                        help="Plateau reduction factors (default: 0.8)")
    parser.add_argument("--plateau-patience", nargs="+", type=int,
                        help="Plateau patience values (default: 10)")
    parser.add_argument("--cosine-T-max", type=int, help="Cosine T_max (default: train.ep)")
    parser.add_argument("--cosine-eta-min", type=float, help="Cosine eta_min (default: 1e-7)")
    parser.add_argument("--metric", default="val_mae", help="Monitored metric name")
    parser.add_argument("--goal", choices=("minimize", "maximize"), default="minimize")
    parser.add_argument("--gpus", help="Comma-separated device ids (recorded in summary.yaml)")
    parser.add_argument("--results-dir", help="Directory for sweep results (default: ./opt_runs)")
    parser.add_argument("--seed", type=int, default=42, help="Base random seed")
    parser.add_argument("--engine", choices=("vmap", "sequential"), default="vmap",
                        help="vmap: the whole grid as stacked replicas, one step of all of "
                             "them at once (substitutes ring->xla and unstages the "
                             "pipeline). sequential: one full Experiment per trial, one "
                             "after another, unsubstituted")
    parser.add_argument("--run-test", action="store_true",
                        help="Also execute the test loop after each fit")
    parser.add_argument("--dry-run", action="store_true",
                        help="Only print the sweep plan without training")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def main(args: argparse.Namespace) -> int:
    from vit_tpu_torch.serve import resolve_device

    resolve_device(args.device)  # fail before reading any data
    gpu_ids = [int(g.strip()) for g in args.gpus.split(",")] if args.gpus else list(range(8))
    runner = ParallelSweepRunner(
        base_config_path=args.base_config, lr_values=args.lr, schedulers=args.schedulers,
        plateau_factors=args.plateau_factor, plateau_patience=args.plateau_patience,
        cosine_T_max=args.cosine_T_max, cosine_eta_min=args.cosine_eta_min,
        metric_name=args.metric, metric_goal=args.goal, results_dir=args.results_dir,
        gpu_ids=gpu_ids, seed=args.seed, skip_test=not args.run_test, engine=args.engine,
        device=args.device)
    runner.run(dry_run=args.dry_run)
    return 0
