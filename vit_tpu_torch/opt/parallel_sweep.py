"""LR and scheduler grid search (port of ``vit_tpu/opt/parallel_sweep.py``):
``python -m vit_tpu_torch lr <base_config> --engine sequential``.

The grid, its ``SweepConfig``/``SweepResult`` records and the artifacts
``launch.sh lr`` reads (``summary.yaml``, ``best_config.yaml``) are
``vit_tpu``'s, schema for schema. The trials run on the sequential engine
(``_SequentialSweepEngine``, ``vit_tpu`` :160-222): one full
:class:`~vit_tpu_torch.train.loop.Experiment` after another on one card, each
with seed ``seed + idx``, ``train.save`` and ``viz.enable`` off and project
``vit-opt-sweep`` unless set, a failure isolated as ``status='error'``, and
as its metric the last monitored value of its fit. Each trial trains through
the fused epoch when its config allows it (``train.fused_epoch: auto``).

``vit_tpu``'s default engine, ``vmap`` (every trial at once, a replica
axis through the model), is not ported yet: asking for it raises
``NotImplementedError`` and never runs the trials one by one instead.
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
        if engine == "vmap":
            raise NotImplementedError(
                "the vmapped sweep engine (every trial at once on a replica axis) is not "
                "ported yet (ROADMAP.md §A.3); pass --engine sequential (engine='sequential') "
                "to train the trials one after another")
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
        print("=" * 62)
        print(f"Parallel LR sweep (sequential full-fidelity trials): "
              f"{len(self.sweep_configs)} configs")
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
        engine = _SequentialSweepEngine(self.base_config, self.sweep_configs, self.metric_name,
                                        self.metric_goal, self.seed, skip_test=self.skip_test,
                                        device=self.device, datamodule=self.datamodule)
        results = engine.run()
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
                        help="sequential: one full Experiment per trial, one after another. "
                             "vmap (vit_tpu's default, every trial at once) is not ported "
                             "yet and raises")
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
