"""The W&B sweep agent: ``python -m vit_tpu_torch sweep`` (port of
``scripts/sweep.py``).

Each trial resolves its base config from ``wandb.config['vit_config']``,
then ``$VIT_CONFIG`` (then ``configs/vit.yaml``), applies the sweep's
parameters as dotted-key overrides onto the nested YAML dict, caps the
host's thread pools, runs ``Experiment(use_wandb=True, sweep=True)`` on the
card (``--device``) and renames the W&B run to the model name. With
``--sweep_id`` it registers as an agent for that sweep; without, it runs
one trial under ``wandb.init``. Without wandb it exits 2 with ``vit_tpu``'s
message.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["RESERVED_KEYS", "add_arguments", "main", "train_fn"]

RESERVED_KEYS = {"vit_config", "_wandb"}


def train_fn(device: str = "cuda") -> None:
    """One sweep trial (``scripts/sweep.py::train_fn``)."""
    import wandb

    from vit_tpu_torch.config import deep_set, load_config
    from vit_tpu_torch.train.loop import Experiment
    from vit_tpu_torch.utils import seed_everything

    run = wandb.init()
    base_path = wandb.config.get("vit_config") or os.environ.get("VIT_CONFIG", "configs/vit.yaml")
    config = load_config(os.path.expandvars(base_path))
    for key, value in dict(wandb.config).items():
        if key in RESERVED_KEYS:
            continue
        deep_set(config, key, value)
    seed_everything(42)
    exp = Experiment(config, use_wandb=True, sweep=True, num_devices=1, device=device)
    try:
        run.name = exp.bundle.model_name
    except Exception:  # a run object without a settable name: keep W&B's
        pass
    exp.run()


def add_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--sweep_id", type=str, default=None, help="register as agent for this sweep")
    p.add_argument("--count", type=int, default=None, help="max trials for this agent")
    p.add_argument("-e", "--entity", type=str, default=os.environ.get("WANDB_ENTITY"))
    p.add_argument("-p", "--project", type=str, default=os.environ.get("WANDB_PROJECT"))
    p.add_argument("--vit_config", type=str, default=None, help="base YAML for trials")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def main(args: argparse.Namespace) -> int:
    # Thread-oversubscription guards (scripts/sweep.py), before torch starts
    # its pools.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    if args.vit_config:
        # train_fn resolves wandb.config > $VIT_CONFIG: the CLI value goes
        # through the environment so agent-spawned trials see it too.
        os.environ["VIT_CONFIG"] = args.vit_config
    try:
        import wandb
    except ImportError:
        print("wandb is not installed; `launch.sh sweep` requires it. "
              "Use `launch.sh lr` for the local parallel sweep instead.")
        return 2
    from vit_tpu_torch.serve import resolve_device

    resolve_device(args.device)  # fail before W&B hands out a trial
    if args.sweep_id:
        wandb.agent(args.sweep_id, function=lambda: train_fn(args.device), entity=args.entity,
                    project=args.project, count=args.count)
    else:
        train_fn(args.device)
    return 0
