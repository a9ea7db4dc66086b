"""Command line of the port: ``python -m vit_tpu_torch run|test|predict|lr|sweep ...``.

* ``run`` trains a config and then tests its best checkpoint (mirrors
  ``scripts/run.py``); ``--ckpt best|last|PATH`` resumes a run.
* ``test`` evaluates a checkpoint on the test split (``scripts/test.py``).
* ``predict`` is batch inference over a torch ``.pt`` checkpoint
  (``scripts/predict.py``): denormalised parameters (regression) or classes
  (classification) for spectra from an HDF5 or ``.npz`` file, written to a
  ``.npz``; ``--quantize int8|int8-w8a8|int8-wo`` serves int8 encoder
  weights and ``--calibrate`` gives W8A8 static activation scales from the
  first ``--batch-size`` inputs; ``-g/--gpus/--devices N`` serves over N
  devices in one process (``Predictor.from_checkpoint(num_devices=N)``,
  which raises when fewer exist).
* ``lr`` is the LR/scheduler grid search (``vit_tpu``'s
  ``opt/parallel_sweep.py``, ``launch.sh lr``) with its flags: ``--engine
  vmap`` (the default) trains the trials as stacked replicas, ``sequential``
  one after another; both write ``summary.yaml`` and ``best_config.yaml``.
* ``sweep`` is the W&B sweep agent (``scripts/sweep.py``, ``launch.sh
  sweep``); it exits 2 without wandb.

``run`` and ``test`` take ``--gpus N``. Launched by ``torchrun``
(``WORLD_SIZE`` in the environment) the process joins its group as one
rank. Otherwise ``N > 1`` starts N local ranks of this same command on a
free localhost port (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
``RANK``/``LOCAL_RANK`` set, as ``torchrun`` sets them), NCCL on the card
(rank r on ``cuda:r``) and gloo on the CPU, and returns the first failing
rank's code (the others are stopped), else 0.

All run on the card unless ``--device cpu`` is given, and raise without
one. Examples:
  python -m vit_tpu_torch run -c configs/exp/att_clp/stride1.yaml --save
  python -m vit_tpu_torch run -c configs/exp/att_clp/baseline.yaml --gpus 2 --device cpu
  torchrun --nproc_per_node 2 -m vit_tpu_torch run -c configs/exp/att_clp/baseline.yaml
  python -m vit_tpu_torch test -c configs/exp/att_clp/stride1.yaml --ckpt best
  python -m vit_tpu_torch predict -f configs/exp/att_clp/stride1.yaml \\
      --ckpt model.pt --input $TEST_DIR/dataset.h5 --output preds.npz
  python -m vit_tpu_torch lr configs/exp/att_clp/baseline.yaml --engine sequential \\
      --lr 1e-4 1e-3 --schedulers none plateau
  python -m vit_tpu_torch sweep --sweep_id ID --vit_config configs/exp/att_clp/baseline.yaml
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np

__all__ = ["main", "load_inputs"]


def load_inputs(path: str, limit: Optional[int]) -> np.ndarray:
    """Spectra from an HDF5 file (reference schema) or an ``.npz`` holding
    ``x`` or ``flux``."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            key = next((k for k in ("x", "flux") if k in z), None)
            if key is None:
                raise KeyError(f"{path} has no 'x'/'flux' array (found: {sorted(z.keys())})")
            x = np.asarray(z[key], np.float32)
    else:
        from vit_tpu_torch.data.hdf5 import load_spectra

        x = np.asarray(load_spectra(path, limit)["flux"], np.float32)
    if limit is not None and 0 < limit < len(x):
        x = x[:limit]
    return x


def _predict(args: argparse.Namespace) -> int:
    from vit_tpu_torch.serve import Predictor, resolve_device

    resolve_device(args.device)  # fail before reading any input
    x = load_inputs(args.input, args.limit)
    pred = Predictor.from_checkpoint(
        args.config, ckpt=args.ckpt, batch_size=args.batch_size,
        precision=args.precision, quantize=args.quantize,
        calibration=x[: args.batch_size] if args.calibrate else None,
        perf_preset=args.perf_preset, num_devices=args.devices, device=args.device,
    )
    out = {"predictions": pred.predict(x)}
    if args.proba and pred.vit_config.task_type == "cls":
        out["probabilities"] = pred.predict_proba(x)
    np.savez(args.output, **out)
    print(f"[predict] {len(x)} inputs -> {args.output} "
          f"(task={pred.vit_config.task_type}, shape={out['predictions'].shape}, "
          f"device={pred.device})")
    return 0


def _experiment_config(args: argparse.Namespace, **train_overrides) -> dict:
    from vit_tpu_torch.config import load_config
    from vit_tpu_torch.serve import resolve_device
    from vit_tpu_torch.utils import seed_everything

    resolve_device(args.device)  # fail before reading any data
    seed_everything(args.seed)
    config = load_config(args.config)
    train = config.setdefault("train", {})
    if args.gpus is not None:
        train["gpus"] = args.gpus
    train.update(train_overrides)
    return config


def _run(args: argparse.Namespace) -> int:
    from vit_tpu_torch.train.loop import Experiment

    flags = dict(debug=1) if args.debug else {}
    if args.save:
        flags["save"] = True
    config = _experiment_config(args, **flags)
    Experiment(config, use_wandb=bool(args.wandb), ckpt_path=args.ckpt, seed=args.seed,
               device=args.device).run()
    _leave_group()
    return 0


def _test(args: argparse.Namespace) -> int:
    from vit_tpu_torch.train.loop import Experiment

    config = _experiment_config(args, save=False, debug=args.debug)
    metrics = Experiment(config, use_wandb=bool(args.wandb), seed=args.seed,
                         device=args.device).test(ckpt=args.ckpt)
    print({k: round(v, 6) for k, v in metrics.items()})
    _leave_group()
    return 0


def _leave_group() -> None:
    """A rank's process group, torn down once its work is done (NCCL warns
    of leaked resources at exit otherwise)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _launch_ranks(n: int, argv: List[str]) -> int:
    """Run this command as ``n`` local ranks (module doc); the first failing
    rank's exit code, else 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen([sys.executable, "-m", "vit_tpu_torch", *argv], env=env))
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed:
                rc = failed[0]
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
            p.wait()
    return rc or next((p.returncode for p in procs if p.returncode), 0)


def _experiment_args(p: argparse.ArgumentParser, ckpt_default, ckpt_help: str) -> None:
    p.add_argument("-c", "-f", "--config", dest="config", required=True,
                   help="YAML config path")
    p.add_argument("--ckpt", default=ckpt_default, help=ckpt_help)
    p.add_argument("-w", "--wandb", type=int, default=0,
                   help="1 = log to W&B (the console only, when wandb is absent)")
    p.add_argument("-g", "--gpus", type=int, default=None,
                   help="ranks (devices) to train on; > 1 starts local ranks (module doc)")
    p.add_argument("-d", "--debug", type=int, nargs="?", const=1, default=0,
                   help="fast dev run (1 batch)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m vit_tpu_torch",
                                description="vit_tpu_torch (PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="command", required=True)
    pr = sub.add_parser("run", help="train, then test the best checkpoint")
    _experiment_args(pr, None, "resume from best | last | PATH")
    pr.add_argument("--save", action="store_true", help="save best/last checkpoints")
    pt = sub.add_parser("test", help="evaluate a checkpoint on the test split")
    _experiment_args(pt, "best", "best | last | PATH")
    pp = sub.add_parser("predict", help="batch inference over a torch .pt checkpoint")
    pp.add_argument("-f", "--config", required=True, help="YAML config path")
    pp.add_argument("--ckpt", required=True, help="torch .pt/.pth/.ckpt state dict")
    pp.add_argument("--input", required=True, help="HDF5 spectra or npz")
    pp.add_argument("--output", default="predictions.npz")
    pp.add_argument("--batch-size", type=int, default=256)
    pp.add_argument("--limit", type=int, default=None)
    pp.add_argument("--proba", action="store_true",
                    help="classification: write softmax probabilities too")
    pp.add_argument("--precision", default=None,
                    help="serving compute dtype override (e.g. bf16)")
    pp.add_argument("--quantize", default=None, choices=["int8", "int8-w8a8", "int8-wo"],
                    help="int8 encoder weights: 'int8' routes W8A8 or weight-only by "
                         "batch size (W8A8 with --calibrate); the others pin the variant")
    pp.add_argument("--calibrate", action="store_true",
                    help="W8A8: static activation scales from the first --batch-size inputs")
    pp.add_argument("--perf-preset", action="store_true",
                    help="bf16 + tanh GELU + bf16 softmax")
    pp.add_argument("-g", "--gpus", "--devices", dest="devices", type=int, default=None,
                    help="data-parallel serving over N devices")
    pp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    from vit_tpu_torch.opt import agent, parallel_sweep

    parallel_sweep.add_arguments(sub.add_parser(
        "lr", help="LR/scheduler grid search (summary.yaml, best_config.yaml)"))
    agent.add_arguments(sub.add_parser("sweep", help="W&B sweep agent"))
    # A W&B agent passes the trial's parameters as flags too; they reach the
    # trial through wandb.config, so the sweep command ignores them.
    argv = list(sys.argv[1:] if argv is None else argv)
    args, unknown = p.parse_known_args(argv)
    if unknown and args.command != "sweep":
        p.error(f"unrecognized arguments: {' '.join(unknown)}")
    if (args.command in ("run", "test") and (args.gpus or 1) > 1
            and "WORLD_SIZE" not in os.environ):
        return _launch_ranks(args.gpus, argv)
    return {"run": _run, "test": _test, "predict": _predict, "lr": parallel_sweep.main,
            "sweep": agent.main}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
