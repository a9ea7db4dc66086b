"""Readings that set a data-parallel cell's correctness limits, several
seeds over one start of the ranks.

    python3 benchmark/calibrate_dp.py --workload <cell> \
        --what program|control|fault:half_batch|fault:skip_sync [...] --seeds <n> [<n> ...]

As ``calibrate.py``, for a cell whose driver runs one process a rank
(``train_dp``), where a fault planted in this process alone would reach
rank 0 only: the driver plants the fault named here on the ranks it names,
in each rank's own process. ``program`` and the faults run each seed's
program through its first steps (``--seconds 0``: the gradient and the
change are compared; the losses, logged at the epoch's end, are not
read), then the reference, over one start of the ranks: with several
``--what``, the seeds are split into as many consecutive blocks, one a
``what``. ``control`` runs the cell's control in this process (the
reference in fp8 in the program's place, on one card). Each seed prints
one JSON line with the numbers and the cell's limits beside them. The
benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from benchlib import runner, spec  # noqa: E402


@contextlib.contextmanager
def half_batch(rank: int, world: int):
    """Every rank: the loss over the first half of its rows, the mean taken
    over the rest."""
    from vit_tpu_torch.train import loop

    orig = loop.compute_loss
    loop.compute_loss = lambda logits, labels, *a, **k: orig(
        logits[:len(logits) // 2], labels[:len(labels) // 2], *a, **k)
    try:
        yield
    finally:
        loop.compute_loss = orig


@contextlib.contextmanager
def skip_sync(rank: int, world: int):
    """The last rank skips the gradients' average: it takes part in the
    all-reduce (the others would wait for it), then puts its own gradients
    back."""
    from vit_tpu_torch.train import loop

    orig = loop.sync_gradients

    def local(params, mesh, extra=None):
        params = list(params)
        own = [p.grad.clone() for p in params]
        out = orig(params, mesh, extra)
        for p, g in zip(params, own):
            p.grad.copy_(g)
        return out

    if rank == world - 1:
        loop.sync_gradients = local
    try:
        yield
    finally:
        loop.sync_gradients = orig


FAULTS = {"fault:half_batch": half_batch, "fault:skip_sync": skip_sync}


def readings(workload: str, what, seeds, device=None, cell_override=None):
    """One dict of numbers per seed; ``what``: one of them, or a list whose
    members take the seeds' consecutive blocks."""
    import torch

    cell = spec.cell(workload)
    if cell_override is not None:
        cell = cell_override(cell)
    whats = [what] if isinstance(what, str) else list(what)
    if len(seeds) % len(whats) or ("control" in whats and len(whats) > 1):
        raise ValueError("the seeds split evenly over the whats; the control runs alone")
    whats = [w for w in whats for _ in range(len(seeds) // len(whats))]
    if whats[0] != "control":
        cell = copy.deepcopy(cell)
        cell.setdefault("params", {})["fault"] = [w if w in FAULTS else None for w in whats]
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    driver = spec.load_module("drivers", cell["traffic_mix"]["driver"])

    def ctx(seed, seconds):
        args = runner.parse(["--workload", workload, "--seed", str(seed),
                             "--seconds", str(seconds)])
        return runner.context(args, time.perf_counter(), device, cell)

    if whats[0] == "control":
        results = [driver.control(ctx(seed, 0)) for seed in seeds]
    else:
        results = driver.launch(ctx(seeds[0], 0), seeds)
    return [{"seed": seed, "what": w, "numbers": r["numbers"],
             "limits": cell.get("limits", {}), "detail": r.get("detail")}
            for seed, w, r in zip(seeds, whats, results)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", required=True, nargs="+", choices=["program", "control", *FAULTS])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for r in readings(args.workload, args.what, args.seeds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
