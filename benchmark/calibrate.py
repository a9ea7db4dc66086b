"""Readings that set a cell's correctness limits, several seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --what program|control \
        --seeds <n> [<n> ...] [--seconds <s>]

``program``: the cell's own run (its driver, a short window) on each seed;
its numbers are the lower readings. ``control``: the cell's control on
each seed (the reference in fp8 in the program's place);
``fault:half_batch``: the program with a fault planted (the loss over half
of the batch). Controls and faults give the upper readings.
Each seed prints one JSON line with the numbers and the cell's limits
beside them. The benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from benchlib import runner, spec  # noqa: E402


def readings(workload: str, what: str, seeds, seconds: float, device=None, cell_override=None):
    """One dict of numbers per seed."""
    import torch

    cell = spec.cell(workload)
    if cell_override is not None:
        cell = cell_override(cell)
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    driver = spec.load_module("drivers", cell["traffic_mix"]["driver"])
    out = []
    for seed in seeds:
        args = runner.parse(["--workload", workload, "--seed", str(seed),
                             "--seconds", str(seconds)])
        ctx = runner.context(args, time.perf_counter(), device, cell)
        if what == "program":
            res = driver.run(ctx)
        elif what == "control":
            res = driver.control(ctx)
        else:
            with FAULTS[what]():
                res = driver.run(ctx)
        out.append({"seed": seed, "what": what, "numbers": res["numbers"],
                    "limits": cell.get("limits", {}), "detail": res.get("detail")})
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def half_batch():
    """A fault planted in the program: the loss over half of the batch, the
    mean taken over the rest."""
    from vit_tpu_torch.train import loop

    orig = loop.compute_loss
    loop.compute_loss = lambda logits, labels, *a, **k: orig(
        logits[:len(logits) // 2], labels[:len(labels) // 2], *a, **k)
    try:
        yield
    finally:
        loop.compute_loss = orig


FAULTS = {"fault:half_batch": half_batch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", required=True,
                    choices=["program", "control", *FAULTS])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    for r in readings(args.workload, args.what, args.seeds, args.seconds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
