"""One run of one cell: ``benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.

It refuses to run without the cards the cell asks for, drives the cell's
traffic through its driver, refuses to print a result if the process has
loaded JAX or the JAX package, reduces a traced run's profile to the
cell's per-layer metrics, and prints the numbers compared beside their
limits (the last lines of standard error) and the result (the last line of
standard output; its ``checks`` key comes last).
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "vit_tpu")


@dataclass
class Context:
    name: str
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    config: Dict[str, Any]
    params: Dict[str, Any] = field(default_factory=dict)
    phases: Dict[str, float] = field(default_factory=dict)

    def mark(self, phase: str) -> None:
        """Seconds since the process started, at the end of a set-up phase."""
        self.sync()
        self.phases[phase] = time.perf_counter() - self.t_start

    @property
    def cuda(self) -> bool:
        return getattr(self.device, "type", str(self.device)) == "cuda"

    def sync(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated()) if self.cuda else 0

    def free(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.empty_cache()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``vit_tpu_torch`` is not ``vit_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card() -> Dict[str, str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in out.split(",", 1))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        return {"name": "unknown", "power_limit": f"unknown ({e})"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def context(args, t_start: float, device, cell: Dict[str, Any]) -> Context:
    params = dict(cell["traffic_mix"])
    params.update(cell.get("params", {}))
    return Context(name=args.workload, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device=device, t_start=t_start,
                   config=copy.deepcopy(cell["config_file"]["config"]), params=params)


def main(argv=None, t_start: Optional[float] = None, device=None, cell_override=None) -> int:
    """``device``: run there without looking for a card (tests on the CPU);
    ``cell_override``: a function applied to the loaded cell (tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    from benchlib import spec

    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    if cell_override is not None:
        cell = cell_override(cell)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.reset_peak_memory_stats()
    else:
        device = torch.device(device)
    ctx = context(args, t_start, device, cell)
    driver = spec.load_module("drivers", cell["traffic_mix"]["driver"])
    res = driver.run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"refused: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    if ctx.trace:
        metrics = per_layer(bench, args.workload, cell, ctx, res)
    else:
        units = {m["name"]: m["unit"] for m in spec.end_to_end_for(args.workload, bench)}
        metrics = {n: {"value": driver_value(res["metrics"], n), "unit": u}
                   for n, u in units.items()}
    from benchlib.checks import verdict

    checked = verdict(res["numbers"], cell.get("limits", {}))
    correct = all(c["ok"] for c in checked.values()) and bool(checked) and res["failed"] == 0
    dev = {"platform": "gpu" if ctx.cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if ctx.cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    counters = dict(res["counters"])
    if ctx.trace and res["trace"] is not None:
        t = res["trace"]
        dev.update(busy_s=t.busy_s(), window_s=t.span_s)
        line["breakdown"] = t.breakdown()
        counters.update(card=card() if ctx.cuda else None, launches=launch_counts(),
                        traced=t.counts)
    print("counters " + json.dumps(counters), flush=True)
    line["checks"] = {n: {"value": c["value"], "limit": c["limit"]} for n, c in checked.items()}
    print("setup_phases " + json.dumps(ctx.phases), file=sys.stderr)
    if res.get("detail"):
        print("check_detail " + json.dumps(res["detail"]), file=sys.stderr)
    spare = {n: v for n, v in res["numbers"].items() if n not in checked}
    if spare:
        print("not_compared " + json.dumps(spare), file=sys.stderr)
    for n, c in checked.items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(f"check failed_calls {res['failed']} limit 0", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def driver_value(values: Dict[str, float], name: str) -> float:
    """The driver's quantity behind end-to-end metric ``name``: the one of
    that name, else the one its part before the first dot names (so
    ``train_samples_per_s.image`` reads ``train_samples_per_s``, and cells
    whose spreads differ can hold one quantity to bounds of their own)."""
    return values[name] if name in values else values[name.split(".")[0]]


def launch_counts() -> Dict[str, int]:
    """The port's kernel launches counted by its wrappers (under a CUDA
    graph a launch counts once, at capture)."""
    from vit_tpu_torch.ops._build import KERNELS

    return {n: k.launches for n, k in KERNELS.items()}


def per_layer(bench, name, cell, ctx, res) -> Dict[str, dict]:
    """Each of the cell's per-layer metrics that its reader finds."""
    from benchlib import spec
    from benchlib.dims import dims

    out = {}
    trace = res["trace"]
    if trace is None:
        return out
    d = dims(ctx.config)
    for m in spec.per_layer_for(name, bench):
        value = spec.load_module("metrics", m["name"]).read(trace, d, ctx.params)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
