"""Data-parallel training traffic: one ``Experiment.fit`` on each of
``params["ranks"]`` ranks, one process and one card a rank (NCCL on the
card, gloo on the CPU), on the path the configuration selects.

The runner's own process is rank 0. It starts the other ranks as
``python benchmark/drivers/train_dp.py <job file> <rank>`` with the
environment ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), joins them, and waits for them.
Each rank makes the data and the weights from the seed on its card and
trains on its rows of every global batch, as the program splits it. A rank
that fails, or a run that overruns its deadline, ends every rank at once:
the others would wait in a collective for it.

Set-up is the ranks' start, their data and weights, the Experiment and the
warm epoch. The window opens at rank 0's log of the warm epoch and runs
whole later epochs, their validation included, until it has lasted
``--seconds``; it closes at rank 0's log of the epoch that passes that mark,
and the ranks stop together at that epoch's end through the program's own
stop (the flag a preemption signal sets, which every rank reads at each
epoch end). A traced run traces rank 0's first window epoch and stops. The
rate is the global samples over rank 0's window; the peak memory the
largest over the cards.

The first steps are read without touching the program. Under ZeRO-1 the
first moments live in ``Zero1Optimizer.views``' blocks: each rank reports
each leaf's sum of squares of its part, and rank 0 adds the blocks up. The
parameters after step ``FIRST_STEPS`` are rank 0's, read before the next
step (ZeRO-1's gather has made them whole by then). Rank 0 then runs the
one-card driver's reference over the whole global batch, while the other
ranks wait to send it their readings over a gloo group.

``--seconds 0`` (calibration only) ends every rank's fit before step
``FIRST_STEPS + 1``: the gradient and the change are read, the losses
(logged at the epoch's end) are not. ``params["fault"]`` plants one of
``benchmark/calibrate_dp.py``'s faults on the ranks it names (a list: one a
seed).
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":  # a rank started by run(): the benchmark's paths first
    _BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [_BENCH, os.path.dirname(_BENCH)]

import contextlib  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.optim.optimizer import (  # noqa: E402
    register_optimizer_step_post_hook,
    register_optimizer_step_pre_hook,
)

from benchlib import checks, reference, runner, spec  # noqa: E402
from benchlib.dims import dims  # noqa: E402
from benchlib.trace import Tracer  # noqa: E402

FIRST_STEPS = 3
RANK_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
DEADLINE_S = 600  # a run's start-up and reference, on top of its window
SEED_S = 180  # each seed's set-up and reference


class FirstStepsRead(Exception):
    """Raised on every rank before step ``FIRST_STEPS + 1`` to end a
    calibration fit."""


def _train():
    """The one-card training driver, whose data, weights, batches and
    control this traffic shares."""
    return spec.load_module("drivers", "train")


class FirstSteps:
    """This rank's first moments after step 1, as each leaf's sum of squares
    of its part (ZeRO-1: its block of a split leaf, the whole of the
    others), and, with ``keep``, the parameters after step ``FIRST_STEPS``,
    read before the next step begins (or at the epoch's end, whichever
    comes first). ``stop``: raise :class:`FirstStepsRead` there."""

    def __init__(self, exp, keep: bool, stop: bool) -> None:
        self.exp, self.keep, self.stop = exp, keep, stop
        self.names = {id(p): n for n, p in exp.module.named_parameters()}
        self.count = 0
        self.moments = None  # name -> (sum of squares, split)
        self.after = None
        self._hooks = [register_optimizer_step_post_hook(self._on_step),
                       register_optimizer_step_pre_hook(self._before_step)]

    def _leaves(self):
        """(name, tensor the inner optimizer steps, split) of each parameter."""
        opt = self.exp.optimizer
        if hasattr(opt, "views"):
            return [(self.names[id(p)], v, s) for p, v, s in zip(opt.params, opt.views, opt.split)]
        return [(self.names[id(p)], p, False) for p in self.exp.module.parameters()]

    def _on_step(self, optimizer, args, kwargs) -> None:
        self.count += 1
        if self.count == 1:
            state = optimizer.state
            self.moments = {n: (float(state[t]["exp_avg"].float().square().sum()), bool(s))
                            for n, t, s in self._leaves() if "exp_avg" in state.get(t, {})}

    def _before_step(self, optimizer, args, kwargs) -> None:
        self.read()
        if self.stop and self.count >= FIRST_STEPS:
            raise FirstStepsRead  # on every rank, before the same step

    def read(self) -> None:
        if self.keep and self.after is None and self.count >= FIRST_STEPS:
            self.after = {n: p.detach().to("cpu", torch.float32, copy=True)
                          for n, p in self.exp.module.named_parameters()}

    def close(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []


@contextlib.contextmanager
def _fault(name, rank: int, world: int):
    if not name:
        yield
        return
    import calibrate_dp

    with calibrate_dp.FAULTS[name](rank, world):
        yield


def _launches() -> int:
    from vit_tpu_torch.ops._build import KERNELS

    return KERNELS["hash_dropout"].launches


def _program(job, seed: int, rank: int, dev, t_start: float, mark) -> dict:
    """This rank's fit of one seed: its readings, and rank 0's window."""
    import torch.distributed as dist

    from vit_tpu_torch.parallel import comm
    from vit_tpu_torch.train.loop import Experiment

    cfg = copy.deepcopy(job["config"])
    d = dims(cfg)
    seed32 = seed % 2**31
    main = rank == 0
    mark("imports")
    drv = _train()
    dm, x, y = drv._data(cfg, d, seed, dev)
    if dev.type == "cuda":  # the peak is the program's, not the data's making
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    w = drv._weights(SimpleNamespace(seed=seed, device=dev, params=job["params"]), d)
    mark("data_and_weights")
    exp = Experiment(copy.deepcopy(cfg), device=dev, seed=seed32, datamodule=dm)
    exp.module.load_state_dict(w, strict=True)
    w = {n: t.cpu() for n, t in w.items()}
    mark("experiment")
    steps_per_epoch = -(-len(x) // d.batch)
    n_val = int(cfg["data"]["num_test_samples"])
    val_batches = -(-n_val // min(d.batch, n_val))
    calibrating = job["seconds"] <= 0
    watch = FirstSteps(exp, keep=main, stop=calibrating)
    tracer = Tracer() if job["trace"] and main else None
    st = {"start": None, "end": None, "epochs": 0, "nonfinite": 0, "first": None, "trace": None,
          "epoch_s": [], "launches": 0, "steps0": 0}

    def on_epoch(epoch, metrics, step=None):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        if st["start"] is None:
            st["first"] = np.asarray(exp.epoch_losses, np.float64)[:FIRST_STEPS].tolist()
            watch.read()
            mark("warm_epoch")
            st["launches"], st["steps0"] = _launches(), watch.count
            comm.reset_stats()
            if tracer is not None:
                tracer.start()
            st["start"] = time.perf_counter()
            return
        st["epochs"] += 1
        st["epoch_s"].append(now - (st["end"] or st["start"]))
        st["end"] = now
        st["nonfinite"] += int((~np.isfinite(np.asarray(exp.epoch_losses))).sum())
        if not main:
            return
        if tracer is not None:
            st["trace"] = tracer.stop({"train_steps": steps_per_epoch, "val_batches": val_batches,
                                       "val_batch_rows": min(d.batch, n_val),
                                       "ranks": job["world"]})
            exp._preempt.triggered = True
        elif now - st["start"] >= job["seconds"]:
            exp._preempt.triggered = True  # every rank stops at this epoch's end

    exp.logger.log_epoch = on_epoch
    try:
        exp.fit()
    except FirstStepsRead:
        pass
    finally:
        watch.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if st["epochs"] == 0 and not calibrating:
        raise RuntimeError("the fit ended before a window epoch")
    mesh = exp.mesh
    out = {"rank": rank, "moments": watch.moments,
           "peak": int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0,
           "card": (torch.cuda.current_device() if dev.type == "cuda" else None),
           "backend": dist.get_backend(), "world": dist.get_world_size(),
           "window_steps": watch.count - st["steps0"],
           "hash_dropout_launches": _launches() - st["launches"],
           "forbidden": runner.forbidden_modules()}
    if main:
        window_s = (st["end"] - st["start"]) if st["epochs"] else None
        out.update(
            window_s=window_s, epochs=st["epochs"], epoch_s=st["epoch_s"],
            nonfinite=st["nonfinite"], trace=st["trace"], first=st["first"],
            setup_s=(st["start"] - t_start) if st["start"] is not None else None,
            steps_per_epoch=steps_per_epoch, val_batches=val_batches,
            stats=copy.deepcopy(comm.STATS),
            change={n: float((p - w[n]).norm()) for n, p in (watch.after or {}).items()})
    groups = {id(g): g for g in [mesh.group(a) for a in mesh.axis_names] + [mesh.world_group]
              if g is not None}
    del exp, dm, watch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["_data"] = (x, y, w, groups)
    return out


def _reference(job, seed: int, dev, x, y, w) -> dict:
    d = dims(job["config"])
    return _train()._reference(SimpleNamespace(device=dev, params=job["params"]), d, w, x, y,
                               seed % 2**31, -(-len(x) // d.batch))


def _combine(job, parts: list, ref: dict) -> dict:
    """Rank 0's result of one seed from every rank's readings."""
    r0 = parts[0]
    d = dims(job["config"])
    bad = sorted({m for p in parts for m in p["forbidden"]})
    if bad:
        raise RuntimeError(f"refused: a rank loaded {', '.join(bad)}")
    grad1 = {}  # a split leaf's blocks added up; a whole leaf as rank 0 holds it
    if all(p["moments"] is not None for p in parts):
        grad1 = {n: float(np.sqrt(sq + (sum(p["moments"][n][0] for p in parts[1:])
                                        if split else 0.0))) / (1 - reference.BETAS[0])
                 for n, (sq, split) in r0["moments"].items()}
    prog = {"losses": r0["first"] or [], "grad1": grad1, "change": r0["change"]}
    numbers, detail = {}, None  # a leaf missing on one side fails every number
    if set(prog["grad1"]) == set(ref["grad1"]) and set(prog["change"]) == set(ref["change"]):
        numbers = checks.train_numbers(prog, ref)
        detail = checks.train_detail(prog, ref)
        if r0["first"] is None:  # a calibration fit: its losses were not read
            numbers = {k: v for k, v in numbers.items() if not k.startswith("loss")}
    steps = r0["epochs"] * r0["steps_per_epoch"]
    metrics = {"setup_s": r0["setup_s"]}
    if r0["window_s"]:
        metrics["train_samples_per_s"] = steps * d.batch / r0["window_s"]
    counters = {"steps_per_epoch": r0["steps_per_epoch"], "val_batches_per_epoch": r0["val_batches"],
                "window_epochs": r0["epochs"], "window_steps": steps,
                "window_epoch_s": r0["epoch_s"], "backend": r0["backend"], "world": r0["world"],
                "cards": [p["card"] for p in parts],
                "memory_peak_bytes_by_rank": [p["peak"] for p in parts],
                "hash_dropout_per_step_by_rank": [
                    p["hash_dropout_launches"] / p["window_steps"] if p["window_steps"] else None
                    for p in parts],
                "comm_stats_rank0": r0["stats"], "reference_s": r0["reference_s"]}
    return {"metrics": metrics, "attempted": steps, "failed": r0["nonfinite"],
            "memory_peak_bytes": max(p["peak"] for p in parts), "numbers": numbers,
            "detail": detail, "trace": r0["trace"], "counters": counters}


def _rank_main(job, rank: int, t_start: float, mark=None) -> list:
    """Every seed of ``job`` on this rank: rank 0's results, one a seed
    (None on the other ranks)."""
    import torch.distributed as dist

    mark = mark or (lambda phase: None)
    dev = torch.device("cuda", rank) if job["device"] == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    results, group, spent = [], None, []
    faults = job["params"].get("fault")
    for i, seed in enumerate(job["seeds"]):
        for g in spent:  # the last seed's mesh groups; every rank is past them
            dist.destroy_process_group(g)
        with _fault(faults[i] if isinstance(faults, list) else faults, rank, job["world"]):
            part = _program(job, seed, rank, dev, t_start, mark)
        x, y, w, groups = part.pop("_data")
        spent = list(groups.values())
        if group is None:  # the readings' gather, on the host
            group = dist.new_group(backend="gloo")
        if rank == 0:
            t_ref = time.perf_counter()
            ref = _reference(job, seed, dev, x, y, w)
            part["reference_s"] = time.perf_counter() - t_ref
        del x, y, w
        parts = [None] * job["world"] if rank == 0 else None
        dist.gather_object({k: v for k, v in part.items() if k != "trace"}, parts, dst=0,
                           group=group)
        if rank == 0:
            parts[0] = part
            results.append(_combine(job, parts, ref))
            if len(job["seeds"]) > 1:  # each seed's numbers as soon as they are known
                print("seed_numbers " + json.dumps({"seed": seed, **results[-1]["numbers"]}),
                      file=sys.stderr, flush=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.destroy_process_group()
    return results


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Watch:
    """Ends the run when a rank exits with an error, or when the run passes
    its deadline: the ranks left in a collective would wait for ever."""

    def __init__(self, procs, deadline: float) -> None:
        self.procs, self.deadline = procs, deadline
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def _watch(self) -> None:
        while not self.done.wait(0.5):
            failed = [(r, p.returncode) for r, p in self.procs if p.poll() not in (None, 0)]
            late = time.monotonic() > self.deadline
            if failed or late:
                why = (f"rank {failed[0][0]} exited with {failed[0][1]}" if failed
                       else "the run passed its deadline")
                print(f"train_dp: {why}; ending every rank", file=sys.stderr, flush=True)
                for _, p in self.procs:
                    p.kill()
                os._exit(1)

    def stop(self) -> None:
        self.done.set()
        self.thread.join()


def launch(ctx, seeds) -> list:
    """The ranks over ``seeds`` (rank 0 here): one result a seed."""
    world = int(ctx.params["ranks"])
    job = {"config": ctx.config, "params": ctx.params, "seeds": [int(s) for s in seeds],
           "seconds": float(ctx.seconds), "trace": bool(ctx.trace),
           "device": getattr(ctx.device, "type", str(ctx.device)), "world": world}
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(world)}
    fd, path = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(job, f)
    saved = {k: os.environ.get(k) for k in RANK_ENV}
    procs, watch = [], None
    try:
        for r in range(1, world):
            procs.append((r, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), path, str(r)], stdout=2,
                env=dict(os.environ, **env, RANK=str(r), LOCAL_RANK=str(r)))))
        watch = _Watch(procs, time.monotonic() + DEADLINE_S
                       + len(job["seeds"]) * (max(job["seconds"], 0.0) + SEED_S))
        os.environ.update(env, RANK="0", LOCAL_RANK="0")
        try:
            results = _rank_main(job, 0, ctx.t_start, ctx.mark)
        except BaseException:
            if job["device"] == "cuda":  # a card's group cannot be torn down mid-collective
                traceback.print_exc()
                for _, p in procs:
                    p.kill()
                os._exit(1)
            raise
        for r, p in procs:
            if p.wait(timeout=DEADLINE_S) != 0:
                raise RuntimeError(f"rank {r} exited with {p.returncode}")
        return results
    finally:
        if watch is not None:
            watch.stop()
        for _, p in procs:
            if p.poll() is None:
                p.kill()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        os.unlink(path)


def run(ctx) -> dict:
    return launch(ctx, [ctx.seed])[0]


def control(ctx) -> dict:
    """The control: the reference in fp8 in the program's place, held
    against the fp32 reference over the whole global batch, in this
    process (the one-card driver's)."""
    return _train().control(ctx)


def _child(path: str, rank: int) -> int:
    parent = os.getppid()

    def orphaned():  # rank 0 gone: nothing will ever meet this rank again
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    with open(path) as f:
        job = json.load(f)
    if job["device"] == "cpu":
        torch.set_num_threads(1)
    _rank_main(job, rank, time.perf_counter())
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1], int(sys.argv[2])))
