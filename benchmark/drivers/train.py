"""Training traffic: one ``Experiment.fit`` of the configuration over data
made from the seed, on the path the configuration selects (per step, or
the fused epoch's CUDA graph).

Set-up builds the Experiment, loads the benchmark's weights and runs the
first (warm) epoch (on the fused path: its first step eagerly, the capture
of the step's graph, then replays). That epoch's first steps are the ones
the reference follows. The window opens when the warm epoch has been logged and runs
whole later epochs of the same fit, their validation included, until it
has lasted ``--seconds``; it closes when the epoch that passes that mark
has been logged. A traced run traces the first window epoch and stops.

The first steps are read without touching the program: the optimizer's
first moment after its first real step (a global step hook, which does
nothing while a graph is being captured) gives the gradient it received,
and the parameters after the third real step (a count of optimizer steps
and of graph replays) give the change.
"""

from __future__ import annotations

import copy
import gc
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from benchlib import checks, inputs, reference
from benchlib.dims import dims
from benchlib.trace import Tracer

FIRST_STEPS = 3


class WindowClosed(Exception):
    """Raised from the epoch log to end the fit once the window is over."""


class FirstSteps:
    """Counts the program's real optimizer steps: one per eager step, one
    per graph replay; keeps the first moment after step 1 and the
    parameters after step ``FIRST_STEPS``."""

    def __init__(self, module: torch.nn.Module) -> None:
        self.params = dict(module.named_parameters())
        self.names = {id(p): n for n, p in self.params.items()}
        self.count = 0
        self.moments = None
        self.after = None
        self._hook = register_optimizer_step_post_hook(self._on_step)
        self._replay = None
        if torch.cuda.is_available():
            self._replay = torch.cuda.CUDAGraph.replay
            original = self._replay

            def replay(graph, *args, **kwargs):
                out = original(graph, *args, **kwargs)
                self._stepped(None)
                return out

            torch.cuda.CUDAGraph.replay = replay

    def _on_step(self, optimizer, args, kwargs) -> None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return
        self._stepped(optimizer)

    def _stepped(self, optimizer) -> None:
        self.count += 1
        if self.count == 1 and optimizer is not None:
            self.moments = {self.names[id(p)]: optimizer.state[p]["exp_avg"].detach().clone()
                            for group in optimizer.param_groups for p in group["params"]
                            if id(p) in self.names and "exp_avg" in optimizer.state.get(p, {})}
        if self.count == FIRST_STEPS:
            self.after = {n: p.detach().clone() for n, p in self.params.items()}
            self.close()

    def to_host(self) -> None:
        """Moves what was kept to the host (before the window opens)."""
        for kept in (self.moments, self.after):
            for n, t in (kept or {}).items():
                kept[n] = t.cpu()

    def close(self) -> None:
        self._hook.remove()
        if self._replay is not None:
            torch.cuda.CUDAGraph.replay = self._replay
            self._replay = None


def _data(cfg, d, seed, dev):
    """(data module, training inputs, training labels as the program
    normalises them) from the seed."""
    data = cfg.get("data", {}) or {}
    n_train, n_val = int(data["num_samples"]), int(data["num_test_samples"])
    if d.image:
        from vit_tpu_torch.data.images import ImageDataModule, ImageDataset

        dm = ImageDataModule(cfg)
        splits = []
        for stream, n in ((1, n_train), (2, n_val)):
            ds = ImageDataset(image_size=d.length, num_classes=d.labels)
            ds.images, ds.labels = inputs.images(n, d.length, d.labels,
                                                 inputs.generator(seed, dev, stream), dev)
            splits.append(ds)
        dm.train, dm.val = splits
        return dm, dm.train.images, dm.train.labels
    from vit_tpu_torch.data.datasets import SpecDataModule

    src = inputs.spectra(n_train, d.length, inputs.generator(seed, dev, 1), dev)
    y = np.asarray(src["params"][data["param"]][:n_train], np.float32)
    lo, hi = y.min(), y.max()
    return SpecDataModule(cfg, source=src), src["flux"][:n_train], ((y - lo) / (hi - lo))[:, None]


def _weights(ctx, d) -> dict:
    """The run's weights from the seed. A cell's ``regressor_bias`` sets the
    regression head's bias: the head's first output is then about that far
    below the labels (which lie in [0, 1]) for every seed, where a drawn
    bias leaves it anywhere in the labels' range. Where it falls on the
    first batch's label mean, the first gradient of the bias (twice the mean
    residual) is a near-cancelling sum and its rounding reads as a large
    share of a near-zero leaf."""
    w = inputs.weights(d, inputs.generator(ctx.seed, ctx.device, 0), ctx.device)
    if "regressor_bias" in ctx.params:
        w["regressor.bias"].fill_(float(ctx.params["regressor_bias"]))
    return w


def _batches(ctx, d, x, y, seed32, steps_per_epoch):
    rows = reference.epoch_rows(len(x), d.batch, steps_per_epoch, seed32)
    dev = ctx.device
    return [(torch.from_numpy(np.ascontiguousarray(x[rows[i * d.batch:(i + 1) * d.batch]])).to(dev),
             torch.from_numpy(np.ascontiguousarray(y[rows[i * d.batch:(i + 1) * d.batch]])).to(dev))
            for i in range(FIRST_STEPS)]


def _reference(ctx, d, w, x, y, seed32, steps_per_epoch, quant=None) -> dict:
    reference.plain_mode()
    seeds = reference.epoch_seeds(seed32, steps_per_epoch, d.sites)[:FIRST_STEPS]
    w = {n: t.to(ctx.device) for n, t in w.items()}
    return reference.train_steps(d, w, _batches(ctx, d, x, y, seed32, steps_per_epoch), seeds,
                                 d.first_lr(), int(ctx.params["ref_block_rows"]), quant)


def run(ctx) -> dict:
    from vit_tpu_torch.train.loop import Experiment

    cfg = copy.deepcopy(ctx.config)
    if (cfg.get("train", {}) or {}).get("handle_preemption") is False:
        raise ValueError("the window ends by the epoch log; keep handle_preemption on")
    d = dims(cfg)
    dev, seed32 = ctx.device, ctx.seed % 2**31
    ctx.mark("imports")
    dm, x, y = _data(cfg, d, ctx.seed, dev)
    w = _weights(ctx, d)
    ctx.mark("data_and_weights")
    exp = Experiment(copy.deepcopy(cfg), device=dev, seed=seed32, datamodule=dm)
    exp.module.load_state_dict(w, strict=True)
    w = {n: t.cpu() for n, t in w.items()}
    ctx.mark("experiment")
    steps_per_epoch = -(-len(x) // d.batch)
    n_val = int(cfg["data"]["num_test_samples"])
    val_batches = -(-n_val // min(d.batch, n_val))
    watch = FirstSteps(exp.module)
    tracer = Tracer() if ctx.trace else None
    st = {"start": None, "end": None, "epochs": 0, "nonfinite": 0, "first": None, "trace": None,
          "epoch_s": []}

    def on_epoch(epoch, metrics, step=None):
        ctx.sync()
        now = time.perf_counter()
        losses = np.asarray(exp.epoch_losses, np.float64)
        if st["start"] is None:
            st["first"] = losses[:FIRST_STEPS].tolist()
            watch.to_host()
            ctx.mark("warm_epoch")
            if tracer is not None:
                tracer.start()
            st["start"] = time.perf_counter()
            return
        st["epochs"] += 1
        st["epoch_s"].append(now - (st["end"] or st["start"]))
        st["end"] = now
        st["nonfinite"] += int((~np.isfinite(losses)).sum())
        if tracer is not None:
            st["trace"] = tracer.stop({"train_steps": steps_per_epoch, "val_batches": val_batches,
                                       "val_batch_rows": min(d.batch, n_val)})
            raise WindowClosed
        if now - st["start"] >= ctx.seconds:
            raise WindowClosed

    exp.logger.log_epoch = on_epoch
    try:
        exp.fit()
    except WindowClosed:
        pass
    finally:
        watch.close()
    ctx.sync()
    if st["epochs"] == 0:
        raise RuntimeError("the fit ended before a window epoch")
    window_s = st["end"] - st["start"]
    steps = st["epochs"] * steps_per_epoch
    fused = exp.fused
    counters = {"steps_per_epoch": steps_per_epoch, "val_batches_per_epoch": val_batches,
                "window_epochs": st["epochs"], "window_steps": steps,
                "window_epoch_s": st["epoch_s"],
                "graph": None if fused is None else {
                    "captured_launches": {str(k): v for k, v in fused.captured_launches.items()},
                    "replays": fused.replays, "eager_steps": fused.eager_steps,
                    "capture_seconds": fused.capture_seconds},
                "optimizer_steps_seen": watch.count}
    peak = ctx.memory_peak()
    b1 = reference.BETAS[0]
    prog = {"losses": st["first"],
            "grad1": {n: float(m.float().norm()) / (1 - b1) for n, m in (watch.moments or {}).items()},
            "change": {n: float((p.float() - w[n]).norm()) for n, p in (watch.after or {}).items()}}
    del exp, dm, watch
    gc.collect()
    ctx.free()
    ref = _reference(ctx, d, w, x, y, seed32, steps_per_epoch)
    numbers, detail = {}, None  # a leaf missing on one side fails every number
    if set(prog["grad1"]) == set(ref["grad1"]) and set(prog["change"]) == set(ref["change"]):
        numbers = checks.train_numbers(prog, ref)
        detail = checks.train_detail(prog, ref)
    return {"metrics": {"train_samples_per_s": steps * d.batch / window_s,
                        "setup_s": st["start"] - ctx.t_start},
            "attempted": steps, "failed": st["nonfinite"], "memory_peak_bytes": peak,
            "numbers": numbers, "detail": detail, "trace": st["trace"], "counters": counters}


def control(ctx) -> dict:
    """The control: the reference in fp8 in the program's place, held
    against the fp32 reference at the cell's size."""
    cfg = copy.deepcopy(ctx.config)
    d = dims(cfg)
    dm, x, y = _data(cfg, d, ctx.seed, ctx.device)
    w = _weights(ctx, d)
    seed32 = ctx.seed % 2**31
    steps_per_epoch = -(-len(x) // d.batch)
    ref = _reference(ctx, d, w, x, y, seed32, steps_per_epoch)
    low = _reference(ctx, d, w, x, y, seed32, steps_per_epoch, quant="fp8")
    return {"numbers": checks.train_numbers(low, ref), "detail": checks.train_detail(low, ref)}
