"""The fused epoch: every training step of an epoch on the device, with no
host sync inside it (port of ``vit_tpu/train/loop.py::make_train_epoch``,
:312-483, and its selection, :1262-1360).

``vit_tpu`` scans the whole epoch in one XLA dispatch. The port keeps the
step it shares with the per-step path (:meth:`Experiment.train_step`) and
takes what varies from step to step out of the host's hands:

* the needed columns (``x``, ``label``, and ``error`` only when there is
  noise) go to the device once, at fit start;
* each epoch, the host makes the index vector (``epoch_permutation``, the
  Batcher's own contract), the dropout seeds of every step, shaped (steps,
  accumulate_steps, sites) and drawn from ``dropout_gen`` in the per-step
  path's order, the injected noise of every micro-batch from ``noise_gen``
  (one draw each, as the per-step path draws it), and the learning rate of
  every step (``spec.lr * schedule(step) * plateau_scale``), and copies them
  into fixed device buffers, once an epoch;
* step ``i`` reads entry ``i`` of each buffer through a step counter held
  on the device, gathers its rows (``epoch_gather: step``; ``block``
  gathers the whole epoch once first), runs the training step with those
  draws, writes its loss into an epoch buffer and advances the counter.

So the fused path sees exactly the per-step path's data and random numbers.
On the card that step is captured once per ``frozen`` state as a
``torch.cuda.CUDAGraph`` and replayed once a step: the first step of a new
state runs eagerly on a side stream (it is a real step, and the warm-up the
capture needs: optimizer state, cuBLAS handles), the capture records the
next one without running it, and replays run the rest. A capture or replay
that fails raises: there is no fallback. On the CPU (only when asked for)
the same step body runs eagerly, step after step.

After an epoch's steps, validation (``fused_val``: inputs under 512 MB)
runs on the device in the per-step path's masked batches, with no host read
per batch; the losses and the logits are read back once an epoch, or once
a block of ``epochs_per_dispatch`` epochs.

:class:`ReplicaEpochs` is the vmapped sweep's epoch
(``vit_tpu/opt/parallel_sweep.py::_VmapSweepEngine``, :405-454): R
replicas' parameters and optimizer state stacked on a leading axis, one
step of all of them through ``torch.func.vmap`` of the loss and one
backward, captured once as a CUDA graph on the card and replayed over the
epoch. Its device buffers are the fused epoch's, with a replica axis: the
R permutations (gathered on read), seeds, noise and learning rates, and the
``active`` and ``frozen`` flags that hold a stopped replica's state and a
frozen preprocessor.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vit_tpu_torch.data.pipeline import epoch_permutation
from vit_tpu_torch.func_internals import reparametrize
from vit_tpu_torch.models.vit import train_forward

__all__ = ["FusedEpochs", "ReplicaEpochs", "StepDraws", "fused_epoch_setting",
           "FUSED_DATA_BYTES", "FUSED_VAL_BYTES"]

FUSED_DATA_BYTES = 4 * 1024**3  # vit_tpu's HBM gate for the epoch's columns
FUSED_VAL_BYTES = 512 * 1024**2  # and for the fused validation inputs
SEED_HIGH = 2**31 - 1  # seeds are drawn in [0, int32 max), as vit_tpu's randint


def fused_epoch_setting(value):
    """``train.fused_epoch`` as True, False or ``"auto"``: the truthy
    spellings of CLI and sweep overrides (1, 'true', 'yes', 'on') count
    (``vit_tpu/train/loop.py:1265-1268``)."""
    if isinstance(value, str):
        v = value.strip().lower()
        return "auto" if v == "auto" else v in ("1", "true", "yes", "on")
    return bool(value)


def _upload(dst: torch.Tensor, src: torch.Tensor) -> None:
    """One host-to-device copy into a fixed buffer, from pinned memory on
    the card (asynchronous, ordered on the stream)."""
    if dst.device.type == "cuda":
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


def _capture(step, device, pool) -> Tuple["torch.cuda.CUDAGraph", Dict[str, int], float]:
    """Run ``step`` once eagerly on a side stream (a real step, and the
    warm-up a capture needs: optimizer state, cuBLAS handles), then capture
    the next one without running it: (graph, kernel launches captured,
    capture seconds)."""
    from vit_tpu_torch.ops._build import KERNELS

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(device).wait_stream(side)
    before = {n: k.launches for n, k in KERNELS.items()}
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    # A graph left by an earlier run is destroyed now, not by a collection
    # that happens to run inside the capture: destroying a graph is not
    # permitted while a stream captures, and would invalidate this capture.
    gc.collect()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            step()
    finally:
        gc.enable()
    return (graph, {n: k.launches - before[n] for n, k in KERNELS.items()},
            time.perf_counter() - t0)


class StepDraws(NamedTuple):
    """One step's draws, as the fused epoch hands them to the step: seeds
    (accumulate_steps, sites) int32 and noise (accumulate_steps, rows,
    length) or None, on the device; the learning rate, a 0-d fp32 device
    tensor on the card and a float on the CPU."""

    seeds: torch.Tensor
    noise: Optional[torch.Tensor]
    lr: Union[torch.Tensor, float]


class FusedEpochs:
    """Runs epochs of ``exp``'s training step on the device.

    ``cols``: the epoch's needed columns (host arrays); ``val_x``: the
    validation inputs for fused validation, or None.
    """

    def __init__(self, exp, spec, schedule, cols: Dict[str, np.ndarray], steps_per_epoch: int,
                 gather_mode: str, val_x: Optional[np.ndarray], val_batch_size: int) -> None:
        if gather_mode not in ("step", "block"):
            raise ValueError(f"train.epoch_gather must be 'step' or 'block', got {gather_mode!r}")
        self.exp, self.spec, self.schedule = exp, spec, schedule
        self.device = exp.device
        self.cuda = self.device.type == "cuda"
        self.steps, self.bs, self.accum = steps_per_epoch, exp.batch_size, exp.accum_steps
        self.n = int(next(iter(cols.values())).shape[0])
        self.gather_mode = gather_mode
        dev = self.device
        self.data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in cols.items()}
        self.noisy = exp.noise_level > 0 and "error" in self.data
        mb = self.bs // self.accum
        length = self.data["x"].shape[1]
        self.perm = torch.zeros(self.steps * self.bs, dtype=torch.int64, device=dev)
        self.seeds = torch.zeros((self.steps, self.accum, exp.module.num_dropout_sites),
                                 dtype=torch.int32, device=dev)
        self.noise = (torch.zeros((self.steps, self.accum, mb, length), device=dev)
                      if self.noisy else None)
        self.lrs = torch.zeros(self.steps, dtype=torch.float32, device=dev)
        self.losses = torch.zeros(self.steps, dtype=torch.float32, device=dev)
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self.block = ({k: torch.empty((self.steps, self.bs) + v.shape[1:], dtype=v.dtype,
                                      device=dev) for k, v in self.data.items()}
                      if gather_mode == "block" else None)
        self.val_x = None
        if val_x is not None:
            n_val = len(val_x)
            nb = max(1, -(-n_val // val_batch_size))
            self.val_x = torch.from_numpy(np.ascontiguousarray(val_x)).to(dev)
            # The per-step path's eval batches: the last row repeats to fill.
            self.val_idx = torch.arange(nb * val_batch_size, device=dev).clamp_max(
                n_val - 1).view(nb, val_batch_size)
            self.n_val = n_val
        # The card: one graph per frozen state, in one memory pool.
        self.graphs: Dict[float, "torch.cuda.CUDAGraph"] = {}
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.captured_launches: Dict[float, Dict[str, int]] = {}
        self.capture_seconds = 0.0
        self.replays = 0
        self.eager_steps = 0

    # -- per-epoch host work -------------------------------------------------
    def _prepare(self, epoch: int) -> float:
        """Copy epoch ``epoch``'s index vector and draws to the device; the
        last step's learning rate (a host float)."""
        exp = self.exp
        perm = epoch_permutation(self.n, self.bs, self.steps, exp.seed, epoch)
        _upload(self.perm, torch.from_numpy(perm.astype(np.int64)))
        seeds = torch.randint(0, SEED_HIGH, tuple(self.seeds.shape), generator=exp.dropout_gen)
        _upload(self.seeds, seeds.to(torch.int32))
        if self.noise is not None:
            shape = tuple(self.noise.shape[2:])
            noise = torch.stack([torch.randn(shape, generator=exp.noise_gen)
                                 for _ in range(self.steps * self.accum)])
            _upload(self.noise, noise.view(self.noise.shape))
        lrs = [self.spec.lr * self.schedule(exp.step + j) * exp.plateau_scale
               for j in range(self.steps)]
        _upload(self.lrs, torch.tensor(lrs, dtype=torch.float32))
        self.host_lrs = lrs
        self.counter.zero_()
        if self.block is not None:
            for k, v in self.data.items():
                torch.index_select(v, 0, self.perm, out=self.block[k].view((-1,) + v.shape[1:]))
        return lrs[-1]

    # -- the step --------------------------------------------------------
    def _step(self) -> None:
        """The step at the device counter: gather, draws, the training step
        (:meth:`Experiment.train_step`), its loss into the epoch buffer."""
        i = self.counter
        if self.block is None:
            idx = self.perm.view(self.steps, self.bs).index_select(0, i).view(self.bs)
            batch = {k: v.index_select(0, idx) for k, v in self.data.items()}
        else:
            batch = {k: v.index_select(0, i)[0] for k, v in self.block.items()}
        # The card's optimizer reads its learning rate from a device scalar;
        # the CPU's holds a Python float, as on the per-step path, so the CPU
        # takes the host value (the counter is host memory there).
        lr = self.lrs.index_select(0, i)[0] if self.cuda else self.host_lrs[int(i)]
        draws = StepDraws(self.seeds.index_select(0, i)[0],
                          None if self.noise is None else self.noise.index_select(0, i)[0], lr)
        loss, _ = self.exp.train_step(batch, self.spec, self.schedule, draws)
        self.losses.index_copy_(0, i, loss.detach().float().view(1))
        self.counter.add_(1)

    def _run_step(self) -> None:
        if not self.cuda:
            self._step()
            self.eager_steps += 1
            return
        key = float(self.exp.frozen)
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            self.replays += 1
            return
        # A new state: this step runs eagerly on a side stream (the capture's
        # warm-up), then the next one is captured, not run.
        graph, launches, seconds = _capture(self._step, self.device, self.pool)
        self.eager_steps += 1
        self.capture_seconds += seconds
        self.captured_launches[key] = launches
        self.graphs[key] = graph

    # -- epochs ------------------------------------------------------------------
    @torch.no_grad()
    def _validate(self, out: torch.Tensor) -> None:
        """The validation forward of the current weights into ``out``
        ((rows, labels), on the device), in eval mode."""
        module = self.exp.module
        module.eval()
        rows = self.val_idx.shape[1]
        for b in range(self.val_idx.shape[0]):
            out[b * rows:(b + 1) * rows] = module(self.val_x.index_select(0, self.val_idx[b]))
        module.train()

    def run(self, epochs: List[int], frozen: List[float], with_val: bool):
        """Train ``epochs`` back to back (their preprocessor ``frozen``
        flags), each followed by its validation forward when ``with_val``.
        One epoch reads its losses back once its steps are done (its time),
        then its logits; a block reads both back once, at its end, and
        shares its time among its epochs. Returns one (losses (steps,)
        float32, last lr, val logits (n_val, K) or None, seconds) per epoch."""
        exp = self.exp
        t0 = time.perf_counter()
        losses = torch.empty((len(epochs), self.steps), dtype=torch.float32, device=self.device)
        logits = None
        if with_val:
            k = exp.bundle.vit_config.num_labels
            logits = torch.empty((len(epochs), self.val_idx.numel(), k), dtype=torch.float32,
                                 device=self.device)
        lrs, losses_host = [], None
        for j, (epoch, fz) in enumerate(zip(epochs, frozen)):
            exp.frozen = fz
            lrs.append(self._prepare(epoch))
            for _ in range(self.steps):
                self._run_step()
            exp.step += self.steps
            losses[j].copy_(self.losses)
            if len(epochs) == 1:
                losses_host = losses.cpu().numpy()
                seconds = [time.perf_counter() - t0]
            if with_val:
                self._validate(logits[j])
        if losses_host is None:
            losses_host = losses.cpu().numpy()
            seconds = [(time.perf_counter() - t0) / len(epochs)] * len(epochs)
        logits_host = None if logits is None else logits[:, :self.n_val].cpu().numpy()
        return [(losses_host[j], lrs[j], None if logits_host is None else logits_host[j],
                 seconds[j]) for j in range(len(epochs))]


class ReplicaEpochs:
    """R replicas' epochs of training steps on the device, all replicas in
    one step (the vmapped sweep's ``vepoch``, module doc).

    ``module``: the model in training mode, whose parameters are replaced by
    ``params`` (name -> (R, ...) leaf tensors) for each call (what
    ``torch.func.functional_call`` does); ``loss_fn(logits, labels)``: the
    task loss; ``optimizer``: a
    :class:`~vit_tpu_torch.train.optim.ReplicaOptimizer` over ``params``
    (its learning-rate vector and ``active`` mask are device buffers the
    step reads); ``cols``: the epoch's needed host columns; ``frozen_names``:
    the parameters a frozen preprocessor holds; ``val_x``: the validation
    inputs, forwarded after each epoch in masked batches of ``val_batch_size``.

    One step: each replica gathers its rows through its own permutation,
    adds its noise, and takes its loss under ``torch.func.vmap``
    (:meth:`_losses`); one backward gives every replica's gradients; a
    frozen preprocessor's are zeroed, each replica is clipped by its own
    global norm, the optimizer steps (holding the inactive replicas), and a
    frozen preprocessor is put back. On the card the step is captured once
    and replayed; on the CPU it runs eagerly, the same arithmetic.
    """

    def __init__(self, module: torch.nn.Module, params: Dict[str, torch.Tensor], optimizer,
                 loss_fn: Callable, cols: Dict[str, np.ndarray], steps_per_epoch: int,
                 batch_size: int, noise_level: float, grad_clip: float,
                 frozen_names: Sequence[str], val_x: Optional[np.ndarray],
                 val_batch_size: int) -> None:
        self.module, self.params, self.optimizer, self.loss_fn = module, params, optimizer, loss_fn
        first = next(iter(params.values()))
        self.device = first.device
        self.cuda = self.device.type == "cuda"
        self.replicas = int(first.shape[0])
        self.steps, self.bs = steps_per_epoch, batch_size
        self.noise_level, self.grad_clip = noise_level, grad_clip
        self.frozen_names = list(frozen_names)
        dev, r = self.device, self.replicas
        self.data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in cols.items()}
        self.n = int(self.data["x"].shape[0])
        self.noisy = noise_level > 0 and "error" in self.data
        self.sites = module.num_dropout_sites
        self.perm = torch.zeros((r, self.steps * self.bs), dtype=torch.int64, device=dev)
        self.seeds = torch.zeros((r, self.steps, self.sites), dtype=torch.int32, device=dev)
        self.noise = (torch.zeros((r, self.steps, self.bs) + tuple(self.data["x"].shape[1:]),
                                  device=dev) if self.noisy else None)
        self.frozen = torch.zeros((), dtype=torch.float32, device=dev)
        self.losses = torch.zeros((r, self.steps), dtype=torch.float32, device=dev)
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self.val_x = None
        if val_x is not None:
            n_val = len(val_x)
            nb = max(1, -(-n_val // val_batch_size))
            self.val_x = torch.from_numpy(np.ascontiguousarray(val_x)).to(dev)
            self.val_idx = torch.arange(nb * val_batch_size, device=dev).clamp_max(
                n_val - 1).view(nb, val_batch_size)
            self.n_val = n_val
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.captured_launches: Dict[str, int] = {}
        self.capture_seconds = 0.0
        self.replays = 0
        self.eager_steps = 0

    # -- per-epoch host work -------------------------------------------------
    def prepare(self, perms: np.ndarray, seeds: torch.Tensor, noise: Optional[torch.Tensor],
                lrs: np.ndarray, active: np.ndarray, frozen: float) -> None:
        """Copy one epoch's (R, steps*batch) permutations, (R, steps, sites)
        seeds, (R, steps, batch, ...) noise (None without), (R,) learning
        rates and active flags and the frozen flag to the device."""
        _upload(self.perm, torch.from_numpy(np.array(perms, np.int64)))
        _upload(self.seeds, seeds.to(torch.int32))
        if self.noise is not None:
            _upload(self.noise, noise.view(self.noise.shape))
        _upload(self.optimizer.param_groups[0]["lr"],
                torch.from_numpy(np.array(lrs, np.float32)))
        _upload(self.optimizer.active, torch.from_numpy(np.array(active, np.float32)))
        self.frozen.fill_(float(frozen))
        self.counter.zero_()

    # -- the step --------------------------------------------------------
    def _losses(self, x: torch.Tensor, y: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
        """(R,) losses of the replicas' batches, each under its parameters:
        ``loss_fn`` of the logits plus, for an MoE model, the router
        regulariser (:func:`~vit_tpu_torch.models.vit.train_forward`)."""
        def one(p, x, y, s):
            with reparametrize(self.module, p):
                logits, reg = train_forward(self.module, x, s)
            loss = self.loss_fn(logits, y)
            return loss if reg is None else loss + reg

        return torch.func.vmap(one)(self.params, x, y, seeds)

    def _step(self) -> None:
        r, i = self.replicas, self.counter
        idx = self.perm.view(r, self.steps, self.bs).index_select(1, i).reshape(-1)
        batch = {k: v.index_select(0, idx).view((r, self.bs) + v.shape[1:])
                 for k, v in self.data.items()}
        x = batch["x"]
        if self.noise is not None:
            noise = self.noise.index_select(1, i).view(x.shape)
            x = x + noise * batch["error"] * self.noise_level
        seeds = self.seeds.index_select(1, i).view(r, self.sites)
        losses = self._losses(x, batch["label"], seeds)
        names = list(self.params)
        grads = torch.autograd.grad(losses.sum(), [self.params[n] for n in names])
        grads = dict(zip(names, grads))
        for n in self.frozen_names:  # before the clip: out of the global norm
            grads[n] = grads[n] * (1.0 - self.frozen)
        if self.grad_clip and self.grad_clip > 0:
            from vit_tpu_torch.train.optim import clip_by_global_norm

            clip_by_global_norm(grads.values(), self.grad_clip, per_replica=True)
        for n in names:
            self.params[n].grad = grads[n]
        held = [(self.params[n], self.params[n].detach().clone()) for n in self.frozen_names]
        self.optimizer.step()
        with torch.no_grad():
            for p, h in held:  # after the optimizer: no update, no weight decay
                p.copy_(torch.where(self.frozen > 0, h, p))
        self.losses.index_copy_(1, i, losses.detach().float().view(r, 1))
        self.counter.add_(1)

    def run_step(self) -> None:
        """The step at the device counter: eager on the CPU; on the card,
        captured once (its first call runs a step eagerly, then captures
        the next) and replayed. One graph serves every epoch: the frozen
        flag, the learning rates and ``active`` are read on the device."""
        if not self.cuda:
            self._step()
            self.eager_steps += 1
        elif self.graph is not None:
            self.graph.replay()
            self.replays += 1
        else:
            self.graph, self.captured_launches, self.capture_seconds = _capture(
                self._step, self.device, self.pool)
            self.eager_steps += 1

    # -- validation ----------------------------------------------------------
    @torch.no_grad()
    def predict(self, x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """Every replica's eval-mode logits of ``x``'s masked batches
        ``rows`` (nb, batch), (R, nb*batch, K) on the device."""
        module = self.module
        module.eval()

        def one(p, xb):
            return torch.func.functional_call(module, p, (xb,))

        try:
            out = [torch.func.vmap(one, in_dims=(0, None))(self.params, x.index_select(0, b))
                   for b in rows]
        finally:
            module.train()
        return torch.cat(out, dim=1)

    def run_epoch(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The prepared epoch's steps, then the validation forward: ((R,
        steps) losses, (R, n_val, K) logits or None), one read-back each."""
        for _ in range(self.steps):
            self.run_step()
        losses = self.losses.cpu().numpy()
        if self.val_x is None:
            return losses, None
        logits = self.predict(self.val_x, self.val_idx)
        return losses, logits[:, :self.n_val].float().cpu().numpy()
