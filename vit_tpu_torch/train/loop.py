"""The training loop and the ``Experiment`` facade (port of
``vit_tpu/train/loop.py``, single device).

One training step (``_make_grads_fn`` :168 and ``_make_step_body`` :242):

* draw the step's dropout seeds on the host, one int32 per dropout call
  site (and per micro-batch), from the Experiment's CPU
  ``torch.Generator`` seeded from ``seed``; the kernels read them from
  device memory, so the CPU and the card draw the same masks for the same
  step and a resumed run draws what the uninterrupted one would (the fused
  epoch draws a whole epoch's at once, in the same order);
* optional noise injection ``x + randn * error * noise_level``, the normal
  draws from a second CPU generator;
* loss and gradients, over ``train.accumulate_steps`` micro-batches whose
  gradients are summed and scaled by 1/A; the loss is the task loss plus,
  for an MoE model, the router regulariser of
  :func:`~vit_tpu_torch.models.vit.train_forward` (the objective the fused
  epoch and the vmapped sweep train as well; evaluation leaves it out);
* global-norm clip (``train.grad_clip``, 0.5) with optax's rule;
* the update at learning rate ``spec.lr * schedule(step) * plateau_scale``
  with ``step`` counted before the update;
* with a preprocessor frozen this epoch (``warmup.freeze_epochs``, see
  :meth:`Experiment._frozen_flag`), its gradients are zeroed before the clip,
  so they take no part in the global norm, and its update is undone after
  the optimizer, so AdamW's decoupled decay cannot shrink it either
  (``vit_tpu/train/loop.py:250-257``). The zeroed gradients stay tensors:
  every optimizer counts the step for every parameter, as optax's global
  count does.

``Experiment.fit`` runs epochs of such steps over ``Batcher`` batches
copied ahead to the device, evaluates the validation split in masked
fixed-size batches, steps ReduceLROnPlateau and early stopping (patience
500, 100 in a sweep) on ``val_<monitor>``, and writes best/last
checkpoints; ``--ckpt`` resumes the optimizer, step, plateau scale,
generators and host scheduler states. ``test`` evaluates a checkpoint on
the test split and, with ``viz.enable``, writes the regression report.

Around the steps, as in ``vit_tpu`` (``loop.py:1210-1224,1444-1702``):

* the preemption guard (``train.handle_preemption``, default on): the
  first SIGTERM stops the run at the end of its epoch, after ``last`` is
  saved; the flag is read once an epoch, with no host sync;
* diagnostics (``viz.enable``): every ``viz.log_every_n_epochs`` epochs
  (or ``log_every_n_steps`` steps) an eval forward with capture over the
  first validation spectra, capped by ``capture_batch_cap``, feeds the
  GIF frames and the CKA monitor; GIFs and the CKA report are written at
  train end. A failure there is printed and skipped, never fatal;
* an MoE model logs ``moe_dropped_frac`` each epoch: the share of (token,
  slot) assignments the capacity dropped, averaged over the layers, from a
  deterministic forward over up to one batch of validation rows
  (``vit_tpu/train/loop.py:1150-1185``), outside any graph;
* ``train.log_mfu``: ``tflops_per_s`` from ``step_matmul_flops`` over the
  epoch's wall clock, and ``mfu`` against ``train.peak_tflops`` (the H100's
  dense bf16 peak is 989);
* ``train.profile``: a torch.profiler Chrome trace of the steady-state
  epoch (the second of the run when there is one), its validation and end
  included, with the port's spans (:mod:`vit_tpu_torch.tracing`), under
  that directory, ``./results/profile`` for ``true``;
* W&B logging and checkpoint artifacts through :class:`MetricLogger`;
* ``train.async_ckpt``: checkpoint writes on a background thread, fenced by
  ``CheckpointManager.wait()`` before any read-back.

A model with a preprocessor takes raw spectra of the preprocessor's input
length (``SpecViT.input_length``), which the builder's adjusted
``model.image_size`` no longer gives; the loaded split's length is checked
against it. Each epoch's metrics add ``preprocessor_frozen`` (1.0 or 0.0).

``train.fused_epoch`` (``true``, ``false`` or ``auto``, the default, as in
``vit_tpu``: fused when the epoch's needed columns are under 4 GB and
``debug`` is off) runs each epoch through :class:`~vit_tpu_torch.train.fused.
FusedEpochs`: the data on the device, the step captured as a CUDA graph and
replayed, the same step and the same random numbers as the per-step path
(bit for bit on the CPU), with ``train.epoch_gather`` and
``train.epochs_per_dispatch`` as ``vit_tpu`` defines them (:1262-1360,
:1456-1460): blocks of epochs with one read-back, checkpoints, plateau and
early stopping at block boundaries, ``log_every_n_steps`` rounded to epochs.
``model.fast_dropout: false`` runs there too: its ``nn.Dropout`` masks are
computed on the device from the sites' seeds.

The optimizer on the card is graph-safe (``build_optimizer(...,
capturable=True)``: the learning rate in a device scalar, the step counts
on the device) on both paths.

Runs on the card unless ``device="cpu"`` is given.

Parallelism (``vit_tpu/train/loop.py:572-760``), one process a rank on
``torch.distributed`` (:mod:`vit_tpu_torch.parallel`): ``Experiment``
builds the ``(data, model[, pipe])`` mesh from ``train.gpus`` (capped by
the world size), ``train.model_parallel`` (tensor parallelism, an MoE
model's expert parallelism), ``train.sequence_parallel`` (ring attention,
``model.attn_impl: ring``) and ``train.pipeline_parallel`` (with
``train.pipeline_microbatches``; stage-resident, or with
``train.pipeline_stage_params: false`` replicated, its gradients shared
over ``pipe`` before anything reads them), with ``vit_tpu``'s mutual-exclusion
errors and its shrink of the data axis to a divisor of the batch rows.
Every rank reads the same global batch (the same permutation, seeds and
noise) and trains on its rows of each micro-batch, at the dropout
:func:`~vit_tpu_torch.ops.dropout.batch_offset` of its first row; the
gradients (and the loss) are averaged over ``data`` before the clip, whose
global norm counts each split block once; ``train.opt_state_sharding``
steps ZeRO-1 (:class:`~vit_tpu_torch.train.optim.Zero1Optimizer`). Every
rank evaluates the whole validation split, so the metrics, the plateau
scale and early stopping agree on all ranks. Rank 0 alone logs, traces and
writes checkpoints, which hold the one-rank layout
(:mod:`vit_tpu_torch.parallel.checkpoint`); a preemption signal on any rank
stops every rank at the same epoch. A rank the shrink leaves out of the
mesh trains nothing (``fit`` and ``test`` return empty metrics).
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vit_tpu_torch.data.datasets import RegSpecDataset, SpecDataModule, parse_param_list
from vit_tpu_torch.data.pipeline import Batcher, prefetch_to_device
from vit_tpu_torch.hardware import get_prefetch_depth
from vit_tpu_torch.models.builder import get_model, step_matmul_flops
from vit_tpu_torch.models.vit import compute_loss, train_forward
from vit_tpu_torch.ops.dropout import batch_offset
from vit_tpu_torch.parallel import comm
from vit_tpu_torch.parallel.checkpoint import (
    canonical_optimizer_state,
    canonical_state_dict,
    local_optimizer_state,
    local_state_dict,
)
from vit_tpu_torch.parallel.mesh import active_mesh_scope, make_mesh, maybe_initialize_distributed
from vit_tpu_torch.parallel.tensor import global_grad_norm, shard_module, split_axes, sync_gradients
from vit_tpu_torch.serve import resolve_device
from vit_tpu_torch.tracing import span
from vit_tpu_torch.train.checkpoint import CheckpointManager, default_ckpt_dir
from vit_tpu_torch.train.fused import (
    FUSED_DATA_BYTES,
    FUSED_VAL_BYTES,
    SEED_HIGH,
    FusedEpochs,
    fused_epoch_setting,
)
from vit_tpu_torch.train.logging import MetricLogger
from vit_tpu_torch.train.metrics import (
    classification_metrics,
    monitor_for_task,
    regression_extras,
    regression_metrics,
)
from vit_tpu_torch.train.optim import (
    EarlyStopping,
    OptSpec,
    PlateauScheduler,
    Zero1Optimizer,
    build_optimizer,
    clip_by_global_norm,
    load_optimizer_state,
    schedule_scale,
    set_learning_rate,
)
from vit_tpu_torch.train.preempt import PreemptionGuard
from vit_tpu_torch.utils import count_params, seed_everything
from vit_tpu_torch.viz.callback_factory import create_viz_callbacks
from vit_tpu_torch.viz.diagnostics import capture_batch_cap, capture_diagnostics

__all__ = ["Experiment", "loss_and_grads", "draw_seeds"]

def draw_seeds(gen: torch.Generator, micro_batches: int, sites: int) -> List[List[int]]:
    """One int32 dropout seed per (micro-batch, call site), on the host."""
    return torch.randint(0, SEED_HIGH, (micro_batches, sites), generator=gen).tolist()


def loss_and_grads(module: torch.nn.Module, batch: Dict[str, torch.Tensor], task: str,
                   loss_name: str, seeds, noise_level: float = 0.0,
                   noise=None, shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """The step's loss (a 0-d tensor on the batch's device), with the
    gradients of the mean over ``len(seeds)`` equal micro-batches left in
    the parameters' ``.grad`` (zeroed first). ``_make_grads_fn``.

    ``seeds``: one row of site seeds per micro-batch (lists of ints, or an
    (accumulate_steps, sites) int tensor on the device). ``noise``: a CPU
    ``torch.Generator`` that draws each micro-batch's normals, or those
    normals already drawn, (accumulate_steps, rows, length) on the device.
    ``shard``: (r, n), this rank's block ``r`` of ``n`` of each micro-batch's
    rows (data parallelism): it trains on those rows, with their noise and
    at their dropout batch offset, so the ``n`` ranks' mean is the one-rank
    step's."""
    for p in module.parameters():
        p.grad = None
    x, y = batch["x"], batch["label"]
    accum = len(seeds)
    if x.shape[0] % accum != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by accumulate_steps {accum}")
    mb = x.shape[0] // accum
    r, n = shard
    if mb % n != 0:
        raise ValueError(f"micro-batch {mb} not divisible by {n} data shards")
    lo, hi = r * mb // n, (r + 1) * mb // n
    total = None
    for a in range(accum):
        xa = x[a * mb + lo:a * mb + hi]
        if noise_level > 0 and "error" in batch:
            z = (noise[a] if isinstance(noise, torch.Tensor)
                 else torch.randn((mb,) + tuple(xa.shape[1:]), generator=noise).to(xa.device))
            xa = xa + z[lo:hi] * batch["error"][a * mb + lo:a * mb + hi] * noise_level
        with batch_offset(lo):
            logits, reg = train_forward(module, xa, seeds[a])
        loss = compute_loss(logits, y[a * mb + lo:a * mb + hi], task, loss_name)
        if reg is not None:
            loss = loss + reg
        loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    if accum > 1:
        for p in module.parameters():
            if p.grad is not None:
                p.grad.mul_(1.0 / accum)
        return total * (1.0 / accum)
    return total


def _host_loss(logits: np.ndarray, labels: np.ndarray, task: str, loss_name: str) -> float:
    if task == "cls":
        z = logits - logits.max(axis=-1, keepdims=True)
        logp = z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
        return float(-logp[np.arange(len(labels)), labels.astype(int)].mean())
    diff = logits.reshape(len(logits), -1) - labels.reshape(len(labels), -1)
    if "l1" in (loss_name or "l2").lower():
        return float(np.abs(diff).mean())
    return float((diff**2).mean())


def _dataset_label_bounds(ds) -> Optional[list]:
    """Fixed denormalised axis bounds from a RegSpecDataset's minmax label
    stats (the original parameter ranges); None lets the viz fall back to
    the first epoch's data ranges."""
    if (getattr(ds, "label_norm", None) == "minmax"
            and getattr(ds, "label_min", None) is not None
            and getattr(ds, "label_max", None) is not None):
        lo = np.ravel(np.asarray(ds.label_min, np.float64))
        hi = np.ravel(np.asarray(ds.label_max, np.float64))
        return [(float(a), float(b)) for a, b in zip(lo, hi)]
    return None


class _Quiet:
    """The logger of a rank other than 0: every call does nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class Experiment:
    """Build model, data and optimizer, then ``fit`` / ``test`` / ``run``.

    ``datamodule``: an already built :class:`SpecDataModule` (e.g. over
    in-memory spectra) in place of the one the config's paths describe. An
    image config (``model.input_kind: image``) reads an
    :class:`~vit_tpu_torch.data.images.ImageDataModule` (NHWC images, the
    synthetic set when no path is configured).
    """

    def __init__(self, config: dict, use_wandb: bool = False, sweep: bool = False,
                 ckpt_path: Optional[str] = None, num_devices: Optional[int] = None,
                 seed: int = 42, device="cuda",
                 datamodule: Optional[SpecDataModule] = None) -> None:
        self.device = resolve_device(device)
        maybe_initialize_distributed(self.device)  # a torchrun launch
        self.config = config
        self.sweep = sweep
        self.ckpt_path = ckpt_path
        self.seed = seed
        seed_everything(seed)
        train_cfg = config.get("train", {}) or {}
        self.bundle = get_model(config, generator=torch.Generator().manual_seed(seed))
        self.module = self.bundle.module.to(self.device)
        # The one-rank layout's names, in order: what checkpoints hold.
        self._state_names = list(self.module.state_dict())
        self._param_names = [n for n, _ in self.module.named_parameters()]
        if datamodule is not None:
            self.datamodule = datamodule
        elif self.bundle.vit_config.input_kind == "image":
            from vit_tpu_torch.data.images import ImageDataModule

            self.datamodule = ImageDataModule.from_config(config)
        else:
            self.datamodule = SpecDataModule.from_config(config)
        self.max_epochs = int(train_cfg.get("ep", 10))
        self.debug = bool(train_cfg.get("debug", 0))
        self.save = bool(train_cfg.get("save", False))
        self.batch_size = int(train_cfg.get("batch_size", 64))
        self.noise_level = float((config.get("noise", {}) or {}).get("noise_level", 0) or 0)
        self.accum_steps = int(train_cfg.get("accumulate_steps", 1) or 1)
        if self.batch_size % self.accum_steps != 0:
            raise ValueError(f"train.batch_size {self.batch_size} must divide by "
                             f"train.accumulate_steps {self.accum_steps}")
        self.prefetch_depth = get_prefetch_depth(config)
        self._build_mesh(train_cfg, train_cfg.get("gpus") if num_devices is None else num_devices)
        self.is_main = self.mesh.rank == 0
        profile = train_cfg.get("profile")
        self.profile_dir: Optional[str] = None
        if profile:
            self.profile_dir = profile if isinstance(profile, str) else "./results/profile"
        self.monitor, self.monitor_mode = monitor_for_task(self.bundle.vit_config.task_type)
        self.logger = (MetricLogger(project=config.get("project", "vit-tpu"),
                                    name=self.bundle.model_name, use_wandb=use_wandb,
                                    config=config, save_artifacts=self.save)
                       if self.is_main else _Quiet())
        # Every rank tracks the best epoch; rank 0 writes.
        self.ckpt = CheckpointManager(default_ckpt_dir(), self.bundle.model_name,
                                      monitor=self.monitor, mode=self.monitor_mode,
                                      enabled=self.save and self.is_main,
                                      async_save=bool(train_cfg.get("async_ckpt", False)))
        # Host generators: dropout seeds and injected noise (see module doc).
        self.dropout_gen = torch.Generator().manual_seed(seed)
        self.noise_gen = torch.Generator().manual_seed(seed + 1)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.frozen = 0.0  # 1.0 while the preprocessor is frozen (_frozen_flag)
        self.plateau_scale = 1.0
        self.plateau: Optional[PlateauScheduler] = None
        self.early: Optional[EarlyStopping] = None
        self.callback_metrics: Dict[str, float] = {}
        self.epoch_losses: Optional[np.ndarray] = None  # the last epoch's step losses
        self.fused: Optional[FusedEpochs] = None  # the fused epoch of the last fit

    # -- the mesh --------------------------------------------------------
    def _build_mesh(self, train_cfg: dict, num_devices) -> None:
        """The run's mesh and this rank's part of the model
        (``vit_tpu/train/loop.py:620-760``): its checks and messages, the
        data axis shrunk to a divisor of the batch rows, then the model's
        tensor/expert split (``train.model_parallel``) or this rank's
        pipeline stage (``train.pipeline_parallel``)."""
        vc = self.bundle.vit_config
        tp = int(train_cfg.get("model_parallel", 1) or 1)
        self.sp = int(train_cfg.get("sequence_parallel", 1) or 1)
        if tp > 1 and self.sp > 1:
            raise ValueError("train.model_parallel and train.sequence_parallel both split "
                             "the 'model' mesh axis — set at most one of them")
        if tp > 1 and vc.attn_impl == "ring":
            raise ValueError("model.attn_impl: ring shards the sequence over the 'model' "
                             "mesh axis and cannot compose with train.model_parallel > 1; "
                             "use train.sequence_parallel instead")
        axis_split = max(tp, self.sp)
        if self.sp > 1 and vc.attn_impl != "ring":
            print(f"[experiment] train.sequence_parallel={self.sp} has no "
                  "effect without model.attn_impl: ring")
        self.pp = int(train_cfg.get("pipeline_parallel", 1) or 1)
        microbatches = int(train_cfg.get("pipeline_microbatches", 0) or 0)
        # train.pipeline_stage_params (on): each rank holds its stage's layers;
        # off: every layer on every rank, the layout that composes with ZeRO-1.
        self.pp_resident = self.pp > 1 and bool(train_cfg.get("pipeline_stage_params", True))
        if self.pp > 1:
            if vc.attn_impl == "ring":
                raise ValueError("model.attn_impl: ring cannot run inside the pipeline "
                                 "(the ring splits the sequence over its own mesh axis); use "
                                 "attn_impl auto/xla/flash with train.pipeline_parallel")
            if self.sp > 1:
                raise ValueError("train.sequence_parallel cannot compose with "
                                 "train.pipeline_parallel (ring attention splits the "
                                 "sequence over the axis the pipeline body would need)")
            if tp > 1 and not self.pp_resident:
                raise ValueError("train.model_parallel x pipeline_parallel requires the "
                                 "stage-resident layout (train.pipeline_stage_params: "
                                 "true, the default)")
            if vc.num_hidden_layers % self.pp != 0:
                raise ValueError(f"model.num_hidden_layers={vc.num_hidden_layers} must be "
                                 f"divisible by train.pipeline_parallel={self.pp}")
        self.pp_microbatches = microbatches or self.pp
        if self.pp <= 1 and microbatches > 0:
            print("[experiment] train.pipeline_microbatches has no effect "
                  "without train.pipeline_parallel > 1")
        self.zero1 = bool(train_cfg.get("opt_state_sharding", False))
        if self.zero1 and axis_split > 1:
            raise ValueError("train.opt_state_sharding composes with data/pipeline "
                             "parallelism only: under model_parallel the moments already "
                             "inherit the tensor-parallel layouts; set model_parallel/"
                             "sequence_parallel to 1")
        if self.zero1 and self.pp_resident:
            raise ValueError("train.opt_state_sharding is redundant with the stage-"
                             "resident pipeline layout (encoder optimizer state is "
                             "already 1/P-sharded over `pipe`); set "
                             "train.pipeline_stage_params: false to combine zero1 with "
                             "the replicated-params pipeline")
        fwd_batch = self.batch_size // self.accum_steps
        if self.pp > 1 and fwd_batch % self.pp_microbatches != 0:
            raise ValueError(
                f"the per-forward batch {fwd_batch} (train.batch_size {self.batch_size} / "
                f"accumulate_steps {self.accum_steps}) must divide by "
                f"train.pipeline_microbatches {self.pp_microbatches}")
        self.mesh = make_mesh(num_devices=num_devices, model_parallel=axis_split,
                              pipeline_parallel=self.pp)
        n_data = self.mesh.size("data")
        rows = fwd_batch // self.pp_microbatches if self.pp > 1 else fwd_batch
        data_par = math.gcd(rows, n_data)
        if data_par != n_data:
            print(f"[experiment] batch rows {rows} not divisible by "
                  f"{n_data} data shards; using {data_par}")
            self.mesh = make_mesh(num_devices=data_par * axis_split * self.pp,
                                  model_parallel=axis_split, pipeline_parallel=self.pp)
        if not self.mesh.member:
            print(f"[experiment] rank {self.mesh.rank} is outside the mesh {self.mesh.shape}: "
                  "it trains nothing")
            return
        if tp > 1:
            shard_module(self.module, self.mesh)
        if self.pp > 1:
            from vit_tpu_torch.parallel.pipeline import attach_pipeline

            attach_pipeline(self.module, self.mesh, self.pp_microbatches,
                            resident=self.pp_resident)
        # _split: this rank holds a part of the model (checkpoints gather it);
        # the replicated pipeline holds it all but counts each layer's
        # gradient norm at its stage.
        self._split = any(split_axes(p) for p in self.module.parameters())
        self._norm_split = self._split or self.pp > 1

    def _all_ranks_any(self, flag: bool) -> bool:
        """True on every rank of the mesh when ``flag`` is on any of them."""
        if self.mesh.world_group is None:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        return bool(comm.all_reduce(t, self.mesh.world_group).item() > 0)

    # -- the step --------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor], spec: OptSpec,
                   schedule, draws=None) -> Tuple[torch.Tensor, float]:
        """One optimizer step; returns (loss tensor, learning rate).

        ``draws``: the fused epoch's :class:`~vit_tpu_torch.train.fused.
        StepDraws` for this step (seeds, noise and learning rate on the
        device; the fused epoch counts the steps). Without it the step draws
        from the host generators and counts itself."""
        with span("vtt.train.step"):
            vc = self.bundle.vit_config
            if draws is None:
                seeds = draw_seeds(self.dropout_gen, self.accum_steps,
                                   self.module.num_dropout_sites)
                noise, lr = self.noise_gen, spec.lr * schedule(self.step) * self.plateau_scale
            else:
                seeds, noise, lr = draws
            mesh = self.mesh
            with span("vtt.train.forward_backward"):
                loss = loss_and_grads(self.module, batch, vc.task_type, self.bundle.loss_name,
                                      seeds, self.noise_level, noise,
                                      shard=(mesh.coord("data"), mesh.size("data")))
                loss = self.reduce_gradients(loss)
            with span("vtt.train.optimizer"):
                # After the exchange: under the replicated pipeline the other
                # stages' layers had no gradient before it, and the optimizer
                # would skip them.
                params = [p for p in self.module.parameters() if p.grad is not None]
                frozen = self._preprocessor_params() if self.frozen else []
                for p in frozen:
                    p.grad.zero_()  # before the clip: out of the global norm
                if spec.grad_clip and spec.grad_clip > 0:
                    norm = global_grad_norm(params, mesh) if self._norm_split else None
                    clip_by_global_norm([p.grad for p in params], spec.grad_clip, norm=norm)
                set_learning_rate(self.optimizer, lr)
                held = [p.detach().clone() for p in frozen]
                self.optimizer.step()
                with torch.no_grad():
                    for p, h in zip(frozen, held):
                        p.copy_(h)  # after the optimizer: no update, no weight decay
            if draws is None:
                self.step += 1
            return loss, lr

    def _make_optimizer(self, spec: OptSpec):
        """The run's optimizer over this rank's parameters: ZeRO-1 over
        ``data`` (``train.opt_state_sharding``) or the plain one."""
        capturable = self.device.type == "cuda"
        if self.zero1 and self.mesh.size("data") > 1:
            return Zero1Optimizer(spec, self.module.parameters(), self.mesh,
                                  capturable=capturable)
        return build_optimizer(spec, self.module.parameters(), capturable=capturable)

    def reduce_gradients(self, loss: torch.Tensor) -> torch.Tensor:
        """The step's gradients (left in ``.grad`` by :func:`loss_and_grads`)
        and ``loss`` averaged over ``data``, before the clip; under the
        replicated pipeline each stage's layers' gradients then go to the
        other stages (:meth:`~vit_tpu_torch.parallel.pipeline.Pipeline.
        share_grads`), so every rank holds them all. Returns the loss."""
        loss = sync_gradients([p for p in self.module.parameters() if p.grad is not None],
                              self.mesh, loss)
        if self.pp > 1 and not self.pp_resident:
            self.module.vit.encoder.pipeline.share_grads(self.module.vit.encoder)
        return loss

    def _preprocessor_params(self) -> List[torch.nn.Parameter]:
        pre = getattr(self.module, "preprocessor", None)
        return [] if pre is None else list(pre.parameters())

    def _frozen_flag(self, epoch: int) -> float:
        """``warmup.freeze_epochs``: -1 frozen for good; N > 0 frozen for the
        first N epochs; 0 never (``vit_tpu/train/loop.py:1013-1021``)."""
        fe = self.bundle.freeze_epochs
        if not self.bundle.has_preprocessor or fe == 0:
            return 0.0
        if fe == -1:
            return 1.0
        return 1.0 if epoch < fe else 0.0

    def _check_input_length(self, dataset) -> None:
        """The split's spectra must have the model's raw input length (for a
        preprocessor model, not the adjusted ``model.image_size``)."""
        flux = getattr(dataset, "flux", None)
        want = self.module.input_length
        if flux is not None and flux.shape[1] != want:
            raise ValueError(f"spectra of length {flux.shape[1]}, but the model takes {want}"
                             + (" (the preprocessor's input dimension)"
                                if self.bundle.has_preprocessor else ""))

    # -- state -------------------------------------------------------------
    def _state(self) -> Dict[str, Any]:
        """The checkpoint, in the one-rank layout (every rank of the mesh
        takes part; rank 0 writes it)."""
        opt = None
        if self.optimizer is not None:
            opt = (canonical_optimizer_state(self.optimizer, self.module, self.mesh,
                                             self._param_names)
                   if self._split else self.optimizer.state_dict())
        return {
            "state_dict": canonical_state_dict(self.module, self.mesh, self._state_names),
            "optimizer": opt,
            "step": self.step,
            "plateau_scale": self.plateau_scale,
            "plateau": self.plateau.state_dict() if self.plateau is not None else None,
            "early_stop": self.early.state_dict() if self.early is not None else None,
            "dropout_rng": self.dropout_gen.get_state(),
            "noise_rng": self.noise_gen.get_state(),
        }

    def _restore(self, spec: str, training: bool) -> None:
        """Load ``best | last | path``: the weights, and for a resumed fit the
        optimizer, step, plateau scale, generators and scheduler states."""
        self.ckpt.wait()  # an async write must land before it is read back
        if self.mesh.world_group is not None:
            dist.barrier(group=self.mesh.world_group)  # rank 0's write has landed
        state = torch.load(self.ckpt.resolve(spec), map_location="cpu", weights_only=True)
        self.module.load_state_dict(local_state_dict(self.module, state["state_dict"]),
                                    strict=True)
        if not training:
            return
        if self.optimizer is not None and state.get("optimizer") is not None:
            opt = state["optimizer"]
            if self._split:
                opt = local_optimizer_state(opt, self.module, self._param_names)
            if isinstance(self.optimizer, Zero1Optimizer):
                self.optimizer.load_state_dict(opt)
            else:
                load_optimizer_state(self.optimizer, opt)
        self.step = int(state["step"])
        self.plateau_scale = float(state["plateau_scale"])
        self.dropout_gen.set_state(state["dropout_rng"])
        self.noise_gen.set_state(state["noise_rng"])
        if self.plateau is not None and state.get("plateau") is not None:
            self.plateau.load_state_dict(state["plateau"])
        if self.early is not None and state.get("early_stop") is not None:
            self.early.load_state_dict(state["early_stop"])

    # -- evaluation ------------------------------------------------------------
    @torch.no_grad()
    def _run_eval(self, dataset, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """Forward the dataset in fixed-size masked batches; (logits, labels)
        of the real rows."""
        was_training = self.module.training
        self.module.eval()
        cols = {k: v for k, v in dataset.arrays().items() if k in ("x", "label")}
        host = list(Batcher(cols, batch_size, eval_mode=True))
        if self.debug:
            host = host[:1]  # fast-dev-run: one eval batch
        logits_all, labels_all = [], []
        xs = prefetch_to_device([{"x": b["x"]} for b in host], self.device, self.prefetch_depth)
        for hb, db in zip(host, xs):
            logits = self.module(db["x"]).float().cpu().numpy()
            logits_all.append(logits[hb["mask"]])
            labels_all.append(hb["label"][hb["mask"]])
        self.module.train(was_training)
        return np.concatenate(logits_all), np.concatenate(labels_all)

    @torch.no_grad()
    def _moe_dropped_frac(self) -> Optional[float]:
        """The capacity's dropped share of (token, slot) assignments, the
        mean over the MoE layers, on a deterministic forward over up to one
        batch of validation rows (training rows without a validation split);
        None for a dense model."""
        if self.bundle.vit_config.moe_experts <= 1:
            return None
        ds = self.datamodule.val or self.datamodule.train
        if ds is None or len(ds) == 0:
            return None
        n = min(self.batch_size, len(ds))
        x = torch.from_numpy(np.ascontiguousarray(ds.arrays()["x"][:n])).to(self.device)
        was_training = self.module.training
        self.module.eval()
        try:
            _, stats = self.module(x, moe_stats=True)
        finally:
            self.module.train(was_training)
        return float(stats[:, 2].mean())

    def _metrics_from_arrays(self, logits: np.ndarray, labels: np.ndarray,
                             prefix: str) -> Dict[str, float]:
        task = self.bundle.vit_config.task_type
        out = {f"{prefix}_loss": _host_loss(logits, labels, task, self.bundle.loss_name)}
        if task == "cls":
            m = classification_metrics(logits, labels)
        else:
            m = regression_metrics(logits, labels)
            names = parse_param_list((self.config.get("data", {}) or {}).get("param"))
            m.update(regression_extras(logits, labels, names))
        out.update({f"{prefix}_{k}": v for k, v in m.items()})
        return out

    def _eval_metrics(self, dataset, prefix: str, batch_size: int) -> Dict[str, float]:
        return self._metrics_from_arrays(*self._run_eval(dataset, batch_size), prefix)

    def _run_capture_eval(self, dataset, num_samples: int):
        """Eval of the first spectra with diagnostics captured (attention
        probabilities, MLP activations, CLS states): ``(logits, labels,
        diag)`` on the host. The reduction runs on the device; the batch is
        capped by token count (``viz.capture_memory_mb``, default 512) so
        stride-1 (~4k token) configs fit."""
        vc = self.bundle.vit_config
        viz_cfg = self.config.get("viz", {}) or {}
        budget = int(float(viz_cfg.get("capture_memory_mb", 512)) * 1024**2)
        cap = capture_batch_cap(vc.seq_len, vc.num_attention_heads, vc.intermediate_size,
                                budget)
        n = min(num_samples, len(dataset), cap)
        if n < min(num_samples, len(dataset)):
            print(f"[viz] capture batch capped at {n} by token count "
                  f"(T={vc.seq_len}, budget={budget // 1024**2} MB)")
        # Only x goes to the device; labels stay on the host.
        arrays = dataset.arrays()
        labels = arrays.get("label")
        labels_host = np.asarray(labels[:n]) if labels is not None else None
        x = torch.from_numpy(np.ascontiguousarray(arrays["x"][:n])).to(self.device)
        logits, diag = capture_diagnostics(self.module, x,
                                           float(viz_cfg.get("sample_rate", 0.15)))
        return logits, labels_host, diag

    def _capture_into(self, viz, cka, label: int, dataset, num_samples: int):
        """One capture fed to the GIF frames and the CKA monitor; the CKA
        metrics (empty without a monitor)."""
        logits, labels, diag = self._run_capture_eval(dataset, num_samples)
        viz.on_validation_epoch(label, logits, labels, diag)
        return cka.on_validation_epoch(label, diag) if cka is not None else {}

    # -- fit ---------------------------------------------------------------
    def fit(self) -> Dict[str, float]:
        """Train for ``train.ep`` epochs. The preemption guard lives as long
        as this call: the first SIGTERM stops the run at the end of its
        epoch, after its checkpoint."""
        if not self.mesh.member:
            return {}
        enabled = bool((self.config.get("train", {}) or {}).get("handle_preemption", True))
        self._preempt = PreemptionGuard(enabled=enabled).install()
        try:
            with active_mesh_scope(self.mesh):
                return self._fit_impl()
        finally:
            self._preempt.uninstall()

    def _fit_impl(self) -> Dict[str, float]:
        self.datamodule.setup("fit")
        train_ds = self.datamodule.train
        self._check_input_length(train_ds)
        steps_per_epoch = max(1, -(-len(train_ds) // self.batch_size))
        has_val = self.datamodule.val is not None and len(self.datamodule.val) > 0
        # The plateau scheduler needs an explicit data.val_path (reference parity).
        explicit_val = bool((self.config.get("data", {}) or {}).get("val_path"))
        spec = OptSpec.from_config(self.config, steps_per_epoch, monitor_metric=self.monitor,
                                   has_val=explicit_val)
        schedule = schedule_scale(spec)
        if self.optimizer is None:
            self.optimizer = self._make_optimizer(spec)
        self.plateau = (PlateauScheduler(spec.plateau_factor, spec.plateau_patience,
                                         mode=spec.plateau_mode or self.monitor_mode)
                        if spec.scheduler == "plateau" else None)
        train_cfg = self.config.get("train", {}) or {}
        self.early = EarlyStopping(
            patience=100 if self.sweep else 500, mode=self.monitor_mode,
            divergence_threshold=train_cfg.get("divergence_threshold"))
        # Achieved TFLOP/s: analytic matmul FLOPs a step over the epoch's
        # wall clock, host dispatch included; mfu against peak_tflops.
        flops_per_step = peak_tflops = None
        if train_cfg.get("log_mfu"):
            flops_per_step = step_matmul_flops(self.bundle.vit_config, self.batch_size,
                                               train=True)
            peak_tflops = train_cfg.get("peak_tflops")

        start_epoch = 0
        if self.ckpt_path:
            self.ckpt.load_best_from_meta()
            self._restore(self.ckpt_path, training=True)
            start_epoch = self.step // steps_per_epoch
            print(f"[experiment] resumed from {self.ckpt_path} at epoch {start_epoch}")

        n_params = count_params(self.module)
        self.logger.log({"num_params(M)": n_params / 1e6}, step=0)
        print(f"[experiment] {self.bundle.model_name}: {n_params / 1e6:.3f}M params, "
              f"{steps_per_epoch} steps/epoch, device={self.device}")

        need = ("x", "error", "label") if self.noise_level > 0 else ("x", "label")
        train_cols = {k: v for k, v in train_ds.arrays().items() if k in need}
        batcher = Batcher(train_cols, self.batch_size, shuffle=not self.debug, seed=self.seed)
        max_epochs = 1 if self.debug else self.max_epochs
        monitor_key = f"val_{self.monitor}"
        ckpt_extra: Dict[str, Any] = {}
        if isinstance(train_ds, RegSpecDataset):
            ckpt_extra = {"label_norm": train_ds.label_norm,
                          "label_norm_stats": {k: (None if v is None else np.asarray(v).tolist())
                                               for k, v in train_ds.norm_stats().items()}}
        # Every rank runs the captures (a split model's forward is
        # collective); rank 0 writes what they make.
        viz, cka, viz_every, viz_every_steps = create_viz_callbacks(
            self.config.get("viz"), save_enabled=self.save and self.is_main,
            model_name=self.bundle.model_name,
            param_names=parse_param_list((self.config.get("data", {}) or {}).get("param")),
            denormalize=train_ds.denormalize if isinstance(train_ds, RegSpecDataset) else None,
            label_bounds=_dataset_label_bounds(train_ds))
        num_viz_samples = int((self.config.get("viz", {}) or {}).get("num_viz_samples", 256))

        fused, fused_val, epd = self._select_fused(spec, schedule, train_cols, steps_per_epoch,
                                                   has_val)
        self.fused = fused
        use_blocks = fused is not None and epd > 1
        val_labels = np.asarray(self.datamodule.val.arrays()["label"]) if fused_val else None
        if viz is not None and viz_every_steps > 0 and fused is not None:
            # A fused epoch runs its steps without the host: honour the step
            # frequency at the nearest epoch boundary (vit_tpu, :1456-1460).
            viz_every = max(1, round(viz_every_steps / steps_per_epoch))
            viz_every_steps = 0
            print(f"[viz] fused-epoch mode: log_every_n_steps -> every {viz_every} epoch(s)")

        epoch_metrics: Dict[str, float] = {}
        block_results: Dict[int, tuple] = {}
        profiled = stop_pending = False
        self.module.train()
        for epoch in range(start_epoch, max_epochs):
            batcher.set_epoch(epoch)
            self.frozen = self._frozen_flag(epoch)
            # Trace the first epoch after the start that trains (steady
            # state), or the start epoch when it is the run's only one; a
            # block's later epochs run no steps.
            dispatched = epd if (use_blocks and epoch + epd <= max_epochs) else 1
            prof = None
            if (self.profile_dir is not None and self.is_main and not profiled
                    and epoch not in block_results
                    and (epoch > start_epoch or epoch + dispatched >= max_epochs)):
                prof = self._start_profile()
            t0 = time.perf_counter()
            fused_logits, block_final, block_dt = None, True, None
            if use_blocks and epoch not in block_results:
                block = list(range(epoch, min(epoch + epd, max_epochs)))
                if len(block) == epd:  # a shorter tail runs one epoch at a time
                    out = fused.run(block, [self._frozen_flag(e) for e in block], fused_val)
                    for e, (ls, lr_e, vl, share) in zip(block, out):
                        block_results[e] = (ls, lr_e, vl, e == block[-1], share)
                    self.frozen = self._frozen_flag(epoch)
            if epoch in block_results:
                losses, last_lr, fused_logits, block_final, block_dt = block_results.pop(epoch)
            elif fused is not None:
                # The epoch's time is its steps', through the read of its losses.
                (losses, last_lr, fused_logits, block_dt), = fused.run([epoch], [self.frozen],
                                                                       fused_val)
            else:
                losses, last_lr = self._per_step_epoch(
                    batcher, spec, schedule, epoch * steps_per_epoch, viz, cka,
                    viz_every_steps if has_val else 0, num_viz_samples)
            with span("vtt.train.epoch_end"):
                # The per-step path's losses are still on the device: its
                # epoch ends at their read-back.
                if torch.is_tensor(losses):
                    losses = losses.float().cpu().numpy()
                self.epoch_losses = np.asarray(losses, np.float32)  # per step
                train_loss = float(np.mean(self.epoch_losses))
                dt = block_dt if block_dt is not None else time.perf_counter() - t0
                n_steps = len(self.epoch_losses)
                epoch_metrics = {"train_loss": train_loss, "lr": float(last_lr),
                                 "epoch_time_s": dt,
                                 "samples_per_s": n_steps * self.batch_size / max(dt, 1e-9)}
                if flops_per_step is not None:
                    tflops = n_steps * flops_per_step / max(dt, 1e-9) / 1e12
                    epoch_metrics["tflops_per_s"] = tflops
                    if peak_tflops:
                        epoch_metrics["mfu"] = tflops / float(peak_tflops)  # one device
                if self.bundle.has_preprocessor:
                    epoch_metrics["preprocessor_frozen"] = float(self.frozen)
                dropped = self._moe_dropped_frac()
                if dropped is not None:
                    epoch_metrics["moe_dropped_frac"] = dropped
            val = None
            if has_val:
                with span("vtt.train.validate"):
                    if fused_logits is not None:
                        val = self._metrics_from_arrays(fused_logits, val_labels, "val")
                    else:
                        val = self._eval_metrics(self.datamodule.val, "val",
                                                 self.datamodule.val_batch_size)
            with span("vtt.train.epoch_end"):
                mon, stop = None, False
                if val is not None:
                    epoch_metrics.update(val)
                    mon = val.get(monitor_key)
                    if self.plateau is not None:
                        self.plateau_scale = self.plateau.step(mon)
                    if viz is not None and viz_every_steps == 0 and epoch % viz_every == 0:
                        try:
                            epoch_metrics.update(self._capture_into(
                                viz, cka, epoch, self.datamodule.val, num_viz_samples))
                        except Exception as e:  # diagnostics never fail training
                            print(f"[viz] epoch diagnostics skipped: {e}")
                    stop = self.early.step(mon)
                    if stop and not block_final and not stop_pending:
                        # The device already trained through the block's last
                        # epoch: log the rest of the block (no device work), and
                        # checkpoint and stop at its end, on the state held.
                        stop_pending = True
                        print(f"[experiment] early stopping triggered at epoch {epoch}; "
                              "flushing to the block boundary")
                if block_final:  # a block's inner states are never on the host
                    extra = dict(ckpt_extra, early_stop_state=self.early.state_dict())
                    if self.plateau is not None:
                        extra["plateau_state"] = self.plateau.state_dict()
                    self.ckpt.on_epoch_end(self._state(), epoch, mon, config=self.config,
                                           extra=extra)
            if prof is not None:  # the epoch's validation and end are in its trace
                self._stop_profile(prof, epoch, includes_warmup=epoch == start_epoch)
                profiled = True
            self.logger.log_epoch(epoch, epoch_metrics, step=(epoch + 1) * steps_per_epoch)
            if (stop or stop_pending) and block_final:
                print(f"[experiment] early stopping at epoch {epoch}")
                break
            if self._all_ranks_any(self._preempt.triggered) and block_final:
                hint = ("resume with --ckpt last" if self.save
                        else "train.save is off: nothing was persisted")
                print(f"[experiment] preemption stop at epoch {epoch} ({hint})")
                break

        if viz is not None:
            try:
                viz.on_train_end(self.logger)
                if cka is not None:
                    cka.on_train_end(viz.save_dir if viz.save_enabled else None, self.logger)
            except Exception as e:
                print(f"[viz] train-end artifacts skipped: {e}")
        self.ckpt.wait()  # async writes land before the artifacts and run()'s test read them
        if self.save:  # W&B model artifacts at train end
            meta = {"monitor": monitor_key, "best_value": self.ckpt.best_value,
                    "best_epoch": self.ckpt.best_epoch}
            self.logger.log_checkpoint(self.ckpt.best_path, "best", metadata=meta)
            self.logger.log_checkpoint(self.ckpt.last_path, "last", metadata=meta)
        self.callback_metrics = dict(epoch_metrics)
        return epoch_metrics

    def _per_step_epoch(self, batcher, spec, schedule, first_step: int, viz, cka,
                        viz_every_steps: int, num_viz_samples: int) -> Tuple[torch.Tensor, float]:
        """One epoch of per-step training over ``batcher``'s batches copied
        ahead to the device, with diagnostics every ``viz_every_steps``
        steps (0: none); (the step losses, on the device, the last learning
        rate)."""
        losses, last_lr = [], spec.lr
        for i, batch in enumerate(prefetch_to_device(batcher, self.device, self.prefetch_depth)):
            loss, last_lr = self.train_step(batch, spec, schedule)
            losses.append(loss)
            gstep = first_step + i + 1
            if viz is not None and viz_every_steps > 0 and gstep % viz_every_steps == 0:
                try:
                    self.logger.log(self._capture_into(viz, cka, gstep, self.datamodule.val,
                                                       num_viz_samples), step=gstep)
                except Exception as e:  # diagnostics never fail training
                    print(f"[viz] step diagnostics skipped: {e}")
            if self.debug and i == 0:
                break
        return torch.stack(losses), last_lr

    def _select_fused(self, spec, schedule, train_cols: Dict[str, np.ndarray],
                      steps_per_epoch: int, has_val: bool):
        """``train.fused_epoch`` / ``epoch_gather`` / ``epochs_per_dispatch``
        as ``vit_tpu`` decides them (``loop.py:1262-1360``), with its notes:
        (the :class:`FusedEpochs` or None, fused validation, epochs a block)."""
        train_cfg = self.config.get("train", {}) or {}
        fused_cfg = fused_epoch_setting(train_cfg.get("fused_epoch", "auto"))
        data_bytes = sum(v.nbytes for v in train_cols.values())
        # A CUDA graph captures NCCL's collectives, not gloo's host-staged
        # ones, and the pipeline's schedule runs per step.
        mesh = self.mesh
        per_step = None
        if self.pp > 1:
            per_step = "the pipeline schedule runs per step (train.pipeline_parallel)"
        elif mesh.world_size > 1 and mesh.backend != "nccl" and self.device.type == "cuda":
            per_step = f"the {mesh.backend} process group's collectives stage through the host"
        if per_step is not None and fused_cfg in (True, "auto") and not self.debug:
            if fused_cfg is True:
                raise ValueError(f"train.fused_epoch=true cannot run here: {per_step}")
            print(f"[experiment] train.fused_epoch=auto: per-step path ({per_step})")
            fused_cfg = False
        use = fused_cfg in (True, "auto") and not self.debug and data_bytes < FUSED_DATA_BYTES
        if fused_cfg is True and not use:
            why = "debug mode" if self.debug else (
                f"epoch data {data_bytes / 1e9:.1f} GB exceeds the 4 GB HBM gate")
            print(f"[experiment] train.fused_epoch=true ignored: {why}")
        epd = int(train_cfg.get("epochs_per_dispatch", 1) or 1)
        if not use:
            if epd > 1:
                print(f"[experiment] train.epochs_per_dispatch={epd} ignored: "
                      "requires the fused-epoch path (train.fused_epoch)")
            return None, False, 1
        val = self.datamodule.val
        fused_val = has_val and val.arrays()["x"].nbytes < FUSED_VAL_BYTES
        gather = str(train_cfg.get("epoch_gather", "step") or "step").lower()
        fused = FusedEpochs(self, spec, schedule, train_cols, steps_per_epoch, gather,
                            val.arrays()["x"] if fused_val else None,
                            self.datamodule.val_batch_size)
        viz_on = bool((self.config.get("viz", {}) or {}).get("enable", False))
        if epd > 1 and (viz_on or (has_val and not fused_val)):
            why = ("viz.enable requires per-epoch states" if viz_on
                   else "fused validation unavailable (val split > 512 MB)")
            print(f"[experiment] train.epochs_per_dispatch={epd} ignored: {why}; "
                  "running one dispatch per epoch")
            epd = 1
        return fused, fused_val, epd

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, epoch: int, includes_warmup: bool) -> str:
        """Stop the trace and write it as a Chrome trace; its path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"{self.bundle.model_name}_epoch{epoch}.json")
        prof.export_chrome_trace(path)
        note = " (includes warm-up)" if includes_warmup else ""
        print(f"[experiment] profiler trace written to {path}{note}")
        return path

    # -- test ----------------------------------------------------------------
    def test(self, ckpt: Optional[str] = None) -> Dict[str, float]:
        """Metrics on the test split, of ``ckpt`` (``best | last | path``) if
        given, and the regression report when ``viz.enable``."""
        if not self.mesh.member:
            return {}
        self.datamodule.setup("test")
        self._check_input_length(self.datamodule.test)
        with active_mesh_scope(self.mesh):
            return self._test_impl(ckpt)

    def _test_impl(self, ckpt: Optional[str]) -> Dict[str, float]:
        if ckpt:
            self._restore(ckpt, training=False)
        metrics = self._eval_metrics(self.datamodule.test, "test", self.batch_size)
        self.logger.log_epoch(-1, metrics)
        self.callback_metrics.update(metrics)
        try:
            self._test_report()
        except Exception as e:  # plots must never fail the eval entry point
            print(f"[experiment] test report skipped: {e}")
        return metrics

    def _test_report(self) -> None:
        """The denormalised prediction report of the test split."""
        ds = self.datamodule.test
        if self.bundle.vit_config.task_type != "reg" or not isinstance(ds, RegSpecDataset):
            return
        if not (self.config.get("viz", {}) or {}).get("enable", False):
            return
        from vit_tpu_torch.viz.plotter import RegressionPlotter

        logits, labels = self._run_eval(ds, self.batch_size)  # on every rank: collective
        if not self.is_main:
            return
        quick = bool((self.config.get("plotting", {}) or {}).get("quick_mode", False))
        plotter = RegressionPlotter(
            param_names=parse_param_list((self.config.get("data", {}) or {}).get("param")),
            denormalize=ds.denormalize, model_name=self.bundle.model_name,
            quick_mode=quick, label_bounds=_dataset_label_bounds(ds))
        plotter.generate_all_plots(logits, labels, logger=self.logger)

    def run(self) -> Dict[str, float]:
        """``fit`` then ``test`` of the best checkpoint when one was saved."""
        self.fit()
        ckpt = "best" if (self.save and self.ckpt.best_epoch is not None) else None
        metrics = self.test(ckpt=ckpt)
        self.logger.finish()
        return metrics
