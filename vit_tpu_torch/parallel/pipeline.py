"""GPipe pipeline parallelism over the ``pipe`` mesh axis (port of
``vit_tpu/parallel/pipeline.py``).

The encoder's ``L`` layers are split into ``P`` contiguous stages (layer
``i`` on stage ``i // (L/P)``); the batch goes through them as ``M``
microbatches in the GPipe schedule of ``M + P - 1`` ticks: at tick ``t``
stage ``p`` runs microbatch ``t - p`` (a bubble when that is outside
``[0, M)``) and sends its output to stage ``p + 1``. The last stage's
outputs are broadcast to every stage, so the final LayerNorm and the head
run on every stage, as in ``vit_tpu`` (its ``psum`` over ``pipe``). The
backward is the mirrored schedule: each stage receives the gradient of its
outputs from the next stage, microbatch by microbatch in reverse, runs its
layers' backward and sends the gradient of its inputs back; stage 0's
input gradients are broadcast so the embeddings' gradients agree on every
stage. Point to point goes through :func:`~vit_tpu_torch.parallel.comm.
exchange` (``vit_tpu``: ``ppermute`` inside one ``shard_map``).

Memory is stage-resident by default, as ``vit_tpu``'s
(``train.pipeline_stage_params``): :func:`attach_pipeline` removes the
other stages' layers from this rank's model, so a rank holds (and its
optimizer steps) only its stage's encoder parameters, under their
canonical names (``vit.encoder.layer.{i}....``). Checkpoints store the
canonical per-layer layout (the stages' layers gathered,
:meth:`~vit_tpu_torch.train.loop.Experiment` ``_state``).
:func:`stack_stage_params` and the other layout helpers convert between
that layout and ``vit_tpu``'s stacked ``(P, L/P, ...)`` one.

``train.pipeline_stage_params: false`` is ``vit_tpu``'s replicated layout
(``attach_pipeline(..., resident=False)``): every rank keeps every layer
and steps them all, as GSPMD's replicated parameters do, so it composes
with ZeRO-1. The schedule still runs this stage's layers only; after the
backward :meth:`Pipeline.share_grads` gives each stage's layers'
gradients, which only that stage's ranks hold, to the other stages (one
bucket a stage, broadcast by its owner). The global norm counts each
layer at its owner (``_pipe_owner``). Evaluation (``module.eval()``) runs
the monolithic forward, as ``vit_tpu``'s eval step does under this layout,
and checkpoints need no gather.

Dropout: each microbatch runs at the :func:`~vit_tpu_torch.ops.dropout.
batch_offset` of its first global row, so every site draws the masks the
one-stage forward draws over the whole batch. ``vit_tpu`` draws its own
per-(stage, layer, tick) streams under the pipeline instead; the two agree
in distribution, not in bits. Deterministic forwards match the monolithic
model to float tolerance.

MoE: each stage returns its layers' router statistics as the mean over the
microbatches (bubble ticks run nothing, so none is counted), gathered over
``pipe`` into the ``(L, 3)`` the monolithic forward returns; the
load-balance loss and the dropped share are means over rows, so the
microbatch mean is the whole batch's value.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from vit_tpu_torch.ops.dropout import batch_offset, current_batch_offset
from vit_tpu_torch.parallel import comm
from vit_tpu_torch.parallel.mesh import Mesh, Sharding

__all__ = [
    "stack_stage_params",
    "unstack_stage_params",
    "stage_resident_params",
    "canonical_params",
    "resident_param_shardings",
    "convert_params_shaped",
    "stage_layers",
    "attach_pipeline",
    "pipeline_encoder",
    "apply_pipelined",
    "Pipeline",
]

_ENC = "vit.encoder."
_MOE_EXPERT_LEAVES = ("wi", "wi_bias", "wo", "wo_bias")


def _layer_count(encoder_params: Mapping[str, torch.Tensor]) -> int:
    idx = {int(k.split(".")[1]) for k in encoder_params if k.startswith("layer.")}
    missing = [f"layer.{i}" for i in range(len(idx)) if i not in idx]
    if missing:
        raise ValueError(f"encoder params missing {missing}")
    return len(idx)


def stack_stage_params(encoder_params: Mapping[str, torch.Tensor],
                       num_stages: int) -> Dict[str, torch.Tensor]:
    """``{layer.{i}.<name>}`` -> ``{<name>: (P, L/P, ...)}``: layer ``i`` at
    stage ``i // (L/P)``, slot ``i % (L/P)``."""
    num_layers = _layer_count(encoder_params)
    if num_stages < 1 or num_layers % num_stages != 0:
        raise ValueError(
            f"num_hidden_layers={num_layers} must be divisible by the "
            f"pipeline degree {num_stages}"
        )
    per_stage = num_layers // num_stages
    names = [k.split(".", 2)[2] for k in encoder_params if k.startswith("layer.0.")]
    return {n: torch.stack([encoder_params[f"layer.{i}.{n}"] for i in range(num_layers)])
            .reshape((num_stages, per_stage) + tuple(encoder_params[f"layer.0.{n}"].shape))
            for n in names}


def unstack_stage_params(stacked: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_stage_params` (per-layer names)."""
    if not stacked:
        raise ValueError("empty stage params")
    num_stages, per_stage = next(iter(stacked.values())).shape[:2]
    flat = {n: t.reshape((num_stages * per_stage,) + tuple(t.shape[2:]))
            for n, t in stacked.items()}
    return {f"layer.{i}.{n}": t[i] for i in range(num_stages * per_stage)
            for n, t in flat.items()}


def stage_resident_params(params: Mapping[str, torch.Tensor],
                          num_stages: int) -> Dict[str, torch.Tensor]:
    """A whole ``state_dict`` in ``vit_tpu``'s stage-resident layout: the
    encoder's layers stacked, ``vit.encoder.<name>`` of ``(P, L/P, ...)``;
    everything else as it is."""
    out = {k: v for k, v in params.items() if not k.startswith(_ENC)}
    enc = {k[len(_ENC):]: v for k, v in params.items() if k.startswith(_ENC)}
    out.update({_ENC + n: t for n, t in stack_stage_params(enc, num_stages).items()})
    return out


def canonical_params(resident: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stage_resident_params` (per-layer encoder names)."""
    out = {k: v for k, v in resident.items() if not k.startswith(_ENC)}
    stacked = {k[len(_ENC):]: v for k, v in resident.items() if k.startswith(_ENC)}
    out.update({_ENC + n: t for n, t in unstack_stage_params(stacked).items()})
    return out


def resident_param_shardings(resident: Mapping[str, torch.Tensor], mesh: Mesh,
                             axis: str = "pipe",
                             tp_axis: Optional[str] = None) -> Dict[str, Sharding]:
    """The stacked encoder leaves' stage dim over ``axis`` (1/P a rank), the
    rest whole; with ``tp_axis``, an encoder ``Linear`` weight also splits
    its output features (dim 2 of (P, L/P, out, *in)) and an MoE expert leaf
    its expert dim (dim 2) over it where they divide
    (``vit_tpu``'s rule, shifted by the two stacked dims)."""
    tp = mesh.size(tp_axis) if tp_axis else 1
    out = {}
    for name, t in resident.items():
        if not name.startswith(_ENC):
            out[name] = Sharding(mesh, ())
            continue
        spec = [axis] + [None] * (t.dim() - 1)
        leaf = name.rsplit(".", 1)[-1]
        if tp > 1 and ".moe." in name and leaf in _MOE_EXPERT_LEAVES:
            if t.dim() >= 3 and t.shape[2] % tp == 0:
                spec[2] = tp_axis
        elif (tp > 1 and leaf == "weight" and t.dim() >= 4 and t.shape[2] % tp == 0
              and t.shape[2] >= 2 * tp):
            spec[2] = tp_axis
        out[name] = Sharding(mesh, tuple(spec))
    return out


def convert_params_shaped(tree, param_names: Sequence[str], convert_fn: Callable):
    """``convert_fn`` applied to every dict of ``tree`` (nested dicts, lists
    and tuples) whose keys are exactly ``param_names``; other leaves pass
    through: optimizer moments keyed by parameter name convert between the
    layouts, step counts do not."""
    keys = set(param_names)

    def walk(x):
        if isinstance(x, Mapping):
            return convert_fn(x) if set(x) == keys else {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    return walk(tree)


def stage_layers(num_layers: int, num_stages: int, stage: int) -> range:
    """The global layer indices stage ``stage`` holds."""
    if num_stages < 1 or num_layers % num_stages != 0:
        raise ValueError(f"num_hidden_layers={num_layers} must be divisible by the "
                         f"pipeline degree {num_stages}")
    per = num_layers // num_stages
    return range(stage * per, (stage + 1) * per)


class _Elsewhere(nn.Module):
    """The place of a layer another stage holds."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this layer lives on another pipeline stage")


def _stage_body(encoder, h: torch.Tensor, seeds, indices):
    """This stage's layers on one microbatch: (h, their MoE stats (n, 3) or
    None)."""
    h, stats = encoder.run_layers(h, seeds, indices)
    return h, (torch.stack(stats) if stats else None)


class _Schedule:
    """One run of the GPipe schedule on this stage; keeps each microbatch's
    graph between the forward and the backward."""

    def __init__(self, stage_fn, mesh: Mesh, axis: str, m: int, aux_rows: int,
                 stats: Optional[dict]) -> None:
        self.stage_fn, self.m, self.aux_rows, self.stats = stage_fn, m, aux_rows, stats
        self.group, self.ranks = mesh.group(axis), mesh.group_ranks(axis)
        self.p, self.n = mesh.coord(axis), mesh.size(axis)
        self.saved = []

    def _recv(self, like: torch.Tensor, src_stage: int) -> torch.Tensor:
        buf = torch.empty_like(like)
        comm.exchange([], [(buf, self.ranks[src_stage])], self.group)
        return buf

    def _send(self, x: torch.Tensor, dst_stage: int) -> None:
        comm.exchange([(x, self.ranks[dst_stage])], [], self.group)

    def _clock(self, device):
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @staticmethod
    def _ms(a, b) -> float:
        return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) * 1e3

    def forward(self, tokens: torch.Tensor, grad: bool):
        p, n, m = self.p, self.n, self.m
        b = tokens.shape[0]
        mb = b // m
        base = current_batch_offset()
        x_mb = tokens.detach().chunk(m)
        outs = [None] * m
        aux_sum = None
        busy = []
        t_start = self._clock(tokens.device)
        for tick in range(m + n - 1):
            j = tick - p
            if not 0 <= j < m:
                continue  # a bubble: nothing to run
            h_in = x_mb[j] if p == 0 else self._recv(x_mb[j], p - 1)
            if grad:
                h_in = h_in.detach().requires_grad_(True)
            t0 = self._clock(tokens.device)
            with torch.set_grad_enabled(grad), batch_offset(base + j * mb):
                h_out, aux = self.stage_fn(h_in)
            busy.append((t0, self._clock(tokens.device)))
            if p < n - 1:
                self._send(h_out.detach(), p + 1)
            else:
                outs[j] = h_out.detach()
            if grad:
                self.saved.append((h_in, h_out, aux))
            if aux is not None:
                aux_sum = aux.detach() if aux_sum is None else aux_sum + aux.detach()
        out = torch.cat(outs) if p == n - 1 else torch.empty_like(tokens)
        comm.broadcast(out, self.ranks[n - 1], self.group)
        aux_all = None
        if self.aux_rows:
            aux_all = comm.all_gather((aux_sum / m).contiguous(), self.group, 0)
        if self.stats is not None:
            t_end = self._clock(tokens.device)
            if tokens.device.type == "cuda":
                torch.cuda.synchronize(tokens.device)
            total = self._ms(t_start, t_end)
            work = sum(self._ms(a, c) for a, c in busy)
            self.stats.setdefault("forward", []).append(
                {"stage": p, "busy_ms": work, "schedule_ms": total,
                 "busy_share": work / total if total > 0 else 0.0,
                 "bubble_share_ideal": (n - 1) / (m + n - 1)})
        return out, aux_all

    def backward(self, g_out: torch.Tensor, g_aux: Optional[torch.Tensor]) -> torch.Tensor:
        p, n, m = self.p, self.n, self.m
        g_mb = g_out.contiguous().chunk(m)
        g_aux_here = None
        if g_aux is not None:
            g_aux_here = g_aux.chunk(n)[p] / m
        d_in = [None] * m
        for j in reversed(range(m)):
            h_in, h_out, aux = self.saved[j]
            g = g_mb[j] if p == n - 1 else self._recv(g_mb[j], p + 1)
            outs, grads = [h_out], [g]
            if aux is not None and g_aux_here is not None:
                outs.append(aux)
                grads.append(g_aux_here)
            torch.autograd.backward(outs, grads)
            if p > 0:
                self._send(h_in.grad, p - 1)
            else:
                d_in[j] = h_in.grad
        self.saved = []
        d = torch.cat(d_in) if p == 0 else torch.empty_like(g_out)
        comm.broadcast(d, self.ranks[0], self.group)
        return d


class _Pipelined(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, schedule):
        ctx.schedule = schedule
        out, aux = schedule.forward(tokens, grad=True)
        return (out, aux) if aux is not None else (out, tokens.new_zeros(0))

    @staticmethod
    def backward(ctx, g_out, g_aux):
        g_aux = g_aux if g_aux is not None and g_aux.numel() else None
        return ctx.schedule.backward(g_out, g_aux), None


def pipeline_encoder(stage_fn: Callable, tokens: torch.Tensor, *, mesh: Mesh,
                     axis: str = "pipe", num_microbatches: int, aux_rows: int = 0,
                     stats: Optional[dict] = None):
    """The encoder forward pipelined over ``mesh``'s ``axis``, differentiable.

    ``stage_fn(h)``: this stage's layers on one microbatch, ``(h, aux)``
    with ``aux`` its layers' (n, 3) MoE stats or None. ``tokens``: the
    embedded (B, T, D) batch, on every stage, ``B % num_microbatches ==
    0``. Returns (B, T, D) on every stage and, with ``aux_rows`` (the
    model's MoE layers), their (aux_rows, 3) stats: ``(out, aux)``.
    ``stats``: a dict that receives each forward's busy and schedule times
    of this stage."""
    m = int(num_microbatches)
    if m < 1 or tokens.shape[0] % m != 0:
        raise ValueError(f"batch {tokens.shape[0]} must be divisible by num_microbatches={m}")
    schedule = _Schedule(stage_fn, mesh, axis, m, aux_rows, stats)
    if torch.is_grad_enabled() and tokens.requires_grad:
        out, aux = _Pipelined.apply(tokens, schedule)
        aux = aux if aux_rows else None
    else:
        out, aux = schedule.forward(tokens, grad=False)
    return (out, aux) if aux_rows else out


class Pipeline:
    """The encoder's pipeline on this rank: stage ``stage`` of ``mesh``'s
    ``axis``, running layers ``layers``, ``num_microbatches`` a training
    batch (an evaluation batch that does not divide takes one).
    ``resident``: this rank holds its stage's layers only (else all)."""

    def __init__(self, mesh: Mesh, num_microbatches: int, num_layers: int,
                 axis: str = "pipe", resident: bool = True) -> None:
        self.mesh, self.axis, self.m = mesh, axis, int(num_microbatches)
        self.resident = resident
        self.stage = mesh.coord(axis)
        self.layers = stage_layers(num_layers, mesh.size(axis), self.stage)
        self.stats: Optional[dict] = None  # set to a dict to record the schedule's times

    @torch.no_grad()
    def share_grads(self, encoder) -> None:
        """The replicated layout's gradient exchange: each stage's layers'
        gradients go from that stage's rank on this rank's ``axis`` line to
        the others, one flat bucket a stage
        (:func:`~vit_tpu_torch.parallel.comm.broadcast_bucket`), so every
        rank holds the whole gradient."""
        n = self.mesh.size(self.axis)
        group, ranks = self.mesh.group(self.axis), self.mesh.group_ranks(self.axis)
        for stage in range(n):
            params = [p for i in stage_layers(len(encoder.layer), n, stage)
                      for p in encoder.layer[i].parameters()]
            for p in params:
                if p.grad is None:  # another stage's layer: the broadcast fills it
                    p.grad = (torch.empty_like if stage != self.stage else torch.zeros_like)(p)
            comm.broadcast_bucket([p.grad for p in params], ranks[stage], group)

    def run(self, encoder, x: torch.Tensor, seeds):
        m = self.m if x.shape[0] % self.m == 0 else 1
        res = pipeline_encoder(lambda h: _stage_body(encoder, h, seeds, self.layers), x,
                               mesh=self.mesh, axis=self.axis, num_microbatches=m,
                               aux_rows=len(encoder.layer) if encoder.has_moe else 0,
                               stats=self.stats)
        return res if encoder.has_moe else (res, None)


def attach_pipeline(module, mesh: Mesh, num_microbatches: int, axis: str = "pipe",
                    resident: bool = True) -> Pipeline:
    """Make ``module`` (a :class:`~vit_tpu_torch.models.vit.SpecViT`) this
    rank's stage: its encoder runs the schedule. Stage-resident
    (``resident``), the other stages' layers leave it and its own encoder
    parameters are marked as owned over ``axis``; replicated, every layer
    stays and each layer's parameters name their stage (``_pipe_owner``).
    Both marks serve the gradient norm. Returns the :class:`Pipeline`."""
    encoder = module.vit.encoder
    pipe = Pipeline(mesh, num_microbatches, len(encoder.layer), axis, resident)
    n = mesh.size(axis)
    for i in range(len(encoder.layer)):
        if not resident:
            for p in encoder.layer[i].parameters():
                p._pipe_owner = i // (len(encoder.layer) // n)
        elif i in pipe.layers:
            for p in encoder.layer[i].parameters():
                p._split_axes = tuple(getattr(p, "_split_axes", ())) + (axis,)
        else:
            encoder.layer[i] = _Elsewhere()
    encoder.pipeline = pipe
    return pipe


def apply_pipelined(module, x: torch.Tensor, *, mesh: Mesh, num_microbatches: int,
                    axis: str = "pipe", dropout_seeds=None):
    """The whole model's forward with the encoder pipelined over ``axis``:
    ``module`` (a :class:`~vit_tpu_torch.models.vit.SpecViT`) becomes this
    rank's stage if it is not one yet. Returns the logits, and for an MoE
    model ``(logits, stats)`` (``vit_tpu``'s ``(logits, aux)``)."""
    if module.vit.encoder.pipeline is None:
        attach_pipeline(module, mesh, num_microbatches, axis)
    moe = module.cfg.moe_experts > 1
    return module(x, dropout_seeds=dropout_seeds, moe_stats=moe)

