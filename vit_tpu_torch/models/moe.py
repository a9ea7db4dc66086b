"""Mixture-of-Experts MLP (port of ``vit_tpu/models/moe.py``).

``model.moe_experts: E`` (> 1) replaces each encoder layer's dense MLP
with ``E`` expert MLPs behind a learned top-k router, in ``vit_tpu``'s
grouped dense-dispatch form (GShard/Switch): static shapes, one-hot
dispatch and combine tensors, four products. Every step of ``vit_tpu``
is kept, in its order and dtypes:

* Router: the input in fp32, times uniform jitter in ``[1-j, 1+j)`` in
  training only (``model.moe_router_jitter``); a ``Linear`` named
  ``router`` computing in fp32; softmax; the top ``k`` experts a token
  (ties to the lower index, as ``lax.top_k``). Gates are renormalised over
  the k chosen (floor 1e-9) for k >= 2 only: with k = 1 the raw top-1
  probability is the gate, the router's one task gradient (Switch).
* Capacity ``C = moe_capacity(T, E, k, cf)`` a row and expert; queue
  positions in GShard's priority (every first choice before any second
  choice, earlier tokens first) from an fp32 cumsum, exact at these
  counts; a slot past ``C`` is dropped (its k-slot contributes zero).
* Dispatch and combine ``(B, T, E, C)``; the experts' products ``(E, B,
  C, ·)`` in ``cfg.dtype`` with GELU between (``gelu_approximate``
  honoured): the four einsums ``vit_tpu`` leaves to XLA, outside any
  Pallas kernel, are ``torch.einsum`` here.

The one-hots are comparisons against an ``arange``, not ``F.one_hot``
(which checks its indices on the host): nothing reads back to the host and
no shape depends on the routing, so the layer runs inside a CUDA graph and
under ``torch.func.vmap``.

The jitter cannot draw ``vit_tpu``'s bits (``jax.random.uniform`` of the
``dropout`` key); it is :func:`~vit_tpu_torch.ops.dropout.stream_uniform`
of the layer's own dropout seed, computed on the device, so the per-step
path, the CUDA graph, remat's recompute and each replica of the vmapped
sweep draw the same noise for the same seed. The two agree in
distribution, not bit for bit.

Expert parallelism (``train.model_parallel`` > 1,
:mod:`vit_tpu_torch.parallel.tensor`): the expert leaves hold E/TP experts
a rank; the router (a column-parallel ``Linear``), the routing, dispatch and
combine run replicated, each rank applies its experts to their slots, and
the partial outputs are summed over ``model`` in fp32 and rounded once to
the compute dtype (``vit_tpu``: GSPMD's collectives around the expert
einsums).

:meth:`MoEMLP.forward` returns ``(y, stats)``: ``stats`` is a (3,) fp32
tensor in :data:`MOE_STATS` order, the Switch load-balance loss over
first choices, the router z-loss ``mean(logsumexp(logits)^2)`` (0 unless
``moe_z_weight > 0``, when ``vit_tpu`` sows it) and the share of (token,
slot) assignments the capacity dropped. They are returned, not stored on
the module, so a recomputed forward (remat) cannot count them twice.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.models.layers import KERNEL_STD, Linear, init_normal_
from vit_tpu_torch.ops.dropout import batch_offsets, stream_uniform
from vit_tpu_torch.parallel.comm import reduce_grad, reduce_sum
from vit_tpu_torch.parallel.tensor import expert_block

__all__ = ["MoEMLP", "moe_capacity", "MOE_STATS"]

MOE_STATS = ("moe_aux", "moe_z", "dropped_frac")


def moe_capacity(seq_len: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Per-row expert capacity: ``ceil(top_k * T * cf / E)``, at least 1."""
    return max(1, int(math.ceil(top_k * seq_len * capacity_factor / num_experts)))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of integer ``idx`` over ``n`` classes (no index check)."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).float()


class MoEMLP(nn.Module):
    """The encoder MLP as E experts and a top-k router: ``(B, T, D)`` in,
    ``(y (B, T, D), stats (3,))`` out. Parameters: ``router`` (a
    :class:`Linear`, weight (E, D)), ``wi`` (E, D, F), ``wi_bias`` (E, F),
    ``wo`` (E, F, D), ``wo_bias`` (E, D)."""

    def __init__(self, cfg: Any) -> None:
        super().__init__()
        self.cfg = cfg
        e, d, f = int(cfg.moe_experts), cfg.hidden_size, cfg.intermediate_size
        self.num_experts = e
        self.top_k = int(cfg.moe_top_k or 1)
        if not 1 <= self.top_k <= e:
            raise ValueError(f"moe_top_k={self.top_k} must be in [1, moe_experts={e}]")
        self.capacity_factor = float(cfg.moe_capacity_factor or 1.25)
        self.jitter = float(cfg.moe_router_jitter or 0.0)
        self.z_loss = float(cfg.moe_z_weight or 0.0) > 0.0
        self.router = Linear(d, e)
        self.wi = nn.Parameter(torch.empty(e, d, f))
        self.wi_bias = nn.Parameter(torch.empty(e, f))
        self.wo = nn.Parameter(torch.empty(e, f, d))
        self.wo_bias = nn.Parameter(torch.empty(e, d))

    def init_(self, g: torch.Generator) -> None:
        """The experts' weights, one N(0, 0.02) draw an expert
        (``_expert_init``), zero biases; the router is a Linear of its own."""
        for w in (self.wi, self.wo):
            for e in range(self.num_experts):
                init_normal_(w[e], KERNEL_STD, g)
        nn.init.zeros_(self.wi_bias)
        nn.init.zeros_(self.wo_bias)

    def route(self, x: torch.Tensor, seed=None) -> Tuple[torch.Tensor, ...]:
        """The router of ``x`` (B, T, D): ``(logits, probs, gate_vals,
        gate_idx)``, each (B, T, ·), the logits and probabilities fp32.
        ``seed``: the jitter's int32 seed, drawn from in training only."""
        router_in = x.float()
        if self.jitter > 0.0 and self.training:
            if seed is None:
                raise ValueError("training-mode router jitter needs its dropout seed")
            u = stream_uniform(router_in.shape, seed, device=x.device,
                               offsets=batch_offsets(router_in.dim()))
            router_in = router_in * ((1.0 - self.jitter) + u * (2.0 * self.jitter))
        logits = self.router(router_in, torch.float32)
        probs = torch.softmax(logits, dim=-1)
        # lax.top_k's order: larger first, ties to the lower index.
        gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, gate_idx = gate_vals[..., :self.top_k], gate_idx[..., :self.top_k]
        if self.top_k > 1:
            gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
        return logits, probs, gate_vals, gate_idx

    def slots(self, gate_idx: torch.Tensor, t: int) -> Tuple[torch.Tensor, ...]:
        """``(sel (B, T, k, E), keep (B, k*T, E), pos (B, k*T, E))``: each
        token's chosen experts, which of those choices found a slot, and
        their queue positions, in GShard's queue order (all first choices,
        then all second choices, ...)."""
        b, e, k = gate_idx.shape[0], self.num_experts, self.top_k
        cap = moe_capacity(t, e, k, self.capacity_factor)
        sel = _one_hot(gate_idx, e)
        sel_prio = sel.transpose(1, 2).reshape(b, k * t, e)
        pos = torch.cumsum(sel_prio, dim=1) - 1.0  # queue position per expert
        return sel, (pos < cap).float() * sel_prio, pos

    def forward(self, x: torch.Tensor, seed=None) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, t, _ = x.shape
        e, k = self.num_experts, self.top_k
        cap = moe_capacity(t, e, k, self.capacity_factor)
        logits, probs, gate_vals, gate_idx = self.route(x, seed)
        sel, keep, pos = self.slots(gate_idx, t)
        slot = _one_hot(pos.clamp(0, cap - 1).long(), cap) * keep.unsqueeze(-1)  # (B, kT, E, C)
        slot_k = slot.reshape(b, k, t, e, cap)
        dispatch = slot_k.sum(1)  # (B, T, E, C): a token's chosen slots
        combine = (slot_k * gate_vals.transpose(1, 2)[..., None, None]).sum(1)

        dt = cfg.dtype
        e0, e_here, group = expert_block(self.wi)
        x_in = x
        if group is not None:
            # Expert parallelism: this rank's E/TP experts on the replicated
            # dispatch; their partial outputs are summed over `model`.
            x_in, combine = reduce_grad(x, group), reduce_grad(combine, group)
            dispatch = dispatch[:, :, e0:e0 + e_here]
            combine = combine[:, :, e0:e0 + e_here]
        expert_in = torch.einsum("btec,btd->ebcd", dispatch.to(dt), x_in.to(dt))
        h = torch.einsum("ebcd,edf->ebcf", expert_in, self.wi.to(dt))
        h = h + self.wi_bias.to(dt)[:, None, None, :]
        h = F.gelu(h, approximate="tanh" if cfg.gelu_approximate else "none")
        h = torch.einsum("ebcf,efd->ebcd", h, self.wo.to(dt))
        h = h + self.wo_bias.to(dt)[:, None, None, :]
        if group is None:
            y = torch.einsum("btec,ebcd->btd", combine.to(dt), h)
        else:  # the experts' sum in fp32, rounded once, as the one product rounds it
            y = reduce_sum(torch.einsum("btec,ebcd->btd", combine.to(dt).float(), h.float()),
                           group).to(dt)

        # Switch load balance: first-choice share per expert times mean
        # router probability, scaled by E (uniform routing gives 1).
        first_frac = sel[:, :, 0, :].mean(dim=1)  # (B, E)
        aux = e * (first_frac * probs.mean(dim=1)).sum(-1).mean()
        z = torch.zeros((), device=x.device)
        if self.z_loss:
            lse = torch.logsumexp(logits, dim=-1)
            z = (lse * lse).mean()
        dropped = 1.0 - keep.sum() / float(b * t * k)
        return y, torch.stack([aux, z, dropped])
