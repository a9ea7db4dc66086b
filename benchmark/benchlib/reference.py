"""The plain reference: the ViT of these configurations in plain PyTorch,
fp32 with TF32 off, its training step (loss, global-norm clip, AdamW) and
its dropout masks, worked out again from the seeds.

It follows the project's model: sliding-window (spectra) or 2-D patch
(images) tokens, a CLS token and learned positions (images), pre-LN blocks
(LayerNorm eps 1e-12, QKV, softmax attention scaled by d^-1/2, output
projection, exact-GELU MLP), a final LayerNorm and the head on the CLS row;
the regression loss of ``loss.name: mae`` is the squared error (the
reference project's quirk), classification takes cross-entropy.

Dropout is the counter hash of the project's kernels, at every site the
training forward has: the embeddings, the attention probabilities, the
attention output and the MLP output, one seed each. The probabilities'
mask is the attention kernels' hash of (seed, batch*heads + head, row,
column) where the streaming kernels run (T >= 1024, head size >= 64) and
the elementwise sites' coordinate hash of the (B, H, T, T) tensor where the
plain products run; a mask multiplies the probabilities after the softmax
has normalised them. Batch rows are hashed at their global index, so the
reference may run a batch in blocks of rows.

``quant="fp8"`` is the control: the same arithmetic computed in float8
e4m3 where the configuration states bf16, each tensor rounded under a
per-tensor scale (amax / 448) where the program rounds to its compute
dtype: every product's operands and output, the tokens, each LayerNorm,
GELU and softmax output, and the residual stream after each add; sums
and statistics stay fp32. The backward takes the rounded values as they
are (straight through).

This module imports nothing of ``jax``, ``vit_tpu`` or ``vit_tpu_torch``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchlib.dims import Dims

U32 = 0xFFFFFFFF
AXIS_MULTS = (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0xD3A2646D)
SEED_MULT = 0x7FEB352D
M1, M2 = 0x85EBCA6B, 0xC2B2AE35
H_ROW, H_COL, H_BH, H_SEED = 0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F
SEED_HIGH = 2**31 - 1
LN_EPS = 1e-12
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def plain_mode() -> None:
    """fp32 products stay fp32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- masks -------------------------------------------------------------------
def _keep(rate: float):
    keep = 1.0 - rate
    return min(U32, int(round(keep * 2.0**32))), 1.0 / keep


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * M1) & U32
    x = x ^ (x >> 13)
    x = (x * M2) & U32
    return x ^ (x >> 16)


def coord_mask(shape: Sequence[int], seed: int, rate: float, row0: int, device) -> torch.Tensor:
    """Keep factors (0 or 1/keep) of a batch-first tensor whose first row is
    global row ``row0``: the elementwise sites' hash of the coordinates."""
    x = torch.full((), ((int(seed) & U32) * SEED_MULT) & U32, dtype=torch.int64, device=device)
    for axis, mult in enumerate(AXIS_MULTS[:len(shape)]):
        view = [1] * len(shape)
        view[axis] = shape[axis]
        idx = torch.arange(shape[axis], dtype=torch.int64, device=device).view(view)
        if axis == 0:
            idx = idx + row0
        x = (x + ((idx & U32) * mult)) & U32
        x = x ^ (x >> 15)
        x = (x * M1) & U32
    threshold, inv = _keep(rate)
    return torch.where(_fmix32(x) < threshold, inv, 0.0).float()


def attention_mask(b: int, heads: int, t: int, seed: int, rate: float, row0: int,
                   device) -> torch.Tensor:
    """(b, heads, t, t) keep factors of the attention kernels' hash; head
    ``h`` of row ``r`` is global head ``(row0 + r) * heads + h``."""
    rows = torch.arange(t, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(t, dtype=torch.int64, device=device)[None, :]
    base = ((rows * H_ROW) & U32) ^ ((cols * H_COL) & U32)
    seed_term = ((int(seed) & U32) * H_SEED) & U32
    threshold, inv = _keep(rate)
    out = torch.empty(b, heads, t, t, device=device)
    for i in range(b):
        for h in range(heads):
            bh = ((row0 + i) * heads + h) * H_BH & U32
            bits = _fmix32((base + bh + seed_term) & U32)
            out[i, h] = torch.where(bits < threshold, inv, 0.0)
    return out


# -- the model ---------------------------------------------------------------
def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


class Plain:
    """The model over a name -> fp32 tensor dict of parameters."""

    def __init__(self, d: Dims, params: Dict[str, torch.Tensor], quant: Optional[str] = None):
        self.d, self.p, self.quant = d, params, quant

    def _r(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` rounded to the control's precision (the identity in fp32)."""
        return _fp8(t) if self.quant == "fp8" else t

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._r(a) @ self._r(b)

    def _linear(self, x, name):
        w = self.p[name + ".weight"]
        return self._r(self._mm(x, w.reshape(w.shape[0], -1).t()) + self.p[name + ".bias"])

    def _ln(self, x, name):
        return self._r(F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"],
                                    self.p[name + ".bias"], LN_EPS))

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
        d = self.d
        if d.image:
            b, s, p, c = x.shape[0], d.length, d.patch, d.channels
            g = s // p
            x = x[:, :g * p, :g * p].reshape(b, g, p, g, p, c).permute(0, 1, 3, 5, 2, 4)
            patches = x.reshape(b, g * g, c * p * p)
        else:
            need = (d.patches - 1) * d.stride + d.patch
            x = F.pad(x, (0, max(0, need - x.shape[1])))
            patches = x.unfold(1, d.patch, d.stride)[:, :d.patches]
        tok = self._linear(patches, "vit.embeddings.patch_embeddings.projection")
        cls = self.p["vit.embeddings.cls_token"].expand(tok.shape[0], 1, -1)
        tok = torch.cat([cls, tok], dim=1)
        if d.learned_pos:
            tok = tok + self.p["vit.embeddings.position_embeddings"]
        return self._r(tok)

    def _drop(self, x, seed, row0):
        if seed is None:
            return x
        return x * coord_mask(x.shape, seed, self.d.dropout, row0, x.device)

    def _attention(self, x, n, seeds, row0):
        d = self.d
        b, t, _ = x.shape
        pre = f"vit.encoder.layer.{n}.attention."
        q, k, v = (self._linear(x, pre + "attention." + s).view(b, t, d.heads, d.head_dim)
                   .transpose(1, 2) for s in ("query", "key", "value"))
        probs = self._r(torch.softmax(self._mm(q, k.transpose(-1, -2)) * d.head_dim**-0.5, dim=-1))
        if seeds is not None:
            if d.flash:
                keep = attention_mask(b, d.heads, t, seeds[0], d.attn_dropout, row0, x.device)
            else:
                keep = coord_mask(probs.shape, seeds[0], d.attn_dropout, row0, x.device)
            probs = probs * keep
        ctx = self._r(self._mm(probs, v)).transpose(1, 2).reshape(b, t, d.hidden)
        out = self._linear(ctx, pre + "output.dense")
        return self._drop(out, None if seeds is None else seeds[1], row0)

    def _layer(self, x, n, seeds, row0):
        pre = f"vit.encoder.layer.{n}."
        x = self._r(x + self._attention(self._ln(x, pre + "layernorm_before"), n, seeds, row0))
        h = self._r(F.gelu(self._linear(self._ln(x, pre + "layernorm_after"),
                                        pre + "intermediate.dense")))
        h = self._linear(h, pre + "output.dense")
        return self._r(x + self._drop(h, None if seeds is None else seeds[2], row0))

    def __call__(self, x: torch.Tensor, seeds: Optional[Sequence[int]] = None,
                 row0: int = 0) -> torch.Tensor:
        """(rows, labels) fp32 logits; ``seeds``: the step's dropout seeds
        (training), ``row0``: the global index of ``x``'s first row."""
        h = self._drop(self._tokens(x), None if seeds is None else seeds[0], row0)
        for n in range(self.d.layers):
            s = None if seeds is None else seeds[1 + 3 * n:4 + 3 * n]
            h = self._layer(h, n, s, row0)
        h = self._ln(h, "vit.layernorm")
        head = "classifier" if self.d.task == "cls" else "regressor"
        return h[:, 0] @ self.p[head + ".weight"].t() + self.p[head + ".bias"]


def loss(d: Dims, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    if d.task == "cls":
        return F.cross_entropy(logits, labels.long())
    return ((logits - labels.float().view(logits.shape)) ** 2).mean()


# -- what the window's first steps see -----------------------------------------
def epoch_rows(n: int, batch: int, steps: int, seed: int, epoch: int = 0) -> np.ndarray:
    """The rows of an epoch's steps: a permutation seeded by ``seed +
    epoch``, cycled from its start to fill the last batch."""
    order = np.random.default_rng(seed + epoch).permutation(n)
    total = steps * batch
    if total > len(order):
        order = np.tile(order, -(-total // len(order)))
    return order[:total]


def epoch_seeds(seed: int, steps: int, sites: int) -> np.ndarray:
    """The (steps, sites) dropout seeds of a run's first epoch."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, SEED_HIGH, (steps, 1, sites), generator=g)[:, 0].numpy()


# -- training ------------------------------------------------------------------
def train_steps(d: Dims, weights: Dict[str, torch.Tensor], batches: List[tuple],
                seeds: np.ndarray, lr: float, block: int, quant: Optional[str] = None) -> dict:
    """The first ``len(batches)`` steps from ``weights``: each step's loss, the
    first step's clipped gradient norm a leaf (what AdamW receives) and the
    parameters' change a leaf after the last step. ``batches``: (x, labels)
    on the device; ``block``: rows a forward at a time."""
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    model = Plain(d, params, quant)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad1, norm1 = [], None, None
    for step, (x, y) in enumerate(batches, start=1):
        for p in params.values():
            p.grad = None
        total, rows = 0.0, x.shape[0]
        for r0 in range(0, rows, block):
            part = loss(d, model(x[r0:r0 + block], [int(s) for s in seeds[step - 1]], r0),
                        y[r0:r0 + block]) * (min(block, rows - r0) / rows)
            part.backward()
            total += float(part.detach())
        losses.append(total)
        grads = {k: p.grad for k, p in params.items()}
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        if d.grad_clip > 0 and norm >= d.grad_clip:
            grads = {k: g * (d.grad_clip / norm) for k, g in grads.items()}
        if step == 1:
            grad1 = {k: float(g.norm()) for k, g in grads.items()}
            norm1 = float(norm)
        with torch.no_grad():
            b1, b2 = BETAS
            for k, p in params.items():
                g = grads[k]
                p.mul_(1.0 - lr * d.weight_decay)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2**step)).add_(ADAM_EPS)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1**step))
    change = {k: float((p.detach() - weights[k].float()).norm()) for k, p in params.items()}
    return {"losses": losses, "grad1": grad1, "change": change, "grad_norm": norm1}


@torch.no_grad()
def logits(d: Dims, weights: Dict[str, torch.Tensor], x: torch.Tensor, block: int,
           quant: Optional[str] = None) -> torch.Tensor:
    """Eval-mode logits of ``x`` (no dropout), ``block`` rows at a time."""
    model = Plain(d, {k: v.float() for k, v in weights.items()}, quant)
    return torch.cat([model(x[r0:r0 + block]) for r0 in range(0, x.shape[0], block)])
