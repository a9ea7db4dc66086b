"""The spectra ViT (port of ``vit_tpu/models/vit.py``), for serving and training.

* ``SpectraEmbeddings`` — SW/C1D/LIN tokenizer + CLS token (N(0, 1) at
  init, the reference quirk) + optional learned positions.
* ``ImageEmbeddings``   — the image family (``model.input_kind: image``):
  2-D patchify of NHWC images (``Patch2DTokenizer``), or a dense embedding
  of pre-tokenized (B, N, F) patch features (the patch-PCA preprocessor's
  output), + CLS token and learned positions (both N(0, 0.02), standard
  ViT; RoPE configs add no positions).
* ``ViTLayer``          — pre-LN block in HF ViT order: layernorm_before ->
  attention -> residual; layernorm_after -> MLP -> residual. LN eps 1e-12.
  The MLP is dense -> GELU -> dense, or, when ``fused_mlp`` is set, the
  fused CUDA kernel inside ``vit_tpu``'s envelope and ``_jnp_mlp``'s math
  outside it (:func:`~vit_tpu_torch.ops.fused_mlp.in_envelope`); both, as
  in ``vit_tpu``, ignore ``gelu_approximate`` (exact GELU).
* ``SpecViT``           — [preprocessor] -> embeddings -> encoder -> final
  LN -> CLS -> head, the head in fp32. The optional preprocessor
  (:mod:`vit_tpu_torch.models.preprocessor`, built by the builder from
  covariance statistics) maps the raw (B, L) spectra before the embeddings,
  in fp32; its parameters sit under ``preprocessor.`` for the freeze
  schedule and are not drawn from the weight generator.

Module attribute names give exactly the HF state-dict keys that
``vit_tpu.train.torch_bridge.to_torch_state_dict`` writes (``vit.embeddings.
cls_token``, ``vit.encoder.layer.{i}.attention.attention.query.weight``,
``regressor.weight``, ...), so its ``.pt`` files load with ``strict=True``.

Training mode (``model.train()``) applies the counter-based hash dropout
of ``vit_tpu`` (``fast_dropout``, the default) at the embeddings, in
attention (probabilities and output) and after the MLP. Each call site
draws its mask from its own int32 seed: :meth:`SpecViT.forward` takes
``dropout_seeds``, :attr:`SpecViT.num_dropout_sites` of them per step, so
a recomputed forward draws the same masks. ``remat: mlp`` checkpoints the
MLP sublayer and ``remat: true`` the whole layer
(``torch.utils.checkpoint``, non-reentrant; no RNG state is stashed: no
site draws from a global generator, and a CUDA graph cannot set one while
it is being captured). Under ``torch.func.vmap`` over stacked replicas (the
vmapped sweep) the checkpoint is taken around the whole replica batch, by
:func:`remat`. ``fast_dropout: false`` takes
``nn.Dropout`` masks at the same sites (:func:`stream_dropout`, a
counter-based stream of each site's seed, so a recompute redraws them); attention's
flash route keeps its hash mask either way. RoPE (``pos_encoding_type:
rope``) rotates q and k inside attention. :func:`compute_loss` keeps the
reference quirk that ``loss.name: 'mae'`` trains MSE.

Mixture of Experts (``model.moe_experts > 1``): each layer's MLP is a
:class:`~vit_tpu_torch.models.moe.MoEMLP` under ``moe.`` (no
``intermediate``/``output``), taken before the fused MLP as in ``vit_tpu``
(``fused_mlp`` then leaves the MLP alone). Each such layer returns its
(3,) router statistics beside its output; ``forward(..., moe_stats=True)``
returns them stacked, (MoE layers, 3), and :func:`train_forward` turns them
into the training objective's regulariser. With ``moe_router_jitter > 0``
each MoE layer takes one more dropout seed, its router's jitter.

Diagnostics capture (``vit_tpu/models/vit.py:231-345``): ``forward`` takes
an optional ``capture`` dict and fills it with ``vit_tpu``'s tree of
intermediates: ``encoder/layer_{i}/attention/attention_probs`` (batch mean,
fp32), ``encoder/layer_{i}/mlp_activation`` (post-GELU, (B, T, I); none
for an MoE layer), ``encoder/cls_hidden_{i}`` (the CLS row after layer i) and
``cls_embedding`` (after the final LayerNorm). Under capture the flash
attention takes the xla math and the fused MLP its dense path, as in
``vit_tpu``, and nothing is rematerialised.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vit_tpu_torch.func_internals import (
    is_batched,
    reparametrize,
    tree_flatten,
    tree_unflatten,
)
from vit_tpu_torch.models.attention import MultiHeadSelfAttention
from vit_tpu_torch.models.moe import MoEMLP
from vit_tpu_torch.models.layers import (
    KERNEL_STD,
    DenseHolder,
    LayerNorm,
    Linear,
    dense,
    init_normal_,
)
from vit_tpu_torch.models.tokenization import (
    Conv1DPatchTokenizer,
    LinearPatchTokenizer,
    Patch2DTokenizer,
    SlidingWindowTokenizer,
)
from vit_tpu_torch.ops.dropout import batch_offset, current_batch_offset, site_dropout
from vit_tpu_torch.parallel.tensor import full_param

__all__ = ["SpectraEmbeddings", "ImageEmbeddings", "ViTLayer", "ViTEncoder", "SpecViT",
           "compute_loss", "remat", "train_forward"]

SITES_PER_LAYER = 3  # attention probabilities, attention output, MLP output


def sites_per_layer(cfg: Any) -> int:
    """Dropout seeds a layer takes: SITES_PER_LAYER, and an MoE router's
    jitter when it is on."""
    return SITES_PER_LAYER + int(cfg.moe_experts > 1 and cfg.moe_router_jitter > 0)


class _ReplicaRemat(torch.autograd.Function):
    """The checkpoint of ``fn`` (a method of ``module``) under
    ``torch.func.vmap``: the checkpoint's recompute runs in the backward,
    after vmap has returned, so it is taken in the vmap rule, around the
    whole replica batch, with ``module``'s (replica) parameters passed in
    explicitly so the recompute can put them back. ``flat``: the leaves of
    ``fn``'s arguments (``spec`` rebuilds them), then the parameters."""

    @staticmethod
    def forward(module, fn, names, spec, *flat):
        raise RuntimeError("_ReplicaRemat runs only under torch.func.vmap")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("_ReplicaRemat runs only under torch.func.vmap")

    @staticmethod
    def vmap(info, in_dims, module, fn, names, spec, *flat):
        dims = in_dims[4:]
        n_args = spec.num_leaves

        def per_replica(*flat):
            with reparametrize(module, dict(zip(names, flat[n_args:]))):
                return fn(*tree_unflatten(list(flat[:n_args]), spec))

        def stacked(*flat):
            return torch.func.vmap(per_replica, in_dims=dims)(*flat)

        out = checkpoint(stacked, *flat, use_reentrant=False, preserve_rng_state=False)
        return out, 0


def remat(module: nn.Module, fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant, no RNG stash); ``fn`` reads
    ``module``'s parameters. The recompute runs at the dropout
    :func:`~vit_tpu_torch.ops.dropout.batch_offset` of the forward."""
    leaves, spec = tree_flatten(list(args))
    if not any(map(is_batched, leaves)):
        rows = current_batch_offset()
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(), batch_offset(rows)))
    names, params = zip(*module.named_parameters())
    return _ReplicaRemat.apply(module, fn, names, spec, *leaves, *params)


def _tokenizer(cfg: Any) -> nn.Module:
    common = dict(input_length=cfg.image_size, patch_size=cfg.patch_size, dtype=cfg.dtype)
    if cfg.proj_fn == "SW":
        return SlidingWindowTokenizer(hidden_size=cfg.hidden_size, stride=cfg.stride, **common)
    if cfg.proj_fn in ("C1D", "CNN"):
        return Conv1DPatchTokenizer(hidden_size=cfg.hidden_size, stride=cfg.stride, **common)
    if cfg.proj_fn in ("LIN", "linear"):
        return LinearPatchTokenizer(embed_dim=cfg.hidden_size, **common)
    raise ValueError(f"Unsupported proj_fn '{cfg.proj_fn}'")


class SpectraEmbeddings(nn.Module):
    """Patch + CLS + positional embeddings for 1-D spectra."""

    def __init__(self, cfg: Any) -> None:
        super().__init__()
        self.cfg = cfg
        self.patch_embeddings = _tokenizer(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.hidden_size))
        self.position_embeddings = None
        if cfg.pos_encoding_type == "learned":
            self.position_embeddings = nn.Parameter(
                torch.empty(1, self.patch_embeddings.num_patches + 1, cfg.hidden_size)
            )
        # 'rope' is applied inside attention; None adds nothing.

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = self.patch_embeddings(x)  # (B, T, H) in the compute dtype
        cls = full_param(self.cls_token).to(tokens.dtype).expand(tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        if self.position_embeddings is not None:
            tokens = tokens + full_param(self.position_embeddings).to(tokens.dtype)
        return tokens

    def init_(self, g: torch.Generator) -> None:
        init_normal_(self.cls_token, 1.0, g)
        if self.position_embeddings is not None:
            init_normal_(self.position_embeddings, 1.0, g)


class ImageEmbeddings(nn.Module):
    """2-D patch (or pre-tokenized patch features) + CLS + learned positions
    (``vit_tpu/models/vit.py::ImageEmbeddings``). ``patch_features``: the
    width F of (B, N, F) inputs (a patch-PCA preprocessor's rank), embedded
    by ``patch_embeddings.projection`` as a dense layer; None for images."""

    def __init__(self, cfg: Any, patch_features: Optional[int] = None) -> None:
        super().__init__()
        self.cfg = cfg
        num_patches = (cfg.image_size // cfg.patch_size) ** 2
        if patch_features is None:
            self.patch_embeddings = Patch2DTokenizer(cfg.image_size, cfg.patch_size,
                                                     cfg.hidden_size, cfg.num_channels,
                                                     cfg.dtype)
        else:
            self.patch_embeddings = nn.Module()
            self.patch_embeddings.projection = Linear(patch_features, cfg.hidden_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.hidden_size))
        self.position_embeddings = None
        if cfg.pos_encoding_type != "rope":
            self.position_embeddings = nn.Parameter(
                torch.empty(1, num_patches + 1, cfg.hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            tokens = self.patch_embeddings.projection(x, self.cfg.dtype)
        else:
            tokens = self.patch_embeddings(x)
        cls = full_param(self.cls_token).to(tokens.dtype).expand(tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        if self.position_embeddings is not None:
            tokens = tokens + full_param(self.position_embeddings).to(tokens.dtype)
        return tokens

    def init_(self, g: torch.Generator) -> None:
        init_normal_(self.cls_token, KERNEL_STD, g)
        if self.position_embeddings is not None:
            init_normal_(self.position_embeddings, KERNEL_STD, g)


class ViTLayer(nn.Module):
    """Pre-LN transformer encoder block (HF ViT ordering)."""

    def __init__(self, cfg: Any) -> None:
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.layernorm_before = LayerNorm(cfg.hidden_size, dt)
        self.attention = MultiHeadSelfAttention(
            hidden_size=cfg.hidden_size,
            num_heads=cfg.num_attention_heads,
            impl=cfg.attn_impl,
            dtype=dt,
            qkv_bias=cfg.qkv_bias,
            use_rope=cfg.pos_encoding_type == "rope",
            rope_base=cfg.rope_base,
            fast_dropout=cfg.fast_dropout,
            softmax_dtype=cfg.softmax_dtype,
            fused_qkv=cfg.fused_qkv,
            dropout_rate=cfg.attention_dropout,
            out_dropout_rate=cfg.hidden_dropout,  # HF ViTSelfOutput drops at the hidden rate
            ring_block_k=cfg.ring_block_k,
        )
        self.layernorm_after = LayerNorm(cfg.hidden_size, dt)
        if cfg.moe_experts > 1:
            self.moe = MoEMLP(cfg)
        else:
            self.intermediate = DenseHolder(cfg.hidden_size, cfg.intermediate_size)
            self.output = DenseHolder(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, seeds: Optional[Sequence[int]] = None,
                capture: Optional[dict] = None):
        """``seeds``: this layer's dropout seeds (training; ``sites_per_layer``
        of them). ``capture``: this layer's dict of intermediates. Returns
        the layer's output, and for an MoE layer ``(output, stats)``
        (:meth:`MoEMLP.forward`)."""
        attn_capture = None if capture is None else capture.setdefault("attention", {})
        x = x + self.attention(self.layernorm_before(x), None if seeds is None else seeds[:2],
                               attn_capture)
        mlp_seeds = None if seeds is None else list(seeds[2:])
        if self.cfg.remat == "mlp" and torch.is_grad_enabled() and capture is None:
            # vit.py:233-236: the attention residuals stay saved; the MLP
            # sublayer (and its kernel) runs again in the backward.
            return remat(self, self._mlp, x, mlp_seeds)
        return self._mlp(x, mlp_seeds, capture)

    def _mlp(self, x: torch.Tensor, seeds: Optional[Sequence[int]],
             capture: Optional[dict] = None):
        """LN -> MLP (MoE, fused or dense) -> dropout -> residual. ``seeds``:
        the MLP output's dropout seed, then an MoE router's jitter seed."""
        cfg = self.cfg
        dt = cfg.dtype
        seed = None if seeds is None else seeds[0]
        h = self.layernorm_after(x)
        stats = None
        if cfg.moe_experts > 1:
            # vit.py:249-257: no mlp_activation capture, the fused MLP unused.
            h, stats = self.moe(h, None if seeds is None or len(seeds) < 2 else seeds[1])
        elif cfg.fused_mlp and capture is None:
            from vit_tpu_torch.ops import fused_mlp as fm

            w1, w2 = self.intermediate.dense, self.output.dense
            mlp = fm.fused_mlp
            if not fm.in_envelope(cfg.hidden_size, cfg.intermediate_size, dt):
                # vit_tpu/ops/fused_mlp.py:247-261: _jnp_mlp past the envelope.
                fm.note_outside_envelope(cfg.hidden_size, cfg.intermediate_size, dt)
                mlp = fm.library_mlp
            h = mlp(h.to(dt), full_param(w1.weight), w1.bias, full_param(w2.weight), w2.bias)
        else:
            w1, w2 = self.intermediate.dense, self.output.dense
            h = F.gelu(w1(h, dt), approximate="tanh" if cfg.gelu_approximate else "none")
            if capture is not None:
                capture["mlp_activation"] = h
            h = w2(h, dt)
        if self.training and seed is not None:
            h = site_dropout(h, cfg.hidden_dropout, seed, cfg.fast_dropout)
        return x + h if stats is None else (x + h, stats)


class ViTEncoder(nn.Module):
    """The layers, run in order; under pipeline parallelism
    (:attr:`pipeline`, :func:`vit_tpu_torch.parallel.pipeline.attach_pipeline`)
    this rank runs its stage's layers only, in the GPipe schedule, and
    holds only them in the stage-resident layout; the replicated layout
    holds every layer and evaluates (``eval()``) without the schedule."""

    def __init__(self, cfg: Any) -> None:
        super().__init__()
        self.remat_layers = cfg.remat is True  # "mlp" remats inside the layer
        self.sites = sites_per_layer(cfg)
        self.has_moe = cfg.moe_experts > 1
        self.layer = nn.ModuleList(ViTLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.pipeline = None

    def forward(self, x: torch.Tensor, seeds: Optional[Sequence[int]] = None,
                capture: Optional[dict] = None):
        """(the last layer's output, the MoE layers' stats stacked (L, 3)
        or None for a dense model)."""
        if self.pipeline is not None and (self.pipeline.resident or self.training):
            if capture is not None:
                raise ValueError("diagnostics capture is not supported under the pipeline "
                                 "(train.pipeline_parallel)")
            return self.pipeline.run(self, x, seeds)
        x, stats = self.run_layers(x, seeds, range(len(self.layer)), capture)
        return x, (torch.stack(stats) if stats else None)

    def run_layers(self, x: torch.Tensor, seeds, indices, capture: Optional[dict] = None):
        """Layers ``indices`` (global) in order on ``x``, each with its own
        slice of ``seeds`` (all the encoder's); (output, MoE stats list)."""
        stats = []
        for i in indices:
            layer = self.layer[i]
            s = None if seeds is None else seeds[self.sites * i:self.sites * (i + 1)]
            if capture is not None:
                out = layer(x, s, capture.setdefault(f"layer_{i}", {}))
            elif self.remat_layers and torch.is_grad_enabled():
                out = remat(layer, layer, x, s)  # vit.py:307
            else:
                out = layer(x, s)
            if self.has_moe:
                x, st = out
                stats.append(st)
            else:
                x = out
            if capture is not None:
                capture[f"cls_hidden_{i}"] = x[:, 0, :]
        return x, stats


class _ViTModel(nn.Module):
    def __init__(self, cfg: Any, patch_features: Optional[int] = None) -> None:
        super().__init__()
        self.embeddings = (ImageEmbeddings(cfg, patch_features) if cfg.input_kind == "image"
                           else SpectraEmbeddings(cfg))
        self.encoder = ViTEncoder(cfg)
        self.layernorm = LayerNorm(cfg.hidden_size, cfg.dtype)


class SpecViT(nn.Module):
    """[preprocessor] -> embeddings -> encoder -> LN -> CLS -> task head
    (``regressor`` or ``classifier``, fp32). Weights are drawn from
    ``generator`` (default: a ``torch.Generator`` seeded with 0) as
    ``vit_tpu`` initialises them; a ``preprocessor`` keeps its own. An image
    model behind a patch-PCA preprocessor embeds its ``out_features``-wide
    patch coefficients."""

    def __init__(self, cfg: Any, generator: Optional[torch.Generator] = None,
                 preprocessor: Optional[nn.Module] = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.head_name = "classifier" if cfg.task_type == "cls" else "regressor"
        patch_features = None
        if cfg.input_kind == "image" and preprocessor is not None:
            patch_features = preprocessor.out_features
        self.vit = _ViTModel(cfg, patch_features)
        self.add_module(self.head_name, Linear(cfg.hidden_size, cfg.num_labels))
        self.init_weights(generator or torch.Generator().manual_seed(0))
        # Registered last: its keys follow the model's, as the bridge writes them.
        self.preprocessor = preprocessor

    @property
    def head(self) -> Linear:
        return getattr(self, self.head_name)

    @property
    def input_length(self) -> int:
        """Raw spectrum length the model takes: the preprocessor's input
        dimension (the builder adjusted ``image_size`` to its output), else
        ``image_size`` (an image model's side, whatever its preprocessor)."""
        if self.preprocessor is not None and self.cfg.input_kind != "image":
            return self.preprocessor.in_features
        return self.cfg.image_size

    def init_weights(self, g: torch.Generator) -> None:
        """Draw every weight of the ViT (not the preprocessor's) from ``g``."""
        for m in [*self.vit.modules(), self.head]:
            if isinstance(m, (Linear, LayerNorm, SpectraEmbeddings, ImageEmbeddings, MoEMLP)):
                m.init_(g)

    @property
    def num_dropout_sites(self) -> int:
        """Seeds one training step draws: the embeddings' and three a layer
        (four an MoE layer with router jitter)."""
        return 1 + sites_per_layer(self.cfg) * self.cfg.num_hidden_layers

    def forward(self, x: torch.Tensor, dropout_seeds: Optional[Sequence[int]] = None,
                capture: Optional[dict] = None, moe_stats: bool = False):
        """(B, L) spectra -> (B, num_labels) fp32 logits. In training mode with
        any dropout rate above 0, or MoE router jitter, ``dropout_seeds``
        holds one int32 per site (:attr:`num_dropout_sites`): a list of
        ints, or a (sites,) integer tensor on the device. ``capture``: a dict
        that receives the diagnostics tree (module doc). ``moe_stats``:
        return ``(logits, stats)``, the MoE layers' router statistics (L, 3)
        in :data:`~vit_tpu_torch.models.moe.MOE_STATS` order, None for a
        dense model."""
        feats, stats = self._features(x, dropout_seeds, capture)
        cls_token = feats[:, 0, :]
        if capture is not None:
            capture["cls_embedding"] = cls_token
        logits = dense(cls_token.float(), full_param(self.head.weight), self.head.bias,
                       torch.float32)
        return (logits, stats) if moe_stats else logits

    def features(self, x: torch.Tensor, dropout_seeds: Optional[Sequence[int]] = None,
                 capture: Optional[dict] = None) -> torch.Tensor:
        """The final LayerNorm's output for every token, (B, T, H), in the
        compute dtype: what the head reads its CLS row from."""
        return self._features(x, dropout_seeds, capture)[0]

    def _features(self, x, dropout_seeds, capture):
        cfg = self.cfg
        seeds = None
        jitter = cfg.moe_experts > 1 and cfg.moe_router_jitter > 0
        if self.training and (cfg.hidden_dropout > 0 or cfg.attention_dropout > 0 or jitter):
            if dropout_seeds is None or len(dropout_seeds) != self.num_dropout_sites:
                raise ValueError(
                    f"training-mode dropout needs {self.num_dropout_sites} dropout_seeds"
                )
            # Ints stay ints; a (sites,) int tensor on the device is split
            # into 0-d views, never read back to the host.
            seeds = (list(dropout_seeds.unbind(0)) if isinstance(dropout_seeds, torch.Tensor)
                     else [int(s) for s in dropout_seeds])
        if self.preprocessor is not None:
            x = self.preprocessor(x)
        tokens = self.vit.embeddings(x)
        if seeds is not None:
            tokens = site_dropout(tokens, cfg.hidden_dropout, seeds[0], cfg.fast_dropout)
        h, stats = self.vit.encoder(tokens, None if seeds is None else seeds[1:],
                                    None if capture is None else capture.setdefault("encoder",
                                                                                    {}))
        return self.vit.layernorm(h), stats


def train_forward(module: SpecViT, x: torch.Tensor, dropout_seeds) -> tuple:
    """The training forward every training path shares (port of
    ``vit_tpu/train/loop.py::make_train_forward``): ``(logits, reg)`` with
    ``reg`` the pre-weighted router regulariser ``moe_aux_weight *
    mean(aux) + moe_z_weight * mean(z)`` over the MoE layers, to be added
    to the task loss, or None for a dense model or with both weights 0.
    Evaluation metrics leave it out."""
    cfg = module.cfg
    aux_w, z_w = (cfg.moe_aux_weight, cfg.moe_z_weight) if cfg.moe_experts > 1 else (0.0, 0.0)
    if aux_w <= 0.0 and z_w <= 0.0:
        return module(x, dropout_seeds=dropout_seeds), None
    logits, stats = module(x, dropout_seeds=dropout_seeds, moe_stats=True)
    reg = aux_w * stats[:, 0].mean()
    if z_w > 0.0:
        reg = reg + z_w * stats[:, 1].mean()
    return logits, reg


def compute_loss(logits: torch.Tensor, labels: torch.Tensor, task_type: str,
                 loss_name: str = "", weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Task loss (``vit_tpu/models/vit.py:353-377``). cls: cross-entropy;
    reg: L1 iff ``'l1'`` is in ``loss_name``, else MSE, so ``'mae'`` trains
    MSE (the reference quirk). ``weights``: per-example 0/1 for masked
    batches."""
    if task_type == "cls":
        per_ex = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    else:
        diff = logits.float() - labels.float().reshape(logits.shape)
        per_elem = diff.abs() if "l1" in (loss_name or "l2").lower() else diff**2
        per_ex = per_elem.mean(dim=-1)
    if weights is None:
        return per_ex.mean()
    w = weights.float()
    return (per_ex * w).sum() / w.sum().clamp_min(1.0)
