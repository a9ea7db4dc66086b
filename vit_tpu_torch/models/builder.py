"""Model construction: config dataclass, builder, naming (port of
``vit_tpu/models/builder.py``).

``get_vit_config`` and ``build_model_name`` follow ``vit_tpu`` field for
field, so a config resolves to the same shapes and the same checkpoint
directory name in both packages. ``step_matmul_flops`` is ``vit_tpu``'s
count of a step's matmul work (``train.log_mfu``). ``get_model`` builds the model and, for spectra,
its covariance preprocessor (``warmup.preprocessor: zca|pca|attention``
with ``warmup.cov_path``, ``vit_tpu/models/builder.py:344-413,483-548``):
it checks the eigenvector rows against ``model.image_size``, adjusts
``config['model']['image_size']`` in place to the preprocessor's output
dimension, and prefixes the model name (``ZCA{r}_fz{fz}{_s..}{_nobias}``,
``PCA{r}_fz..``, ``Attn{r}{_scaled}_fz..``), which names the checkpoint
directory. The image family (``input_kind: image`` or a preset name,
``IMAGE_VIT_PRESETS``) builds the same way, and with ``warmup.preprocessor:
pca`` puts a patch-level PCA projection in front of its embeddings
(``_get_image_pca_model``, ``vit_tpu/models/builder.py:416``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
from torch import nn

from vit_tpu_torch.config import normalize_task
from vit_tpu_torch.models.moe import moe_capacity
from vit_tpu_torch.models.tokenization import conv1d_num_patches, sliding_window_num_patches

__all__ = [
    "VitConfig",
    "ModelBundle",
    "get_vit_config",
    "get_model",
    "build_model_name",
    "step_matmul_flops",
    "IMAGE_VIT_PRESETS",
]

_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "bf16-mixed": torch.bfloat16,
}

# Standard image-ViT presets (patch 16): hidden/layers/heads.
IMAGE_VIT_PRESETS: Dict[str, Dict[str, int]] = {
    "vit-s16": dict(hidden_size=384, num_hidden_layers=12, num_attention_heads=6, patch_size=16),
    "vit-b16": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, patch_size=16),
    "vit-l16": dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, patch_size=16),
}


@dataclasses.dataclass(frozen=True)
class VitConfig:
    """Static model configuration; the fields of ``vit_tpu``'s VitConfig."""

    task_type: str = "reg"
    image_size: int = 4096
    patch_size: int = 32
    num_channels: int = 1
    hidden_size: int = 32
    num_hidden_layers: int = 3
    num_attention_heads: int = 2
    intermediate_size: int = 128
    stride_ratio: float = 1.0
    stride_size: Optional[int] = None
    proj_fn: str = "SW"
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    qkv_bias: bool = True
    num_labels: int = 1
    pos_encoding_type: Optional[str] = None
    max_position_embeddings: int = 512
    rope_base: float = 10000.0
    input_kind: str = "spectra"
    attn_impl: str = "auto"
    ring_block_k: Optional[int] = None
    precision: str = "float32"
    remat: Union[bool, str] = False  # a training-memory option; inference ignores it
    gelu_approximate: bool = False
    softmax_dtype: Optional[str] = None
    fast_dropout: bool = True
    fused_qkv: bool = False
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_z_weight: float = 0.0
    moe_router_jitter: float = 0.0
    fused_mlp: bool = False

    @property
    def dtype(self) -> torch.dtype:
        key = str(self.precision).lower()
        if key not in _DTYPES:
            raise ValueError(f"Unsupported precision '{self.precision}'")
        return _DTYPES[key]

    @property
    def stride(self) -> int:
        if self.stride_size and self.stride_size > 0:
            return int(self.stride_size)
        return int(self.stride_ratio * self.patch_size)

    @property
    def num_patches(self) -> int:
        if self.input_kind == "image":
            return (self.image_size // self.patch_size) ** 2
        if self.proj_fn == "SW":
            return sliding_window_num_patches(self.image_size, self.patch_size, self.stride)
        if self.proj_fn in ("C1D", "CNN"):
            return conv1d_num_patches(self.image_size, self.patch_size, self.stride)
        if self.proj_fn in ("LIN", "linear"):
            return self.image_size // self.patch_size
        raise ValueError(f"Unsupported proj_fn '{self.proj_fn}'")

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def step_matmul_flops(vc: VitConfig, batch_size: int, train: bool = True) -> float:
    """Analytic matmul FLOPs of one step (a multiply-add is 2 FLOPs):
    patch embedding, per-layer QKV and output projections, the two T x T
    attention products, the MLP pair and the head, for one batch; ``train``
    applies the fwd+bwd factor 3. Elementwise work (LayerNorm, GELU,
    softmax, dropout) is left out, so this is a lower bound: the numerator
    of ``tflops_per_s`` and ``mfu`` (``train.log_mfu``)."""
    T, H, L = vc.seq_len, vc.hidden_size, vc.num_hidden_layers
    inter = vc.intermediate_size
    patch_in = vc.patch_size**2 * vc.num_channels if vc.input_kind == "image" else vc.patch_size
    embed = 2.0 * vc.num_patches * patch_in * H
    if vc.moe_experts > 1:
        # Experts process E * C slot-tokens a row (C: the per-row capacity,
        # vit_tpu's moe_capacity) instead of T, plus the (T, H) @ (H, E) router.
        capacity = moe_capacity(T, vc.moe_experts, vc.moe_top_k, vc.moe_capacity_factor)
        mlp = 4.0 * vc.moe_experts * capacity * H * inter + 2.0 * T * H * vc.moe_experts
    else:
        mlp = 4.0 * T * H * inter
    per_layer = 8.0 * T * H * H + 4.0 * T * T * H + mlp
    head = 2.0 * H * vc.num_labels
    fwd = batch_size * (L * per_layer + embed + head)
    return 3.0 * fwd if train else fwd


@dataclasses.dataclass
class ModelBundle:
    module: nn.Module
    vit_config: VitConfig
    model_name: str
    loss_name: str
    freeze_epochs: int = 0
    has_preprocessor: bool = False
    preprocessor_desc: str = ""


def build_model_name(cfg: VitConfig, model_prefix: str = "ViT",
                     full_config: Optional[dict] = None) -> str:
    """``{prefix}_p{patch}_h{hidden}_l{layers}_a{heads}_s{stride}_p{proj}``
    plus ``_moe{E}`` and ``_nz{level}`` tags, as ``vit_tpu`` names them."""
    stride_tag = (
        int(cfg.stride_size) if (cfg.stride_size is not None and cfg.stride_size)
        else cfg.stride_ratio
    )
    name = (
        f"{model_prefix}_p{cfg.patch_size}_h{cfg.hidden_size}_l{cfg.num_hidden_layers}_"
        f"a{cfg.num_attention_heads}_s{stride_tag}_p{cfg.proj_fn}"
    )
    if cfg.moe_experts > 1:
        name += f"_moe{cfg.moe_experts}"
    if full_config is not None:
        noise_level = (full_config.get("noise", {}) or {}).get("noise_level", 0)
        if noise_level and noise_level > 0:
            name += f"_nz{str(noise_level).replace('.', '')}"
    return name


def _derive_num_labels(m: dict, d: dict, task: str) -> int:
    if task in ("reg", "regression"):
        p = d.get("param")
        num_labels = 1
        if isinstance(p, str) and p.strip():
            num_labels = max(1, len([x for x in p.split(",") if x.strip()]))
        elif isinstance(p, (list, tuple)) and len(p) > 0:
            num_labels = len(p)
        cfg_labels = m.get("num_labels")
        if cfg_labels is not None and int(cfg_labels) != num_labels:
            print(
                f"Warning: model.num_labels={cfg_labels} conflicts with data.param "
                f"(implies {num_labels}); using {num_labels}"
            )
        m["num_labels"] = num_labels
        return num_labels
    return int(m.get("num_labels", 1) or 1)


def _parse_remat(value) -> Union[bool, str]:
    if isinstance(value, str):
        v = value.strip().lower()
        if v == "mlp":
            return "mlp"
        if v in ("true", "1", "yes"):
            return True
        if v in ("false", "0", "no", ""):
            return False
        raise ValueError(f"model.remat must be true/false or 'mlp', got {value!r}")
    return bool(value)


def get_vit_config(config: dict) -> VitConfig:
    """YAML ``model`` (+``data``/``train``) sections -> :class:`VitConfig`.

    Writes the derived ``num_labels`` back into ``config['model']``."""
    m = dict(config["model"])
    preset = IMAGE_VIT_PRESETS.get(str(m.get("name", "")).lower())
    if preset:
        for k, v in preset.items():
            m.setdefault(k, v)
        m.setdefault("input_kind", "image")
    d = config.get("data", {}) or {}
    t = config.get("train", {}) or {}
    task = normalize_task(config)
    num_labels = _derive_num_labels(m, d, task)
    config["model"]["num_labels"] = m.get("num_labels", num_labels)

    hidden = int(m["hidden_size"])
    return VitConfig(
        task_type=task,
        image_size=int(m["image_size"]),
        patch_size=int(m["patch_size"]),
        num_channels=int(m.get("num_channels", 3 if m.get("input_kind") == "image" else 1)),
        hidden_size=hidden,
        num_hidden_layers=int(m["num_hidden_layers"]),
        num_attention_heads=int(m["num_attention_heads"]),
        intermediate_size=int(m.get("intermediate_size", 4 * hidden)),
        stride_ratio=m.get("stride_ratio", 1),
        stride_size=m.get("stride_size"),
        proj_fn=m.get("proj_fn", "SW"),
        hidden_dropout=float(m.get("hidden_dropout_prob", 0.1)),
        attention_dropout=float(m.get("attention_probs_dropout_prob", 0.1)),
        qkv_bias=bool(m.get("qkv_bias", True)),
        num_labels=num_labels,
        pos_encoding_type=m.get("pos_encoding_type"),
        max_position_embeddings=int(m.get("max_position_embeddings", 512)),
        rope_base=float(m.get("rope_base", 10000.0)),
        input_kind=m.get("input_kind", "spectra"),
        attn_impl=m.get("attn_impl", "auto"),
        ring_block_k=int(m["ring_block_k"]) if m.get("ring_block_k") else None,
        precision=str(t.get("precision", "float32")),
        remat=_parse_remat(m.get("remat", False)),
        fast_dropout=bool(m.get("fast_dropout", True)),
        gelu_approximate=bool(m.get("gelu_approximate", False)),
        softmax_dtype=m.get("softmax_dtype") or None,
        fused_mlp=bool(m.get("fused_mlp", False)),
        fused_qkv=bool(m.get("fused_qkv", False)),
        moe_experts=int(m.get("moe_experts", 0) or 0),
        moe_top_k=int(m.get("moe_top_k", 1) or 1),
        moe_capacity_factor=float(m.get("moe_capacity_factor", 1.25) or 1.25),
        moe_aux_weight=float(m.get("moe_aux_weight", 0.01) or 0.0),
        moe_z_weight=float(m.get("moe_z_weight", 0.0) or 0.0),
        moe_router_jitter=float(m.get("moe_router_jitter", 0.0) or 0.0),
    )


def _get_freeze_suffix(freeze_epochs: int) -> str:
    return "perm" if freeze_epochs == -1 else str(freeze_epochs)


def _build_preprocessor(preproc_type: str, warmup_cfg: dict, stats: dict, input_dim: int):
    """(module, output_dim, name_prefix, desc) from covariance stats."""
    from vit_tpu_torch.models.preprocessor import (
        LinearPreprocessor,
        PrefilledAttention,
        compute_pca_matrix,
        compute_zca_matrix,
    )

    eigvecs = stats["eigvecs"]
    mean = stats.get("mean")
    r = warmup_cfg.get("r")
    fz = _get_freeze_suffix(int(warmup_cfg.get("freeze_epochs", 0) or 0))

    if preproc_type == "zca":
        eps = warmup_cfg.get("eps", 1e-5)
        shrinkage = warmup_cfg.get("shrinkage", 0.0)
        use_bias = warmup_cfg.get("bias", True)
        P = compute_zca_matrix(eigvecs, stats["eigvals"], eps=eps, r=r, shrinkage=shrinkage)
        bias = (-(mean @ P.T)).astype("float32") if (use_bias and mean is not None) else None
        rank_str = f"ZCA{r}" if r is not None else "ZCA"
        shrink_str = f"_s{int(shrinkage * 10)}" if shrinkage > 0 else ""
        bias_str = "" if use_bias else "_nobias"
        return (
            LinearPreprocessor(P, bias),
            P.shape[0],
            f"{rank_str}_fz{fz}{shrink_str}{bias_str}",
            f"{'low-rank' if r else 'full-rank'} ZCA, eps={eps}, shrinkage={shrinkage}, "
            f"bias={use_bias}",
        )
    if preproc_type == "pca":
        use_bias = warmup_cfg.get("bias", True)
        P = compute_pca_matrix(eigvecs, r=r)
        bias = (-(mean @ P.T)).astype("float32") if (use_bias and mean is not None) else None
        rank_str = f"PCA{r}" if r is not None else "PCA"
        bias_str = "" if use_bias else "_nobias"
        return (
            LinearPreprocessor(P, bias),
            P.shape[0],
            f"{rank_str}_fz{fz}{bias_str}",
            f"PCA with r={r}, bias={use_bias}" if r else f"full-rank PCA, bias={use_bias}",
        )
    if preproc_type == "attention":
        eps = warmup_cfg.get("eps", 1e-5)
        scale_by_eigvals = warmup_cfg.get("scale_by_eigvals", True)
        # The 2-D output dim is the number of eigvec COLUMNS without an
        # explicit r (stats may hold truncated top-k eigvecs).
        n_comp = int(eigvecs.shape[1])
        if r is not None and int(r) > n_comp:
            raise ValueError(
                f"warmup.r={r} exceeds the {n_comp} eigenvector columns in the covariance stats"
            )
        module = PrefilledAttention(input_dim, eigvecs, eigvals=stats.get("eigvals"), r=r,
                                    scale_by_eigvals=scale_by_eigvals, eps=eps)
        out_dim = int(r) if r is not None else n_comp
        rank_str = r if r else "Full"
        scale_suffix = "_scaled" if (scale_by_eigvals and stats.get("eigvals") is not None) else ""
        return (
            module,
            out_dim,
            f"Attn{rank_str}{scale_suffix}_fz{fz}",
            f"Attention preprocessor with r={r}, scale_by_eigvals={scale_by_eigvals}",
        )
    raise ValueError(f"Unknown preprocessor type: '{preproc_type}'")


def _get_image_pca_model(config: dict, warmup_cfg: dict, loss_name: str, preproc_type,
                         generator: Optional[torch.Generator]) -> ModelBundle:
    """An image ViT behind a patch-level PCA projection
    (``vit_tpu/models/builder.py::_get_image_pca_model``): ``warmup.
    preprocessor: pca`` with ``warmup.cov_path`` (or ``pca_path``) naming a
    patch-PCA artifact, an optional rank ``warmup.r`` and the usual
    ``freeze_epochs``."""
    from vit_tpu_torch.models.preprocessor import PatchPCAProjector
    from vit_tpu_torch.models.vit import SpecViT
    from vit_tpu_torch.utils import load_patch_pca_stats

    if str(preproc_type).lower() not in ("pca", "patch_pca"):
        raise ValueError(
            f"Image models support preprocessor 'pca' (patch-level); got '{preproc_type}'")
    path = warmup_cfg.get("pca_path") or warmup_cfg.get("cov_path")
    if path is None:
        raise ValueError("image patch-PCA requires 'cov_path' (or 'pca_path') in warmup config")
    stats = load_patch_pca_stats(path)
    vit_config = get_vit_config(config)
    patch_dim = vit_config.patch_size**2 * vit_config.num_channels
    basis = stats["components"]
    if basis.shape[0] != patch_dim:
        raise ValueError(
            f"Mismatch: PCA basis dimension {basis.shape[0]} != patch dim {patch_dim} "
            f"({vit_config.patch_size}x{vit_config.patch_size}x{vit_config.num_channels})")
    r = warmup_cfg.get("r")
    r = int(r) if r is not None else int(basis.shape[1])
    if r > basis.shape[1]:
        raise ValueError(f"warmup.r={r} exceeds the {basis.shape[1]} components in the "
                         f"patch-PCA artifact")
    freeze_epochs = int(warmup_cfg.get("freeze_epochs", 0) or 0)
    fz = _get_freeze_suffix(freeze_epochs)
    preprocessor = PatchPCAProjector(vit_config.patch_size, vit_config.num_channels,
                                     basis[:, :r], stats.get("mean"))
    module = SpecViT(vit_config, generator=generator, preprocessor=preprocessor)
    name = build_model_name(vit_config, f"PCAp{r}_fz{fz}_ViT", full_config=config)
    desc = f"patch-level PCA, r={r}/{basis.shape[1]}, patch_dim={patch_dim}"
    print(f"[builder] Created {desc} preprocessor -> {name}")
    return ModelBundle(module, vit_config, name, loss_name, freeze_epochs=freeze_epochs,
                       has_preprocessor=True, preprocessor_desc=desc)


def get_model(config: dict, generator: Optional[torch.Generator] = None) -> ModelBundle:
    """Build the model (and its optional preprocessor) from the full config
    dict. Mutates ``config['model']['image_size']`` when a preprocessor
    changes the input dimension; the raw length stays the preprocessor's
    ``in_features`` (``SpecViT.input_length``)."""
    from vit_tpu_torch.models.vit import SpecViT  # local import avoids a cycle
    from vit_tpu_torch.utils import load_cov_stats

    warmup_cfg = config.get("warmup", {}) or {}
    loss_name = (config.get("loss", {}) or {}).get("name") or ""
    task = normalize_task(config)
    if task == "cls":
        loss_name = "ce"
    elif not loss_name:
        loss_name = "l2"
    preproc_type = warmup_cfg.get("preprocessor")
    if preproc_type is None or str(preproc_type).lower() in ("none", "null"):
        vit_config = get_vit_config(config)
        module = SpecViT(vit_config, generator=generator)
        name = build_model_name(vit_config, "ViT", full_config=config)
        return ModelBundle(module, vit_config, name, loss_name)

    model_cfg = config.get("model", {}) or {}
    if (str(model_cfg.get("input_kind", "")).lower() == "image"
            or str(model_cfg.get("name", "")).lower() in IMAGE_VIT_PRESETS):
        return _get_image_pca_model(config, warmup_cfg, loss_name, preproc_type, generator)
    cov_path = warmup_cfg.get("cov_path")
    if cov_path is None:
        raise ValueError(f"preprocessor='{preproc_type}' requires 'cov_path' in warmup config")
    stats = load_cov_stats(cov_path)
    input_dim = int(stats["eigvecs"].shape[0])
    original_image_size = int(config["model"]["image_size"])
    if input_dim != original_image_size:
        raise ValueError(
            f"Mismatch: eigvecs dimension {input_dim} != image_size {original_image_size}"
        )
    freeze_epochs = int(warmup_cfg.get("freeze_epochs", 0) or 0)
    preprocessor, output_dim, name_prefix, desc = _build_preprocessor(
        str(preproc_type).lower(), warmup_cfg, stats, input_dim
    )
    if output_dim != original_image_size:
        print(f"[builder] Auto-adjusting image_size: {original_image_size} -> {output_dim}")
        config["model"]["image_size"] = int(output_dim)
    vit_config = get_vit_config(config)
    module = SpecViT(vit_config, generator=generator, preprocessor=preprocessor)
    name = build_model_name(vit_config, f"{name_prefix}_ViT", full_config=config)
    print(f"[builder] Created {desc} preprocessor -> {name}")
    return ModelBundle(module, vit_config, name, loss_name, freeze_epochs=freeze_epochs,
                       has_preprocessor=True, preprocessor_desc=desc)
