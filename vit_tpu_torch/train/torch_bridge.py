"""Weights into the port: flax param trees and ``.pt`` checkpoints.

The port's ``SpecViT.state_dict()`` keys are the HF ViT names that
``vit_tpu``'s bridge writes, so a ``.pt`` from ``save_torch_checkpoint`` or
``scripts/convert.py`` loads with ``load_state_dict(strict=True)``.
:func:`from_flax_params` is this package's own copy of that mapping, for a
tree of numpy arrays laid out like ``vit_tpu``'s Flax params:

* ``vit.embeddings.cls_token`` / ``position_embeddings`` <- ``embeddings/...``
* ``vit.embeddings.patch_embeddings.projection.*`` <- ``embeddings/patch_embeddings/
  projection`` (Linear kernel (in, out) -> weight (out, in); Conv1d kernel
  (P, 1, H) -> weight (H, 1, P); the image family's Conv2d kernel (kh, kw,
  in, H) -> weight (H, in, kh, kw), as ``vit_tpu/train/torch_bridge.py:81-90``
  maps it), or ``embeddings/patch_embeddings`` itself, the dense embedding
  of an image model behind a patch-PCA preprocessor
* ``vit.encoder.layer.{i}.attention.attention.{query,key,value}.*`` <-
  ``encoder/layer_i/attention/{query,key,value}``
* ``vit.encoder.layer.{i}.attention.output.dense.*`` <- ``.../attention/out``
* ``vit.encoder.layer.{i}.{intermediate,output}.dense.*`` <- ``.../{intermediate,output}``
* an MoE layer (``model.moe_experts > 1``) instead of those two:
  ``vit.encoder.layer.{i}.moe.router.weight`` (E, D) and ``.bias`` (E,) <-
  ``.../moe/router/{kernel,bias}`` (kernel (D, E) transposed to torch's
  (out, in)), and ``vit.encoder.layer.{i}.moe.{wi,wi_bias,wo,wo_bias}``
  ((E, D, F), (E, F), (E, F, D), (E, D)) <- ``.../moe/{wi,wi_bias,wo,wo_bias}``
  as they are
* ``vit.encoder.layer.{i}.layernorm_{before,after}.*`` and ``vit.layernorm.*``
  <- LayerNorm ``scale``/``bias``
* ``classifier.*`` | ``regressor.*`` <- the task head
* ``preprocessor.linear.{weight,bias}`` <- ``preprocessor/{kernel,bias}``
  (``LinearPreprocessor``, ``PatchPCAProjector``);
  ``preprocessor.{q_lin,k_lin,v_lin}.weight`` <-
  ``preprocessor/{q_lin,k_lin,v_lin}`` (``PrefilledAttention``), those present

The MoE keys are the port's own: ``vit_tpu``'s HF export
(``to_torch_state_dict``) raises for an MoE model, and an MoE ``.pt`` of the
port is no HF ViT layout. A port ``state.pt`` of an MoE model loads back
with ``strict=True`` (``Predictor.from_checkpoint``, ``test --ckpt``).

:func:`from_flax_kpca_attention` maps the parameters of ``vit_tpu``'s
``KPCAWarmSelfAttention`` to the port's module of that name
(:mod:`vit_tpu_torch.prepca.attention`): ``{q_adapter,k_adapter,v_proj,
out_proj}.{weight,bias}`` <- ``{q_adapter,k_adapter,v_proj,out_proj}/
{kernel,bias}``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["from_flax_params", "from_flax_kpca_attention", "load_torch_checkpoint",
           "save_torch_checkpoint"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True, order="C"))


def _dense(prefix: str, node: dict, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(node["kernel"]).T)
    if "bias" in node:
        out[f"{prefix}.bias"] = _t(node["bias"])


def _ln(prefix: str, node: dict, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(node["scale"])
    out[f"{prefix}.bias"] = _t(node["bias"])


def from_flax_params(params: Dict[str, Any], vit_config) -> Dict[str, torch.Tensor]:
    """Flax-layout param tree (numpy leaves) -> the port's ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    emb = params["embeddings"]
    out["vit.embeddings.cls_token"] = _t(emb["cls_token"])
    if "position_embeddings" in emb:
        out["vit.embeddings.position_embeddings"] = _t(emb["position_embeddings"])
    proj = emb["patch_embeddings"]
    proj = proj.get("projection", proj)  # the image PCA model's bare Dense
    kernel = np.asarray(proj["kernel"])
    if kernel.ndim == 2:  # SW / Linear tokenizer, or the dense patch embedding
        out["vit.embeddings.patch_embeddings.projection.weight"] = _t(kernel.T)
    elif kernel.ndim == 3:  # Conv1d: flax (P, in, H) -> torch (H, in, P)
        out["vit.embeddings.patch_embeddings.projection.weight"] = _t(kernel.transpose(2, 1, 0))
    else:  # Conv2d: flax (kh, kw, in, H) -> torch (H, in, kh, kw)
        out["vit.embeddings.patch_embeddings.projection.weight"] = _t(
            kernel.transpose(3, 2, 0, 1))
    if "bias" in proj:
        out["vit.embeddings.patch_embeddings.projection.bias"] = _t(proj["bias"])

    for i in range(vit_config.num_hidden_layers):
        layer = params["encoder"][f"layer_{i}"]
        tp = f"vit.encoder.layer.{i}"
        attn = layer["attention"]
        for name in ("query", "key", "value"):
            _dense(f"{tp}.attention.attention.{name}", attn[name], out)
        _dense(f"{tp}.attention.output.dense", attn["out"], out)
        if "moe" in layer:
            moe = layer["moe"]
            _dense(f"{tp}.moe.router", moe["router"], out)
            for name in ("wi", "wi_bias", "wo", "wo_bias"):
                out[f"{tp}.moe.{name}"] = _t(moe[name])
        else:
            _dense(f"{tp}.intermediate.dense", layer["intermediate"], out)
            _dense(f"{tp}.output.dense", layer["output"], out)
        _ln(f"{tp}.layernorm_before", layer["layernorm_before"], out)
        _ln(f"{tp}.layernorm_after", layer["layernorm_after"], out)
    _ln("vit.layernorm", params["layernorm"], out)
    head_name = "classifier" if vit_config.task_type == "cls" else "regressor"
    _dense(head_name, params[head_name], out)
    if "preprocessor" in params:
        pre = params["preprocessor"]
        if "kernel" in pre:  # LinearPreprocessor
            _dense("preprocessor.linear", pre, out)
        else:  # PrefilledAttention
            for name in ("q_lin", "k_lin", "v_lin"):
                if name in pre:
                    _dense(f"preprocessor.{name}", pre[name], out)
    return out


def from_flax_kpca_attention(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``KPCAWarmSelfAttention`` params (numpy leaves, with or without
    the outer ``params`` level) -> the port module's ``state_dict``: each
    Dense kernel (in, out) becomes an ``nn.Linear`` weight (out, in)."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for name in ("q_adapter", "k_adapter", "v_proj", "out_proj"):
        _dense(name, params[name], out)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pt``/``.ckpt`` state dict: strips a Lightning ``state_dict``
    wrapper and the reference's ``model.`` key prefix."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    if raw and all(k.startswith("model.") for k in raw):
        raw = {k[len("model."):]: v for k, v in raw.items()}
    return raw


def save_torch_checkpoint(module: torch.nn.Module, path: str) -> str:
    """Write ``module``'s state dict (on the CPU) as a ``.pt`` file."""
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, path)
    return path
