"""Batch inference (port of ``vit_tpu/serve.py::Predictor``).

Load a config and a torch ``.pt`` checkpoint, run batched prediction on the
card with fixed batch shapes (the last batch padded by repeating its final
row), and return *denormalised* stellar parameters for regression or class
ids / probabilities for classification. The label statistics come from the
checkpoint's ``meta.yaml`` or are passed to :class:`Predictor` directly.

The device is explicit: ``device="cuda"`` (the default) raises when CUDA is
absent; pass ``device="cpu"`` to run on the CPU. A model with a covariance
preprocessor takes raw spectra of the eigenvector rows' length
(:attr:`Predictor.input_length`), not the builder's adjusted
``model.image_size`` (``vit_tpu/serve.py:300-308``); an image model takes
(N, S, S, C) images (NHWC, or NCHW), with or without its patch-PCA
preprocessor.

``quantize`` (``vit_tpu/serve.py:141-221``): ``"int8-w8a8"`` (int8
activations and weights, ``torch._int_mm``), ``"int8-wo"`` (int8 weights,
the product in the compute dtype) or ``"int8"``, which routes as
``vit_tpu`` does: W8A8 with a ``calibration`` batch (static activation
scales) or below :data:`~vit_tpu_torch.ops.quant.W8A8_WO_BATCH_THRESHOLD`,
weight-only at or above it. The quantized layers' fp32 weights are
stripped from the device (:mod:`vit_tpu_torch.ops.quant`).
:meth:`Predictor.export` writes a ``torch.export`` artifact that
:func:`vit_tpu_torch.export.load_exported` serves without model code.

``num_devices=N > 1`` (``vit_tpu/serve.py:106-125``, data-parallel
serving): one process holds a replica of the model (and of its int8 table)
on each of ``cuda:0 .. cuda:N-1``; each batch's rows are split into N
equal blocks, as ``vit_tpu``'s ``data`` axis splits them, run on their
cards and returned in order. It raises as ``vit_tpu`` does when N exceeds
the devices present (a CPU predictor has one), or when the batch size does
not divide by N.

Example::

    from vit_tpu_torch.serve import Predictor
    p = Predictor.from_checkpoint("configs/exp/att_clp/stride1.yaml", ckpt="model.pt")
    params = p.predict(spectra)          # (N, num_labels), physical units
"""

from __future__ import annotations

import copy
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["Predictor", "resolve_device", "serving_devices"]

QUANTIZE_MODES = (None, "int8", "int8-w8a8", "int8-wo")


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``; raises for CUDA when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available; pass device='cpu' "
            "to run on the CPU"
        )
    return dev


def serving_devices(device: torch.device, n: int) -> list:
    """The devices of ``n`` serving replicas beside ``device``: ``cuda:0 ..
    cuda:n-1`` (a CPU predictor has one device)."""
    avail = torch.cuda.device_count() if device.type == "cuda" else 1
    if n > avail:
        raise ValueError(f"num_devices={n} requested but only {avail} devices are available")
    return [torch.device(device.type, i) if device.type == "cuda" else device
            for i in range(n)]


def _to(obj, device):
    """A nest of dicts, lists and tuples with its tensors on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, device) for v in obj)
    return obj


def _check_quantize_mode(quantize: Optional[str]) -> None:
    if quantize not in QUANTIZE_MODES:
        raise ValueError(
            f"Unsupported quantize mode '{quantize}' "
            "(expected None, 'int8', 'int8-w8a8', or 'int8-wo')"
        )


class Predictor:
    def __init__(
        self,
        module: torch.nn.Module,
        vit_config,
        label_norm: str = "none",
        label_norm_stats: Optional[dict] = None,
        batch_size: int = 256,
        quantize: Optional[str] = None,
        calibration=None,
        num_devices: Optional[int] = None,
        input_shape: Optional[tuple] = None,
    ) -> None:
        _check_quantize_mode(quantize)
        self.module = module.eval()
        self.vit_config = vit_config
        self.quantize = quantize
        self.device = next(module.parameters()).device
        # Per-input shape (no batch axis): recorded by from_checkpoint, what
        # export needs for its static batch shape.
        self.input_shape = tuple(input_shape) if input_shape else None
        # Raw spectrum length: a preprocessor's input dimension when there is
        # one; an image model takes (S, S, C) images (NHWC, or NCHW).
        self.input_length = int(getattr(module, "input_length", vit_config.image_size))
        self.image_shapes = None
        if vit_config.input_kind == "image":
            s_, c_ = vit_config.image_size, vit_config.num_channels
            self.image_shapes = ((s_, s_, c_), (c_, s_, s_))
        self.label_norm = label_norm or "none"
        self.label_norm_stats = {
            k: (None if v is None else np.asarray(v, np.float64))
            for k, v in (label_norm_stats or {}).items()
        }
        self.batch_size = int(batch_size)
        if (
            self.label_norm != "none"
            and getattr(vit_config, "task_type", "reg") != "cls"
            and not any(v is not None for v in self.label_norm_stats.values())
        ):
            print(
                f"[serve] label_norm='{self.label_norm}' but no normalization "
                "stats were found in checkpoint meta — predictions will be "
                "returned in NORMALIZED units"
            )
        self.quant_variant = None
        self._qtable = None
        devices = None
        if num_devices is not None and num_devices > 1:
            devices = serving_devices(self.device, int(num_devices))
            if self.batch_size % len(devices):
                raise ValueError(f"serving batch_size {self.batch_size} must divide by the "
                                 f"data-parallel degree {len(devices)}")
        if quantize is not None:
            self._quantize(quantize, calibration)
        # (module, int8 table, device) of each replica; the first is this one.
        self.replicas = [(self.module, self._qtable, self.device)]
        for dev in (devices or [])[1:]:
            self.replicas.append((copy.deepcopy(self.module).to(dev), _to(self._qtable, dev),
                                  dev))

    def _quantize(self, quantize: str, calibration) -> None:
        """Build the int8 table, strip the fp32 weights it replaces, pick the
        variant and, for W8A8 with a calibration batch, its static scales."""
        from vit_tpu_torch.ops.quant import (
            W8A8_WO_BATCH_THRESHOLD,
            calibrate_activation_scales,
            quantize_dense_params,
            strip_quantized,
        )

        vc = self.vit_config
        if getattr(vc, "fused_mlp", False) or getattr(vc, "fused_qkv", False):
            # The fused MLP and fused QKV read their weights directly, not
            # through Linear.forward: the int8 table would never be used
            # and the stripped weights would be.
            raise ValueError(
                "quantize requires the unfused Dense paths: rebuild the "
                "module with model.fused_mlp=False and "
                "model.fused_qkv=False (identical math)"
            )
        self._qtable = quantize_dense_params(self.module)
        if not self._qtable:
            # Every Linear below min_fan_in (or excluded): serving stays fp32.
            print(
                f"[serve] quantize='{quantize}' matched no layers "
                "(no Dense kernel with fan-in >= 64) — serving "
                "UNQUANTIZED at full resident size"
            )
        strip_quantized(self.module, self._qtable)
        weight_only = quantize == "int8-wo" or (
            quantize == "int8"
            and calibration is None
            and self.batch_size >= W8A8_WO_BATCH_THRESHOLD
        )
        self.quant_variant = "int8-wo" if weight_only else "int8-w8a8"
        if calibration is not None and not weight_only and self._qtable:
            calib = np.ascontiguousarray(np.asarray(calibration, np.float32)[: self.batch_size])
            self._qtable = calibrate_activation_scales(
                self.module, self._qtable, torch.from_numpy(calib).to(self.device))

    def _forward(self, x: torch.Tensor, qtable: Optional[dict] = None,
                 module: Optional[torch.nn.Module] = None) -> torch.Tensor:
        """One batch through the model (default the predictor's own),
        quantized by ``qtable`` (default the predictor's) where it has one:
        the forward both the live predictor and an exported artifact run."""
        qtable = self._qtable if qtable is None else qtable
        module = self.module if module is None else module
        if not qtable:
            return module(x)
        from vit_tpu_torch.ops.quant import quantized_apply

        return quantized_apply(module, qtable, x, weight_only=self.quant_variant == "int8-wo")

    def _replicated_logits(self, chunk: np.ndarray) -> np.ndarray:
        """One batch's logits, its rows split over the replicas in order."""
        if len(self.replicas) == 1:
            return self._forward(torch.from_numpy(chunk).to(self.device)).float().cpu().numpy()
        parts = np.split(chunk, len(self.replicas))
        outs = [self._forward(torch.from_numpy(part).to(dev), table, module)
                for part, (module, table, dev) in zip(parts, self.replicas)]
        return np.concatenate([o.float().cpu().numpy() for o in outs])

    @classmethod
    def from_checkpoint(
        cls,
        config: Union[str, dict],
        ckpt: str = "best",
        batch_size: int = 256,
        precision: Optional[str] = None,
        quantize: Optional[str] = None,
        calibration=None,
        perf_preset: bool = False,
        num_devices: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> "Predictor":
        """Build from a YAML config (path or dict) and a torch ``.pt``/``.pth``/
        ``.ckpt`` state dict, or ``"best"``/``"last"`` of the port's own
        training run under ``$CKPT_DIR/<model_name>/``, on ``device``.

        ``precision``: compute dtype override (e.g. ``"bf16"``); parameters
        stay fp32. ``perf_preset=True``: bf16 (unless ``precision`` is given)
        + tanh GELU + bf16 softmax accumulation, as in ``vit_tpu``.
        ``quantize``: ``"int8"`` | ``"int8-w8a8"`` | ``"int8-wo"`` (the model
        is rebuilt with ``fused_mlp`` and ``fused_qkv`` off, identical math);
        ``calibration``: representative inputs, of which the first
        ``batch_size`` give W8A8 its static activation scales.
        """
        from vit_tpu_torch.config import load_config
        from vit_tpu_torch.models.builder import get_model
        from vit_tpu_torch.train.checkpoint import (
            ORBAX_HINT,
            CheckpointManager,
            default_ckpt_dir,
            read_meta,
        )
        from vit_tpu_torch.train.torch_bridge import load_torch_checkpoint

        # Fail fast on a bad mode, before the model is built.
        _check_quantize_mode(quantize)
        dev = resolve_device(device)
        own = str(ckpt) in ("best", "last")
        if not own and not str(ckpt).endswith((".pt", ".pth", ".ckpt")):
            raise ValueError(f"ckpt={ckpt!r}: {ORBAX_HINT}")
        # A copy: the builder adjusts model.image_size in place for a preprocessor.
        cfg = load_config(config) if isinstance(config, str) else copy.deepcopy(config)
        if perf_preset:
            if precision is None:
                precision = "bf16"
            cfg = dict(cfg, model=dict(cfg.get("model", {}) or {},
                                       gelu_approximate=True, softmax_dtype="bfloat16"))
        if precision is not None:
            cfg = dict(cfg, train=dict(cfg.get("train", {}) or {}, precision=precision))
        if (cfg.get("model", {}) or {}).get("attn_impl") == "ring":
            # Sequence parallelism is a training-mesh concern; serving runs
            # the numerically identical single-device xla path.
            cfg = dict(cfg, model=dict(cfg["model"], attn_impl="xla"))
        mcfg = cfg.get("model", {}) or {}
        if quantize is not None and (mcfg.get("fused_mlp") or mcfg.get("fused_qkv")):
            # Both read their weights directly, past the Linear interception
            # that int8 serving hooks: serve the identical-math unfused layers.
            cfg = dict(cfg, model=dict(cfg["model"], fused_mlp=False, fused_qkv=False))
        bundle = get_model(cfg)
        meta = read_meta(default_ckpt_dir(), bundle.model_name)
        if own:
            try:
                ckpt = CheckpointManager(default_ckpt_dir(), bundle.model_name,
                                         enabled=False).resolve(str(ckpt))
            except FileNotFoundError as e:  # e.g. an orbax run of vit_tpu
                raise ValueError(f"ckpt={ckpt!r}: {e}; {ORBAX_HINT}") from None
        bundle.module.load_state_dict(load_torch_checkpoint(str(ckpt)), strict=True)
        vc = bundle.vit_config
        if vc.input_kind == "image":
            input_shape = (vc.image_size, vc.image_size, vc.num_channels)
        else:
            input_shape = (int(getattr(bundle.module, "input_length", vc.image_size)),)
        return cls(
            bundle.module.to(dev),
            bundle.vit_config,
            label_norm=meta.get("label_norm", (cfg.get("data", {}) or {}).get("label_norm", "none")),
            label_norm_stats=meta.get("label_norm_stats"),
            batch_size=batch_size,
            quantize=quantize,
            calibration=calibration,
            num_devices=num_devices,
            input_shape=input_shape,
        )

    def export(self, path: str, input_shape=None) -> dict:
        """Write a self-contained serving artifact (a ``torch.export``
        program: weights, int8 table and denormalisation inside) that
        :func:`vit_tpu_torch.export.load_exported` serves without model code."""
        from vit_tpu_torch.export import export_predictor

        return export_predictor(self, path, input_shape=input_shape)

    # -- inference -----------------------------------------------------------
    @torch.inference_mode()
    def _batched_logits(self, x: np.ndarray) -> np.ndarray:
        n = len(x)
        if n == 0:
            return np.zeros((0, int(self.vit_config.num_labels)), np.float32)
        if self.image_shapes is not None:
            if tuple(x.shape[1:]) not in self.image_shapes:
                raise ValueError(f"images of shape {tuple(x.shape[1:])}, but the model takes "
                                 f"{self.image_shapes[0]} (NHWC) or {self.image_shapes[1]}")
        elif x.shape[-1] != self.input_length:
            raise ValueError(f"spectra of length {x.shape[-1]}, but the model takes "
                             f"{self.input_length}")
        bs = self.batch_size
        outs = []
        for i in range(0, n, bs):
            chunk = x[i : i + bs]
            pad = bs - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
            logits = self._replicated_logits(chunk)
            outs.append(logits[: bs - pad] if pad else logits)
        return np.concatenate(outs)

    def _denormalize(self, y: np.ndarray) -> np.ndarray:
        from vit_tpu_torch.viz.viz_utils import denormalize

        s = self.label_norm_stats
        return denormalize(
            y, self.label_norm,
            label_mean=s.get("label_mean"), label_std=s.get("label_std"),
            label_min=s.get("label_min"), label_max=s.get("label_max"),
        )

    def predict(self, x: np.ndarray) -> np.ndarray:
        """reg: denormalised parameters (N, num_labels); cls: class ids (N,)."""
        logits = self._batched_logits(np.ascontiguousarray(x, np.float32))
        if self.vit_config.task_type == "cls":
            return logits.argmax(axis=-1)
        return self._denormalize(logits)

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        """Classification: softmax probabilities (N, num_classes)."""
        if self.vit_config.task_type != "cls":
            raise ValueError("predict_proba is only defined for classification")
        logits = self._batched_logits(np.ascontiguousarray(x, np.float32))
        z = logits - logits.max(axis=-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=-1, keepdims=True)
