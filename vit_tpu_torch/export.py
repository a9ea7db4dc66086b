"""Serving artifacts: export once, serve without model code (port of ``vit_tpu/export.py``).

:func:`export_predictor` writes a :class:`~vit_tpu_torch.serve.Predictor`'s
forward as one ``torch.export`` program: the weights, the int8 table when
the predictor is quantized, and the label denormalisation are all inside,
at the predictor's static batch shape. A serving host loads it with
:func:`load_exported` and needs torch and this module only: no config, no
checkpoint and no ``vit_tpu_torch.models``. The program keeps the
hand-written kernels the served forward launches, K1, K2 and K3, as
opaque custom operators (``torch.ops.vit_tpu_torch.flash_fwd``,
``short_fwd``, ``fused_mlp_fwd``); importing this module registers them,
so the loaded program launches the same kernels, built from the package's
``csrc/`` at first use, and on the CPU their plain versions.

File format: ``MAGIC``, a 4-byte little-endian header length, a JSON
header, then the ``torch.export.save`` blob::

    VITTXPT1\\n <u32 len> {"format": 1, "task_type": ..., "device": ...} <blob>

The magic is the port's own, so ``vit_tpu``'s loader and this one each
refuse the other's artifact at the first bytes. The header records the
device type the program was exported on; :func:`load_exported` refuses
another, as ``jax.export``'s platform check does.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# The operators of the served kernels: registered on import.
import vit_tpu_torch.ops.flash_attention  # noqa: F401
import vit_tpu_torch.ops.fused_mlp  # noqa: F401

__all__ = ["export_predictor", "load_exported", "ExportedPredictor", "MAGIC"]

MAGIC = b"VITTXPT1\n"
_FORMAT = 1
# A real header is under 1 KB: a longer length means the 4 bytes are
# garbage (a truncated or corrupt file), so fail instead of a huge read.
_MAX_HEADER = 1 << 20


def _denorm_fn(label_norm: str, stats: dict) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """fp32 ``(mul, add)`` with ``y * mul + add`` the denormalisation of
    ``viz_utils.denormalize``, or None where the kind or the stats do not
    give one (``vit_tpu/export.py::_denorm_fn``)."""
    kind = (label_norm or "none").lower()
    eps = 1e-8
    if kind in ("standard", "zscore"):
        mean, std = stats.get("label_mean"), stats.get("label_std")
        if mean is None or std is None:
            return None
        mul = torch.as_tensor(np.asarray(std, np.float32))
        add = torch.as_tensor(np.asarray(mean, np.float32))
    elif kind == "minmax":
        lo, hi = stats.get("label_min"), stats.get("label_max")
        if lo is None or hi is None:
            return None
        add = torch.as_tensor(np.asarray(lo, np.float32))
        mul = torch.as_tensor(np.asarray(hi, np.float32)) - add
    else:
        return None
    mul = torch.where(mul.abs() < eps, torch.ones_like(mul), mul)
    return mul, add


class _Served(torch.nn.Module):
    """What the artifact computes: the predictor's forward on one batch
    (its model, its int8 table as buffers), then the denormalisation."""

    def __init__(self, predictor, denorm) -> None:
        super().__init__()
        self.predictor = predictor
        self.model = predictor.module
        self.names = list(predictor._qtable or {})
        for i, name in enumerate(self.names):
            for key, t in predictor._qtable[name].items():
                if t is not None:
                    self.register_buffer(f"q{i}_{key}", t)
        self.denorm = denorm is not None
        if denorm is not None:
            self.register_buffer("mul", denorm[0].to(predictor.device))
            self.register_buffer("add", denorm[1].to(predictor.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The table from this module's buffers, which the trace follows.
        keys = ("wq", "scale", "bias", "sx")
        table = {name: {k: getattr(self, f"q{i}_{k}", None) for k in keys}
                 for i, name in enumerate(self.names)}
        y = self.predictor._forward(x, table).float()
        return y * self.mul + self.add if self.denorm else y


def export_predictor(predictor, path: str, input_shape: Optional[Sequence[int]] = None) -> dict:
    """Export ``predictor``'s forward to ``path``; returns the header.

    ``input_shape``: the per-input shape (no batch axis); by default the one
    ``Predictor.from_checkpoint`` records. The artifact's batch size is the
    predictor's, its device the predictor's.
    """
    shape = tuple(input_shape or getattr(predictor, "input_shape", None) or ())
    if not shape:
        raise ValueError(
            "input_shape is required for directly-constructed Predictors "
            "(from_checkpoint records it automatically)"
        )
    vc = predictor.vit_config
    task_type = getattr(vc, "task_type", "reg")
    denorm = None
    if task_type != "cls":
        denorm = _denorm_fn(predictor.label_norm, predictor.label_norm_stats)
    served = _Served(predictor, denorm).eval()
    example = torch.zeros((predictor.batch_size,) + shape, dtype=torch.float32,
                          device=predictor.device)
    # No gradient: the served forward takes its inference route, whose
    # kernels are the custom operators.
    with torch.no_grad():
        program = torch.export.export(served, (example,), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    header = {
        "format": _FORMAT,
        "task_type": task_type,
        "batch_size": int(predictor.batch_size),
        "input_shape": list(shape),
        "num_labels": int(getattr(vc, "num_labels", 1)),
        "label_norm": predictor.label_norm,
        "denormalized": denorm is not None,
        "quantize": predictor.quantize,
        "quant_variant": predictor.quant_variant,
        "device": predictor.device.type,
    }
    hjson = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(hjson)))
        f.write(hjson)
        f.write(buf.getvalue())
    return header


class ExportedPredictor:
    """Serve an artifact of :func:`export_predictor` (no model code needed)."""

    def __init__(self, header: dict, program, device: torch.device) -> None:
        self.header = header
        self.program = program
        self._fn = program.module()
        self.device = device
        self.batch_size = int(header["batch_size"])
        self.task_type = header["task_type"]
        self.input_shape: Tuple[int, ...] = tuple(header["input_shape"])

    @torch.inference_mode()
    def _batched(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        if x.shape[1:] != self.input_shape:
            raise ValueError(f"input shape {x.shape[1:]} != exported {self.input_shape}")
        n, bs = len(x), self.batch_size
        if n == 0:
            return np.zeros((0, int(self.header["num_labels"])), np.float32)
        outs = []
        for i in range(0, n, bs):
            chunk = x[i : i + bs]
            pad = bs - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
            out = self._fn(torch.from_numpy(chunk).to(self.device)).cpu().numpy()
            outs.append(out[: bs - pad] if pad else out)
        return np.concatenate(outs)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """reg: physical-unit predictions (the denormalisation is inside the
        artifact); cls: class ids."""
        out = self._batched(x)
        if self.task_type == "cls":
            return out.argmax(axis=-1)
        return out

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        if self.task_type != "cls":
            raise ValueError("predict_proba is only defined for classification")
        logits = self._batched(x)
        z = logits - logits.max(axis=-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=-1, keepdims=True)


def load_exported(path: str, device="cuda") -> ExportedPredictor:
    """Load an artifact of :func:`export_predictor` to serve on ``device``
    (default the card; ``"cpu"`` for the CPU), which must be of the device
    type it was exported on.

    Raises ``ValueError`` naming ``path`` for anything that is not a
    well-formed artifact: bad magic, truncation, a corrupt header, an
    unknown format, another device type.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but CUDA is not available; pass "
                           "device='cpu' to serve a CPU artifact on the CPU")
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a vit_tpu_torch export (bad magic {magic!r})")
        lenbytes = f.read(4)
        if len(lenbytes) != 4:
            raise ValueError(f"{path}: truncated vit_tpu_torch export (no header length)")
        (hlen,) = struct.unpack("<I", lenbytes)
        if hlen == 0 or hlen > _MAX_HEADER:
            raise ValueError(f"{path}: corrupt vit_tpu_torch export (header length {hlen})")
        hraw = f.read(hlen)
        if len(hraw) != hlen:
            raise ValueError(f"{path}: truncated vit_tpu_torch export (short header)")
        try:
            header = json.loads(hraw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: corrupt vit_tpu_torch export header ({e})") from e
        if header.get("format") != _FORMAT:
            raise ValueError(f"{path}: unsupported format {header.get('format')}")
        if header.get("device") != dev.type:
            raise ValueError(f"{path}: exported for device type {header.get('device')!r}, "
                             f"asked to serve on {dev.type!r}")
        blob = f.read()
    program = torch.export.load(io.BytesIO(blob))
    if (
        header.get("task_type") == "reg"
        and (header.get("label_norm") or "none").lower() != "none"
        and not header.get("denormalized", False)
    ):
        print(
            f"[vit_tpu_torch.export] WARNING: {path} was exported without label "
            f"denormalization stats (label_norm={header.get('label_norm')!r}); "
            "predictions are in NORMALIZED units, not physical units."
        )
    return ExportedPredictor(header, program, dev)
