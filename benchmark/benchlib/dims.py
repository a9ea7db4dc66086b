"""The shapes and training settings a configuration dict resolves to,
worked out by the benchmark itself (the rules of the project's config
format: the ``vit-b16`` preset, the sliding-window patch count, the
attention route's crossover, the optimizer's defaults).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

PRESETS = {
    "vit-s16": dict(hidden_size=384, num_hidden_layers=12, num_attention_heads=6, patch_size=16),
    "vit-b16": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, patch_size=16),
    "vit-l16": dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, patch_size=16),
}
PRECISIONS = {"bf16": "bf16", "bfloat16": "bf16", "bf16-mixed": "bf16",
              "fp32": "fp32", "float32": "fp32", "32": "fp32"}


@dataclasses.dataclass(frozen=True)
class Dims:
    image: bool          # 2-D images (NHWC) or 1-D spectra
    length: int          # spectrum length or image side
    patch: int
    stride: int
    channels: int
    hidden: int
    layers: int
    heads: int
    inter: int
    labels: int
    learned_pos: bool
    task: str            # "reg" or "cls"
    precision: str       # "bf16" or "fp32"
    dropout: float       # embeddings, attention output and MLP output
    attn_dropout: float  # attention probabilities
    batch: int
    lr: float
    weight_decay: float
    grad_clip: float
    warmup_epochs: int

    @property
    def patches(self) -> int:
        if self.image:
            return (self.length // self.patch) ** 2
        return math.ceil((self.length - self.patch) / self.stride) + 1

    @property
    def seq(self) -> int:
        return self.patches + 1

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def flash(self) -> bool:
        """The attention route: the streaming kernels from T 1024 at head
        size 64 or more, the plain products below."""
        return self.seq >= 1024 and self.head_dim >= 64

    @property
    def patch_in(self) -> int:
        return self.patch * self.patch * self.channels if self.image else self.patch

    @property
    def sites(self) -> int:
        """Dropout seeds a training step draws: the embeddings', then three
        a layer (attention probabilities, attention output, MLP output)."""
        return 1 + 3 * self.layers

    def first_lr(self) -> float:
        """The learning rate of the first epoch's steps: the warm-up's
        factor 0.1 when there is one (every schedule of these
        configurations is flat within an epoch)."""
        return self.lr * (0.1 if self.warmup_epochs > 0 else 1.0)


def dims(config: Dict[str, Any]) -> Dims:
    m = dict(config["model"])
    for k, v in PRESETS.get(str(m.get("name", "")).lower(), {}).items():
        m.setdefault(k, v)
        m.setdefault("input_kind", "image")
    t = config.get("train", {}) or {}
    o = config.get("opt", {}) or {}
    w = config.get("warmup", {}) or {}
    image = m.get("input_kind") == "image"
    task = str(m.get("task_type", "cls")).lower()
    task = "cls" if task in ("cls", "class", "classification") else "reg"
    hidden = int(m["hidden_size"])
    patch = int(m["patch_size"])
    stride = int(m.get("stride_size") or 0) or int(float(m.get("stride_ratio", 1)) * patch)
    labels = int(m.get("num_labels", 1)) if task == "cls" else 1
    return Dims(
        image=image, length=int(m["image_size"]), patch=patch, stride=stride,
        channels=int(m.get("num_channels", 3 if image else 1)), hidden=hidden,
        layers=int(m["num_hidden_layers"]), heads=int(m["num_attention_heads"]),
        inter=int(m.get("intermediate_size", 4 * hidden)), labels=labels,
        learned_pos=(image and m.get("pos_encoding_type") != "rope")
        or m.get("pos_encoding_type") == "learned",
        task=task, precision=PRECISIONS[str(t.get("precision", "fp32")).lower()],
        dropout=float(m.get("hidden_dropout_prob", 0.1)),
        attn_dropout=float(m.get("attention_probs_dropout_prob", 0.1)),
        batch=int(t.get("batch_size", 64)),
        lr=float(o.get("lr", 1e-3)), weight_decay=float(o.get("weight_decay", 0.0) or 0.0),
        grad_clip=float(t.get("grad_clip", 0.5)), warmup_epochs=int(w.get("epochs", 0) or 0))


def param_shapes(d: Dims):
    """(name, shape) of every parameter, in the project's checkpoint layout
    (the HF ViT state-dict keys)."""
    h, i = d.hidden, d.inter
    proj = (h, d.channels, d.patch, d.patch) if d.image else (h, d.patch)
    out = [("vit.embeddings.cls_token", (1, 1, h))]
    if d.learned_pos:
        out.append(("vit.embeddings.position_embeddings", (1, d.seq, h)))
    out += [("vit.embeddings.patch_embeddings.projection.weight", proj),
            ("vit.embeddings.patch_embeddings.projection.bias", (h,))]
    for n in range(d.layers):
        p = f"vit.encoder.layer.{n}."
        out += [(p + "layernorm_before.weight", (h,)), (p + "layernorm_before.bias", (h,))]
        for k in ("query", "key", "value"):
            out += [(p + f"attention.attention.{k}.weight", (h, h)),
                    (p + f"attention.attention.{k}.bias", (h,))]
        out += [(p + "attention.output.dense.weight", (h, h)),
                (p + "attention.output.dense.bias", (h,)),
                (p + "layernorm_after.weight", (h,)), (p + "layernorm_after.bias", (h,)),
                (p + "intermediate.dense.weight", (i, h)), (p + "intermediate.dense.bias", (i,)),
                (p + "output.dense.weight", (h, i)), (p + "output.dense.bias", (h,))]
    head = "classifier" if d.task == "cls" else "regressor"
    out += [("vit.layernorm.weight", (h,)), ("vit.layernorm.bias", (h,)),
            (f"{head}.weight", (d.labels, h)), (f"{head}.bias", (d.labels,))]
    return out
