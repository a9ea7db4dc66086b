"""Per-epoch training diagnostics (GIFs) and the CKA layer-learning monitor
(port of ``vit_tpu/viz/diagnostics.py``).

The eval forward itself returns the diagnostics: ``SpecViT.forward`` fills
an explicit ``capture`` dict with attention probabilities, MLP activations,
per-layer CLS hidden states and the final CLS embedding
(``vit_tpu_torch/models/vit.py``). :func:`reduce_intermediates` shrinks
them on the device (batch-mean probabilities, activation stats and a sample
taken at ``vit_tpu``'s indices) before :func:`extract_diagnostics` copies
them to the host, so a long sequence's capture never moves a (B, T, I)
tensor to the host. The Experiment feeds the result to these monitors each
logging epoch; GIFs and PNGs are written at train end.

Frame deques are capped at 100; activations are subsampled by
``viz.sample_rate``; CKA(initial, current) per layer flags a layer at
>= 0.95 as not learning; outputs go under ``viz.save_dir`` and to W&B when
a live run exists.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from vit_tpu_torch.prepca.pipeline import compute_cka
from vit_tpu_torch.viz import gif_maker

__all__ = [
    "VizDiagnostics",
    "CKAMonitor",
    "extract_diagnostics",
    "reduce_intermediates",
    "capture_batch_cap",
    "capture_diagnostics",
    "cka_matrix",
]

MAX_ACT_SAMPLE = 65_536  # per-layer histogram sample cap (elements)


def capture_batch_cap(
    seq_len: int,
    num_heads: int,
    intermediate_size: int,
    budget_bytes: int = 512 * 1024**2,
) -> int:
    """Largest capture batch whose transient diagnostics fit the budget.

    The dominant capture tensors are the per-layer attention probabilities
    (B, H, T, T) and MLP activations (B, T, I), fp32; at stride-1 (~4k
    tokens) an uncapped ``num_viz_samples=256`` would need tens of GB. One
    layer's probabilities are live at a time (the forward keeps only their
    batch mean).
    """
    per_sample = 4 * (num_heads * seq_len * seq_len + seq_len * intermediate_size)
    return max(1, int(budget_bytes // max(1, per_sample)))


def reduce_intermediates(intermediates: dict, num_layers: int, sample_rate: float):
    """On-device reduction of the captured tree (``SpecViT.forward``'s
    ``capture`` dict).

    Shrinks what crosses to the host: attention probs are already batch
    mean (H, T, T); MLP activations (B, T, I) become per-layer scalar stats
    and a ``sample_rate`` subsample (at most MAX_ACT_SAMPLE) for histograms;
    CLS states pass through (small).
    """
    enc = intermediates.get("encoder", {})
    out = {"attn": [], "mlp": {}, "cls_hidden": {}}
    for i in range(num_layers):
        layer = enc.get(f"layer_{i}", {})
        probs = layer.get("attention", {}).get("attention_probs")
        if probs is not None:
            out["attn"].append(probs)
        act = layer.get("mlp_activation")
        if act is not None:
            flat = act.reshape(-1)
            n = flat.shape[0]
            k = max(1, min(int(n * sample_rate), MAX_ACT_SAMPLE))
            # Coprime-step gather, vit_tpu's indices: a plain stride aliases
            # with the neuron axis for power-of-two widths (flat[::stride]
            # would sample only a couple of neuron columns).
            step = 7_368_787  # prime
            while np.gcd(step, n) != 1:
                step += 1
            idx = torch.from_numpy(np.arange(k, dtype=np.int64) * step % n).to(flat.device)
            stats = gif_maker.activation_stats(flat, act.reshape(-1, act.shape[-1]))
            stats["sample"] = flat[idx]
            out["mlp"][f"layer_{i}"] = stats
        cls_h = enc.get(f"cls_hidden_{i}")
        if cls_h is not None:
            out["cls_hidden"][f"layer_{i}"] = cls_h
    out["cls_embedding"] = intermediates.get("cls_embedding")
    return out


@torch.no_grad()
def capture_diagnostics(module: torch.nn.Module, x: torch.Tensor, sample_rate: float):
    """One eval forward of ``x`` with capture, reduced on ``x``'s device and
    then copied to the host: ``(logits (B, num_labels) numpy, diagnostics)``.
    The module runs in eval mode and gets its previous mode back."""
    was_training = module.training
    module.eval()
    try:
        tree: dict = {}
        logits = module(x, capture=tree)
        reduced = reduce_intermediates(tree, module.cfg.num_hidden_layers, sample_rate)
    finally:
        module.train(was_training)
    return logits.float().cpu().numpy(), extract_diagnostics(reduced)


def cka_matrix(
    reps_a: Dict[str, np.ndarray],
    reps_b: Dict[str, np.ndarray],
    kernel: str = "linear",
) -> np.ndarray:
    """Full layer-by-layer CKA matrix between two sets of representations:
    entry (i, j) = CKA(a_i, b_j)."""
    a_keys, b_keys = list(reps_a), list(reps_b)
    out = np.zeros((len(a_keys), len(b_keys)))
    for i, ka in enumerate(a_keys):
        for j, kb in enumerate(b_keys):
            out[i, j] = compute_cka(reps_a[ka], reps_b[kb], kernel=kernel, debiased=False)
    return out

MAX_FRAMES = 100


def extract_diagnostics(reduced: dict, num_layers: int = 0) -> Dict[str, object]:
    """Copy the (already reduced) diagnostics to the host as fp32 numpy.

    Input = :func:`reduce_intermediates` output. Returns ``{attn:
    [per-layer (H, T, T) batch-mean], mlp: {layer: stats dict},
    cls_hidden: {layer: (B, D)}, cls_embedding: (B, D)}``.
    """
    del num_layers  # shape already resolved by reduce_intermediates

    def to_np(x):
        return None if x is None else x.detach().float().cpu().numpy()

    out: Dict[str, object] = {
        "attn": [to_np(a) for a in reduced.get("attn", [])],
        "mlp": {
            k: {s: to_np(v) for s, v in stats.items()}
            for k, stats in (reduced.get("mlp") or {}).items()
        },
        "cls_hidden": {k: to_np(v) for k, v in (reduced.get("cls_hidden") or {}).items()},
        "cls_embedding": to_np(reduced.get("cls_embedding")),
    }
    return out


class VizDiagnostics:
    """Builds per-epoch GIF frames from captured eval diagnostics."""

    def __init__(
        self,
        viz_cfg: dict,
        model_name: str = "model",
        param_names: Optional[List[str]] = None,
        denormalize=None,
        save_enabled: bool = True,
        label_bounds: Optional[List[tuple]] = None,
    ) -> None:
        self.cfg = viz_cfg or {}
        self.model_name = model_name
        self.param_names = param_names or []
        self.denormalize = denormalize or (lambda y: y)
        self.save_enabled = save_enabled
        # fixed denormalized axis bounds per output: GIF frames must not
        # wobble epoch-to-epoch; lazily
        # derived from the first epoch's labels when not provided
        self.label_bounds = label_bounds
        self.save_dir = os.path.join(
            self.cfg.get("save_dir", "./results/viz"), model_name
        )
        # sample_rate is consumed on-device by reduce_intermediates (the
        # Experiment reads it from the same viz config).
        self.sample_rate = float(self.cfg.get("sample_rate", 0.15))
        self.gif_duration = int(self.cfg.get("gif_duration", 500))
        self.embedding_method = self.cfg.get("embedding_method", "umap")

        self.frames: Dict[str, deque] = {
            k: deque(maxlen=MAX_FRAMES)
            for k in ("distribution", "activation", "attention", "attention_analytics",
                      "embedding", "collinearity")
        }
        self.entropy_history: List[float] = []

    def _want(self, key: str) -> bool:
        return bool(self.cfg.get(f"create_{key}_gif", True))

    def on_validation_epoch(
        self,
        epoch: int,
        preds: np.ndarray,
        labels: np.ndarray,
        diag: Dict[str, object],
    ) -> None:
        preds2 = np.reshape(preds, (len(preds), -1))
        labels2 = np.reshape(np.asarray(labels), (len(labels), -1))
        if preds2.shape[1] != labels2.shape[1]:
            # Classification: logits (n, C) vs integer labels (n,) — reduce
            # to predicted class ids so the per-output figures are
            # class-vs-class.
            preds = preds2.argmax(axis=1).astype(np.float64).reshape(-1, 1)
        names = self.param_names or [str(j) for j in range(np.reshape(preds, (len(preds), -1)).shape[1])]
        if self._want("distribution"):
            preds_d = self.denormalize(preds)
            labels_d = self.denormalize(labels)
            if self.label_bounds is None:
                from vit_tpu_torch.viz.viz_utils import label_axis_bounds

                # pin to the FIRST epoch's label range: labels are the same
                # val set every epoch, so this is constant across the GIF
                self.label_bounds = label_axis_bounds(labels_d)
            self.frames["distribution"].append(
                gif_maker.distribution_frame(
                    preds_d, labels_d, names, epoch, self.model_name,
                    bounds=self.label_bounds,
                )
            )
        mlp = diag.get("mlp") or {}
        if self._want("activation") and mlp:
            # per-layer stats + histogram samples, reduced on device
            self.frames["activation"].append(
                gif_maker.activation_frame(mlp, epoch, self.model_name)
            )
        attn = diag.get("attn") or []
        if self._want("attention") and attn:
            ent = float(
                np.mean([-(p * np.log(p + 1e-12)).sum(-1).mean() for p in attn])
            )
            self.entropy_history.append(ent)
            self.frames["attention"].append(
                gif_maker.attention_heatmap_frame(attn, epoch, self.model_name)
            )
            self.frames["attention_analytics"].append(
                gif_maker.attention_analytics_frame(
                    attn, self.entropy_history, epoch, self.model_name
                )
            )
        emb = diag.get("cls_embedding")
        if emb is not None:
            if self.cfg.get("create_embedding_gif", True):
                self.frames["embedding"].append(
                    gif_maker.embedding_frame(
                        emb, labels, epoch, self.embedding_method, self.model_name
                    )
                )
            if self._want("collinearity"):
                self.frames["collinearity"].append(
                    gif_maker.collinearity_frame(emb, epoch, self.model_name)
                )

    def on_train_end(self, logger=None) -> Dict[str, str]:
        """Write GIFs (+ final-frame PNGs); log to W&B when available.

        With ``train.save`` (or ``viz.save_local``) the artifacts land in
        ``viz.save_dir``; without it they go to a temporary directory only
        to feed the W&B upload, and are skipped when neither destination
        exists.
        """
        written: Dict[str, str] = {}
        wandb_run = getattr(logger, "_wandb", None) if logger is not None else None
        if not self.save_enabled and wandb_run is None:
            return written
        out_dir = self.save_dir
        if not self.save_enabled:
            import tempfile

            out_dir = tempfile.mkdtemp(prefix="vit_tpu_torch_viz_")
        os.makedirs(out_dir, exist_ok=True)
        for key, frames in self.frames.items():
            if not frames:
                continue
            path = os.path.join(out_dir, f"{key}.gif")
            gif_maker.save_gif(list(frames), path, duration=self.gif_duration)
            frames[-1].save(os.path.join(out_dir, f"{key}_final.png"))
            written[key] = path
            if wandb_run is not None:
                try:
                    import wandb

                    wandb_run.log({f"viz/{key}": wandb.Video(path)})
                except Exception as e:
                    print(f"[viz] wandb video upload skipped: {e}")
        if not self.save_enabled:
            # W&B-only: the tmp artifacts were consumed by the upload.
            import shutil

            shutil.rmtree(out_dir, ignore_errors=True)
            return {}
        if written:
            print(f"[viz] wrote {len(written)} GIFs to {out_dir}")
        return written


class CKAMonitor:
    """Diagonal CKA(initial, current) per layer: flags layers not learning."""

    def __init__(self, threshold: float = 0.95, max_samples: int = 500) -> None:
        self.threshold = threshold
        self.max_samples = max_samples
        self.initial: Optional[Dict[str, np.ndarray]] = None
        self.history: Dict[str, List[float]] = {}

    def _reps(self, diag: Dict[str, object]) -> Dict[str, np.ndarray]:
        reps = dict(diag.get("cls_hidden") or {})
        emb = diag.get("cls_embedding")
        if emb is not None:
            reps["cls_embedding"] = emb
        return {k: np.asarray(v)[: self.max_samples] for k, v in reps.items()}

    def on_validation_epoch(self, epoch: int, diag: Dict[str, object]) -> Dict[str, float]:
        reps = self._reps(diag)
        if not reps:
            return {}
        if self.initial is None:
            self.initial = reps
            # The first logged epoch reports CKA(init, init) = 1.0.
            out = {f"cka/{k}": 1.0 for k in reps}
            out["cka/mean"] = 1.0
            out["cka/unchanged_count"] = float(len(reps))
            return out
        out: Dict[str, float] = {}
        unchanged = 0
        for name, cur in reps.items():
            init = self.initial.get(name)
            if init is None or init.shape != cur.shape:
                continue
            v = float(compute_cka(init, cur, debiased=False))
            out[f"cka/{name}"] = v
            self.history.setdefault(name, []).append(v)
            if v >= self.threshold:
                unchanged += 1
        if out:
            vals = [v for k, v in out.items()]
            out["cka/mean"] = float(np.mean(vals))
            out["cka/unchanged_count"] = float(unchanged)
        return out

    def on_train_end(self, save_dir: Optional[str] = None, logger=None) -> None:
        if not self.history:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(11, 4))
        for name, vals in self.history.items():
            axes[0].plot(vals, label=name, lw=1)
        axes[0].axhline(self.threshold, color="r", ls="--", lw=1)
        axes[0].set_title("CKA(initial, current) evolution")
        axes[0].set_xlabel("logged epoch")
        axes[0].legend(fontsize=7)
        finals = {k: v[-1] for k, v in self.history.items()}
        axes[1].barh(list(finals.keys()), list(finals.values()))
        axes[1].axvline(self.threshold, color="r", ls="--", lw=1)
        axes[1].set_title("final CKA per layer (>=0.95 ~ not learning)")
        fig.tight_layout()
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            fig.savefig(os.path.join(save_dir, "cka_report.png"), dpi=110)
        wandb_run = getattr(logger, "_wandb", None) if logger is not None else None
        if wandb_run is not None:
            import wandb

            wandb_run.log({"viz/cka_report": wandb.Image(fig)})
        plt.close(fig)
