"""GIF frame renderers and writer for training diagnostics (port of
``vit_tpu/viz/gif_maker.py``).

Per-epoch matplotlib figures rendered to PIL frames (prediction
distribution, activation statistics, attention heatmaps and analytics,
the CLS-embedding scatter with its umap -> t-SNE -> PCA fallback, embedding
collinearity), assembled into GIFs at train end. matplotlib, PIL, sklearn
and umap are imported only where a frame is drawn. :func:`activation_stats`
runs in torch on the tensor's own device, so the capture reduces the MLP
activations on the card before anything crosses to the host.
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "activation_stats",
    "fig_to_frame",
    "save_gif",
    "distribution_frame",
    "activation_frame",
    "attention_heatmap_frame",
    "attention_analytics_frame",
    "embedding_frame",
    "collinearity_frame",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def fig_to_frame(fig):
    """Render a matplotlib figure to a PIL RGB image and close it."""
    from PIL import Image

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=90)
    _plt().close(fig)
    buf.seek(0)
    return Image.open(buf).convert("RGB")


def save_gif(frames: List, path: str, duration: int = 500) -> Optional[str]:
    """Write frames to an animated GIF; returns the path (None if <1 frame)."""
    if not frames:
        return None
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    # Normalize frame sizes (matplotlib can vary by a pixel across epochs).
    w = min(f.width for f in frames)
    h = min(f.height for f in frames)
    frames = [f.crop((0, 0, w, h)) for f in frames]
    frames[0].save(
        path,
        save_all=True,
        append_images=frames[1:],
        duration=duration,
        loop=0,
        optimize=True,
    )
    return path


def _footer(fig, epoch: int, model_name: str) -> None:
    fig.text(0.99, 0.01, f"{model_name} — epoch {epoch}", ha="right", fontsize=7, alpha=0.6)


def distribution_frame(preds, labels, names, epoch: int, model_name: str = "",
                       bounds=None):
    """3-row scatter/residual/error figure for the epoch. ``bounds`` pins
    the true/pred axes so consecutive GIF frames are comparable."""
    from vit_tpu_torch.viz.viz_utils import multi_output_figure

    fig = multi_output_figure(
        preds, labels, names, title=f"epoch {epoch}", bounds=bounds
    )
    _footer(fig, epoch, model_name)
    return fig_to_frame(fig)


def activation_stats(flat, per_neuron) -> Dict[str, torch.Tensor]:
    """Activation health stats: mean, std, sparsity (|a| < 1e-6), dead
    neurons (std over rows < 1e-6) and saturation (|a| > 3 std), as 0-d
    tensors on the input's device. Population std (numpy's and jnp's
    ``ddof=0``). Takes tensors or numpy arrays."""
    flat, per_neuron = torch.as_tensor(flat), torch.as_tensor(per_neuron)
    std = flat.std(correction=0)
    return {
        "mean": flat.mean(),
        "std": std,
        "sparsity": (flat.abs() < 1e-6).float().mean(),
        "dead_frac": (per_neuron.std(dim=0, correction=0) < 1e-6).float().mean(),
        "sat_frac": (flat.abs() > 3 * (std + 1e-9)).float().mean(),
    }


def activation_frame(
    activations: Dict[str, dict], epoch: int, model_name: str = ""
):
    """Per-layer activation stats: mean±std, sparsity, dead/saturated, hist.

    ``activations``: layer -> stats dict from the on-device reduction
    (``viz.diagnostics.reduce_intermediates``): scalar ``mean/std/sparsity/
    dead_frac/sat_frac`` + 1-D ``sample`` for histograms. Raw arrays are
    also accepted (stats computed here) for standalone use.
    """
    plt = _plt()

    def stats_of(v):
        if isinstance(v, dict):
            return {k: (np.asarray(x) if k == "sample" else float(x)) for k, x in v.items()}
        arr = np.asarray(v)
        flat = arr.reshape(-1)
        out = {k: float(x) for k, x in
               activation_stats(flat, arr.reshape(-1, arr.shape[-1])).items()}
        out["sample"] = flat
        return out

    stats = {k: stats_of(v) for k, v in activations.items()}
    layers = list(stats.keys())
    n = max(1, len(layers))
    fig, axes = plt.subplots(2, 2, figsize=(10, 7))

    axes[0][0].errorbar(
        range(n),
        [stats[k]["mean"] for k in layers],
        yerr=[stats[k]["std"] for k in layers],
        fmt="o-",
    )
    axes[0][0].set_title("activation mean ± std")
    axes[0][0].set_xticks(range(n))
    axes[0][0].set_xticklabels(layers, rotation=30, fontsize=7)

    axes[0][1].plot(range(n), [stats[k]["sparsity"] for k in layers], "o-", label="sparsity")
    axes[0][1].plot(range(n), [stats[k]["dead_frac"] for k in layers], "s-", label="dead neurons")
    axes[0][1].set_ylim(0, 1)
    axes[0][1].legend(fontsize=8)
    axes[0][1].set_title("sparsity / dead fraction")

    axes[1][0].plot(range(n), [stats[k]["sat_frac"] for k in layers], "o-")
    axes[1][0].set_title("saturation fraction (>3 sigma)")

    for k in layers[:4]:
        axes[1][1].hist(stats[k]["sample"], bins=50, alpha=0.5, label=k, density=True)
    axes[1][1].legend(fontsize=7)
    axes[1][1].set_title("activation histograms (sampled)")

    fig.suptitle(f"activations — epoch {epoch}")
    fig.tight_layout()
    _footer(fig, epoch, model_name)
    return fig_to_frame(fig)


def attention_heatmap_frame(
    attn_probs: List[np.ndarray], epoch: int, model_name: str = "", max_heads: int = 8
):
    """Grid of batch-averaged per-layer/per-head attention heatmaps."""
    plt = _plt()
    n_layers = len(attn_probs)
    n_heads = min(max_heads, attn_probs[0].shape[0])
    fig, axes = plt.subplots(
        n_layers, n_heads, figsize=(2.2 * n_heads, 2.0 * n_layers), squeeze=False
    )
    for li in range(n_layers):
        for hi in range(n_heads):
            ax = axes[li][hi]
            ax.imshow(attn_probs[li][hi], aspect="auto", cmap="viridis")
            ax.set_xticks([])
            ax.set_yticks([])
            if li == 0:
                ax.set_title(f"head {hi}", fontsize=8)
            if hi == 0:
                ax.set_ylabel(f"layer {li}", fontsize=8)
    fig.suptitle(f"attention — epoch {epoch}")
    fig.tight_layout()
    _footer(fig, epoch, model_name)
    return fig_to_frame(fig)


def attention_analytics_frame(
    attn_probs: List[np.ndarray],
    entropy_history: List[float],
    epoch: int,
    model_name: str = "",
):
    """Entropy trend, per-layer/head entropy, CLS attention, distance profile."""
    plt = _plt()
    fig, axes = plt.subplots(2, 2, figsize=(10, 7))

    axes[0][0].plot(entropy_history, "o-")
    axes[0][0].set_title("mean attention entropy over epochs")
    axes[0][0].set_xlabel("logged epoch")

    ent = np.array(
        [
            [-(p[hi] * np.log(p[hi] + 1e-12)).sum(-1).mean() for hi in range(p.shape[0])]
            for p in attn_probs
        ]
    )  # (layers, heads)
    im = axes[0][1].imshow(ent, aspect="auto", cmap="magma")
    axes[0][1].set_title("entropy per layer/head")
    axes[0][1].set_xlabel("head")
    axes[0][1].set_ylabel("layer")
    fig.colorbar(im, ax=axes[0][1])

    # CLS-token attention to the sequence (layer-mean of head-mean)
    cls_attn = np.stack([p.mean(0)[0] for p in attn_probs])  # (layers, T)
    for li in range(cls_attn.shape[0]):
        axes[1][0].plot(cls_attn[li], lw=1, label=f"layer {li}")
    axes[1][0].set_title("CLS attention profile")
    axes[1][0].legend(fontsize=7)

    # attention-vs-distance profile (mean over layers/heads): the mean over
    # |i-j| == d is the mean of the two offset-d diagonals, O(T) per
    # sampled distance, plotted against the sampled distances themselves.
    p0 = np.mean([p.mean(0) for p in attn_probs], axis=0)  # (T, T)
    t = p0.shape[0]
    sampled = list(range(0, t, max(1, t // 64)))
    prof = [
        np.concatenate([np.diagonal(p0, d), np.diagonal(p0, -d)]).mean()
        if d else np.diagonal(p0).mean()
        for d in sampled
    ]
    axes[1][1].plot(sampled, prof)
    axes[1][1].set_xlabel("token distance")
    axes[1][1].set_title("attention vs token distance")

    fig.suptitle(f"attention analytics — epoch {epoch}")
    fig.tight_layout()
    _footer(fig, epoch, model_name)
    return fig_to_frame(fig)


def _embed_2d(x: np.ndarray, method: str = "umap") -> np.ndarray:
    """2-D embedding with graceful fallback: umap -> tsne -> pca.

    The fallback chain catches ANY failure, not just missing imports —
    e.g. t-SNE's ValueError when the capture cap leaves < 4 samples
    (long-sequence configs) must degrade to PCA, not abort the epoch's
    diagnostics (which would also drop that epoch's CKA metrics).
    """
    if x.shape[0] < 4:
        method = "pca"  # too few samples for neighbor-based embeddings
    if method == "umap":
        try:
            import umap

            return umap.UMAP(n_components=2).fit_transform(x)
        except Exception:
            method = "tsne"
    if method == "tsne":
        try:
            from sklearn.manifold import TSNE

            perplexity = min(30, max(2, x.shape[0] // 4))
            perplexity = min(perplexity, x.shape[0] - 1)
            return TSNE(n_components=2, perplexity=perplexity, init="pca").fit_transform(x)
        except Exception:
            method = "pca"
    # PCA fallback (always available)
    xc = x - x.mean(0)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    return xc @ vt[:2].T


def embedding_frame(
    cls_embed: np.ndarray,
    labels: np.ndarray,
    epoch: int,
    method: str = "umap",
    model_name: str = "",
):
    plt = _plt()
    z = _embed_2d(np.asarray(cls_embed, np.float64), method)
    c = np.asarray(labels).reshape(len(labels), -1)[:, 0]
    fig, ax = plt.subplots(figsize=(6, 5))
    sc = ax.scatter(z[:, 0], z[:, 1], c=c, s=10, cmap="viridis")
    fig.colorbar(sc, ax=ax, label="label")
    ax.set_title(f"CLS embedding ({method}) — epoch {epoch}")
    fig.tight_layout()
    _footer(fig, epoch, model_name)
    return fig_to_frame(fig)


def collinearity_frame(cls_embed: np.ndarray, epoch: int, model_name: str = ""):
    plt = _plt()
    x = np.asarray(cls_embed, np.float64)
    std = x.std(0)
    safe = np.where(std < 1e-9, 1.0, std)
    corr = np.corrcoef(((x - x.mean(0)) / safe).T)
    corr = np.nan_to_num(corr)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(corr, vmin=-1, vmax=1, cmap="RdBu_r")
    fig.colorbar(im, ax=ax)
    off = np.abs(corr - np.diag(np.diag(corr)))
    ax.set_title(
        f"embedding collinearity — epoch {epoch}\nmean |off-diag corr| = {off.mean():.3f}"
    )
    fig.tight_layout()
    _footer(fig, epoch, model_name)
    return fig_to_frame(fig)
