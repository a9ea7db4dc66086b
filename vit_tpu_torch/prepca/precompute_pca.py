"""CLI: precompute a patch-level PCA basis and save it (port of
``vit_tpu/prepca/precompute_pca.py``, the same flags and artifact).

PCA over the length-``--patch-size`` windows of HDF5 spectra (``--data``),
or over the ``P x P x C`` patches of an ``.npz`` of NHWC images
(``--images``), on ``--device`` (default ``cuda``). Saves ``{U, V, S, mean,
explained_variance_ratio, patch_size, step, num_patches}`` to
``$PCA_DIR/pca_patch_{P}_s{S}.npz`` (``--out`` names another file under
``$PCA_DIR``, or an absolute path; ``.pt`` writes a torch file), with
``--plot`` the singular values and the top-10 components as PNGs.

Example:
  python -m vit_tpu_torch.prepca.precompute_pca --patch-size 32 --step 32 --device cuda
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from vit_tpu_torch.data.hdf5 import load_spectra
from vit_tpu_torch.prepca.pipeline import compute_patch_pca_images, compute_pca
from vit_tpu_torch.serve import resolve_device
from vit_tpu_torch.utils import seed_everything


def _plot(result: dict, out_path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    base = os.path.splitext(out_path)[0]
    plt.figure()
    plt.plot(result["singular_values"])
    plt.yscale("log")
    plt.title("PCA singular values")
    plt.tight_layout()
    plt.savefig(base + "_spectrum.png", dpi=150)
    plt.close()
    V = result["components"]
    plt.figure()
    for i in range(min(10, V.shape[1])):
        plt.plot(V[:, i] + 0.01 * i, label=f"PC{i + 1}")
    plt.title("Top PCA components (offset)")
    plt.tight_layout()
    plt.savefig(base + "_top10.png", dpi=150)
    plt.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=str, required=False,
                    default=os.environ.get("TRAIN_DIR", "./data") + "/dataset.h5",
                    help="Path to HDF5 with [N, L] spectra")
    ap.add_argument("--images", type=str, default=None,
                    help="npz with {images: NHWC} -> patch-level image PCA "
                         "(P x P x C patches) instead of 1-D spectra windows")
    ap.add_argument("--patch-size", type=int, required=True, help="Patch length (D)")
    ap.add_argument("--step", type=int, default=None,
                    help="Stride between windows (default=patch-size)")
    ap.add_argument("--limit", type=int, default=None, help="Limit number of spectra")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None,
                    help="Output name, prefixed with $PCA_DIR unless absolute; "
                         "default=pca_patch_{P}_s{S}.npz")
    ap.add_argument("--plot", action="store_true",
                    help="Save spectrum and top-component plots next to out")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    seed_everything(args.seed)
    if args.images:
        images = np.load(args.images)["images"]
        print(f"[PCA] Loaded images: {images.shape}")
        result = compute_patch_pca_images(images, patch_size=args.patch_size, limit=args.limit,
                                          device=device)
        result.setdefault("scores", np.zeros((0,), np.float32))
        step = int(result["patch_size"])
    else:
        flux = load_spectra(args.data, args.limit)["flux"]
        print(f"[PCA] Loaded flux: {flux.shape}")
        result = compute_pca(flux, patch_size=args.patch_size, step=args.step, limit=args.limit,
                             device=device)
        step = int(result["step"])
    patch_size = int(result["patch_size"])

    out_name = args.out or f"pca_patch_{patch_size}_s{step}.npz"
    out_path = os.path.join(os.environ.get("PCA_DIR", "./data/pca"), out_name)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    payload = {
        "U": result["scores"],
        "V": result["components"],
        "S": result["singular_values"],
        "mean": result["mean"],
        "explained_variance_ratio": result["explained_variance_ratio"],
        "patch_size": np.asarray(patch_size),
        "step": np.asarray(step),
        "num_patches": np.asarray(int(result["num_patches"])),
    }
    if out_path.endswith((".pt", ".pth")):
        torch.save({k: (torch.from_numpy(v) if v.ndim else int(v)) for k, v in payload.items()},
                   out_path)
    else:
        np.savez(out_path, **payload)
    print(f"[PCA] Saved PCA basis to {out_path} with V={result['components'].shape}")

    if args.plot:
        try:
            _plot(result, out_path)
            print(f"[PCA] Saved plots next to {out_path}")
        except ImportError as e:
            print(f"[PCA] Plotting skipped: {e}")


if __name__ == "__main__":
    main()
