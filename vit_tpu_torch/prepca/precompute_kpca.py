"""CLI: precompute a Nyström kernel-PCA state and save it (port of
``vit_tpu/prepca/precompute_kpca.py``, the same flags and artifact, plus
``--device``, default ``cuda``).

Example:
  python -m vit_tpu_torch.prepca.precompute_kpca \\
      --data /path/to/dataset.h5 --r 64 --landmarks 2048 \\
      --kernel rbf --gamma auto --out /path/to/kpca_state.npz --device cuda
"""

from __future__ import annotations

import argparse
import os

from vit_tpu_torch.data.hdf5 import load_spectra
from vit_tpu_torch.prepca.pipeline import compute_kernel_pca
from vit_tpu_torch.serve import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=str, required=True, help="Path to HDF5 with [N, L] spectra")
    ap.add_argument("--r", type=int, default=64, help="#KPCA components")
    ap.add_argument("--landmarks", type=int, default=2048, help="#landmarks for Nystrom")
    ap.add_argument("--kernel", type=str, default="rbf", choices=["rbf", "poly", "linear"])
    ap.add_argument("--gamma", type=str, default="auto", help="'auto' or float")
    ap.add_argument("--degree", type=int, default=3, help="poly degree")
    ap.add_argument("--coef0", type=float, default=1.0, help="poly coef0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, required=True, help="Output .npz/.pt path")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    flux = load_spectra(args.data)["flux"]
    print(f"[KPCA] Loaded {flux.shape[0]} spectra, L={flux.shape[1]}")
    state = compute_kernel_pca(
        flux,
        r=args.r,
        landmarks=args.landmarks,
        kernel_name=args.kernel,
        gamma=None if args.gamma == "auto" else float(args.gamma),
        degree=args.degree,
        coef0=args.coef0,
        seed=args.seed,
        device=device,
    )
    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
    state.save(args.out)
    print(f"[KPCA] Saved state to {args.out}  (r={state.r}, landmarks={state.landmarks.shape[0]})")


if __name__ == "__main__":
    main()
