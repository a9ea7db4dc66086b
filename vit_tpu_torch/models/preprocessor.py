"""Linear input preprocessors built from covariance statistics (port of
``vit_tpu/models/preprocessor.py``).

* :func:`compute_zca_matrix`: full rank ``V diag(1/sqrt(lam_hat + eps)) V^T``
  with the eigenvalues shrunk toward their mean; low rank
  ``(Vr * invsqrt_r) Vr^T + s_perp (I - Vr Vr^T)`` with ``s_perp`` from the
  tail's median, floored at 1e-3 of the kept mean. float64 numpy, fp32 out.
* :func:`compute_pca_matrix`: ``V[:, :r]^T``.
* :class:`LinearPreprocessor`: ``y = x P^T + b`` (``b = -mean P^T`` centres),
  always in fp32 whatever the model's precision: whitening matrices are
  ill-conditioned. Its weight is ``preprocessor.linear.weight``.
* :class:`PrefilledAttention`: Q and K prefilled with the top-r eigenvectors
  (scaled by ``1/sqrt(lam + eps)`` with ``scale_by_eigvals``); a 2-D input
  (a spectrum) applies ``q_lin`` alone, a 3-D input runs softmax attention
  with ``v_lin`` drawn from U(±1/sqrt(D)). Like ``vit_tpu``'s flax module, it
  holds only the parameters its input kind uses: ``q_lin`` for spectra,
  ``q_lin``, ``k_lin`` and ``v_lin`` for token inputs (``token_input``).

The matrices are data-dependent constants computed when the model is built;
the products run on the module's device. Freezing is the training loop's
concern (``warmup.freeze_epochs``), keyed on the ``preprocessor.`` prefix.

* :class:`PatchPCAProjector` (the image family's): ``(B, H, W, C) -> (B, N,
  r)``, each non-overlapping ``P x P x C`` patch flattened row-major over
  (P, P, C) and projected in fp32 onto the top-r PCA basis, bias ``-mean @
  V_r``; ``preprocessor.linear.weight`` is ``V_r^T``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

__all__ = [
    "compute_zca_matrix",
    "compute_pca_matrix",
    "LinearPreprocessor",
    "PrefilledAttention",
    "PatchPCAProjector",
]


def _shrink(eigvals: np.ndarray, shrinkage: float) -> np.ndarray:
    if shrinkage > 0.0:
        return (1.0 - shrinkage) * eigvals + shrinkage * eigvals.mean()
    return eigvals


def compute_zca_matrix(eigvecs: np.ndarray, eigvals: np.ndarray, eps: float = 1e-5,
                       r: Optional[int] = None, shrinkage: float = 0.1) -> np.ndarray:
    """ZCA whitening matrix ``P`` (D, D); eigvecs/eigvals sorted descending."""
    eigvecs = np.asarray(eigvecs, dtype=np.float64)
    eigvals = np.asarray(eigvals, dtype=np.float64)
    lam = _shrink(eigvals, shrinkage)
    if r is None:
        inv_sqrt = 1.0 / np.sqrt(lam + eps)
        P = (eigvecs * inv_sqrt[None, :]) @ eigvecs.T
    else:
        Vr = eigvecs[:, :r]
        inv_sqrt_r = 1.0 / np.sqrt(lam[:r] + eps)
        tail = lam[r:]
        lam0 = np.median(tail) if tail.size > 0 else lam[r - 1]
        lam0 = max(lam0, 1e-3 * lam[:r].mean())  # relative floor
        s_perp = 1.0 / np.sqrt(lam0 + eps)
        proj = Vr @ Vr.T
        P = (Vr * inv_sqrt_r[None, :]) @ Vr.T + s_perp * (np.eye(eigvecs.shape[0]) - proj)
    return P.astype(np.float32)


def compute_pca_matrix(eigvecs: np.ndarray, r: Optional[int] = None) -> np.ndarray:
    """PCA projection ``P = V[:, :r]^T``: (r, D), or (D, D) at full rank."""
    eigvecs = np.asarray(eigvecs, dtype=np.float32)
    if r is None:
        return eigvecs.T.copy()
    return eigvecs[:, :r].T.copy()


def _param(value: np.ndarray) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(np.array(value, np.float32, copy=True, order="C")))


class _Weights(nn.Module):
    """A bare ``weight`` (out, in) [+ ``bias``]: the ``nn.Linear`` key layout."""

    def __init__(self, weight: np.ndarray, bias: Optional[np.ndarray] = None) -> None:
        super().__init__()
        self.weight = _param(weight)
        self.bias = None if bias is None else _param(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.float(), self.weight.t())
        return y if self.bias is None else y + self.bias


class LinearPreprocessor(nn.Module):
    """``y = x P^T + b`` in fp32, ``P`` (out, in) as ``preprocessor.linear.weight``."""

    def __init__(self, matrix: np.ndarray, bias: Optional[np.ndarray] = None) -> None:
        super().__init__()
        self.linear = _Weights(matrix, bias)

    @property
    def in_features(self) -> int:
        return int(self.linear.weight.shape[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class PrefilledAttention(nn.Module):
    """Q and K prefilled with (scaled) eigenvectors. ``r < input_dim`` (or
    ``low_rank``) gives (r, D) projections; otherwise (D, D) with the first
    r rows prefilled and the rest zero. ``v_lin`` is drawn from
    ``generator``."""

    def __init__(self, input_dim: int, eigvecs: np.ndarray,
                 eigvals: Optional[np.ndarray] = None, r: Optional[int] = None,
                 low_rank: Optional[bool] = None, scale_by_eigvals: bool = True,
                 eps: float = 1e-5, token_input: bool = False,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.input_dim = int(input_dim)
        rank = int(r) if r is not None else int(np.asarray(eigvecs).shape[1])
        V = np.asarray(eigvecs, dtype=np.float32)[:, :rank].T  # (r, D)
        if scale_by_eigvals and eigvals is not None:
            scale = 1.0 / np.sqrt(np.asarray(eigvals, dtype=np.float32)[:rank] + eps)
            V = V * scale[:, None]
        if low_rank if low_rank is not None else rank < self.input_dim:
            qk = V
        else:
            qk = np.zeros((self.input_dim, self.input_dim), dtype=np.float32)
            qk[:rank, :] = V  # prefill the first r rows, the rest zero
        self.qk_out = int(qk.shape[0])
        self.q_lin = _Weights(qk)
        self.k_lin = self.v_lin = None
        if token_input:
            self.k_lin = _Weights(qk)
            # torch kaiming_uniform_(a=sqrt(5)) on (out, in): U(-1/sqrt(in), 1/sqrt(in))
            bound = 1.0 / math.sqrt(self.input_dim)
            g = generator or torch.Generator().manual_seed(0)
            v = torch.rand(self.input_dim, self.input_dim, generator=g) * (2 * bound) - bound
            self.v_lin = _Weights(v.numpy())

    @property
    def in_features(self) -> int:
        return self.input_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if x.dim() == 2:
            return self.q_lin(x32)
        if self.k_lin is None:
            raise ValueError("PrefilledAttention was built for 2-D inputs (token_input=False)")
        q, k, v = self.q_lin(x32), self.k_lin(x32), self.v_lin(x32)
        scores = torch.matmul(q, k.transpose(-1, -2)) / float(self.qk_out) ** 0.5
        return torch.matmul(torch.softmax(scores, dim=-1), v)


class PatchPCAProjector(nn.Module):
    """Patch-level PCA projection for NHWC images (NCHW is transposed
    first), ``vit_tpu/models/preprocessor.py::PatchPCAProjector``: the basis
    (patch_dim, r) and the optional patch mean (patch_dim,) prefill
    ``linear`` (weight ``basis^T``, bias ``-mean @ basis``)."""

    def __init__(self, patch_size: int, num_channels: int, basis: np.ndarray,
                 mean: Optional[np.ndarray] = None) -> None:
        super().__init__()
        basis = np.asarray(basis, np.float32)
        self.patch_size = int(patch_size)
        self.num_channels = int(num_channels)
        patch_dim = self.patch_size**2 * self.num_channels
        if basis.shape[0] != patch_dim:
            raise ValueError(f"PCA basis rows {basis.shape[0]} != patch dim {patch_dim} "
                             f"({patch_size}x{patch_size}x{num_channels})")
        bias = None if mean is None else -(np.asarray(mean, np.float32) @ basis)
        self.linear = _Weights(basis.T, bias)

    @property
    def out_features(self) -> int:
        return int(self.linear.weight.shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(f"PatchPCAProjector expects (B, H, W, C), got {tuple(x.shape)}")
        c, p = self.num_channels, self.patch_size
        if x.shape[1] == c and x.shape[-1] != c:
            x = x.permute(0, 2, 3, 1)  # NCHW -> NHWC
        b, hgt, wid, ch = x.shape
        if hgt % p or wid % p or ch != c:
            raise ValueError(f"image {tuple(x.shape[1:])} not tileable by patch {p} x {p} x {c}")
        patches = x.reshape(b, hgt // p, p, wid // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return self.linear(patches.reshape(b, -1, p * p * c))
