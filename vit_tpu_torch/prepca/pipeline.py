"""Offline preprocessing statistics: patch PCA, Nyström KPCA, ZCA, PCP, CKA
(port of ``vit_tpu/prepca/pipeline.py``).

Each function takes ``device=`` (default ``"cuda"``; ``"cpu"`` must be
asked for) and runs its linear algebra there with ``torch.linalg``:

* :func:`compute_pca`: the sliding windows by ``Tensor.unfold``, a float64
  Gram of the centred windows accumulated over chunks of windows (one chunk
  resident), ``eigh`` in float64, the scores in float32;
* :func:`compute_kernel_pca`: the landmarks' kernel matrix in float32 as
  ``vit_tpu`` computes it, centred in float64 with row and column means in
  place of ``vit_tpu``'s m³ products by a matrix of 1/m (the same matrix),
  ``eigh`` in float64; :meth:`KernelPCAState.transform` in float32 chunks;
* :class:`ZCAWhitening`: covariance, shrinkage and ``eigh`` in float64;
* :func:`compute_pcp`: the inexact-ALM loop in float64, its singular value
  thresholding by the ``eigh`` of the smaller float64 Gram;
* :func:`compute_cka`: host numpy float64, as in ``vit_tpu``.

The products that ``vit_tpu`` computes in float32 (PCA scores, the kernel
matrices and KPCA transforms, ZCA's ``transform``) are float32 here too;
on the card they are exact float32 only with
``torch.backends.cuda.matmul.allow_tf32`` off. The Grams, covariances and
eigendecompositions are float64 and do not depend on that switch.

Random choices stay on numpy's Generator: the KPCA landmarks are
``np.random.default_rng(seed).permutation(n)[:m]`` and PCP's power
iteration starts from ``rng.standard_normal(m)``, so both packages pick
the same landmarks and the same step size. The rbf median heuristic for
gamma is numpy's float32 computation on the host (see
:func:`_median_gamma`), so both packages resolve the same gamma. Eigenvectors carry
``torch.linalg``'s signs; ``vit_tpu`` fixes no sign convention either.
Artifacts keep ``vit_tpu``'s ``.npz`` and ``.pt`` schemas, so each package
reads the other's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from vit_tpu_torch.data.hdf5 import load_spectra
from vit_tpu_torch.serve import resolve_device
from vit_tpu_torch.utils import to_device

__all__ = [
    "load_spectra",
    "compute_pca",
    "compute_patch_pca_images",
    "KernelPCAState",
    "compute_kernel_pca",
    "ZCAWhitening",
    "ZCAState",
    "compute_pcp",
    "compute_cka",
    "PreprocessingPipeline",
]

Device = Union[str, torch.device]
PCA_CHUNK_WINDOWS = 1 << 20  # windows a Gram/score chunk holds (256 MiB in fp64 at patch 32)
TRANSFORM_CHUNK_ELEMS = 1 << 27  # kernel-matrix elements a transform chunk holds (512 MiB)


def _as_np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# PCA (patch-level)
# ---------------------------------------------------------------------------
def _window_chunks(x: torch.Tensor, patch: int, step: int):
    """The (rows, patch) windows of ``x``'s spectra (``Tensor.unfold``), in
    chunks of whole spectra of about PCA_CHUNK_WINDOWS windows each."""
    n, length = x.shape
    per = (length - patch) // step + 1
    rows = max(1, PCA_CHUNK_WINDOWS // per)
    for i in range(0, n, rows):
        yield x[i : i + rows].unfold(1, patch, step).reshape(-1, patch)


def compute_pca(spectra, *, patch_size: int, step: Optional[int] = None,
                limit: Optional[int] = None, device: Device = "cuda") -> Dict[str, np.ndarray]:
    """PCA basis over the length-``patch_size`` windows of the spectra,
    ``step`` apart (default ``patch_size``).

    Returns ``{components V, scores U, singular_values S, mean,
    explained_variance_ratio, patch_size, step, num_patches}``, the
    ``torch.pca_lowrank(q=patch_size, center=True)`` contract of
    ``vit_tpu``: V (patch, patch) by decreasing singular value, U the
    windows' float32 scores ``(w - mean) @ V / S``. The mean is summed in
    float64 and rounded to float32, the value the windows are centred by.
    """
    dev = resolve_device(device)
    x = to_device(spectra, dev, torch.float32)
    if x.ndim != 2:
        raise ValueError(f"Expected [N, L] array, got {tuple(x.shape)}")
    if limit is not None and 0 < limit < x.shape[0]:
        x = x[:limit]
    patch = int(patch_size)
    step = int(step) if (step is not None and int(step) > 0) else patch
    total = torch.zeros(patch, dtype=torch.float64, device=dev)
    count = 0
    for w in _window_chunks(x, patch, step):
        total += w.sum(dim=0, dtype=torch.float64)
        count += w.shape[0]
    mean = (total / count).float()
    gram = torch.zeros((patch, patch), dtype=torch.float64, device=dev)
    for w in _window_chunks(x, patch, step):
        c = (w - mean).double()
        gram += c.T @ c
    eigvals, eigvecs = torch.linalg.eigh(gram)
    eigvals, eigvecs = eigvals.flip(0).clamp_min(0.0), eigvecs.flip(1)
    V = eigvecs.float()
    S = eigvals.sqrt().float()
    inv_s = 1.0 / torch.where(S > 0, S, 1.0)
    scores = np.empty((count, patch), np.float32)
    row = 0
    for w in _window_chunks(x, patch, step):
        u = ((w - mean) @ V) * inv_s
        scores[row : row + u.shape[0]] = u.cpu().numpy()
        row += u.shape[0]
    tot = float(eigvals.sum())
    evr = eigvals / tot if tot > 0 else eigvals
    return {
        "components": V.cpu().numpy(),
        "scores": scores,
        "singular_values": S.cpu().numpy(),
        "mean": mean.cpu().numpy(),
        "explained_variance_ratio": evr.float().cpu().numpy(),
        "patch_size": np.asarray(patch),
        "step": np.asarray(step),
        "num_patches": np.asarray(count),
    }


def compute_patch_pca_images(images, *, patch_size: int, limit: Optional[int] = None,
                             device: Device = "cuda") -> Dict[str, np.ndarray]:
    """Patch-level PCA over the non-overlapping ``P x P x C`` patches of
    (N, H, W, C) images (uint8 scaled to [0, 1]); patches flatten row-major
    over (P, P, C), as :class:`~vit_tpu_torch.models.preprocessor.
    PatchPCAProjector` reads them. Returns ``vit_tpu``'s artifact schema:
    ``components`` (patch_dim, patch_dim), columns the directions by
    decreasing variance, ``singular_values``, ``mean``,
    ``explained_variance_ratio``, ``patch_size``, ``num_channels``,
    ``num_patches``."""
    dev = resolve_device(device)
    images = _as_np(images)
    if images.ndim != 4:
        raise ValueError(f"Expected (N, H, W, C) images, got {images.shape}")
    if limit is not None and 0 < limit < images.shape[0]:
        images = images[:limit]
    x = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    n, hgt, wid, c = x.shape
    p = int(patch_size)
    if hgt % p or wid % p:
        raise ValueError(f"image {hgt}x{wid} not tileable by patch {p}")
    patches = x.reshape(n, hgt // p, p, wid // p, p, c).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(-1, p * p * c)
    mean = patches.mean(dim=0)
    centered = (patches - mean).double()
    dof = max(1, centered.shape[0] - 1)
    cov = centered.T @ centered / dof
    eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
    eigvals, eigvecs = eigvals.flip(0).clamp_min(0.0), eigvecs.flip(1)
    total = float(eigvals.sum())
    evr = eigvals / total if total > 0 else eigvals
    return {
        "components": eigvecs.float().cpu().numpy(),
        "singular_values": torch.sqrt(eigvals * dof).float().cpu().numpy(),
        "mean": mean.cpu().numpy(),
        "explained_variance_ratio": evr.float().cpu().numpy(),
        "patch_size": np.asarray(p),
        "num_channels": np.asarray(c),
        "num_patches": np.asarray(patches.shape[0]),
    }


# ---------------------------------------------------------------------------
# Kernels + Nyström KPCA
# ---------------------------------------------------------------------------
def _pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``|x_i - y_j|²`` as ``x² + y² - 2xy``, both sets first moved by y's
    mean: the distances are the same, and the float32 cancellation shrinks
    with the norms. Without the shift, 4096-pixel spectra (``|x|²`` ~ 4096,
    distances ~ 4) lose ~1e-4 of a distance, and a KPCA feature ~2e-3."""
    c = y.mean(dim=0)
    x, y = x - c, y - c
    x2 = (x * x).sum(dim=1, keepdim=True)
    y2 = (y * y).sum(dim=1, keepdim=True).T
    return (x2 + y2 - 2.0 * (x @ y.T)).clamp_min(0.0)


def _median_gamma(x: torch.Tensor, y: torch.Tensor) -> float:
    """The rbf median heuristic, 1 / (median of the float32 pairwise squared
    distances between every ``n // 4096``-th row of x and of y + 1e-8),
    computed with numpy on the host as ``vit_tpu`` computes it. The
    reference's ``x² + y² - 2xy`` loses about 1e-4 of a spectrum's squared
    distance to cancellation in float32, so the median moves with the
    product's rounding; numpy's rounding gives ``vit_tpu``'s gamma exactly."""
    xs = x[:: max(1, x.shape[0] // 4096)].cpu().numpy()
    ys = y[:: max(1, y.shape[0] // 4096)].cpu().numpy()
    med = np.median(_np_pairwise_sq_dists(xs, ys).flatten())
    return float(1.0 / (med + 1e-8))


def _kernel(x: torch.Tensor, y: torch.Tensor, *, name: str = "rbf",
            gamma: Optional[float] = None, degree: int = 3, coef0: float = 1.0) -> torch.Tensor:
    if name == "linear":
        return x @ y.T
    if name == "poly":
        if gamma is None:
            gamma = 1.0 / x.shape[1]
        return (gamma * (x @ y.T) + coef0) ** degree
    if name == "rbf":
        if gamma is None:
            gamma = _median_gamma(x, y)
        return torch.exp(-gamma * _pairwise_sq_dists(x, y))
    raise ValueError(f"Unknown kernel: {name}")


def _center_gram_train(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """The double-centred float64 Gram (symmetrised), the column means and
    their mean: ``K - 1K - K1 + 1K1`` with 1 the matrix of 1/m, written with
    the means those products are."""
    Kd = K.double()
    col = Kd.mean(dim=0)
    row = Kd.mean(dim=1)
    grand = col.mean()
    Kc = Kd - col[None, :] - row[:, None] + grand
    return 0.5 * (Kc + Kc.T), col.float(), float(grand)


def _center_kvec_test(k_xy: torch.Tensor, row_means: torch.Tensor, k_mean) -> torch.Tensor:
    mean_b = k_xy.mean(dim=1, keepdim=True)
    return k_xy - mean_b - row_means[None, :] + k_mean


def kpca_features(x: torch.Tensor, landmarks: torch.Tensor, A: torch.Tensor,
                  row_means: torch.Tensor, k_mean, *, kernel_name: str,
                  gamma: Optional[float], degree: int, coef0: float) -> torch.Tensor:
    """(rows, D) -> (rows, r): the centred kernel row against the landmarks
    times ``A``; differentiable in ``x`` (:class:`~vit_tpu_torch.prepca.
    attention.KPCAWarmSelfAttention` runs it under autograd)."""
    k = _kernel(x, landmarks, name=kernel_name, gamma=gamma, degree=degree, coef0=coef0)
    return _center_kvec_test(k, row_means, k_mean) @ A


@dataclasses.dataclass
class KernelPCAState:
    """Nyström KPCA state: landmarks and the projection ``A = U_r Lam_r^{-1/2}``
    (columns by increasing eigenvalue, as ``vit_tpu`` orders them).

    The arrays are numpy, in ``vit_tpu``'s dtypes; ``device`` is where
    :meth:`transform` computes (not saved)."""

    landmarks: np.ndarray
    A: np.ndarray
    row_means: np.ndarray
    K_mean: float
    kernel_name: str = "rbf"
    gamma: Optional[float] = None
    degree: int = 3
    coef0: float = 1.0
    r: int = 32
    device: str = "cuda"

    def resolve_gamma(self) -> Optional[float]:
        """Pin the rbf gamma of a state that carries ``gamma=None`` (the
        reference's artifacts): the median heuristic over the landmarks'
        positive squared distances, derived once and stored, so chunked
        transforms agree. Computed with numpy on the host, as ``vit_tpu``
        computes it: whether ``d2 > 0`` keeps a diagonal entry depends on
        how the float32 product ``x·x`` rounds, so another backend would
        take the median over another set of values."""
        if self.gamma is None and self.kernel_name == "rbf":
            lm = np.asarray(self.landmarks, np.float32)
            d2 = _np_pairwise_sq_dists(lm, lm)
            pos = d2[d2 > 0]
            med = float(np.median(pos)) if pos.size else 1.0
            self.gamma = float(1.0 / (med + 1e-8))
            print(f"[kpca] gamma=None in state; resolved median-heuristic "
                  f"gamma={self.gamma:.4e} from the landmarks")
        return self.gamma

    def tensors(self, device: Device) -> Dict[str, torch.Tensor]:
        """``landmarks``, ``A`` and ``row_means`` as float32 tensors on ``device``."""
        return {k: torch.from_numpy(np.ascontiguousarray(getattr(self, k), np.float32)).to(device)
                for k in ("landmarks", "A", "row_means")}

    def transform(self, X, chunk: int = 0, device: Optional[Device] = None) -> np.ndarray:
        """(..., D) -> (..., r) float32 features, ``chunk`` rows at a time
        (0: as many as keep the kernel matrix under TRANSFORM_CHUNK_ELEMS)."""
        self.resolve_gamma()
        dev = resolve_device(device if device is not None else self.device)
        if not isinstance(X, torch.Tensor):
            X = np.asarray(X)
        shape = tuple(X.shape)
        xf = to_device(X, dev, torch.float32).reshape(-1, shape[-1])
        t = self.tensors(dev)
        rows = chunk if chunk > 0 else max(1, TRANSFORM_CHUNK_ELEMS // t["landmarks"].shape[0])
        out = np.empty((xf.shape[0], self.A.shape[1]), np.float32)
        for i in range(0, xf.shape[0], rows):
            z = kpca_features(xf[i : i + rows], t["landmarks"], t["A"], t["row_means"],
                              self.K_mean, kernel_name=self.kernel_name, gamma=self.gamma,
                              degree=self.degree, coef0=self.coef0)
            out[i : i + z.shape[0]] = z.cpu().numpy()
        return out.reshape(*shape[:-1], self.A.shape[1])

    def save(self, path: str) -> None:
        if path.endswith((".pt", ".pth")):
            torch.save({
                "landmarks": torch.from_numpy(self.landmarks),
                "A": torch.from_numpy(self.A),
                "row_means": torch.from_numpy(self.row_means),
                "K_mean": self.K_mean,
                "kernel_name": self.kernel_name,
                "gamma": self.gamma,
                "degree": self.degree,
                "coef0": self.coef0,
                "r": self.r,
            }, path)
            return
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 landmarks=self.landmarks, A=self.A, row_means=self.row_means,
                 K_mean=np.asarray(self.K_mean), kernel_name=np.asarray(self.kernel_name),
                 gamma=np.asarray(self.gamma if self.gamma is not None else np.nan),
                 degree=np.asarray(self.degree), coef0=np.asarray(self.coef0),
                 r=np.asarray(self.r))

    @staticmethod
    def load(path: str, device: Device = "cuda") -> "KernelPCAState":
        """A state from ``.npz`` or ``.pt`` (either package's, or the
        reference's ``.pt`` with ``gamma=None``), to transform on ``device``."""
        dev = str(resolve_device(device))
        if path.endswith((".pt", ".pth")):
            obj = torch.load(path, map_location="cpu", weights_only=True)
            return KernelPCAState(
                landmarks=_as_np(obj["landmarks"]),
                A=_as_np(obj["A"]),
                row_means=_as_np(obj["row_means"]),
                K_mean=float(obj["K_mean"]),
                kernel_name=obj["kernel_name"],
                gamma=obj.get("gamma"),
                degree=obj.get("degree", 3),
                coef0=obj.get("coef0", 1.0),
                r=obj.get("r", _as_np(obj["A"]).shape[1]),
                device=dev,
            )
        with np.load(path, allow_pickle=False) as z:
            gamma = float(z["gamma"])
            return KernelPCAState(
                landmarks=z["landmarks"],
                A=z["A"],
                row_means=z["row_means"],
                K_mean=float(z["K_mean"]),
                kernel_name=str(z["kernel_name"]),
                gamma=None if np.isnan(gamma) else gamma,
                degree=int(z["degree"]),
                coef0=float(z["coef0"]),
                r=int(z["r"]),
                device=dev,
            )


def compute_kernel_pca(spectra, *, r: int, landmarks: Optional[int] = None,
                       kernel_name: str = "rbf", gamma: Optional[float] = None,
                       degree: int = 3, coef0: float = 1.0, seed: int = 0,
                       device: Device = "cuda") -> KernelPCAState:
    """Nyström KPCA on ``landmarks`` rows drawn by
    ``np.random.default_rng(seed).permutation(n)``; an rbf ``gamma=None``
    is resolved once by the median heuristic over the landmarks and stored."""
    dev = resolve_device(device)
    x = to_device(spectra, dev, torch.float32)
    n = x.shape[0]
    m = min(landmarks or n, n)
    idx = np.random.default_rng(seed).permutation(n)[:m]
    L = x[torch.from_numpy(idx).to(dev)]
    if gamma is None and kernel_name == "rbf":
        gamma = _median_gamma(L, L)
    K = _kernel(L, L, name=kernel_name, gamma=gamma, degree=degree, coef0=coef0)
    Kc, row_means, k_mean = _center_gram_train(K)
    eigvals, eigvecs = torch.linalg.eigh(Kc)
    eigvals = eigvals.clamp_min(1e-9)
    top = min(r, eigvals.numel())
    A = (eigvecs[:, -top:] / eigvals[-top:].sqrt()[None, :]).float()
    return KernelPCAState(
        landmarks=L.cpu().numpy(),
        A=A.cpu().numpy(),
        row_means=row_means.cpu().numpy(),
        K_mean=k_mean,
        kernel_name=kernel_name,
        gamma=gamma,
        degree=degree,
        coef0=coef0,
        r=top,
        device=str(dev),
    )


# ---------------------------------------------------------------------------
# ZCA whitening
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ZCAState:
    mean: np.ndarray
    whitening: np.ndarray
    covariance: np.ndarray
    eigenvectors: np.ndarray
    eigenvalues: np.ndarray
    projector: Optional[np.ndarray]
    metadata: Dict[str, object]


class ZCAWhitening:
    """Fit/transform ZCA whitening with diagonal shrinkage and a low-rank mode.

    ``gamma``: diagonal shrinkage in [0, 1]; ``eps``: jitter; ``rank``:
    low-rank whitening plus an ``alpha``-scaled orthogonal complement;
    ``dtype``: the stored state's numpy dtype; ``device``: where
    :meth:`fit` and the transforms compute. The state is numpy, in
    ``vit_tpu``'s ``.npz`` schema.
    """

    def __init__(self, *, gamma: float = 0.0, eps: float = 1e-5, rank: Optional[int] = None,
                 alpha: float = 0.0, dtype=np.float32, device: Device = "cuda") -> None:
        if not 0.0 <= gamma <= 1.0:
            raise ValueError("gamma must be in [0, 1]")
        self.gamma = float(gamma)
        self.eps = float(eps)
        self.rank = rank
        self.alpha = float(alpha)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._state: Optional[ZCAState] = None

    def fit(self, data) -> "ZCAWhitening":
        x = to_device(data, self.device, torch.float64)
        if x.ndim != 2:
            raise ValueError("Expected 2D array for ZCA fit")
        if x.shape[0] < 2:
            raise ValueError("Need at least two samples to compute covariance")
        mean = x.mean(dim=0)
        c = x - mean
        cov = c.T @ c / (x.shape[0] - 1)
        del c
        if self.gamma > 0:
            cov = (1.0 - self.gamma) * cov + self.gamma * torch.diag(torch.diagonal(cov))
        d = cov.shape[0]
        eye = torch.eye(d, dtype=torch.float64, device=self.device)
        cov = cov + self.eps * eye
        eigvals, eigvecs = torch.linalg.eigh(cov)
        eigvals, eigvecs = eigvals.clamp_min(self.eps).flip(0), eigvecs.flip(1)
        whitening = (eigvecs / eigvals.sqrt()[None, :]) @ eigvecs.T
        projector = None
        if self.rank is not None:
            r = max(1, min(int(self.rank), d))
            Vr, lam_r = eigvecs[:, :r], eigvals[:r]
            projector = Vr.T
            whitening = (Vr / lam_r.sqrt()[None, :]) @ Vr.T + self.alpha * (eye - Vr @ Vr.T)

        def f(t):
            return t.cpu().numpy().astype(self.dtype)

        self._state = ZCAState(
            mean=f(mean),
            whitening=f(whitening),
            covariance=f(cov),
            eigenvectors=f(eigvecs),
            eigenvalues=f(eigvals),
            projector=None if projector is None else f(projector),
            metadata={"gamma": self.gamma, "eps": self.eps, "rank": self.rank,
                      "alpha": self.alpha, "dtype": np.dtype(self.dtype).name},
        )
        return self

    def fit_transform(self, data) -> np.ndarray:
        return self.fit(data).transform(data)

    def _require_state(self) -> ZCAState:
        if self._state is None:
            raise RuntimeError("ZCAWhitening has not been fitted yet")
        return self._state

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _input(self, data, s: ZCAState) -> torch.Tensor:
        return to_device(data, self.device, self._t(s.mean).dtype)

    def transform(self, data) -> np.ndarray:
        s = self._require_state()
        return ((self._input(data, s) - self._t(s.mean)) @ self._t(s.whitening).T).cpu().numpy()

    def inverse_transform(self, data) -> np.ndarray:
        s = self._require_state()
        v, lam = self._t(s.eigenvectors), self._t(s.eigenvalues)
        dewhiten = (v * lam.sqrt()[None, :]) @ v.T
        return (self._input(data, s) @ dewhiten.T + self._t(s.mean)).cpu().numpy()

    def project(self, data) -> np.ndarray:
        s = self._require_state()
        if s.projector is None:
            raise RuntimeError("No projector available; fit with rank != None to enable")
        return ((self._input(data, s) - self._t(s.mean)) @ self._t(s.projector).T).cpu().numpy()

    @property
    def whitening_matrix(self) -> np.ndarray:
        return self._require_state().whitening

    def save(self, path: str) -> None:
        s = self._require_state()
        arrays = {
            "mean": s.mean,
            "whitening": s.whitening,
            "covariance": s.covariance,
            "eigenvectors": s.eigenvectors,
            "eigenvalues": s.eigenvalues,
            "gamma": np.asarray(self.gamma),
            "eps": np.asarray(self.eps),
            "rank": np.asarray(-1 if self.rank is None else self.rank),
            "alpha": np.asarray(self.alpha),
        }
        if s.projector is not None:
            arrays["projector"] = s.projector
        np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)

    @classmethod
    def load(cls, path: str, device: Device = "cuda") -> "ZCAWhitening":
        with np.load(path, allow_pickle=False) as z:
            rank = int(z["rank"])
            obj = cls(gamma=float(z["gamma"]), eps=float(z["eps"]),
                      rank=None if rank < 0 else rank, alpha=float(z["alpha"]), device=device)
            obj._state = ZCAState(
                mean=z["mean"],
                whitening=z["whitening"],
                covariance=z["covariance"],
                eigenvectors=z["eigenvectors"],
                eigenvalues=z["eigenvalues"],
                projector=z["projector"] if "projector" in z.files else None,
                metadata={},
            )
        return obj


# ---------------------------------------------------------------------------
# PCP (robust PCA, inexact ALM)
# ---------------------------------------------------------------------------
def _soft_threshold(X: torch.Tensor, tau: float) -> torch.Tensor:
    return torch.sign(X) * torch.clamp_min(X.abs() - tau, 0.0)


def _svt(M: torch.Tensor, tau: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U, max(s - tau, 0), Vt) of ``M`` from the ``eigh`` of its smaller
    Gram: the singular values are the square roots of its eigenvalues, the
    other side's vectors ``Mᵀu / s``. Where s is at most tau its shrunk
    value is 0 and its vectors do not enter ``(U * s) @ Vt``."""
    tall = M.shape[0] > M.shape[1]
    A = M.T if tall else M
    lam, U = torch.linalg.eigh(A @ A.T)
    lam, U = lam.flip(0).clamp_min(0.0), U.flip(1)
    s = lam.sqrt()
    Vt = (U.T @ A) / torch.where(s > 0, s, 1.0)[:, None]
    shrunk = torch.clamp_min(s - tau, 0.0)
    return (Vt.T, shrunk, U.T) if tall else (U, shrunk, Vt)


def compute_pcp(spectra, *, lambda_: Optional[float] = None, mu: Optional[float] = None,
                tol: float = 1e-7, max_iter: int = 1000, verbose: bool = False, seed: int = 0,
                device: Device = "cuda") -> Tuple[np.ndarray, np.ndarray, Dict[str, Iterable[float]]]:
    """Principal component pursuit: D = L (low-rank) + S (sparse).

    D is rounded to float32 as in ``vit_tpu``; the step size ``mu`` (the
    reference's ``1.25 / sqrt(||D x||)`` after five float32 power
    iterations from ``default_rng(seed).standard_normal(m)``) is a float32
    scalar, as there. The loop runs in float64 and returns float64 L and S.
    ``vit_tpu``'s loop takes its dtype from NumPy's promotion of its
    scalars: with the default ``lambda_`` (``1 / np.sqrt(...)``, a float64
    scalar) S, the residual and Y are float64 from the first threshold on,
    and it returns float64, as here; with ``lambda_`` and ``mu`` both
    Python floats it stays float32. One host read an iteration gives the
    stop test and ``history`` (``primal_resid``, ``rank``: singular values
    left after shrinkage, ``nnz``, ``iters``)."""
    dev = resolve_device(device)
    D32 = to_device(spectra, dev, torch.float32)
    n, m = D32.shape
    D = D32.double()
    normD = np.float32(torch.linalg.vector_norm(D).item())
    if lambda_ is None:
        lambda_ = 1.0 / np.sqrt(max(n, m))
    if mu is None:
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(dev)
        for _ in range(5):  # power iteration for the spectral norm
            x = D32.T @ (D32 @ x)
            x = x / (torch.linalg.vector_norm(x) + 1e-12)
        spectral = np.sqrt(np.float32(torch.linalg.vector_norm(D32 @ x).item()))
        mu = 1.25 / (spectral + 1e-12)
    mu_bar = mu * 1e7
    rho = 1.5
    S = torch.zeros_like(D)
    Y = torch.zeros_like(D)
    L = torch.zeros_like(D)
    history: Dict[str, list] = {"primal_resid": [], "rank": [], "nnz": [], "iters": 0}
    for k in range(1, max_iter + 1):
        U, s, Vt = _svt(D - S + Y / float(mu), float(1.0 / mu))
        L = (U * s) @ Vt
        S = _soft_threshold(D - L + Y / float(mu), float(lambda_ / mu))
        R = D - L - S
        Y = Y + float(mu) * R
        stats = torch.stack([torch.linalg.vector_norm(R), (s > 0).sum().double(),
                             (S.abs() > 0).sum().double()]).tolist()
        resid = float(stats[0] / (normD + 1e-12))
        history["primal_resid"].append(resid)
        history["rank"].append(int(stats[1]))
        history["nnz"].append(int(stats[2]))
        history["iters"] = k
        if verbose and (k % 10 == 0 or resid < tol):
            print(f"[PCP] iter={k:4d} resid={resid:.3e} rank={history['rank'][-1]} "
                  f"nnz={history['nnz'][-1]} mu={mu:.3e}")
        if resid < tol:
            break
        mu = min(mu * rho, mu_bar)
    return L.cpu().numpy(), S.cpu().numpy(), history


# ---------------------------------------------------------------------------
# CKA (host numpy float64)
# ---------------------------------------------------------------------------
def _np_pairwise_sq_dists(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    x2 = (x * x).sum(axis=1, keepdims=True)
    y2 = (y * y).sum(axis=1, keepdims=True).T
    return np.clip(x2 + y2 - 2.0 * (x @ y.T), 0.0, None)


def _center_gram(G: np.ndarray) -> np.ndarray:
    n = G.shape[0]
    H = np.eye(n) - np.full((n, n), 1.0 / n)
    return H @ G @ H


def compute_cka(A, B, *, kernel: str = "linear", debiased: bool = True) -> float:
    """HSIC-normalised (linear or rbf) CKA, with the reference's debias
    factor 1 - 2/(n - 1) when ``debiased``."""
    A, B = _as_np(A).astype(np.float64), _as_np(B).astype(np.float64)
    if A.shape[0] != B.shape[0]:
        raise ValueError("CKA requires both inputs to have the same number of samples")
    if kernel == "linear":
        GA, GB = _center_gram(A @ A.T), _center_gram(B @ B.T)
    elif kernel == "rbf":
        GA = _center_gram(np.exp(-_np_pairwise_sq_dists(A, A)))
        GB = _center_gram(np.exp(-_np_pairwise_sq_dists(B, B)))
    else:
        raise ValueError("kernel must be 'linear' or 'rbf'")
    hsic = float((GA * GB).sum())
    cka = hsic / (np.linalg.norm(GA) * np.linalg.norm(GB) + 1e-12)
    if not debiased:
        return float(cka)
    n = A.shape[0]
    return float(cka * (1.0 - 2.0 / (n - 1)))


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------
class PreprocessingPipeline:
    """Load spectra once (HDF5, through :func:`load_spectra`), then
    ``run('pca'|'kpca'|'zca'|'pcp'|'cka', **kw)`` on ``device``."""

    def __init__(self, file_path: str, *, num_samples: Optional[int] = None,
                 device: Device = "cuda") -> None:
        self.device = resolve_device(device)
        data = load_spectra(file_path, num_samples)
        self.flux = data["flux"]
        self.wave = data["wave"]
        self.error = data.get("error")

    def run(self, method: str, **kwargs):
        method = method.lower()
        if method == "pca":
            result = compute_pca(self.flux, device=self.device, **kwargs)
            result["wave"] = self.wave
            return result
        if method == "kpca":
            return {"wave": self.wave,
                    "state": compute_kernel_pca(self.flux, device=self.device, **kwargs)}
        if method == "zca":
            return {"wave": self.wave,
                    "zca": ZCAWhitening(device=self.device, **kwargs).fit(self.flux)}
        if method == "pcp":
            L, S, history = compute_pcp(self.flux, device=self.device, **kwargs)
            return {"wave": self.wave, "low_rank": L, "sparse": S, "history": history}
        if method == "cka":
            other = kwargs.pop("other", None)
            if other is None:
                raise ValueError("'cka' requires 'other' array via kwargs")
            return {"cka": compute_cka(self.flux, other, **kwargs)}
        raise ValueError(f"Unknown preprocessing method '{method}'")
