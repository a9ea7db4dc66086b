"""Spectroscopy utilities (port of ``vit_tpu/spectro.py``).

Lick-index equivalent widths, Voigt line injection, SNR and RMS
estimators and air<->vacuum conversion (Greisen 2006, eqns 65/66) are host
numpy/scipy, as in ``vit_tpu``; ``pandas`` is imported inside
:func:`get_equivalent_width` only. :class:`SVDDenoiser` fits and denoises
on ``device`` (the card unless asked otherwise) in float64.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from vit_tpu_torch.utils import to_device

__all__ = [
    "LICK_INDICES",
    "LICK_INDICES_VAC",
    "get_equivalent_width_i",
    "get_equivalent_width",
    "create_new_voigt_line",
    "add_new_line",
    "SVDDenoiser",
    "calculate_snr",
    "calculate_rms",
    "calculate_snr_masked",
    "air_to_vac",
    "vac_to_air",
    "air_to_vac_deriv",
]

# Lick spectral indices: [feature_start, feature_end, blue_start, blue_end,
# red_start, red_end] in Angstroms (air wavelengths).
LICK_INDICES: Dict[str, list] = {
    "TiO_4": [7643.25, 7717.25, 7527.0, 7577.75, 7735.5, 7782.75],
    "Ca1_LB13": [8484.0, 8513.0, 8474.0, 8484.0, 8563.0, 8577.0],
    "Ca2_LB13": [8522.0, 8562.0, 8474.0, 8484.0, 8563.0, 8577.0],
    "Ca3_LB13": [8642.0, 8682.0, 8619.0, 8642.0, 8700.0, 8725.0],
}

# The same bands converted to vacuum wavelengths.
LICK_INDICES_VAC: Dict[str, np.ndarray] = {
    "TiO_4": np.array([7645.45, 7719.47, 7529.16, 7579.93, 7737.72, 7784.99]),
    "Ca1_LB13": np.array([8486.44, 8515.45, 8476.44, 8486.44, 8565.46, 8579.47]),
    "Ca2_LB13": np.array([8524.45, 8564.46, 8476.44, 8486.44, 8565.46, 8579.47]),
    "Ca3_LB13": np.array([8644.49, 8684.5, 8621.48, 8644.49, 8702.5, 8727.51]),
}


def get_equivalent_width_i(wave: np.ndarray, flux: np.ndarray, feature_start: float,
                           feature_end: float, blue_start: float, blue_end: float,
                           red_start: float, red_end: float) -> float:
    """EW of one feature: a linear continuum through the blue and red
    sidebands' means, then ``trapz(1 - F/F_cont)`` over the feature band
    (NaN when a band holds no pixel)."""
    wave = np.asarray(wave, np.float64)
    flux = np.asarray(flux, np.float64)
    blue = (wave >= blue_start) & (wave <= blue_end)
    feat = (wave >= feature_start) & (wave <= feature_end)
    red = (wave >= red_start) & (wave <= red_end)
    if not (blue.any() and feat.any() and red.any()):
        return float("nan")
    blue_flux, red_flux = flux[blue].mean(), flux[red].mean()
    blue_mid, red_mid = wave[blue].mean(), wave[red].mean()
    slope = (red_flux - blue_flux) / (red_mid - blue_mid)
    intercept = blue_flux - slope * blue_mid
    feat_wave, feat_flux = wave[feat], flux[feat]
    cont = slope * feat_wave + intercept
    return float(np.trapezoid(1.0 - feat_flux / cont, feat_wave))


def get_equivalent_width(wave: np.ndarray, spectra: np.ndarray, redshifts: np.ndarray,
                         indices: Optional[Dict[str, np.ndarray]] = None):
    """Per-spectrum EWs of every Lick index, the bands shifted by (1+z): a
    pandas DataFrame with a ``SpecID`` column first."""
    import pandas as pd

    indices = indices if indices is not None else LICK_INDICES_VAC
    rows = []
    for i, spec in enumerate(np.asarray(spectra)):
        row = {"SpecID": i}
        for name, bands in indices.items():
            row[name] = get_equivalent_width_i(
                wave, spec, *(np.asarray(bands) * (1 + redshifts[i]))
            )
        rows.append(row)
    return pd.DataFrame(rows)


def create_new_voigt_line(input_wave: np.ndarray, u: float = 8700.0, hw: float = 10.0,
                          sigma: float = 1.0, gamma: float = 1.0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Voigt profile sampled on the wavelengths within ``u ± hw``."""
    from scipy.special import voigt_profile

    wave = np.asarray(input_wave)
    sel = wave[(wave > u - hw) & (wave < u + hw)]
    return sel, voigt_profile(sel - u, sigma, gamma)


def add_new_line(old_wave: np.ndarray, old_flux: np.ndarray, new_wave: np.ndarray,
                 new_line: np.ndarray, sign: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Inject (or subtract, ``sign=-1``) a line profile into a spectrum."""
    idx = np.where(np.isin(old_wave, new_wave))
    line_flux = old_flux[idx] + new_line * sign
    new_flux = old_flux.copy()
    new_flux[idx] = line_flux
    return line_flux, new_flux


class SVDDenoiser:
    """Truncated-SVD denoiser: fit a basis on clean spectra, project noisy ones.

    The fit takes the right singular vectors of the centred spectra as the
    eigenvectors of their float64 Gram matrix ``XᵀX`` (pixels x pixels):
    the basis ``vit_tpu``'s full ``np.linalg.svd`` gives, up to each
    column's sign (``torch.linalg.eigh``'s); :meth:`denoise` is a
    projection and does not depend on the signs. ``V``, ``mean_spectrum`` and
    ``explained_variance_ratio_`` are float64 numpy arrays, as in ``vit_tpu``.
    """

    def __init__(self, n_components: int, device: Union[str, torch.device] = "cuda") -> None:
        from vit_tpu_torch.serve import resolve_device

        self.n_components = int(n_components)
        self.device = resolve_device(device)
        self.V: Optional[np.ndarray] = None
        self.mean_spectrum: Optional[np.ndarray] = None
        self.explained_variance_ratio_: Optional[np.ndarray] = None

    def fit(self, clean_spectra) -> "SVDDenoiser":
        x = to_device(clean_spectra, self.device, torch.float64)
        mean = x.mean(dim=0)
        c = x - mean
        k = self.n_components
        lam, v = torch.linalg.eigh(c.T @ c)
        lam, v = lam.flip(0).clamp_min(0.0), v.flip(1)[:, :k]
        self.mean_spectrum = mean.cpu().numpy()
        self.V = v.cpu().numpy()
        self.explained_variance_ratio_ = (lam[:k] / lam.sum()).cpu().numpy()
        return self

    def denoise(self, noisy_spectra) -> np.ndarray:
        if self.V is None:
            raise RuntimeError("Must fit the denoiser before using it to denoise spectra")
        v = torch.from_numpy(self.V).to(self.device)
        mean = torch.from_numpy(self.mean_spectrum).to(self.device)
        c = to_device(noisy_spectra, self.device, torch.float64) - mean
        return ((c @ v) @ v.T + mean).cpu().numpy()

    def fit_transform(self, clean_spectra) -> np.ndarray:
        return self.fit(clean_spectra).denoise(clean_spectra)


def calculate_snr(flux: np.ndarray) -> np.ndarray:
    """Median-signal / second-difference-noise SNR (last axis)."""
    flux = np.asarray(flux, np.float64)
    signal = np.median(flux, axis=-1)
    diff = 2 * flux[..., 1:-1] - flux[..., :-2] - flux[..., 2:]
    noise = (1.482602 / np.sqrt(6.0)) * np.median(np.abs(diff), axis=-1)
    return signal / noise


def calculate_rms(noisy: Optional[np.ndarray] = None, flux: Optional[np.ndarray] = None,
                  residual: Optional[np.ndarray] = None) -> np.ndarray:
    """``||flux|| / ||noisy - flux||`` per spectrum."""
    if residual is None:
        residual = np.asarray(noisy) - np.asarray(flux)
    return np.linalg.norm(flux, axis=-1) / np.linalg.norm(residual, axis=-1)


def calculate_snr_masked(value: np.ndarray, mask: np.ndarray, shift: int = 1,
                         binning: int = 1) -> float:
    """Masked SNR with configurable difference shift and binning factor."""
    v = np.asarray(value)[np.asarray(mask)]
    signal = np.median(v)
    df = np.abs(2 * v[shift:-shift] - v[: -2 * shift] - v[2 * shift :])
    noise = 1.482602 / np.sqrt(6.0) * np.median(df)
    return float(signal / noise * np.sqrt(binning))


def air_to_vac(wave: np.ndarray) -> np.ndarray:
    """Air -> vacuum wavelength, Greisen 2006 eqn 65 (wave in Angstroms)."""
    wave = np.asarray(wave, np.float64)
    wlum = wave * 1e5
    return (1 + 1e-6 * (287.6155 + 1.62887 / wlum**2 + 0.01360 / wlum**4)) * wave


def vac_to_air(wave: np.ndarray) -> np.ndarray:
    """Vacuum -> air; identity below 2000 A (the formula's validity bound)."""
    wave = np.asarray(wave, np.float64)
    fact = 1.0 + 2.735182e-4 + 131.4182 / wave**2 + 2.76249e8 / wave**4
    fact = fact * (wave >= 2000) + 1.0 * (wave < 2000)
    return wave / fact


def air_to_vac_deriv(wave: np.ndarray) -> np.ndarray:
    """d(vac)/d(air), Greisen 2006 eqn 66."""
    wave = np.asarray(wave, np.float64)
    wlum = wave * 1e5
    return 1 + 1e-6 * (287.6155 - 1.62877 / wlum**2 - 0.04080 / wlum**4)
