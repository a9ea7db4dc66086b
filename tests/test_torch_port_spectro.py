"""The port's spectral helpers and the four dataset helpers against vit_tpu,
on the CPU, from seeded numpy inputs.

The host numpy helpers are copies and must agree bit for bit. The SVD
denoiser fits on ``device`` from the eigendecomposition of the float64
Gram XᵀX where vit_tpu takes a full float64 SVD: the explained
variance ratios agree to rel 1e-9, each basis column up to its sign to 1e-8
where its eigenvalue stands apart from its neighbours by more than 1e-6 of
the largest, the projector V Vᵀ and the denoised spectra (a projection, sign
free) to 1e-9 of the data's scale.
"""

import numpy as np
import pytest
import torch

import vit_tpu.data.datasets as jds
import vit_tpu.spectro as jsp
import vit_tpu_torch.data.datasets as pds
import vit_tpu_torch.spectro as psp

EVR_RTOL = 1e-9
COL_TOL = 1e-8
GAP = 1e-6  # relative eigengap above which a column is compared on its own
PROJ_TOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eigendecompositions: torch's thread pool, one per core in each
    of the parallel test workers, would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lick_tables_are_vit_tpus():
    assert psp.LICK_INDICES == jsp.LICK_INDICES
    assert psp.LICK_INDICES_VAC.keys() == jsp.LICK_INDICES_VAC.keys()
    for k, v in jsp.LICK_INDICES_VAC.items():
        np.testing.assert_array_equal(psp.LICK_INDICES_VAC[k], v)


def _spectra(n, length, seed):
    rng = np.random.default_rng(seed)
    wave = np.linspace(7400, 8800, length)
    flux = 1.0 + 0.05 * rng.standard_normal((n, length))
    for c in (7650.0, 8500.0, 8540.0, 8660.0):
        flux -= 0.4 * np.exp(-0.5 * ((wave - c) / 4.0) ** 2)
    return wave, flux


@pytest.mark.parametrize("bands", [[8490, 8520, 8450, 8480, 8530, 8560],
                                   [7643.25, 7717.25, 7527.0, 7577.75, 7735.5, 7782.75],
                                   [9000, 9100, 8990, 9000, 9100, 9200]])  # the last: NaN
def test_equivalent_width_i_is_vit_tpus(bands):
    wave, flux = _spectra(1, 3000, 0)
    a = jsp.get_equivalent_width_i(wave, flux[0], *bands)
    b = psp.get_equivalent_width_i(wave, flux[0], *bands)
    assert (np.isnan(a) and np.isnan(b)) or a == b


def test_equivalent_width_table_is_vit_tpus():
    wave, flux = _spectra(4, 4000, 1)
    z = np.random.default_rng(2).uniform(0, 1e-4, 4)
    a = jsp.get_equivalent_width(wave, flux, z)
    b = psp.get_equivalent_width(wave, flux, z)
    assert list(b.columns) == list(a.columns) and list(b.columns)[0] == "SpecID"
    np.testing.assert_array_equal(b.to_numpy(), a.to_numpy())


@pytest.mark.parametrize("sign", [1, -1])
def test_voigt_line_and_injection_are_vit_tpus(sign):
    wave = np.linspace(8600, 8800, 2000)
    flux = np.ones_like(wave) + 0.01 * np.random.default_rng(3).standard_normal(2000)
    wa, la = jsp.create_new_voigt_line(wave, u=8700, hw=10, sigma=1.5, gamma=0.7)
    wb, lb = psp.create_new_voigt_line(wave, u=8700, hw=10, sigma=1.5, gamma=0.7)
    np.testing.assert_array_equal(wb, wa)
    np.testing.assert_array_equal(lb, la)
    for x, y in zip(psp.add_new_line(wave, flux, wb, lb, sign=sign),
                    jsp.add_new_line(wave, flux, wa, la, sign=sign)):
        np.testing.assert_array_equal(x, y)


def test_snr_rms_and_masked_snr_are_vit_tpus():
    rng = np.random.default_rng(4)
    flux = 10.0 + rng.standard_normal((5, 2049)) * 0.1
    np.testing.assert_array_equal(psp.calculate_snr(flux), jsp.calculate_snr(flux))
    np.testing.assert_array_equal(psp.calculate_rms(noisy=flux + 0.1, flux=flux),
                                  jsp.calculate_rms(noisy=flux + 0.1, flux=flux))
    res = rng.standard_normal(flux.shape)
    np.testing.assert_array_equal(psp.calculate_rms(flux=flux, residual=res),
                                  jsp.calculate_rms(flux=flux, residual=res))
    mask = rng.random(2049) > 0.3
    for shift, binning in ((1, 1), (2, 4)):
        assert (psp.calculate_snr_masked(flux[0], mask, shift, binning)
                == jsp.calculate_snr_masked(flux[0], mask, shift, binning))


def test_air_vacuum_conversions_are_vit_tpus():
    wave = np.concatenate([[1500.0, 1999.0, 2000.0], np.linspace(3000, 11000, 97)])
    for name in ("air_to_vac", "vac_to_air", "air_to_vac_deriv"):
        np.testing.assert_array_equal(getattr(psp, name)(wave), getattr(jsp, name)(wave))


def _check_basis(V, W, eigvals):
    """Columns up to sign where the relative eigengap exceeds GAP; the
    projector onto all k columns in any case."""
    lam = np.asarray(eigvals, np.float64)
    scale = lam.max()
    gaps = np.abs(np.diff(lam)) / scale
    own = np.minimum(np.r_[np.inf, gaps], np.r_[gaps, np.inf]) > GAP
    sign = np.sign((V * W).sum(0))
    assert np.abs(V * sign - W)[:, own].max() <= COL_TOL
    assert np.abs(V @ V.T - W @ W.T).max() <= PROJ_TOL


@pytest.mark.parametrize("n,length,k", [(200, 256, 4), (300, 64, 8), (40, 128, 16)])
def test_svd_denoiser_is_vit_tpus(n, length, k):
    rng = np.random.default_rng(5)
    basis = rng.standard_normal((k + 2, length))
    clean = rng.standard_normal((n, k + 2)) @ basis + 0.01 * rng.standard_normal((n, length))
    noisy = clean + rng.standard_normal(clean.shape) * 0.05
    a = jsp.SVDDenoiser(k).fit(clean)
    b = psp.SVDDenoiser(k, device="cpu").fit(clean)
    np.testing.assert_allclose(b.explained_variance_ratio_, a.explained_variance_ratio_,
                               rtol=EVR_RTOL)
    np.testing.assert_allclose(b.mean_spectrum, a.mean_spectrum, rtol=0, atol=1e-12)
    _check_basis(b.V, a.V, a.explained_variance_ratio_)
    scale = np.abs(clean).max()
    assert np.abs(b.denoise(noisy) - a.denoise(noisy)).max() <= PROJ_TOL * scale
    assert np.abs(b.fit_transform(clean) - a.fit_transform(clean)).max() <= PROJ_TOL * scale
    assert b.V.dtype == a.V.dtype == np.float64


def test_svd_denoiser_needs_a_fit_and_a_device():
    with pytest.raises(RuntimeError, match="Must fit"):
        psp.SVDDenoiser(2, device="cpu").denoise(np.zeros((1, 4)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        psp.SVDDenoiser(2).fit(np.zeros((4, 4)))


@pytest.mark.parametrize("ratio", [0.1, 0.5, 0.9])
def test_mask_helpers_are_vit_tpus(ratio):
    rng = np.random.default_rng(6)
    arr = rng.random((10, 100))
    mask = pds.create_quantile_mask(arr, ratio=ratio)
    np.testing.assert_array_equal(mask, jds.create_quantile_mask(arr, ratio=ratio))
    np.testing.assert_array_equal(pds.fill_masked(arr, mask), jds.fill_masked(arr, mask))
    np.testing.assert_array_equal(pds.fill_masked(arr, mask, filler=0.0),
                                  jds.fill_masked(arr, mask, filler=0.0))
    wave = np.linspace(4000, 9000, 1000)
    lines = [3990.0, 5000.0, 7000.0, 8999.0]  # two near the edges
    for hw in (5, 25):
        np.testing.assert_array_equal(pds.create_lvrg_mask(wave, lines, hw),
                                      jds.create_lvrg_mask(wave, lines, hw))


@pytest.mark.parametrize("seed,level", [(42, 1.0), (7, 0.5)])
def test_single_spectrum_noise_dataset_is_vit_tpus(seed, level):
    flux = np.linspace(0, 1, 64).astype(np.float32)
    err = np.full(64, 0.1, np.float32)
    a = jds.SingleSpectrumNoiseDataset(flux, err, noise_level=level, repeat=32, seed=seed)
    b = pds.SingleSpectrumNoiseDataset(flux, err, noise_level=level, repeat=32, seed=seed)
    assert len(b) == len(a) == 32
    np.testing.assert_array_equal(b.noisy, a.noisy)
    for x, y in zip(b[3], a[3]):
        np.testing.assert_array_equal(x, y)
    for key, value in a.arrays().items():
        np.testing.assert_array_equal(b.arrays()[key], value)
