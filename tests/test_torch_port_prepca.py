"""The port's offline statistics against vit_tpu/prepca, on the CPU.

The same seeded numpy inputs go through ``vit_tpu.prepca`` and through
``vit_tpu_torch.prepca`` with ``device="cpu"``. Eigenvectors are defined up
to sign, so columns are compared sign-aligned where their eigenvalue stands
apart from its neighbours by more than GAP of the largest, and every group
of nearer eigenvalues is compared through its projector. Tolerances, each
with the largest error measured on the CPU:

* PCA: singular values rel 1e-5 (measured 1.2e-7), explained variance
  ratios abs 1e-7 (2.3e-10), the mean abs 1e-5 (2.4e-6: vit_tpu sums it in
  float32 row by row, the port in float64), components 1e-5 (2e-7), scores
  rel 1e-4 of each column's largest (4e-5, from that mean);
* KPCA: landmark indices identical, gamma rel 1e-6 (0: both take numpy's
  float32 median heuristic), transforms rel 1e-4 of the largest feature
  (5.4e-7), chunked against unchunked rel 1e-6; on spectra the port's
  features within 1e-5 of float64 (5.5e-7);
* ZCA: whitening matrix, covariance and eigenvalues rel 1e-6 (4.4e-8),
  projectors 1e-6, transforms rel 1e-5 (5.2e-7);
* PCP: L and S within 1e-4 * ||D|| (1.1e-8), iterations within 2 (equal);
  the port's loop is float64, as vit_tpu's is with its default lambda_;
* KPCA-warm attention against flax apply and jax.grad: 1e-5 (1.2e-6).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.prepca.pipeline as J
import vit_tpu_torch.prepca.pipeline as P
from vit_tpu.data.synthetic import make_dummy_spectra

GAP = 1e-4  # relative eigengap above which a column is compared on its own
PCA_S_RTOL, PCA_EVR_ATOL, PCA_MEAN_ATOL, PCA_V_ATOL, PCA_U_RTOL = 1e-5, 1e-7, 1e-5, 1e-5, 1e-4
GAMMA_RTOL, KPCA_RTOL, CHUNK_RTOL, KPCA_F64_RTOL = 1e-6, 1e-4, 1e-6, 1e-5
ZCA_RTOL, PROJ_ATOL, ZCA_X_RTOL = 1e-6, 1e-6, 1e-5
PCP_TOL, PCP_ITER_SLACK = 1e-4, 2
ATTN_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """Small linear algebra in loops (PCP's iterations, small eigh): the
    thread pools of torch and of numpy's BLAS, one thread per core in each
    of the parallel test workers, would oversubscribe the cores."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gauss_data():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((32, 32))
    return (rng.standard_normal((500, 32)) @ A).astype(np.float32)


@pytest.fixture(scope="module")
def spectra():
    return make_dummy_spectra(n=48, length=512, seed=3)["flux"]


def _groups(lam):
    """Index groups of eigenvalues (any order) whose neighbours lie within GAP."""
    lam = np.asarray(lam, np.float64)
    order = np.argsort(lam)
    rel = np.diff(lam[order]) / max(np.abs(lam).max(), 1e-300)
    cuts = np.flatnonzero(rel > GAP) + 1
    return [order[g] for g in np.split(np.arange(len(lam)), cuts)]


def _assert_basis(V, W, lam, atol):
    """Columns of V and W (same eigenvalues ``lam``) equal up to sign where
    they stand alone, and each group's projector equal."""
    for g in _groups(lam):
        if len(g) == 1:
            s = np.sign(V[:, g].T @ W[:, g]).item()
            assert np.abs(V[:, g] * s - W[:, g]).max() <= atol
        assert np.abs(V[:, g] @ V[:, g].T - W[:, g] @ W[:, g].T).max() <= atol


def _rel(a, b):
    return np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max()


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("patch,step,limit", [(8, 8, None), (8, 3, None), (16, 1, 16),
                                              (32, 32, None), (32, 5, 40), (16, None, 12)])
def test_compute_pca_is_vit_tpus(spectra, patch, step, limit):
    a = J.compute_pca(spectra, patch_size=patch, step=step, limit=limit)
    b = P.compute_pca(spectra, patch_size=patch, step=step, limit=limit, device="cpu")
    assert set(b) == set(a)
    for key in ("patch_size", "step", "num_patches"):
        assert int(b[key]) == int(a[key])
    for key in a:
        assert b[key].dtype == a[key].dtype and b[key].shape == a[key].shape, key
    np.testing.assert_allclose(b["singular_values"], a["singular_values"], rtol=PCA_S_RTOL)
    assert np.abs(b["explained_variance_ratio"] - a["explained_variance_ratio"]).max() \
        <= PCA_EVR_ATOL
    assert np.abs(b["mean"] - a["mean"]).max() <= PCA_MEAN_ATOL
    lam = a["singular_values"].astype(np.float64) ** 2
    _assert_basis(b["components"], a["components"], lam, PCA_V_ATOL)
    for g in _groups(lam):
        if len(g) == 1:
            s = np.sign((a["components"][:, g] * b["components"][:, g]).sum())
            err = np.abs(b["scores"][:, g] * s - a["scores"][:, g]).max()
            assert err <= PCA_U_RTOL * np.abs(a["scores"][:, g]).max()
    rec_a = (a["scores"] * a["singular_values"]) @ a["components"].T
    rec_b = (b["scores"] * b["singular_values"]) @ b["components"].T
    assert _rel(rec_b, rec_a) <= PCA_U_RTOL


def test_compute_pca_takes_a_tensor_and_rejects_3d(spectra):
    a = P.compute_pca(spectra, patch_size=16, device="cpu")
    b = P.compute_pca(torch.from_numpy(spectra).double(), patch_size=16, device="cpu")
    for key in a:
        np.testing.assert_array_equal(b[key], a[key])
    with pytest.raises(ValueError, match="Expected"):
        P.compute_pca(spectra[None], patch_size=16, device="cpu")


def test_pca_chunks_give_the_unchunked_result(spectra, monkeypatch):
    whole = P.compute_pca(spectra, patch_size=16, step=2, device="cpu")
    monkeypatch.setattr(P, "PCA_CHUNK_WINDOWS", 500)  # 2 spectra a chunk
    chunked = P.compute_pca(spectra, patch_size=16, step=2, device="cpu")
    np.testing.assert_allclose(chunked["singular_values"], whole["singular_values"], rtol=1e-6)
    np.testing.assert_allclose(chunked["mean"], whole["mean"], rtol=0, atol=1e-7)
    assert _rel(chunked["scores"], whole["scores"]) <= CHUNK_RTOL


# ---------------------------------------------------------------------------
# Nyström KPCA
# ---------------------------------------------------------------------------
KPCA_CASES = [dict(kernel_name="rbf"), dict(kernel_name="rbf", gamma=1e-3),
              dict(kernel_name="poly", degree=2, coef0=0.5), dict(kernel_name="linear")]


def _kpca_lam(state):
    return 1.0 / (state.A.astype(np.float64) ** 2).sum(0)  # A = V Lam^-1/2


def _assert_features(za, zb, lam):
    """Transforms equal up to each standing-alone column's sign."""
    for g in _groups(lam):
        if len(g) == 1:
            s = np.sign((za[..., g] * zb[..., g]).sum())
            assert np.abs(zb[..., g] * s - za[..., g]).max() <= KPCA_RTOL * np.abs(za).max()


@pytest.mark.parametrize("kw", KPCA_CASES, ids=lambda kw: "-".join(map(str, kw.values())))
@pytest.mark.parametrize("landmarks", [128, 1000])
def test_kernel_pca_is_vit_tpus(gauss_data, kw, landmarks):
    a = J.compute_kernel_pca(gauss_data, r=8, landmarks=landmarks, seed=1, **kw)
    b = P.compute_kernel_pca(gauss_data, r=8, landmarks=landmarks, seed=1, device="cpu", **kw)
    np.testing.assert_array_equal(b.landmarks, a.landmarks)  # the same draw of numpy's rng
    if kw == {"kernel_name": "rbf"}:
        assert abs(b.gamma / a.gamma - 1) <= GAMMA_RTOL
    else:
        assert b.gamma == a.gamma
    assert (b.r, b.kernel_name, b.degree, b.coef0) == (a.r, a.kernel_name, a.degree, a.coef0)
    assert b.A.dtype == a.A.dtype and b.row_means.dtype == a.row_means.dtype
    np.testing.assert_allclose(_kpca_lam(b), _kpca_lam(a), rtol=1e-5)
    x = gauss_data[:40].reshape(4, 10, 32)
    za, zb = a.transform(x), b.transform(x)
    assert zb.shape == za.shape == (4, 10, 8)
    _assert_features(za, zb, _kpca_lam(a))


def _kpca_float64(state, x):
    """``state``'s features of x evaluated in float64."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float64))

    return P.kpca_features(t(x), t(state.landmarks), t(state.A), t(state.row_means),
                           state.K_mean, kernel_name=state.kernel_name, gamma=state.gamma,
                           degree=state.degree, coef0=state.coef0).numpy()


def test_kpca_features_on_spectra_hold_float64():
    """On spectra (``|x|²`` ~ the pixel count, distances far smaller) the
    reference's float32 ``x² + y² - 2xy`` cancels: vit_tpu's features lie
    ~1e-4 from a float64 evaluation of its own state (measured 7.6e-5 to
    2.0e-4 at 256 pixels). The port shifts both sets by the landmarks'
    mean first and stays within KPCA_F64_RTOL (measured 5.5e-7)."""
    x = make_dummy_spectra(n=48, length=256, seed=5)["flux"]
    for r, landmarks in ((6, 32), (8, 40)):
        state = P.compute_kernel_pca(x, r=r, landmarks=landmarks, seed=4, device="cpu")
        assert _rel(state.transform(x[:10]), _kpca_float64(state, x[:10])) <= KPCA_F64_RTOL
        theirs = J.compute_kernel_pca(x, r=r, landmarks=landmarks, seed=4)
        np.testing.assert_array_equal(state.landmarks, theirs.landmarks)
        assert state.gamma == theirs.gamma


def test_kernel_pca_chunks_and_nystrom_property(gauss_data):
    state = P.compute_kernel_pca(gauss_data, r=8, landmarks=128, seed=0, device="cpu")
    z = state.transform(gauss_data[:50])
    for chunk in (7, 50, 64):
        assert _rel(state.transform(gauss_data[:50], chunk=chunk), z) <= CHUNK_RTOL
    zl = state.transform(state.landmarks)
    np.testing.assert_allclose(zl.mean(axis=0), 0.0, atol=1e-3)
    gram = zl.T @ zl
    off = gram - np.diag(np.diag(gram))
    assert np.abs(off).max() < 1e-4 * np.abs(np.diag(gram)).max()
    assert np.all(np.diag(gram) > 0)


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_kernel_pca_artifacts_load_in_both_packages(gauss_data, tmp_path, suffix):
    mine = P.compute_kernel_pca(gauss_data, r=6, landmarks=96, seed=2, device="cpu")
    theirs = J.compute_kernel_pca(gauss_data, r=6, landmarks=96, seed=2)
    x = gauss_data[100:120]
    mine.save(str(tmp_path / f"port{suffix}"))
    theirs.save(str(tmp_path / f"jax{suffix}"))
    by_them = J.KernelPCAState.load(str(tmp_path / f"port{suffix}"))
    by_me = P.KernelPCAState.load(str(tmp_path / f"jax{suffix}"), device="cpu")
    assert _rel(by_them.transform(x), mine.transform(x)) <= KPCA_RTOL
    np.testing.assert_array_equal(by_them.A, mine.A)
    assert by_me.gamma == theirs.gamma and by_me.r == theirs.r
    assert _rel(by_me.transform(x), theirs.transform(x)) <= KPCA_RTOL


def test_reference_pt_state_with_gamma_none(gauss_data, tmp_path):
    """A reference ``.pt`` state leaves gamma unresolved: both packages pin
    the median heuristic over the landmarks' positive squared distances."""
    base = J.compute_kernel_pca(gauss_data, r=6, landmarks=64, seed=3)
    path = str(tmp_path / "reference_kpca.pt")
    torch.save({"landmarks": torch.from_numpy(base.landmarks), "A": torch.from_numpy(base.A),
                "row_means": torch.from_numpy(base.row_means), "K_mean": base.K_mean,
                "kernel_name": "rbf", "gamma": None}, path)
    theirs = J.KernelPCAState.load(path)
    mine = P.KernelPCAState.load(path, device="cpu")
    assert mine.gamma is None and mine.r == 6 and mine.degree == 3
    x = gauss_data[:20]
    za, zb = theirs.transform(x), mine.transform(x)
    assert abs(mine.gamma / theirs.gamma - 1) <= GAMMA_RTOL
    assert _rel(zb, za) <= KPCA_RTOL


# ---------------------------------------------------------------------------
# ZCA
# ---------------------------------------------------------------------------
ZCA_CASES = [dict(eps=1e-6), dict(gamma=0.1, eps=1e-5), dict(eps=1e-6, rank=8, alpha=0.5),
             dict(rank=4, alpha=0.0), dict(eps=1e-6, dtype=np.float64)]


@pytest.mark.parametrize("kw", ZCA_CASES, ids=lambda kw: "-".join(map(str, kw.values())))
@pytest.mark.parametrize("n", [500, 20])  # full rank; fewer samples than features
def test_zca_is_vit_tpus(gauss_data, kw, n):
    data = gauss_data[:n]
    a = J.ZCAWhitening(**kw).fit(data)
    b = P.ZCAWhitening(device="cpu", **kw).fit(data)
    sa, sb = a._state, b._state
    for key in ("mean", "whitening", "covariance", "eigenvalues"):
        got, want = getattr(sb, key), getattr(sa, key)
        assert got.dtype == want.dtype
        assert _rel(got, want) <= ZCA_RTOL, key
    assert sb.metadata == sa.metadata
    _assert_basis(sb.eigenvectors.astype(np.float64), sa.eigenvectors.astype(np.float64),
                  sa.eigenvalues, PROJ_ATOL)
    if kw.get("rank"):
        pa, pb = sa.projector.astype(np.float64), sb.projector.astype(np.float64)
        assert np.abs(pb.T @ pb - pa.T @ pa).max() <= PROJ_ATOL  # the projector's subspace
        assert b.project(data[:5]).shape == a.project(data[:5]).shape == (5, kw["rank"])
    x = gauss_data[-10:]
    assert _rel(b.transform(x), a.transform(x)) <= ZCA_X_RTOL
    y = np.random.default_rng(1).standard_normal((10, 32)).astype(np.float32)
    assert _rel(b.inverse_transform(y), a.inverse_transform(y)) <= ZCA_X_RTOL
    np.testing.assert_array_equal(b.whitening_matrix, sb.whitening)


def test_zca_whitens_and_round_trips(gauss_data):
    zca = P.ZCAWhitening(eps=1e-6, device="cpu")
    out = zca.fit_transform(gauss_data)
    np.testing.assert_allclose(np.cov(out.T), np.eye(32), atol=0.15)
    back = zca.inverse_transform(zca.transform(gauss_data[:10]))
    np.testing.assert_allclose(back, gauss_data[:10], rtol=1e-2, atol=1e-2)
    with pytest.raises(RuntimeError, match="No projector"):
        zca.project(gauss_data[:2])
    with pytest.raises(RuntimeError, match="not been fitted"):
        P.ZCAWhitening(device="cpu").transform(gauss_data[:2])
    with pytest.raises(ValueError, match="gamma"):
        P.ZCAWhitening(gamma=1.5, device="cpu")


@pytest.mark.parametrize("rank", [None, 8])
def test_zca_artifacts_load_in_both_packages(gauss_data, tmp_path, rank):
    mine = P.ZCAWhitening(eps=1e-6, rank=rank, alpha=0.5, device="cpu").fit(gauss_data)
    theirs = J.ZCAWhitening(eps=1e-6, rank=rank, alpha=0.5).fit(gauss_data)
    mine.save(str(tmp_path / "port.npz"))
    theirs.save(str(tmp_path / "jax"))  # the suffix is added
    by_them = J.ZCAWhitening.load(str(tmp_path / "port.npz"))
    by_me = P.ZCAWhitening.load(str(tmp_path / "jax.npz"), device="cpu")
    x = gauss_data[:7]
    np.testing.assert_array_equal(by_them.whitening_matrix, mine.whitening_matrix)
    np.testing.assert_array_equal(by_me.whitening_matrix, theirs.whitening_matrix)
    assert _rel(by_me.transform(x), theirs.transform(x)) <= ZCA_X_RTOL
    assert _rel(by_them.transform(x), mine.transform(x)) <= ZCA_X_RTOL
    assert (by_me.rank, by_me.alpha, by_me.eps) == (rank, 0.5, 1e-6)
    if rank:
        np.testing.assert_array_equal(by_me._state.projector, theirs._state.projector)


# ---------------------------------------------------------------------------
# PCP
# ---------------------------------------------------------------------------
def _pcp_data(transpose=False):
    rng = np.random.default_rng(1)
    n, m, r = 200, 100, 3
    L = rng.standard_normal((n, r)) @ rng.standard_normal((r, m)) / np.sqrt(r)
    S = np.zeros((n, m))
    idx = rng.random((n, m)) < 0.05
    S[idx] = rng.standard_normal(int(idx.sum())) * 5
    D = L + S
    return (D.T, idx.T) if transpose else (D, idx)


@pytest.mark.parametrize("transpose,kw", [(False, dict(max_iter=500, tol=1e-6)), (False, {}),
                                          (True, dict(max_iter=500, tol=1e-6)),
                                          (False, dict(lambda_=0.08, mu=0.05, tol=1e-6))])
def test_pcp_is_vit_tpus(transpose, kw):
    D, idx = _pcp_data(transpose)
    La, Sa, ha = J.compute_pcp(D, **kw)
    Lb, Sb, hb = P.compute_pcp(D, device="cpu", **kw)
    norm = np.linalg.norm(D)
    assert Lb.dtype == Sb.dtype == np.float64
    if "lambda_" not in kw:  # vit_tpu's default lambda_ makes its loop float64 too
        assert La.dtype == Sa.dtype == np.float64
    assert np.abs(Lb - La).max() <= PCP_TOL * norm
    assert np.abs(Sb - Sa).max() <= PCP_TOL * norm
    assert abs(hb["iters"] - ha["iters"]) <= PCP_ITER_SLACK
    assert len(hb["primal_resid"]) == len(hb["rank"]) == len(hb["nnz"]) == hb["iters"]
    assert hb["primal_resid"][-1] < kw.get("tol", 1e-7) <= hb["primal_resid"][-2]
    spike = np.abs(Sb[idx]).sum() / (np.abs(Sb).sum() + 1e-12)
    assert spike > 0.5


# ---------------------------------------------------------------------------
# Facade and CLIs (HDF5 read on the CPU: the card's machine has no h5py)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    """write_dummy_h5's file with correlated Gaussian rows as the flux:
    vit_tpu's float32 kernel distances on spectra are only good to ~1e-4
    (test_kpca_features_on_spectra_hold_float64), which its KPCA fit turns
    into ~1e-3 of a feature, so the facade and the CLIs are compared on
    data where vit_tpu is accurate."""
    from vit_tpu.data.synthetic import write_dummy_h5

    data = make_dummy_spectra(n=48, length=256, seed=5)
    rng = np.random.default_rng(5)
    data["flux"] = (1.0 + rng.standard_normal((48, 256)) @ rng.standard_normal((256, 256))
                    / 16).astype(np.float32)
    path = tmp_path_factory.mktemp("prepca") / "dataset.h5"
    write_dummy_h5(str(path), data=data)
    return str(path)


def test_preprocessing_pipeline_is_vit_tpus(h5_file):
    a = J.PreprocessingPipeline(h5_file, num_samples=40)
    b = P.PreprocessingPipeline(h5_file, num_samples=40, device="cpu")
    np.testing.assert_array_equal(b.flux, a.flux)
    np.testing.assert_array_equal(b.wave, a.wave)
    pa, pb = a.run("pca", patch_size=16), b.run("PCA", patch_size=16)
    np.testing.assert_allclose(pb["singular_values"], pa["singular_values"], rtol=PCA_S_RTOL)
    np.testing.assert_array_equal(pb["wave"], pa["wave"])
    ka, kb = a.run("kpca", r=4, landmarks=32), b.run("kpca", r=4, landmarks=32)
    np.testing.assert_array_equal(kb["state"].landmarks, ka["state"].landmarks)
    _assert_features(ka["state"].transform(a.flux[:5]), kb["state"].transform(b.flux[:5]),
                     _kpca_lam(ka["state"]))
    za, zb = a.run("zca", eps=1e-5), b.run("zca", eps=1e-5)
    assert _rel(zb["zca"].whitening_matrix, za["zca"].whitening_matrix) <= ZCA_RTOL
    ca, cb = a.run("pcp", max_iter=50, tol=1e-5), b.run("pcp", max_iter=50, tol=1e-5)
    assert np.abs(cb["low_rank"] - ca["low_rank"]).max() <= PCP_TOL * np.linalg.norm(a.flux)
    assert abs(cb["history"]["iters"] - ca["history"]["iters"]) <= PCP_ITER_SLACK
    other = np.random.default_rng(0).standard_normal((40, 8))
    assert b.run("cka", other=other)["cka"] == a.run("cka", other=other)["cka"]
    with pytest.raises(ValueError, match="Unknown"):
        b.run("ica")


def _jax_cli(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_precompute_pca_cli_on_spectra(h5_file, tmp_path, monkeypatch, suffix):
    import vit_tpu.prepca.precompute_pca as jcli
    import vit_tpu_torch.prepca.precompute_pca as pcli
    from vit_tpu.utils import load_patch_pca_stats as j_load
    from vit_tpu_torch.utils import load_patch_pca_stats as p_load

    monkeypatch.setenv("PCA_DIR", str(tmp_path))
    args = ["--data", h5_file, "--patch-size", "16", "--step", "8", "--limit", "32"]
    pcli.main(args + ["--out", f"port{suffix}", "--device", "cpu"])
    _jax_cli(monkeypatch, jcli, args + ["--out", f"jax{suffix}"])
    mine, theirs = j_load(str(tmp_path / f"port{suffix}")), j_load(str(tmp_path / f"jax{suffix}"))
    assert set(mine) == set(theirs) >= {"U", "V", "S", "mean", "components", "step"}
    for key in ("patch_size", "step", "num_patches"):
        assert int(mine[key]) == int(theirs[key])
    np.testing.assert_allclose(mine["S"], theirs["S"], rtol=PCA_S_RTOL)
    _assert_basis(mine["V"], theirs["V"], theirs["S"].astype(np.float64) ** 2, PCA_V_ATOL)
    np.testing.assert_array_equal(p_load(str(tmp_path / f"jax{suffix}"))["components"],
                                  theirs["components"])


def test_precompute_pca_cli_on_images_default_name(tmp_path, monkeypatch):
    import vit_tpu.prepca.precompute_pca as jcli
    import vit_tpu_torch.prepca.precompute_pca as pcli
    from vit_tpu.data.images import write_dummy_images_npz
    from vit_tpu.utils import load_patch_pca_stats as j_load

    npz = write_dummy_images_npz(str(tmp_path / "imgs.npz"), n=24, image_size=16, seed=1)
    monkeypatch.setenv("PCA_DIR", str(tmp_path / "port"))
    pcli.main(["--images", npz, "--patch-size", "4", "--device", "cpu", "--plot"])
    monkeypatch.setenv("PCA_DIR", str(tmp_path / "jax"))
    _jax_cli(monkeypatch, jcli, ["--images", npz, "--patch-size", "4"])
    mine = j_load(str(tmp_path / "port" / "pca_patch_4_s4.npz"))
    theirs = j_load(str(tmp_path / "jax" / "pca_patch_4_s4.npz"))
    assert set(mine) == set(theirs) and mine["U"].shape == (0,)
    np.testing.assert_allclose(mine["explained_variance_ratio"],
                               theirs["explained_variance_ratio"], rtol=0, atol=1e-6)
    _assert_basis(mine["components"], theirs["components"],
                  theirs["explained_variance_ratio"].astype(np.float64), 1e-4)


@pytest.mark.parametrize("suffix,r,landmarks", [(".npz", 6, 32), (".pt", 4, 40)])
def test_precompute_kpca_cli(h5_file, tmp_path, monkeypatch, suffix, r, landmarks):
    import vit_tpu.prepca.precompute_kpca as jcli
    import vit_tpu_torch.prepca.precompute_kpca as pcli

    args = ["--data", h5_file, "--r", str(r), "--landmarks", str(landmarks), "--seed", "4"]
    pcli.main(args + ["--out", str(tmp_path / "out" / f"port{suffix}"), "--device", "cpu"])
    _jax_cli(monkeypatch, jcli, args + ["--out", str(tmp_path / f"jax{suffix}")])
    mine = J.KernelPCAState.load(str(tmp_path / "out" / f"port{suffix}"))
    theirs = J.KernelPCAState.load(str(tmp_path / f"jax{suffix}"))
    np.testing.assert_array_equal(mine.landmarks, theirs.landmarks)
    assert abs(mine.gamma / theirs.gamma - 1) <= GAMMA_RTOL
    x = J.load_spectra(h5_file)["flux"][:10]
    _assert_features(theirs.transform(x), mine.transform(x), _kpca_lam(theirs))


def test_entry_points_raise_without_cuda(gauss_data, h5_file, tmp_path):
    from vit_tpu_torch.prepca.attention import KPCAWarmSelfAttention
    from vit_tpu_torch.prepca.precompute_kpca import main as kpca_main
    from vit_tpu_torch.prepca.precompute_pca import main as pca_main
    from vit_tpu_torch.spectro import SVDDenoiser

    assert not torch.cuda.is_available()
    state = P.compute_kernel_pca(gauss_data, r=4, landmarks=16, device="cpu")
    calls = [
        lambda: P.compute_pca(gauss_data, patch_size=8),
        lambda: P.compute_kernel_pca(gauss_data, r=4),
        lambda: P.ZCAWhitening().fit(gauss_data),
        lambda: P.compute_pcp(gauss_data[:20]),
        lambda: SVDDenoiser(2).fit(gauss_data),
        lambda: KPCAWarmSelfAttention(32, 2, state),
        lambda: P.PreprocessingPipeline(h5_file),
        lambda: P.KernelPCAState.load("unused.npz"),
        lambda: state.transform(gauss_data[:2], device="cuda"),
        lambda: pca_main(["--data", h5_file, "--patch-size", "8"]),
        lambda: kpca_main(["--data", h5_file, "--out", str(tmp_path / "k.npz")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not os.path.exists(tmp_path / "k.npz")


# ---------------------------------------------------------------------------
# KPCA-warm attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel,bias,qk_dim", [("rbf", False, None), ("rbf", True, 6),
                                                ("poly", True, None), ("linear", False, 3)])
def test_kpca_warm_attention_is_vit_tpus(kernel, bias, qk_dim):
    from vit_tpu.prepca.attention import KPCAWarmSelfAttention as JaxAttention
    from vit_tpu_torch.prepca.attention import KPCAWarmSelfAttention
    from vit_tpu_torch.train.torch_bridge import from_flax_kpca_attention

    rng = np.random.default_rng(3)
    dim = 16
    data = rng.standard_normal((200, dim)).astype(np.float32)
    kw = dict(r=8, landmarks=64, seed=0, kernel_name=kernel)
    jstate, pstate = J.compute_kernel_pca(data, **kw), P.compute_kernel_pca(data, device="cpu", **kw)
    jm = JaxAttention(dim=dim, num_heads=2, kpca_state=jstate, qk_dim=qk_dim, use_bias=bias)
    x = rng.standard_normal((2, 5, dim)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    noise = np.random.default_rng(1)  # move every parameter off its init
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * noise.standard_normal(a.shape).astype(np.float32), params)
    pm = KPCAWarmSelfAttention(dim, 2, pstate, qk_dim=qk_dim, use_bias=bias, device="cpu")
    assert pm.d_k == jm.d_k
    ident = np.asarray(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]["q_adapter"]
                       ["kernel"])
    np.testing.assert_array_equal(pm.q_adapter.weight.detach().numpy(), ident.T)
    np.testing.assert_array_equal(pm.k_adapter.weight.detach().numpy(), ident.T)
    sd = from_flax_kpca_attention(jax.tree_util.tree_map(np.asarray, params))
    pm.load_state_dict(sd, strict=True)
    out, probs = jm.apply(params, jnp.asarray(x), need_weights=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    o, p = pm(xt, need_weights=True)
    assert np.abs(o.detach().numpy() - np.asarray(out)).max() <= ATTN_TOL
    assert np.abs(p.detach().numpy() - np.asarray(probs)).max() <= ATTN_TOL
    assert p.dtype == torch.float32
    w = rng.standard_normal(out.shape).astype(np.float32)
    gp, gx = jax.grad(lambda prm, xx: (jm.apply(prm, xx) * w).sum(), argnums=(0, 1))(
        params, jnp.asarray(x))
    (o * torch.from_numpy(w)).sum().backward()
    assert np.abs(xt.grad.numpy() - np.asarray(gx)).max() <= ATTN_TOL
    want = from_flax_kpca_attention(jax.tree_util.tree_map(np.asarray, gp))
    got = {k: v.grad for k, v in pm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert np.abs(got[k].numpy() - want[k].numpy()).max() <= ATTN_TOL, k
    assert pm(xt).shape == (2, 5, dim)


def test_kpca_warm_attention_resolves_a_reference_gamma(gauss_data):
    from vit_tpu.prepca.attention import KPCAWarmSelfAttention as JaxAttention
    from vit_tpu_torch.prepca.attention import KPCAWarmSelfAttention

    fitted = P.compute_kernel_pca(gauss_data, r=4, landmarks=32, seed=0, device="cpu")
    unresolved = dataclasses.replace(fitted, gamma=None)
    theirs = J.KernelPCAState(**{k: v for k, v in unresolved.__dict__.items() if k != "device"})
    pm = KPCAWarmSelfAttention(32, 2, unresolved, device="cpu")
    jm = JaxAttention(dim=32, num_heads=2, kpca_state=theirs)
    x = gauss_data[:6].reshape(1, 6, 32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    from vit_tpu_torch.train.torch_bridge import from_flax_kpca_attention

    pm.load_state_dict(from_flax_kpca_attention(jax.tree_util.tree_map(np.asarray, params)))
    assert abs(unresolved.gamma / theirs.gamma - 1) <= GAMMA_RTOL
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = pm(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() <= ATTN_TOL * max(1.0, np.abs(want).max())
