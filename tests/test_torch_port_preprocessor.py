"""The port's covariance preprocessors against vit_tpu's: the statistics and
their cache, the ZCA/PCA matrices, the builder's names and checks, the
forward through weights carried from vit_tpu, the freeze schedule in
training (tests/test_preprocessor_integration.py's cases), and two epochs
against vit_tpu's Experiment.

Both packages read the same statistics file: whitening matrices are
ill-conditioned, so stats recomputed on each side would differ by more than
the packages do.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.models import preprocessor as jpre
from vit_tpu.models.builder import get_model as jax_get_model
from vit_tpu.prepca import stats as jstats
from vit_tpu.train import optim as jopt
from vit_tpu.train.loop import Experiment as JaxExperiment
from vit_tpu.train.torch_bridge import to_torch_state_dict
from vit_tpu.utils import clear_cov_cache as jax_clear_cov_cache
from vit_tpu_torch.models import preprocessor as pre
from vit_tpu_torch.models.builder import get_model
from vit_tpu_torch.prepca import stats
from vit_tpu_torch.train.loop import Experiment
from vit_tpu_torch.train.torch_bridge import from_flax_params
from vit_tpu_torch.utils import clear_cov_cache, load_cov_stats, save_cov_stats

MATRIX_TOL = 1e-6  # float64 numpy on both sides, rounded to fp32 once
STATS_TOL = 1e-5  # relative L2: fp32 covariance products summed in another order
FP32_TOL = 1e-5  # logits through a preprocessor, fp32
# test_two_epochs_match_vit_tpu_experiment's and test_three_steps_match_
# make_train_step's limits (tests/test_torch_port_train.py)
METRIC_REL = 1e-4
PARAM_TOL = 1e-5
# The attention key biases get gradients that are zero in exact arithmetic
# (softmax ignores a per-row constant), ~1e-11 of rounding noise in each
# framework, which Adam scales up to steps of ~lr * g / eps: over twelve
# steps they drift by ~1e-5 apart from their start in both, independently.
# They are held to stay within 1e-4 of each other; every other parameter
# to PARAM_TOL, of the tensor's largest value where that exceeds 1 (the ZCA
# weights reach ~90, where one fp32 ulp is 7.6e-6).
KEY_BIAS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def cov_path(tiny_config, tmp_path):
    """Covariance stats over the synthetic training flux (512 pixels),
    computed by vit_tpu and read by both packages."""
    clear_cov_cache()
    jax_clear_cov_cache()
    from vit_tpu.data.hdf5 import load_spectra

    flux = load_spectra(tiny_config["data"]["file_path"], 96)["flux"]
    path = str(tmp_path / "cov.npz")
    jstats.compute_covariance_stats(flux, save_path=path)
    yield path
    clear_cov_cache()


def _warm_config(tiny_config, cov_path, **warmup):
    cfg = copy.deepcopy(tiny_config)  # the builder adjusts model.image_size in place
    cfg["train"] = dict(cfg["train"], ep=2, batch_size=16)
    cfg["opt"] = {"type": "AdamW", "lr": 3e-3, "lr_sch": "none"}
    cfg["warmup"] = {"cov_path": cov_path, **warmup}
    return cfg


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / np.linalg.norm(np.asarray(b, np.float64)))


# -- matrices and statistics ---------------------------------------------------
def _eig(n=40, d=24, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, d)) @ np.diag(np.linspace(2, 0.01, d))
    w, v = np.linalg.eigh(np.cov(x, rowvar=False))
    return v[:, ::-1].astype(np.float32), np.clip(w[::-1], 0, None).astype(np.float32)


@pytest.mark.parametrize("kind, r, shrinkage", [
    ("zca", None, 0.0), ("zca", None, 0.1), ("zca", 8, 0.0), ("zca", 8, 0.3),
    ("zca", 24, 0.1), ("pca", None, None), ("pca", 8, None)])
def test_zca_and_pca_matrices_match_vit_tpu(kind, r, shrinkage):
    v, w = _eig()
    if kind == "zca":
        got = pre.compute_zca_matrix(v, w, eps=1e-5, r=r, shrinkage=shrinkage)
        want = jpre.compute_zca_matrix(v, w, eps=1e-5, r=r, shrinkage=shrinkage)
    else:
        got, want = pre.compute_pca_matrix(v, r=r), jpre.compute_pca_matrix(v, r=r)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=MATRIX_TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("ext", [".npz", ".pt"])
def test_load_cov_stats_reads_npz_and_pt(tmp_path, ext):
    from vit_tpu.utils import load_cov_stats as jax_load

    v, w = _eig()
    raw = {"mean": np.arange(24, dtype=np.float32), "cov": np.eye(24, dtype=np.float32),
           "eigvals": w, "eigvecs": v, "num_samples": np.asarray(40)}
    path = str(tmp_path / f"cov{ext}")
    save_cov_stats(raw, path)
    clear_cov_cache()
    got = load_cov_stats(path)
    want = jax_load(path, use_cache=False)
    assert set(got) == set(want) == set(raw)
    for k in raw:
        assert isinstance(got[k], np.ndarray) and np.array_equal(got[k], want[k]), k
    assert load_cov_stats(path) is got  # cached by the resolved path
    clear_cov_cache()
    assert load_cov_stats(path) is not got
    bad = str(tmp_path / f"bad{ext}")
    save_cov_stats({"mean": raw["mean"], "eigvecs": v}, bad)
    with pytest.raises(KeyError, match=r"\['cov', 'eigvals'\]"):
        load_cov_stats(bad)
    with pytest.raises(FileNotFoundError):
        load_cov_stats(str(tmp_path / "missing.npz"))
    with pytest.raises(ValueError, match="Unsupported"):
        save_cov_stats(raw, str(tmp_path / "cov.txt"))


def test_compute_covariance_stats_matches_vit_tpu(tmp_path):
    """mean and covariance within 1e-5 relative L2, eigenvalues too; the
    eigenvectors (arbitrary in sign and inside near-degenerate clusters)
    through the covariance they rebuild. Saved to .npz with its two plots."""
    data = np.random.default_rng(1).standard_normal((300, 48)).astype(np.float32)
    data[:, :8] *= 5.0
    path = str(tmp_path / "port.npz")
    got = stats.compute_covariance_stats(data, save_path=path, device="cpu")
    want = jstats.compute_covariance_stats(data)
    for k in ("mean", "cov", "eigvals"):
        assert getattr(got, k).dtype == np.float32
        assert _rel(getattr(got, k), getattr(want, k)) <= STATS_TOL, k
    assert got.num_samples == 300 and np.all(np.diff(got.eigvals) <= 0)
    rebuilt = (got.eigvecs * got.eigvals) @ got.eigvecs.T
    assert _rel(rebuilt, want.cov) <= STATS_TOL
    loaded = stats.load_covariance_stats(path)
    assert loaded.num_samples == 300 and np.array_equal(loaded.cov, got.cov)
    for plot in ("port_heatmap.png", "port_eigenvalues.png"):
        assert (tmp_path / plot).exists()
    assert stats.load_or_compute_covariance(path).num_samples == 300
    fresh = str(tmp_path / "sub" / "fresh.npz")
    made = stats.load_or_compute_covariance(fresh, data=data, device="cpu")
    assert np.array_equal(made.cov, got.cov)
    assert set(stats.ensure_covariance(fresh)) == {"mean", "cov", "num_samples", "eigvals",
                                                   "eigvecs"}
    with pytest.raises(ValueError, match="Data must be provided"):
        stats.load_or_compute_covariance(str(tmp_path / "none.npz"))
    with pytest.raises(FileNotFoundError):
        stats.ensure_covariance(str(tmp_path / "none.npz"), compute_if_missing=False)


def test_covariance_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stats.compute_covariance_stats(np.zeros((4, 3), np.float32))


def test_zca_self_check_passes_and_fails():
    v, w = _eig(n=200, d=16, seed=3)
    cov = (v * w) @ v.T
    P = pre.compute_zca_matrix(v, w, eps=0.0, shrinkage=0.0)
    got = stats.zca_self_check(P, cov)
    want = jstats.zca_self_check(P, cov)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert got[0] < 0.1 and got[1] > got[2]
    Vr = v[:, :4]
    low = pre.compute_zca_matrix(v, w, eps=0.0, r=4, shrinkage=0.0)
    assert stats.zca_self_check(low, cov, lowrank=True, Vr=Vr)[0] < 0.1
    with pytest.raises(AssertionError, match="ZCA self-check failed"):
        stats.zca_self_check(2.0 * P, cov)
    with pytest.raises(AssertionError, match="ZCA self-check failed"):
        stats.zca_self_check(pre.compute_zca_matrix(v, w, eps=1e-5, shrinkage=0.5), cov)
    with pytest.raises(ValueError, match="Vr basis"):
        stats.zca_self_check(low, cov, lowrank=True)


# -- builder -------------------------------------------------------------------
BUILDS = {
    "pca64": dict(preprocessor="pca", r=64),
    "pca_full_nobias": dict(preprocessor="pca", bias=False, freeze_epochs=3),
    "zca_full_s1_perm": dict(preprocessor="zca", eps=1e-5, shrinkage=0.1, freeze_epochs=-1),
    "zca16_nobias": dict(preprocessor="zca", r=16, bias=False, freeze_epochs=1),
    "attn32": dict(preprocessor="attention", r=32),
    "attn_full_unscaled": dict(preprocessor="attention", scale_by_eigvals=False),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_builder_names_and_image_size_match_vit_tpu(tiny_config, cov_path, name, capsys):
    jcfg = _warm_config(tiny_config, cov_path, **BUILDS[name])
    pcfg = copy.deepcopy(jcfg)
    jb = jax_get_model(jcfg)
    jout = capsys.readouterr().out
    pb = get_model(pcfg)
    pout = capsys.readouterr().out
    assert pout == jout and "[builder] Created" in pout
    assert pb.model_name == jb.model_name
    assert pcfg["model"]["image_size"] == jcfg["model"]["image_size"]
    assert (pb.freeze_epochs, pb.has_preprocessor, pb.preprocessor_desc) == (
        jb.freeze_epochs, jb.has_preprocessor, jb.preprocessor_desc)
    assert pb.module.input_length == 512
    assert pb.vit_config == type(pb.vit_config)(**{
        f: getattr(jb.vit_config, f) for f in pb.vit_config.__dataclass_fields__})


def test_builder_errors(tiny_config, cov_path):
    cfg = copy.deepcopy(tiny_config)
    cfg["warmup"] = {"preprocessor": "pca", "r": 16}
    with pytest.raises(ValueError, match="cov_path"):
        get_model(cfg)
    cfg = _warm_config(tiny_config, cov_path, preprocessor="pca", r=16)
    cfg["model"]["image_size"] = 4096
    with pytest.raises(ValueError, match="Mismatch: eigvecs dimension 512 != image_size 4096"):
        get_model(cfg)
    with pytest.raises(ValueError, match="exceeds the 512 eigenvector columns"):
        get_model(_warm_config(tiny_config, cov_path, preprocessor="attention", r=600))
    with pytest.raises(ValueError, match="Unknown preprocessor type"):
        get_model(_warm_config(tiny_config, cov_path, preprocessor="kpca"))
    image = _warm_config(tiny_config, cov_path, preprocessor="pca")
    image["model"]["input_kind"] = "image"
    with pytest.raises(ValueError, match="patch dim"):  # a spectra basis is no patch basis
        get_model(image)
    # The image family's patch-PCA builder: a patch basis of 4 x 4 x 3 patches.
    from vit_tpu_torch.data.images import make_dummy_images
    from vit_tpu_torch.prepca.pipeline import compute_patch_pca_images

    stats = compute_patch_pca_images(make_dummy_images(16, 16)["images"], patch_size=4,
                                     device="cpu")
    patch_path = str(os.path.join(os.path.dirname(cov_path), "patch_pca.npz"))
    np.savez(patch_path, components=stats["components"], mean=stats["mean"])
    image["model"].update(image_size=16, patch_size=4, task_type="cls", num_labels=3)
    image["warmup"].update(cov_path=patch_path, r=12)
    bundle = get_model(image)
    assert bundle.has_preprocessor and bundle.model_name.startswith("PCAp12_fz0_ViT")
    assert bundle.module.eval()(torch.zeros((2, 16, 16, 3))).shape == (2, 3)
    for off in ("none", None):
        cfg = _warm_config(tiny_config, cov_path, preprocessor=off)
        assert not get_model(cfg).has_preprocessor and cfg["model"]["image_size"] == 512


@pytest.mark.parametrize("name", ["zca_full_s1_perm", "zca16_nobias", "pca64", "attn32",
                                  "attn_full_unscaled"])
def test_forward_matches_vit_tpu_through_its_state_dict(tiny_config, cov_path, name):
    """vit_tpu's params written by to_torch_state_dict load with strict=True
    and equal from_flax_params; the logits agree within 1e-5 (fp32)."""
    cfg = _warm_config(tiny_config, cov_path, **BUILDS[name])
    cfg["model"]["attn_impl"] = "flash"
    pcfg = copy.deepcopy(cfg)
    jb = jax_get_model(cfg)
    x = np.random.default_rng(2).standard_normal((3, 512)).astype(np.float32)
    params = jb.module.init(jax.random.PRNGKey(0), x[:1])["params"]
    want = np.asarray(jb.module.apply({"params": params}, x))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    sd = {k: torch.from_numpy(np.array(v, order="C"))
          for k, v in to_torch_state_dict(np_params, jb.vit_config).items()}
    pb = get_model(pcfg)
    assert set(pb.module.state_dict()) == set(sd)
    assert [k for k in sd if k.startswith("preprocessor.")] == [
        k for k in pb.module.state_dict() if k.startswith("preprocessor.")]
    for k, v in pb.module.state_dict().items():
        if k.startswith("preprocessor."):  # the prefilled constants, before any load
            np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
    pb.module.load_state_dict(sd, strict=True)
    for k, v in from_flax_params(np_params, pb.vit_config).items():
        assert torch.equal(v, sd[k]), k
    with torch.no_grad():
        got = pb.module.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)


def test_linear_preprocessor_runs_in_fp32_under_bf16(tiny_config, cov_path):
    cfg = _warm_config(tiny_config, cov_path, preprocessor="zca", shrinkage=0.1)
    cfg["train"]["precision"] = "bf16"
    m = get_model(cfg).module
    x = torch.randn(2, 512, generator=torch.Generator().manual_seed(0))
    y = m.preprocessor(x)
    assert y.dtype == torch.float32
    P = m.preprocessor.linear
    torch.testing.assert_close(y, x @ P.weight.t() + P.bias, atol=0, rtol=0)
    assert m.eval()(x).dtype == torch.float32


@pytest.mark.parametrize("r", [6, None])
def test_prefilled_attention_token_input_matches_vit_tpu(r):
    """A 3-D input runs the full softmax attention (q_lin, k_lin, v_lin); a
    2-D one only q_lin. Holds exactly the parameters flax creates for each."""
    v, w = _eig(d=12)
    x = np.random.default_rng(4).standard_normal((2, 5, 12)).astype(np.float32)
    jmod = jpre.PrefilledAttention(input_dim=12, eigvecs=v, eigvals=w, r=r)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = pre.PrefilledAttention(12, v, eigvals=w, r=r, token_input=True)
    assert {n for n, _ in mod.named_parameters()} == {f"{k}.weight" for k in params}
    bound = 1.0 / np.sqrt(12)
    assert float(mod.v_lin.weight.detach().abs().max()) <= bound
    mod.load_state_dict({f"{k}.weight": torch.from_numpy(np.array(p["kernel"]).T.copy())
                         for k, p in params.items()}, strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)
    flat = pre.PrefilledAttention(12, v, eigvals=w, r=r)
    jflat = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x[:, 0]))["params"]
    assert {n for n, _ in flat.named_parameters()} == {f"{k}.weight" for k in jflat} == {
        "q_lin.weight"}
    with pytest.raises(ValueError, match="2-D"):
        flat(torch.from_numpy(x))


# -- training with the freeze schedule (test_preprocessor_integration.py) ----------
def test_pca_preprocessor_build_adjusts_image_size(tiny_config, cov_path):
    cfg = _warm_config(tiny_config, cov_path, preprocessor="pca", r=64)
    bundle = get_model(cfg)
    assert bundle.has_preprocessor
    assert cfg["model"]["image_size"] == 64
    assert bundle.model_name.startswith("PCA64_fz0_ViT")
    logits = bundle.module.eval()(torch.ones(2, 512))  # the ORIGINAL input dim
    assert logits.shape == (2, 1)
    assert any(k.startswith("preprocessor.") for k in bundle.module.state_dict())


def test_zca_preprocessor_full_rank(tiny_config, cov_path):
    cfg = _warm_config(tiny_config, cov_path, preprocessor="zca", eps=1e-5, shrinkage=0.1,
                       freeze_epochs=-1)
    bundle = get_model(cfg)
    assert cfg["model"]["image_size"] == 512
    assert bundle.model_name.startswith("ZCA_fzperm_s1_ViT")
    assert bundle.freeze_epochs == -1


def test_attention_preprocessor(tiny_config, cov_path):
    cfg = _warm_config(tiny_config, cov_path, preprocessor="attention", r=32)
    bundle = get_model(cfg)
    assert cfg["model"]["image_size"] == 32
    assert bundle.module.eval()(torch.ones(2, 512)).shape == (2, 1)
    assert "preprocessor.q_lin.weight" in bundle.module.state_dict()


def test_missing_cov_path_raises(tiny_config):
    cfg = copy.deepcopy(tiny_config)
    cfg["warmup"] = {"preprocessor": "pca", "r": 16}
    with pytest.raises(ValueError, match="cov_path"):
        get_model(cfg)


def test_eigvec_dim_mismatch_raises(tiny_config, cov_path):
    cfg = _warm_config(tiny_config, cov_path, preprocessor="pca", r=16)
    cfg["model"] = dict(cfg["model"], image_size=4096)
    with pytest.raises(ValueError, match="Mismatch"):
        get_model(cfg)


def test_freeze_schedule_holds_then_releases(tiny_config, cov_path, monkeypatch, tmp_path):
    """freeze_epochs=1: the preprocessor is bit-unchanged through epoch 0 and
    moves in epoch 1; preprocessor_frozen reads 1.0, then 0.0."""
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
    P = pre.compute_pca_matrix(load_cov_stats(cov_path)["eigvecs"], r=32)
    exp = Experiment(_warm_config(tiny_config, cov_path, preprocessor="pca", r=32,
                                  freeze_epochs=1), device="cpu", seed=0)
    exp.config["train"]["ep"] = 1
    exp.max_epochs = 1
    m = exp.fit()
    assert m["preprocessor_frozen"] == 1.0
    assert np.array_equal(exp.module.preprocessor.linear.weight.detach().numpy(), P)
    exp2 = Experiment(_warm_config(tiny_config, cov_path, preprocessor="pca", r=32,
                                   freeze_epochs=1), device="cpu", seed=0)
    m2 = exp2.fit()
    assert m2["preprocessor_frozen"] == 0.0
    assert not np.allclose(exp2.module.preprocessor.linear.weight.detach().numpy(), P,
                           rtol=1e-6)


def test_cls_preprocessor_test_only_entry(tiny_config, cov_path, monkeypatch, tmp_path):
    """The eval-only entry for cls + preprocessor: a fresh config finds the
    checkpoint under the prefixed name; the raw length is the split's."""
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
    cfg = _warm_config(tiny_config, cov_path, preprocessor="pca", r=32)
    cfg["model"] = dict(cfg["model"], task_type="cls", num_labels=2)
    cfg["train"].update(ep=1, save=True)
    Experiment(cfg, device="cpu", seed=0).fit()
    cfg2 = _warm_config(tiny_config, cov_path, preprocessor="pca", r=32)
    cfg2["model"] = dict(cfg2["model"], task_type="cls", num_labels=2)
    exp2 = Experiment(cfg2, device="cpu", seed=0)
    assert exp2.bundle.model_name.startswith("PCA32_fz0_ViT")
    m = exp2.test(ckpt="last")
    assert np.isfinite(m["test_acc"])


def test_permanent_freeze(tiny_config, cov_path, monkeypatch, tmp_path):
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
    cfg = _warm_config(tiny_config, cov_path, preprocessor="zca", freeze_epochs=-1,
                       shrinkage=0.1)
    exp = Experiment(cfg, device="cpu", seed=0)
    m = exp.fit()
    st = load_cov_stats(cov_path)
    P = pre.compute_zca_matrix(st["eigvecs"], st["eigvals"], eps=1e-5, shrinkage=0.1)
    assert m["preprocessor_frozen"] == 1.0
    np.testing.assert_array_equal(exp.module.preprocessor.linear.weight.detach().numpy(), P)


def test_split_length_is_checked_against_the_raw_input(tiny_config, cov_path):
    exp = Experiment(_warm_config(tiny_config, cov_path, preprocessor="pca", r=32),
                     device="cpu", seed=0)
    assert exp.module.input_length == 512 and exp.bundle.vit_config.image_size == 32

    class Short:
        flux = np.zeros((2, 32), np.float32)

    with pytest.raises(ValueError, match="length 32, but the model takes 512"):
        exp._check_input_length(Short())


def _jax_params(jexp):
    jexp.datamodule.setup("fit")  # the raw input length comes from the split
    spec = jopt.OptSpec.from_config(jexp.config, 1)
    jexp.state = jexp._init_state(jopt.build_optimizer(spec))
    return jax.tree_util.tree_map(np.asarray, jax.device_get(jexp.state.params))


def test_two_epochs_with_freeze_match_vit_tpu_experiment(tiny_config, cov_path, monkeypatch):
    """ZCA with freeze_epochs: 1 and AdamW with weight decay, dropout off, two
    epochs from the same weights: epoch metrics within 1e-4 relative,
    parameters within 1e-5 (see KEY_BIAS_TOL), the preprocessor bit-unchanged through epoch 0
    and moved in epoch 1 by the same amount in both."""
    cfg = _warm_config(tiny_config, cov_path, preprocessor="zca", shrinkage=0.1,
                       freeze_epochs=1)
    cfg["model"].update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg["opt"]["weight_decay"] = 0.05
    jexp = JaxExperiment(copy.deepcopy(cfg))
    params = _jax_params(jexp)
    p0 = params["preprocessor"]["kernel"].T.copy()
    jlog, jpre_w = [], []

    def jlog_epoch(epoch, metrics, step=None):
        jlog.append(dict(metrics))
        jpre_w.append(np.asarray(jexp.state.params["preprocessor"]["kernel"]).T.copy())

    monkeypatch.setattr(jexp.logger, "log_epoch", jlog_epoch)
    jexp.fit()

    exp = Experiment(copy.deepcopy(cfg), device="cpu")
    exp.module.load_state_dict(from_flax_params(params, exp.bundle.vit_config), strict=True)
    plog, ppre_w = [], []

    def plog_epoch(epoch, metrics, step=None):
        plog.append(dict(metrics))
        ppre_w.append(exp.module.preprocessor.linear.weight.detach().numpy().copy())

    monkeypatch.setattr(exp.logger, "log_epoch", plog_epoch)
    exp.fit()
    assert len(plog) == len(jlog) == 2
    for jm, pm in zip(jlog, plog):
        assert set(pm) == set(jm)
        for key in ("train_loss", "val_loss", "val_mae", "val_mse", "val_r2", "val_p90"):
            assert pm[key] == pytest.approx(jm[key], rel=METRIC_REL, abs=1e-6), key
        assert pm["preprocessor_frozen"] == jm["preprocessor_frozen"]
    assert [m["preprocessor_frozen"] for m in plog] == [1.0, 0.0]
    assert np.array_equal(ppre_w[0], p0) and np.array_equal(jpre_w[0], p0)
    assert np.abs(ppre_w[1] - p0).max() > 100 * PARAM_TOL
    want = from_flax_params(jax.tree_util.tree_map(np.asarray, jexp.state.params),
                            exp.bundle.vit_config)
    for k, v in exp.module.state_dict().items():
        w = want[k].numpy()
        tol = (KEY_BIAS_TOL if k.endswith("attention.key.bias")
               else PARAM_TOL * max(1.0, float(np.abs(w).max())))
        np.testing.assert_allclose(v.numpy(), w, atol=tol, rtol=0, err_msg=k)
