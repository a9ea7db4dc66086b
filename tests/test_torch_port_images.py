"""The port's image ViT family against vit_tpu's (ports of
``tests/test_images.py``): synthetic images and their datasets, the S/16
preset, the patch PCA (statistics, projector, builder), the image ViT's
forward and two epochs of its training from weights carried through the
bridge (the Conv2d patch kernel included), and serving.

Everything runs on the CPU in fp32 with the plain versions of the kernels;
dropout is off where the two packages are compared.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.data import images as jimages
from vit_tpu_torch.data import images as pimages
from vit_tpu_torch.train.torch_bridge import from_flax_params


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image_config(**model):
    cfg = {
        "project": "img-test",
        "model": {"name": "vit", "task_type": "cls", "input_kind": "image", "image_size": 32,
                  "patch_size": 8, "hidden_size": 32, "num_hidden_layers": 2,
                  "num_attention_heads": 2, "num_labels": 10, "num_channels": 3,
                  "pos_encoding_type": "learned", "hidden_dropout_prob": 0.0,
                  "attention_probs_dropout_prob": 0.0},
        "train": {"batch_size": 32, "ep": 2, "save": False},
        "loss": {"name": "ce"},
        "opt": {"type": "AdamW", "lr": 3e-3, "lr_sch": "none"},
        "data": {"num_samples": 128, "num_test_samples": 64},
        "noise": {"noise_level": 0},
        "viz": {"enable": False},
    }
    cfg["model"].update(model)
    return cfg


def test_make_dummy_images_is_vit_tpus_and_learnable():
    d = pimages.make_dummy_images(n=100, image_size=32, num_classes=10, seed=0)
    ref = jimages.make_dummy_images(n=100, image_size=32, num_classes=10, seed=0)
    for k in ("images", "labels"):
        np.testing.assert_array_equal(d[k], ref[k])
    assert d["images"].shape == (100, 32, 32, 3) and d["images"].dtype == np.uint8
    imgs = d["images"].astype(np.float32)
    means = [imgs[d["labels"] == c].mean() for c in range(3) if (d["labels"] == c).any()]
    assert len(set(np.round(means, 1))) > 1


def test_image_dataset_npz_fallback_and_missing_path(tmp_path):
    path = str(tmp_path / "cifar_like.npz")
    pimages.write_dummy_images_npz(path, n=64, image_size=32, seed=0)
    ds = pimages.ImageDataset(file_path=path, num_samples=48, image_size=32)
    ds.load_data("fit")
    ref = jimages.ImageDataset(file_path=path, num_samples=48, image_size=32)
    ref.load_data("fit")
    assert len(ds) == 48 and ds.images.dtype == np.float32
    np.testing.assert_array_equal(ds.images, ref.images)
    np.testing.assert_array_equal(ds.arrays()["label"], ref.arrays()["label"])
    for stage in ("fit", "val", "test"):
        fb = pimages.ImageDataset(file_path=None, num_samples=32, num_test_samples=16)
        fb.load_data(stage)
        jfb = jimages.ImageDataset(file_path=None, num_samples=32, num_test_samples=16)
        jfb.load_data(stage)
        np.testing.assert_array_equal(fb.images, jfb.images)
    with pytest.raises(FileNotFoundError):
        pimages.ImageDataset(file_path=str(tmp_path / "missing.npz")).load_data("fit")
    dm = pimages.ImageDataModule.from_config(_image_config())
    dm.setup("fit")
    assert len(dm.train) == 128 and dm.val_batch_size == 32


def test_image_preset_s16_shapes():
    from vit_tpu.models.builder import get_vit_config as jcfg
    from vit_tpu_torch.models.builder import get_model, get_vit_config

    cfg = {"model": {"name": "vit-s16", "task_type": "cls", "image_size": 224,
                     "num_labels": 1000, "input_kind": "image"}, "data": {}}
    vc = get_vit_config(copy.deepcopy(cfg))
    ref = jcfg(copy.deepcopy(cfg))
    assert vc.hidden_size == 384 == ref.hidden_size and vc.patch_size == 16
    assert vc.num_patches == 196 == ref.num_patches and vc.seq_len == 197 == ref.seq_len
    assert vc.num_channels == 3 and vc.num_hidden_layers == 12 == ref.num_hidden_layers
    module = get_model(copy.deepcopy(cfg)).module
    emb = module.vit.embeddings
    assert emb.patch_embeddings.projection.weight.shape == (384, 3, 16, 16)
    assert emb.position_embeddings.shape == (1, 197, 384)


def _patch_pca_artifact(tmp_path, patch=8, n=128):
    from vit_tpu_torch.prepca.pipeline import compute_patch_pca_images

    d = pimages.make_dummy_images(n=n, image_size=32, num_classes=10, seed=0)
    stats = compute_patch_pca_images(d["images"], patch_size=patch, device="cpu")
    path = str(tmp_path / f"pca_patch_img_{patch}.npz")
    np.savez(path, V=stats["components"], mean=stats["mean"],
             explained_variance_ratio=stats["explained_variance_ratio"],
             patch_size=stats["patch_size"])
    return path, stats, d["images"]


def test_compute_patch_pca_images_orthonormal_and_vit_tpus(tmp_path):
    """torch.linalg's statistics against vit_tpu's numpy ones: each basis
    column equal up to its sign (the eigensolvers choose signs freely)."""
    from vit_tpu.prepca.pipeline import compute_patch_pca_images as jpca

    _, stats, images = _patch_pca_artifact(tmp_path, patch=4)
    V = stats["components"]
    assert V.shape == (48, 48)
    np.testing.assert_allclose(V.T @ V, np.eye(48), atol=1e-4)
    evr = stats["explained_variance_ratio"]
    assert evr[0] >= evr[-1] and abs(float(evr.sum()) - 1.0) < 1e-4
    ref = jpca(images, patch_size=4)
    for k in ("mean", "explained_variance_ratio", "singular_values"):
        np.testing.assert_allclose(stats[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert int(stats["num_patches"]) == int(ref["num_patches"]) == 128 * 64
    signs = np.sign((V * ref["components"]).sum(0))
    top = evr > 1e-3  # well-separated directions; the tail's may rotate
    np.testing.assert_allclose((V * signs)[:, top], ref["components"][:, top], atol=1e-3)


def test_patch_pca_projector_is_vit_tpus(tmp_path):
    from vit_tpu.models.preprocessor import PatchPCAProjector as JProj
    from vit_tpu_torch.models.preprocessor import PatchPCAProjector

    _, stats, _ = _patch_pca_artifact(tmp_path, patch=8)
    V, mean = stats["components"][:, :16], stats["mean"]
    x = pimages.make_dummy_images(n=4, image_size=32, seed=1)["images"].astype(np.float32) / 255
    jmod = JProj(patch_size=8, num_channels=3, basis=V, mean=mean)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = PatchPCAProjector(8, 3, V, mean)
    got = mod(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (4, 16, 16)
    np.testing.assert_allclose(got, want, atol=1e-5)
    nchw = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy()
    np.testing.assert_array_equal(nchw, got)
    p = x.reshape(4, 4, 8, 4, 8, 3).transpose(0, 1, 3, 2, 4, 5).reshape(4, 16, -1)
    np.testing.assert_allclose(got, (p - mean) @ V, atol=1e-4)


def test_image_pca_basis_dim_mismatch(tmp_path):
    from vit_tpu_torch.models.builder import get_model

    pca_path, _, _ = _patch_pca_artifact(tmp_path, patch=4)  # dim 48
    cfg = _image_config(num_hidden_layers=1)
    cfg["warmup"] = {"preprocessor": "pca", "cov_path": pca_path}
    with pytest.raises(ValueError, match="patch dim"):
        get_model(cfg)
    cfg["model"]["patch_size"] = 4
    cfg["warmup"]["r"] = 49
    with pytest.raises(ValueError, match="exceeds"):
        get_model(cfg)


def _carried(cfg):
    """(vit_tpu bundle, its initial params, the port's module with them)."""
    from vit_tpu.models.builder import get_model as jget
    from vit_tpu_torch.models.builder import get_model

    jb = jget(copy.deepcopy(cfg))
    s = cfg["model"]["image_size"]
    params = jb.module.init(jax.random.PRNGKey(3), jnp.zeros((1, s, s, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    pb = get_model(copy.deepcopy(cfg))
    pb.module.load_state_dict(from_flax_params(params, pb.vit_config), strict=True)
    return jb, params, pb


@pytest.mark.parametrize("case", ["plain", "flash_fused", "rope", "pca"])
def test_image_vit_forward_is_vit_tpus(tmp_path, case):
    """Embeddings and the whole image ViT from carried weights: NHWC and
    NCHW inputs, within 1e-4 (fp32)."""
    model = {"flash_fused": dict(attn_impl="flash", fused_mlp=True),
             "rope": dict(pos_encoding_type="rope")}.get(case, {})
    cfg = _image_config(**model)
    if case == "pca":
        path, _, _ = _patch_pca_artifact(tmp_path, patch=8)
        cfg["warmup"] = {"preprocessor": "pca", "cov_path": path, "r": 24}
    jb, params, pb = _carried(cfg)
    x = np.random.default_rng(0).standard_normal((5, 32, 32, 3)).astype(np.float32)
    pb.module.eval()
    emb_in = jnp.asarray(x)
    if case == "pca":
        emb_in = jb.module.preprocessor.apply({"params": params["preprocessor"]}, emb_in)
    from vit_tpu.models.vit import ImageEmbeddings as JEmb

    jemb = np.asarray(JEmb(jb.vit_config).apply({"params": params["embeddings"]}, emb_in))
    pin = torch.from_numpy(x)
    if case == "pca":
        pin = pb.module.preprocessor(pin)
    np.testing.assert_allclose(pb.module.vit.embeddings(pin).detach().numpy(), jemb, atol=1e-4)
    want = np.asarray(jb.module.apply({"params": params}, jnp.asarray(x), deterministic=True))
    got = pb.module(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    nchw = pb.module(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).detach().numpy()
    np.testing.assert_allclose(nchw, got, rtol=0, atol=1e-6)


def _record_epochs(exp, monkeypatch):
    epochs = []
    monkeypatch.setattr(exp.logger, "log_epoch",
                        lambda epoch, metrics, step=None: epochs.append(dict(metrics)))
    return epochs


@pytest.mark.parametrize("case", ["plain", "pca"])
def test_two_image_epochs_match_vit_tpu_experiment(tmp_path, monkeypatch, case):
    """Two epochs of image training from vit_tpu's initial weights: train
    loss and validation metrics per epoch within rel 1e-4; behind the patch
    PCA with freeze_epochs 1, so the second epoch trains the projector."""
    from vit_tpu.train import optim as jopt
    from vit_tpu.train.loop import Experiment as JaxExperiment
    from vit_tpu_torch.train.loop import Experiment

    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
    cfg = _image_config()
    if case == "pca":
        path, _, _ = _patch_pca_artifact(tmp_path, patch=8)
        cfg["warmup"] = {"preprocessor": "pca", "cov_path": path, "r": 24, "freeze_epochs": 1}
    jexp = JaxExperiment(copy.deepcopy(cfg), seed=0)
    jexp.state = jexp._init_state(jopt.build_optimizer(jopt.OptSpec.from_config(jexp.config, 1)))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jexp.state.params))
    jlog = _record_epochs(jexp, monkeypatch)
    jexp.fit()
    exp = Experiment(copy.deepcopy(cfg), seed=0, device="cpu")
    exp.module.load_state_dict(from_flax_params(params, exp.bundle.vit_config), strict=True)
    plog = _record_epochs(exp, monkeypatch)
    exp.fit()
    assert len(plog) == len(jlog) == 2
    for jm, pm in zip(jlog, plog):
        for key in ("train_loss", "val_loss", "val_acc"):
            assert pm[key] == pytest.approx(jm[key], rel=1e-4, abs=1e-6), key
    if case == "pca":
        assert [m["preprocessor_frozen"] for m in plog] == [1.0, 0.0]
        basis = exp.module.preprocessor.linear.weight.detach().numpy()
        assert not np.allclose(basis, params["preprocessor"]["kernel"].T, atol=1e-7)


def test_image_model_serves_nhwc_and_nchw(tmp_path, monkeypatch):
    """An image model trained and saved by the port serves NHWC and NCHW
    images through Predictor, the model's own logits; spectra raise."""
    from vit_tpu_torch.serve import Predictor
    from vit_tpu_torch.train.loop import Experiment

    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
    cfg = _image_config()
    cfg["train"].update(ep=1, save=True)
    exp = Experiment(copy.deepcopy(cfg), seed=0, device="cpu")
    exp.fit()
    pred = Predictor.from_checkpoint(copy.deepcopy(cfg), ckpt="best", batch_size=8,
                                     device="cpu")
    x = pimages.ImageDataset(num_samples=20)
    x.load_data("fit")
    ids = pred.predict(x.images)
    assert ids.shape == (20,)
    np.testing.assert_array_equal(pred.predict(np.transpose(x.images, (0, 3, 1, 2))), ids)
    with torch.no_grad():
        want = exp.module.eval()(torch.from_numpy(x.images)).numpy()
    np.testing.assert_allclose(pred.predict_proba(x.images).argmax(-1), want.argmax(-1))
    with pytest.raises(ValueError, match="images of shape"):
        pred.predict(np.zeros((2, 4096), np.float32))
