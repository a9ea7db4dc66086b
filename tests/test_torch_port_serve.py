"""The port's Predictor and CLI against vit_tpu's Predictor on one .pt file."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from vit_tpu.models.builder import get_model as jax_get_model
from vit_tpu.serve import Predictor as JaxPredictor
from vit_tpu.train.torch_bridge import save_torch_checkpoint
from vit_tpu_torch.data.synthetic import make_dummy_spectra, write_dummy_h5
from vit_tpu_torch.serve import Predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = {"label_min": [0.25], "label_max": [4.75], "label_mean": None, "label_std": None}
TOL = 1e-4  # fp32 on the CPU; denormalised log_g spans ~[0, 5]
# perf_preset is bf16 with tanh GELU and bf16 softmax in both packages;
# rounding places differ (see test_torch_port_model.BF16_TOL), scaled by
# the 4.5-wide minmax range.
PRESET_TOL = 5e-2


def _config(task="reg", **model):
    return {
        "model": dict(name="vit", task_type=task, image_size=512, patch_size=32,
                      hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                      stride_size=16, proj_fn="SW", **model),
        "train": {"batch_size": 16, "compilation_cache": False},
        "data": {"param": "log_g", "label_norm": "minmax"},
        "noise": {"noise_level": 0},
    }


@pytest.fixture()
def served(tmp_path, monkeypatch):
    """A vit_tpu-initialised model written as .pt, with meta.yaml stats."""

    def make(task="reg", **model):
        cfg = _config(task, **model)
        monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
        bundle = jax_get_model(dict(cfg, model=dict(cfg["model"])))
        params = bundle.module.init(jax.random.PRNGKey(1), np.zeros((1, 512), np.float32))
        pt = str(tmp_path / "model.pt")
        save_torch_checkpoint(jax.device_get(params["params"]), bundle.vit_config, pt)
        meta_dir = tmp_path / "ckpt" / bundle.model_name
        meta_dir.mkdir(parents=True)
        (meta_dir / "meta.yaml").write_text(
            yaml.safe_dump({"label_norm": "minmax", "label_norm_stats": STATS})
        )
        return cfg, pt

    return make


@pytest.mark.parametrize("model", [dict(attn_impl="xla"),
                                   dict(attn_impl="flash", fused_mlp=True, fused_qkv=True)])
def test_predictions_equal_vit_tpu(served, model):
    cfg, pt = served(**model)
    x = make_dummy_spectra(n=17, length=512, seed=3)["flux"]
    want = JaxPredictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=7).predict(x)
    pred = Predictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=7, device="cpu")
    got = pred.predict(x)
    assert got.shape == want.shape == (17, 1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # denormalised: minmax stats from meta.yaml map [0, 1] onto [0.25, 4.75]
    np.testing.assert_allclose(got, pred._batched_logits(x) * 4.5 + 0.25, atol=1e-5)
    # the padded last chunk does not change any row
    full = Predictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=17, device="cpu").predict(x)
    np.testing.assert_allclose(got, full, atol=1e-5, rtol=0)
    assert pred.predict(x[:0]).shape == (0, 1)


def test_perf_preset_close_to_vit_tpu(served):
    cfg, pt = served(attn_impl="flash")
    x = make_dummy_spectra(n=9, length=512, seed=4)["flux"]
    want = JaxPredictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=4,
                                        perf_preset=True).predict(x)
    pred = Predictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=4, perf_preset=True,
                                     device="cpu")
    assert pred.vit_config.dtype == torch.bfloat16 and pred.vit_config.gelu_approximate
    np.testing.assert_allclose(pred.predict(x), want, atol=PRESET_TOL, rtol=0)


def test_classification_matches_vit_tpu(served):
    cfg, pt = served(task="cls", num_labels=4)
    x = make_dummy_spectra(n=10, length=512, seed=5)["flux"]
    ref = JaxPredictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=4)
    pred = Predictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=4, device="cpu")
    np.testing.assert_allclose(pred.predict_proba(x), ref.predict_proba(x), atol=TOL)
    np.testing.assert_array_equal(pred.predict(x), ref.predict(x))
    reg = Predictor(pred.module, dataclasses.replace(pred.vit_config, task_type="reg"))
    with pytest.raises(ValueError):
        reg.predict_proba(x)


def test_orbax_ckpt_names_the_converter(served):
    cfg, _ = served()
    with pytest.raises(ValueError, match="scripts/convert.py"):
        Predictor.from_checkpoint(dict(cfg), ckpt="best", device="cpu")


def test_unported_options_raise(served, monkeypatch):
    """Data-parallel serving (``num_devices``) raises as vit_tpu's does when
    more devices are asked for than exist (a CPU predictor has one); with
    two replicas (both on the CPU here) each batch's rows are split between
    them and returned in order, the single predictor's logits. (quantize,
    calibration and export are tests/test_torch_port_{quant,export}.py's.)"""
    from vit_tpu_torch import serve

    cfg, pt = served()
    with pytest.raises(ValueError, match="num_devices=2 requested but only 1 devices"):
        Predictor.from_checkpoint(dict(cfg), ckpt=pt, device="cpu", num_devices=2)
    monkeypatch.setattr(serve, "serving_devices", lambda dev, n: [dev] * n)
    with pytest.raises(ValueError, match="data-parallel degree 2"):
        Predictor.from_checkpoint(dict(cfg), ckpt=pt, device="cpu", num_devices=2,
                                  batch_size=5)
    one = Predictor.from_checkpoint(dict(cfg), ckpt=pt, device="cpu", batch_size=4)
    two = Predictor.from_checkpoint(dict(cfg), ckpt=pt, device="cpu", batch_size=4,
                                    num_devices=2)
    assert len(two.replicas) == 2 and two.replicas[1][0] is not two.module
    x = np.random.default_rng(0).standard_normal((7, one.input_length)).astype(np.float32)
    np.testing.assert_allclose(two._batched_logits(x), one._batched_logits(x), atol=1e-6)


def test_lightning_checkpoint_loads(served, tmp_path):
    cfg, pt = served()
    sd = torch.load(pt, weights_only=True)
    ckpt = str(tmp_path / "lightning.ckpt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, ckpt)
    x = make_dummy_spectra(n=3, length=512, seed=6)["flux"]
    a = Predictor.from_checkpoint(dict(cfg), ckpt=pt, device="cpu").predict(x)
    b = Predictor.from_checkpoint(dict(cfg), ckpt=ckpt, device="cpu").predict(x)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", ["h5", "npz"])
def test_predict_cli(served, tmp_path, fmt):
    cfg, pt = served(attn_impl="flash")
    data = make_dummy_spectra(n=12, length=512, seed=7)
    if fmt == "h5":
        inp = write_dummy_h5(str(tmp_path / "data" / "dataset.h5"), data=data)
    else:
        inp = str(tmp_path / "spectra.npz")
        np.savez(inp, flux=data["flux"])
    cfg_path = tmp_path / "serve.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "preds.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "vit_tpu_torch", "predict", "-f", str(cfg_path), "--ckpt", pt,
         "--input", inp, "--output", str(out), "--batch-size", "5", "--limit", "10",
         "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, CKPT_DIR=str(tmp_path / "ckpt")),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "device=cpu" in proc.stdout
    with np.load(out) as z:
        got = z["predictions"]
    x = data["flux"][:10]
    want = JaxPredictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=5).predict(x)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_predict_cli_takes_devices(served, tmp_path, monkeypatch):
    """``predict -g 2`` (scripts/predict.py's ``-g/--gpus/--devices``) reaches
    ``Predictor.from_checkpoint(num_devices=2)`` in the one process: with
    one device it raises vit_tpu's message; with two (serving_devices
    patched, both the CPU) it writes the single predictor's predictions."""
    from vit_tpu_torch import serve
    from vit_tpu_torch.__main__ import main

    cfg, pt = served()
    inp = str(tmp_path / "spectra.npz")
    np.savez(inp, flux=make_dummy_spectra(n=10, length=512, seed=8)["flux"])
    cfg_path = tmp_path / "serve.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))

    def predict(out, *extra):
        assert main(["predict", "-f", str(cfg_path), "--ckpt", pt, "--input", inp,
                     "--output", str(tmp_path / out), "--batch-size", "4", "--device", "cpu",
                     *extra]) == 0
        with np.load(tmp_path / out) as z:
            return z["predictions"]

    for flag in ("-g", "--gpus", "--devices"):
        with pytest.raises(ValueError, match="num_devices=2 requested but only 1 devices are "
                                             "available"):
            predict("never.npz", flag, "2")
    one = predict("one.npz")
    monkeypatch.setattr(serve, "serving_devices", lambda dev, n: [dev] * n)
    np.testing.assert_allclose(predict("two.npz", "-g", "2"), one, atol=1e-6, rtol=0)
