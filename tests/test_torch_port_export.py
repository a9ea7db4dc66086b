"""The port's serving artifacts (``vit_tpu_torch.export``), mirroring
``tests/test_export.py``: the round trip against the live ``Predictor`` and
vit_tpu's, the header and magic, classification, quantized artifacts, loud
failures, the normalised-units warning, and a loading process that imports
no model code.

Weights are vit_tpu's init written as a ``.pt``; the model takes the flash
route (K2 at T=32) and the fused MLP (K3), so the exported program holds
both as custom operators. On the CPU they run their plain versions.
"""

import json
import os
import re
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import yaml

from vit_tpu.models.builder import get_model as jax_get_model
from vit_tpu.serve import Predictor as JaxPredictor
from vit_tpu.train.torch_bridge import save_torch_checkpoint
from vit_tpu_torch.data.synthetic import make_dummy_spectra
from vit_tpu_torch.export import MAGIC, export_predictor, load_exported
from vit_tpu_torch.serve import Predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = {"label_min": [0.25], "label_max": [4.75], "label_mean": None, "label_std": None}
# The artifact denormalises in fp32, the live Predictor in float64 numpy:
# vit_tpu's test_export_roundtrip_matches_predictor tolerance.
RTOL, ATOL = 1e-4, 1e-5


def _config(task="reg", **model):
    return {
        "model": dict(name="vit", task_type=task, image_size=512, patch_size=32,
                      hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                      stride_size=16, proj_fn="SW", attn_impl="flash", fused_mlp=True,
                      **model),
        "train": {"batch_size": 8, "compilation_cache": False},
        "data": {"param": "log_g", "label_norm": "minmax"},
        "noise": {"noise_level": 0},
    }


def _write(tmp, cfg, key=1):
    bundle = jax_get_model(dict(cfg, model=dict(cfg["model"])))
    params = bundle.module.init(jax.random.PRNGKey(key), np.zeros((1, 512), np.float32))
    pt = str(tmp / f"{cfg['model']['task_type']}.pt")
    save_torch_checkpoint(jax.device_get(params["params"]), bundle.vit_config, pt)
    meta = tmp / "ckpt" / bundle.model_name
    meta.mkdir(parents=True, exist_ok=True)
    (meta / "meta.yaml").write_text(yaml.safe_dump({"label_norm": "minmax",
                                                    "label_norm_stats": STATS}))
    return pt


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """One regression model, its live Predictor (batch 8) and its artifact."""
    tmp = tmp_path_factory.mktemp("export")
    cfg = _config()
    pt = _write(tmp, cfg)
    os.environ["CKPT_DIR"] = str(tmp / "ckpt")
    try:
        pred = Predictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=8, device="cpu")
        path = str(tmp / "model.vittxpt")
        header = pred.export(path)
    finally:
        del os.environ["CKPT_DIR"]
    return dict(cfg=cfg, pt=pt, tmp=tmp, pred=pred, path=path, header=header)


@pytest.fixture(autouse=True)
def _ckpt_dir(request, monkeypatch):
    if "art" in request.fixturenames:
        monkeypatch.setenv("CKPT_DIR", str(request.getfixturevalue("art")["tmp"] / "ckpt"))


def _flux(n, seed=3):
    return make_dummy_spectra(n=n, length=512, seed=seed)["flux"]


def test_export_roundtrip_matches_predictor(art):
    """Across padded chunk boundaries, against the live Predictor and
    vit_tpu's; the kernels are custom operators in the program."""
    header, pred = art["header"], art["pred"]
    assert header["denormalized"] is True and header["batch_size"] == 8
    assert header["device"] == "cpu" and header["quantize"] is None
    loaded = load_exported(art["path"], device="cpu")
    flux = _flux(19)  # 2 full chunks + a padded one
    got = loaded.predict(flux)
    np.testing.assert_allclose(got, pred.predict(flux), rtol=RTOL, atol=ATOL)
    want = JaxPredictor.from_checkpoint(dict(art["cfg"]), ckpt=art["pt"],
                                        batch_size=8).predict(flux)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert loaded.predict(flux[:0]).shape == (0, 1)
    ops = set(re.findall(r"torch\.ops\.vit_tpu_torch\.(\w+)", loaded.program.graph_module.code))
    assert ops == {"short_fwd", "fused_mlp_fwd"}


def test_export_header_and_magic(art, tmp_path):
    """The port's magic; each package's loader refuses the other's artifact;
    another device type is refused."""
    from vit_tpu.export import load_exported as jax_load_exported

    with open(art["path"], "rb") as f:
        assert f.read(len(MAGIC)) == MAGIC
    assert art["header"]["task_type"] == "reg" and art["header"]["input_shape"] == [512]
    bad = tmp_path / "bad.vittxpt"
    bad.write_bytes(b"not an export")
    with pytest.raises(ValueError, match="bad magic"):
        load_exported(str(bad), device="cpu")
    with pytest.raises(ValueError, match="bad magic"):
        jax_load_exported(art["path"])
    jpath = str(tmp_path / "j.vitxpt")
    JaxPredictor.from_checkpoint(dict(art["cfg"]), ckpt=art["pt"], batch_size=4).export(jpath)
    with pytest.raises(ValueError, match="bad magic"):
        load_exported(jpath, device="cpu")
    with pytest.raises((ValueError, RuntimeError), match="cuda"):
        load_exported(art["path"], device="cuda")


def test_export_cls_predicts_classes(tmp_path, monkeypatch):
    cfg = _config(task="cls", num_labels=3)
    pt = _write(tmp_path, cfg)
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
    pred = Predictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=8, device="cpu")
    path = str(tmp_path / "cls.vittxpt")
    assert pred.export(path)["denormalized"] is False
    loaded = load_exported(path, device="cpu")
    flux = _flux(10)
    np.testing.assert_array_equal(loaded.predict(flux), pred.predict(flux))
    proba = loaded.predict_proba(flux)
    np.testing.assert_allclose(proba.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(proba, pred.predict_proba(flux), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["int8-wo", "int8"])
def test_export_quantized_matches_live(art, tmp_path, mode):
    """The int8 table is inside the program: the artifact equals the live
    quantized Predictor (the same forward), and differs from the unquantized
    one only within quantization error."""
    pred = Predictor.from_checkpoint(dict(art["cfg"]), ckpt=art["pt"], batch_size=8,
                                     quantize=mode, device="cpu")
    path = str(tmp_path / f"q_{mode}.vittxpt")
    header = pred.export(path)
    assert header["quantize"] == mode and header["quant_variant"] == pred.quant_variant
    loaded = load_exported(path, device="cpu")
    flux = _flux(11)
    np.testing.assert_allclose(loaded.predict(flux), pred.predict(flux), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loaded.predict(flux), art["pred"].predict(flux), rtol=0.2,
                               atol=0.2)
    code = loaded.program.graph_module.code
    assert ("_int_mm" in code) == (pred.quant_variant == "int8-w8a8")


def test_export_corrupt_files_fail_loudly(art, tmp_path):
    raw = open(art["path"], "rb").read()
    m = len(MAGIC)

    def write(name, data):
        p = tmp_path / name
        p.write_bytes(data)
        return str(p)

    with pytest.raises(ValueError, match="cut_len.*no header length"):
        load_exported(write("cut_len.vittxpt", raw[: m + 2]), device="cpu")
    with pytest.raises(ValueError, match="huge.*header length"):
        load_exported(write("huge.vittxpt", raw[:m] + b"\xff\xff\xff\xff" + raw[m + 4:]),
                      device="cpu")
    with pytest.raises(ValueError, match="zero.*header length 0"):
        load_exported(write("zero.vittxpt", raw[:m] + b"\x00" * 4 + raw[m + 4:]), device="cpu")
    with pytest.raises(ValueError, match="short.*short header"):
        load_exported(write("short.vittxpt", raw[: m + 4 + 10]), device="cpu")
    hlen = int.from_bytes(raw[m:m + 4], "little")
    with pytest.raises(ValueError, match="garble.*corrupt"):
        load_exported(write("garble.vittxpt", raw[: m + 4] + b"\x00" * hlen
                            + raw[m + 4 + hlen:]), device="cpu")
    body = json.dumps(dict(art["header"], format=2)).encode()
    body_cuda = json.dumps(dict(art["header"], device="cuda")).encode()
    with pytest.raises(ValueError, match="device type 'cuda'"):
        load_exported(write("dev.vittxpt", MAGIC + struct.pack("<I", len(body_cuda))
                            + body_cuda + raw[m + 4 + hlen:]), device="cpu")
    with pytest.raises(ValueError, match="unsupported format 2"):
        load_exported(write("fmt.vittxpt", MAGIC + struct.pack("<I", len(body)) + body
                            + raw[m + 4 + hlen:]), device="cpu")


def test_export_normalized_units_warning(art, tmp_path, capsys):
    pred = art["pred"]
    saved = pred.label_norm_stats
    pred.label_norm_stats = {}  # as if the stats were missing at export time
    try:
        path = str(tmp_path / "nodenorm.vittxpt")
        assert pred.export(path)["denormalized"] is False
    finally:
        pred.label_norm_stats = saved
    capsys.readouterr()
    load_exported(path, device="cpu")
    assert "NORMALIZED units" in capsys.readouterr().out


def test_export_rejects_data_parallel_and_missing_shape(art, tmp_path):
    with pytest.raises(ValueError, match="num_devices"):  # one CPU device
        Predictor.from_checkpoint(dict(art["cfg"]), ckpt=art["pt"], batch_size=8,
                                  num_devices=2, device="cpu")
    live = art["pred"]
    direct = Predictor(live.module, live.vit_config, batch_size=4)
    with pytest.raises(ValueError, match="input_shape"):
        export_predictor(direct, str(tmp_path / "y.vittxpt"))
    export_predictor(direct, str(tmp_path / "y.vittxpt"), input_shape=(512,))
    loaded = load_exported(str(tmp_path / "y.vittxpt"), device="cpu")
    flux = _flux(4)
    assert loaded.predict(flux).shape == (4, 1)
    with pytest.raises(ValueError, match="input shape"):
        loaded.predict(flux[:, :7])


def test_loading_process_imports_no_model_code(art, tmp_path):
    """A fresh process loads and serves the artifact with
    ``vit_tpu_torch.export`` alone: no vit_tpu_torch.models, config or
    train, and nothing of JAX or vit_tpu, in ``sys.modules``."""
    flux = _flux(5)
    np.save(tmp_path / "x.npy", flux)
    code = f"""
import sys, numpy as np
from vit_tpu_torch.export import load_exported
p = load_exported({art['path']!r}, device="cpu")
np.save({str(tmp_path / 'y.npy')!r}, p.predict(np.load({str(tmp_path / 'x.npy')!r})))
bad = sorted(m for m in sys.modules if m.startswith(("vit_tpu_torch.models",
      "vit_tpu_torch.config", "vit_tpu_torch.train", "vit_tpu_torch.serve", "jax", "flax",
      "optax", "orbax")) or m == "vit_tpu" or m.startswith("vit_tpu."))
print("IMPORTED", bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "IMPORTED []" in proc.stdout, proc.stdout
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"), art["pred"].predict(flux),
                               rtol=RTOL, atol=ATOL)
