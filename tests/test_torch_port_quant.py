"""The port's int8 serving (``vit_tpu_torch.ops.quant`` and the quantized
``Predictor``) against vit_tpu's, mirroring ``tests/test_quant.py``.

Both packages get the same weights: vit_tpu's init, its kernels scaled by
``KERNEL_GAIN`` so that the outputs depend on the inputs (at the std-0.02
init every spectrum gives nearly one logit, and a comparison would be
blind), written once as a ``.pt`` that vit_tpu's and the port's
``Predictor.from_checkpoint`` both read. Everything runs on the CPU in fp32,
through the plain versions of the kernels and ``torch._int_mm``'s CPU path.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vit_tpu.models.builder import get_model as jax_get_model
from vit_tpu.ops import quant as jquant
from vit_tpu.serve import Predictor as JaxPredictor
from vit_tpu.train.torch_bridge import save_torch_checkpoint, to_torch_state_dict
from vit_tpu_torch.data.synthetic import make_dummy_spectra
from vit_tpu_torch.models.builder import get_model
from vit_tpu_torch.ops import quant
from vit_tpu_torch.serve import Predictor
from vit_tpu_torch.train.torch_bridge import from_flax_params

KERNEL_GAIN = 6.0
STATS = {"label_min": [0.25], "label_max": [4.75], "label_mean": None, "label_std": None}
# The whole quantized Predictor against vit_tpu's, fp32 on the CPU, physical
# units spanning ~4.5: measured 3.8e-6 at most over the modes below.
TOL = 1e-4


def _config(hidden=64, layers=2, heads=4, **model):
    return {
        "project": "q",
        "model": dict(name="vit", task_type="reg", image_size=512, patch_size=16,
                      hidden_size=hidden, num_hidden_layers=layers, num_attention_heads=heads,
                      stride_size=16, proj_fn="SW", **model),
        "train": {"batch_size": 8, "compilation_cache": False},
        "loss": {"name": "mae"},
        "data": {"param": "log_g", "label_norm": "minmax"},
        "noise": {"noise_level": 0},
    }


def _scaled_init(cfg, key=0):
    """vit_tpu's module and its init params, kernels scaled by KERNEL_GAIN."""
    bundle = jax_get_model(copy.deepcopy(cfg))
    params = bundle.module.init(jax.random.PRNGKey(key), jnp.zeros((1, 512)))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a * KERNEL_GAIN if p[-1].key == "kernel" else a, params)
    return bundle, jax.device_get(params)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(config, .pt path, CKPT_DIR, vit_tpu bundle, params), written once."""
    tmp = tmp_path_factory.mktemp("quant")
    cfg = _config()
    bundle, params = _scaled_init(cfg)
    pt = str(tmp / "model.pt")
    save_torch_checkpoint(params, bundle.vit_config, pt)
    meta = tmp / "ckpt" / bundle.model_name
    meta.mkdir(parents=True)
    (meta / "meta.yaml").write_text(yaml.safe_dump({"label_norm": "minmax",
                                                    "label_norm_stats": STATS}))
    return cfg, pt, str(tmp / "ckpt"), bundle, params


@pytest.fixture(autouse=True)
def _ckpt_dir(request, monkeypatch):
    if "served" in request.fixturenames:
        monkeypatch.setenv("CKPT_DIR", request.getfixturevalue("served")[2])


@pytest.fixture(scope="module")
def spectra():
    return make_dummy_spectra(n=24, length=512, seed=3)["flux"]


def _port_model(cfg, params, bundle):
    m = get_model(copy.deepcopy(cfg)).module
    m.load_state_dict(from_flax_params(params, bundle.vit_config), strict=True)
    return m.eval()


def _hf_names(params, vc, table):
    """vit_tpu's table paths as HF state-dict names, through its own bridge:
    the key whose weight is the path's kernel transposed."""
    sd = to_torch_state_dict(params, vc)
    out = {}
    for path in table:
        node = params
        for part in path.split("/"):
            node = node[part]
        kt = np.asarray(node["kernel"]).T
        (key,) = [k for k, v in sd.items() if k.endswith(".weight") and v.shape == kt.shape
                  and np.array_equal(v, kt)]
        out[path] = key[: -len(".weight")]
    return out


# -- the side table and the layer functions ----------------------------------------
def test_side_table_is_vit_tpus_key_for_key_and_bit_for_bit(served):
    cfg, _, _, bundle, params = served
    jtable = jquant.quantize_dense_params(params)
    table = quant.quantize_dense_params(_port_model(cfg, params, bundle))
    names = _hf_names(params, bundle.vit_config, jtable)
    assert sorted(names.values()) == sorted(table)  # exactly the same layers
    assert len(table) == 6 * 2  # q, k, v, out, intermediate, output a layer
    for path, name in names.items():
        j, p = jtable[path], table[name]
        assert p["wq"].dtype == torch.int8 and p["wq"].shape == j["wq"].shape[::-1]
        np.testing.assert_array_equal(p["wq"].numpy(), np.asarray(j["wq"]).T)
        np.testing.assert_array_equal(p["scale"].numpy(), np.asarray(j["scale"]))
        np.testing.assert_array_equal(p["bias"].numpy(), np.asarray(j["bias"]))
    assert quant.quantized_size_bytes(table) == jquant.quantized_size_bytes(jtable)
    assert quant.DEFAULT_EXCLUDE == jquant.DEFAULT_EXCLUDE
    assert quant.W8A8_WO_BATCH_THRESHOLD == jquant.W8A8_WO_BATCH_THRESHOLD


def _layer_inputs(rows):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(rows + (128,)).astype(np.float32)
    w = (rng.standard_normal((128, 256)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(256) * 0.01).astype(np.float32)
    scale = jnp.maximum(jnp.max(jnp.abs(w), axis=0), 1e-12) / 127.0
    wq = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
    port = (torch.from_numpy(np.asarray(wq).T.copy()), torch.from_numpy(np.asarray(scale)),
            torch.from_numpy(b))
    return x, w, b, (wq, scale, jnp.asarray(b)), port


@pytest.mark.parametrize("rows", [(32,), (2, 5), (3,)])
def test_int8_dense_equals_vit_tpus_within_one_ulp(rows):
    """Dynamic and static activation scales; 3 and 10 rows are padded to
    torch._int_mm's 17 (exact: rows are independent)."""
    x, w, b, jargs, pargs = _layer_inputs(rows)
    for sx in (None, 0.02):
        want = np.asarray(jquant.int8_dense(jnp.asarray(x), *jargs,
                                            sx=None if sx is None else jnp.float32(sx)))
        got = quant.int8_dense(torch.from_numpy(x), *pargs,
                               sx=None if sx is None else torch.tensor(sx)).numpy()
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    # tests/test_quant.py's envelope against the fp32 product
    ref = x @ w + b
    out = quant.int8_dense(torch.from_numpy(x), *pargs).numpy()
    assert np.sqrt(((out - ref) ** 2).mean()) / np.sqrt((ref**2).mean()) < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dense_weight_only_equals_vit_tpus(dtype):
    """fp32: to 1 ulp of the largest output (the two libraries sum the
    K=128 products in their own orders); bf16: the compute dtype kept, to
    one bf16 rounding of the output."""
    x, _, _, jargs, pargs = _layer_inputs((32,))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jquant.int8_dense_weight_only(jnp.asarray(x), *jargs, compute_dtype=jdt))
    got = quant.int8_dense_weight_only(torch.from_numpy(x), *pargs, compute_dtype=tdt)
    assert got.dtype == torch.float32  # returned in x's dtype
    gap = np.abs(got.numpy() - want).max()
    ulp = np.spacing(np.abs(want).max().astype(np.float32))
    limit = ulp if dtype == "float32" else 2**-8 * np.abs(want).max()
    assert gap <= limit, (gap, limit)


def test_int_mm_row_padding_is_exact():
    g = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (5, 64), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (24, 64), generator=g, dtype=torch.int8)
    want = xq.int() @ wq.int().t()
    assert torch.equal(quant.int8_matmul(xq, wq), want)
    assert torch.equal(quant.int8_matmul(xq[None], wq), want[None])
    with pytest.raises(ValueError, match="K="):
        quant.int8_matmul(xq, wq[:, :32])


def test_quantize_selects_encoder_excludes_head_and_smalls(served):
    cfg, _, _, bundle, params = served
    table = quant.quantize_dense_params(_port_model(cfg, params, bundle))
    for i in range(2):
        for leaf in ("attention.attention.query", "attention.attention.key",
                     "attention.attention.value", "attention.output.dense",
                     "intermediate.dense", "output.dense"):
            assert f"vit.encoder.layer.{i}.{leaf}" in table
    assert not any("regressor" in n or "patch_embeddings" in n for n in table)  # fan-in 16
    e = table["vit.encoder.layer.0.intermediate.dense"]
    assert e["wq"].dtype == torch.int8 and e["wq"].shape == (256, 64)
    assert e["scale"].shape == (256,)


def test_quantize_respects_min_fan_in_and_exclude(served):
    cfg, _, _, bundle, params = served
    m = _port_model(cfg, params, bundle)
    assert quant.quantize_dense_params(m, min_fan_in=10_000) == {}
    assert "regressor" in quant.quantize_dense_params(m, exclude=())


def test_quantize_excludes_a_router():
    """DEFAULT_EXCLUDE skips the MoE ``router`` (its logits feed a
    discontinuous top_k), on a real MoE model as tests/test_quant.py does:
    only attention's Linears quantize; the stacked experts are no Linear."""
    cfg = _config(moe_experts=4, moe_top_k=1)
    table = quant.quantize_dense_params(get_model(copy.deepcopy(cfg)).module)
    assert table and not any("router" in n or ".moe." in n for n in table), sorted(table)
    assert sorted(table) == sorted(f"vit.encoder.layer.{i}.attention.{leaf}" for i in range(2)
                                   for leaf in ("attention.query", "attention.key",
                                                "attention.value", "output.dense"))


def test_quantized_forward_close_and_strip_exact(served, spectra):
    cfg, _, _, bundle, params = served
    m = _port_model(cfg, params, bundle)
    x = torch.from_numpy(spectra[:8])
    table = quant.quantize_dense_params(m)
    with torch.no_grad():
        ref = m(x)
        out = quant.quantized_apply(m, table, x)
        quant.strip_quantized(m, table)
        out2 = quant.quantized_apply(m, table, x)
    rel = ((out - ref).abs() / (ref.abs() + 1e-6)).max().item()
    assert 0 < rel < 0.05  # the table acts, within W8A8's envelope
    assert torch.equal(out, out2)  # the stripped weights are never read
    assert m.vit.encoder.layer[0].intermediate.dense.weight.shape == (1, 1)
    with pytest.raises(RuntimeError):  # unintercepted, a stripped layer fails loudly
        m(x)


def test_weight_only_respects_module_dtype(served, spectra):
    """Weight-only in an fp32 model computes in fp32: equal, to fp32
    rounding, to the model with the dequantized weights substituted."""
    cfg, _, _, bundle, params = served
    m = _port_model(cfg, params, bundle)
    x = torch.from_numpy(spectra[:8])
    table = quant.quantize_dense_params(m)
    deq = _port_model(cfg, params, bundle)
    with torch.no_grad():
        for name, mod in deq.named_modules():
            if name in table:
                mod.weight.copy_(table[name]["wq"].float() * table[name]["scale"][:, None])
        ref = deq(x)
        out = quant.quantized_apply(m, table, x, weight_only=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-6, atol=2e-6)


def test_resident_weight_reduction():
    cfg = _config(hidden=128, layers=4)
    bundle, params = _scaled_init(cfg)
    m = _port_model(cfg, params, bundle)

    def nbytes(mod):
        return sum(p.numel() * p.element_size() for p in mod.parameters())

    orig = nbytes(m)
    table = quant.quantize_dense_params(m)
    fp32_encoder = sum(e["wq"].numel() * 4 for e in table.values())
    quant.strip_quantized(m, table)
    after = nbytes(m) + quant.quantized_size_bytes(table)
    assert orig - after > 0.70 * fp32_encoder
    assert quant.quantized_size_bytes(table) < 0.30 * fp32_encoder


def test_calibrated_static_scales_equal_vit_tpus(served, spectra):
    """One calibration forward: every layer gains a 0-d fp32 ``sx``, within
    rel 1e-5 of vit_tpu's (a layer's maximum is of inputs both packages
    compute by the same math but sum in their own orders: measured 2 fp32
    ulps, 2.4e-7 relative, at most); the calibrated forward stays within 2x
    W8A8's envelope."""
    cfg, _, _, bundle, params = served
    m = _port_model(cfg, params, bundle)
    x = spectra[:8]
    table = quant.quantize_dense_params(m)
    ctable = quant.calibrate_activation_scales(m, table, torch.from_numpy(x))
    jtable = jquant.quantize_dense_params(params)
    jc = jquant.calibrate_activation_scales(bundle.module, {"params": params}, jtable,
                                            jnp.asarray(x), deterministic=True)
    names = _hf_names(params, bundle.vit_config, jtable)
    assert set(ctable) == set(table)
    for path, name in names.items():
        sx = ctable[name]["sx"]
        assert sx.shape == () and sx.dtype == torch.float32 and sx.item() > 0
        np.testing.assert_allclose(sx.numpy(), np.asarray(jc[path]["sx"]), rtol=1e-5, atol=0)
    with torch.no_grad():
        ref = m(torch.from_numpy(x))
        out = quant.quantized_apply(m, ctable, torch.from_numpy(x))
    assert ((out - ref).abs() / (ref.abs() + 1e-6)).max().item() < 0.10


def test_calibrated_scales_saturate_not_explode(served, spectra):
    cfg, _, _, bundle, params = served
    m = _port_model(cfg, params, bundle)
    x = torch.from_numpy(spectra[:8])
    ctable = quant.calibrate_activation_scales(m, quant.quantize_dense_params(m), x)
    with torch.no_grad():
        out = quant.quantized_apply(m, ctable, 10.0 * x)
        jt = jquant.calibrate_activation_scales(
            bundle.module, {"params": params}, jquant.quantize_dense_params(params),
            jnp.asarray(x.numpy()), deterministic=True)
    want = jquant.quantized_apply(bundle.module, {"params": params}, jt,
                                  jnp.asarray(10.0 * x.numpy()), deterministic=True)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL, rtol=0)


# -- the quantized Predictor -----------------------------------------------------------
def _pair(cfg, pt, **kw):
    return (JaxPredictor.from_checkpoint(dict(cfg), ckpt=pt, **kw),
            Predictor.from_checkpoint(dict(cfg), ckpt=pt, device="cpu", **kw))


@pytest.mark.parametrize("mode, batch, calibrate, variant", [
    ("int8-w8a8", 8, False, "int8-w8a8"),
    ("int8-w8a8", 8, True, "int8-w8a8"),
    ("int8-wo", 8, False, "int8-wo"),
    ("int8", 8, False, "int8-w8a8"),   # auto: below the threshold
    ("int8", 64, False, "int8-wo"),    # auto: at the threshold
    ("int8", 64, True, "int8-w8a8"),   # auto: calibration overrides the batch route
])
def test_quantized_predictor_matches_vit_tpu(served, spectra, mode, batch, calibrate, variant):
    """Each mode and route against vit_tpu's Predictor within TOL (measured
    3.8e-6). Calibrated: the port's own static scales are within rel 1e-5
    of vit_tpu's (2 fp32 ulps: the maxima are of activations the two
    libraries sum in their own orders), and with them one output in 24
    moved by 5.2e-3 (one activation on a rounding boundary of x / sx, held
    below 1e-2 here); the forward is then held at TOL with vit_tpu's scales
    carried into the port's table, so that it is compared alone."""
    cfg, pt, _, bundle, params = served
    calib = spectra[:16] if calibrate else None
    want_p, got_p = _pair(cfg, pt, batch_size=batch, quantize=mode, calibration=calib)
    assert got_p.quant_variant == want_p.quant_variant == variant
    assert set(got_p._qtable) and all(("sx" in e) == calibrate for e in got_p._qtable.values())
    want = want_p.predict(spectra)
    if calibrate:
        own = got_p.predict(spectra)
        assert np.abs(own - want).max() < 1e-2
        for path, name in _hf_names(params, bundle.vit_config, want_p._qtable).items():
            jsx = np.asarray(want_p._qtable[path]["sx"])
            np.testing.assert_allclose(got_p._qtable[name]["sx"].numpy(), jsx, rtol=1e-5)
            got_p._qtable[name]["sx"] = torch.from_numpy(jsx.copy())
    got = got_p.predict(spectra)
    assert got.shape == want.shape == (len(spectra), 1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # the quantized outputs differ from fp32 serving by far more than TOL,
    # so the comparison sees the tables, and stay within vit_tpu's envelope
    ref = Predictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=batch, device="cpu")
    drift = np.abs(got - ref.predict(spectra)).max()
    assert 10 * TOL < drift < 0.08 * (np.abs(want).mean() + 1.0)


def test_predictor_int8_fused_qkv_rebuilds_unfused(served, spectra):
    cfg, pt, _, bundle, params = served
    qcfg = dict(cfg, model=dict(cfg["model"], fused_qkv=True, fused_mlp=True,
                                attn_impl="flash"))
    want_p, got_p = _pair(qcfg, pt, batch_size=8, quantize="int8")
    vc = got_p.vit_config
    assert not vc.fused_qkv and not vc.fused_mlp
    np.testing.assert_allclose(got_p.predict(spectra), want_p.predict(spectra), atol=TOL, rtol=0)
    direct = _port_model(qcfg, params, bundle)
    with pytest.raises(ValueError, match="fused_qkv"):
        Predictor(direct, direct.cfg, quantize="int8")


def test_predictor_int8_precision_and_perf_preset(served, spectra):
    """bf16 serving and the perf preset compose with int8 (tests/test_quant.py's
    bf16 and preset cases): finite, within those cases' envelopes of fp32."""
    cfg, pt = served[:2]
    ref = Predictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=8, device="cpu")
    ref_y = ref.predict(spectra)
    env = np.abs(ref_y).mean() + 1.0
    bf = Predictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=8, precision="bf16",
                                   device="cpu").predict(spectra)
    assert np.isfinite(bf).all() and np.abs(bf - ref_y).max() < 0.03 * env
    for kw in (dict(quantize="int8-wo"), dict(quantize="int8", calibration=spectra[:8])):
        p = Predictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=8, perf_preset=True,
                                      device="cpu", **kw)
        assert p.vit_config.gelu_approximate and p.vit_config.dtype == torch.bfloat16
        out = p.predict(spectra)
        assert np.isfinite(out).all() and np.abs(out - ref_y).max() < 0.08 * env


def test_predictor_rejects_unknown_quantize_and_data_parallel(served):
    cfg, pt = served[:2]
    with pytest.raises(ValueError, match="quantize"):
        Predictor.from_checkpoint(dict(cfg), ckpt=pt, quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="num_devices"):  # one CPU device
        Predictor.from_checkpoint(dict(cfg), ckpt=pt, quantize="int8", num_devices=8,
                                  device="cpu")


def test_predictor_strips_and_reports_no_layers(served, tmp_path, monkeypatch, capsys):
    """The quantized layers' fp32 weights leave the module; a model whose
    layers all have fan-in below 64 matches no layer and says so, as
    vit_tpu does (hidden 32 with intermediate_size 48: baseline.yaml's 4x
    intermediate of 128 does clear it, in both packages)."""
    cfg, pt = served[:2]
    p = Predictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=8, quantize="int8-w8a8",
                                  device="cpu")
    layer = p.module.vit.encoder.layer[0]
    assert layer.intermediate.dense.weight.shape == (1, 1)
    assert layer.layernorm_before.weight.shape == (64,)
    small = _config(hidden=32, heads=2, intermediate_size=48)
    sbundle, sparams = _scaled_init(small)
    spt = str(tmp_path / "small.pt")
    save_torch_checkpoint(sparams, sbundle.vit_config, spt)
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "none"))
    capsys.readouterr()
    q = Predictor.from_checkpoint(small, ckpt=spt, batch_size=4, quantize="int8", device="cpu")
    assert q._qtable == {} and "matched no layers" in capsys.readouterr().out
    x = make_dummy_spectra(n=3, length=512, seed=4)["flux"]
    plain = Predictor.from_checkpoint(small, ckpt=spt, batch_size=4, device="cpu")
    np.testing.assert_array_equal(q.predict(x), plain.predict(x))


def test_predict_cli_quantize_calibrate(served, tmp_path):
    """``python -m vit_tpu_torch predict --quantize int8 --calibrate``: the
    first --batch-size inputs calibrate, the output is the Predictor's."""
    import os
    import subprocess
    import sys

    cfg, pt, ckpt_dir = served[:3]
    x = make_dummy_spectra(n=12, length=512, seed=7)["flux"]
    inp, out = str(tmp_path / "x.npz"), str(tmp_path / "p.npz")
    np.savez(inp, flux=x)
    cfg_path = tmp_path / "q.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "vit_tpu_torch", "predict", "-f", str(cfg_path), "--ckpt", pt,
         "--input", inp, "--output", out, "--batch-size", "5", "--quantize", "int8",
         "--calibrate", "--device", "cpu"],
        cwd=root, env=dict(os.environ, CKPT_DIR=ckpt_dir), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = Predictor.from_checkpoint(dict(cfg), ckpt=pt, batch_size=5, quantize="int8",
                                     calibration=x[:5], device="cpu").predict(x)
    with np.load(out) as z:
        np.testing.assert_array_equal(z["predictions"], want)
