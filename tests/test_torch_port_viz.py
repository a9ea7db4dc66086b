"""The port's diagnostics against vit_tpu's: the capture through the model,
its on-device reduction, CKA, the FLOP count, and ports of
``tests/test_viz.py`` run against ``vit_tpu_torch.viz``.

Everything runs on the CPU in fp32. matplotlib draws with its Agg backend.
Tolerances: captured diagnostics 1e-5 (fp32 sums in another order; the
measured gap is ~1e-7), CKA 1e-12 (the same float64 numpy code on the same
float32 inputs).
"""

import copy
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from vit_tpu.models import builder as jbuilder
from vit_tpu.prepca.pipeline import compute_cka as jax_compute_cka
from vit_tpu.viz import diagnostics as jdiag
from vit_tpu_torch.config import load_config
from vit_tpu_torch.models import builder as pbuilder
from vit_tpu_torch.prepca.pipeline import compute_cka
from vit_tpu_torch.train.loop import Experiment
from vit_tpu_torch.train.torch_bridge import from_flax_params
from vit_tpu_torch.viz import diagnostics as pdiag
from vit_tpu_torch.viz.diagnostics import CKAMonitor, VizDiagnostics, extract_diagnostics
from vit_tpu_torch.viz.plotter import RegressionPlotter
from vit_tpu_torch.viz.viz_utils import calculate_metrics, denormalize, label_axis_bounds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPTURE_TOL = 1e-5
CKA_TOL = 1e-12
CONFIGS = ("configs/exp/att_clp/baseline.yaml", "configs/exp/att_clp/stride1.yaml",
           "configs/exp/logg/base.yaml")


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small CPU ops; one torch thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(**model):
    """2 layers, hidden 16, T = 33 (32 patches + CLS)."""
    return {"model": dict(dict(name="vit", task_type="reg", image_size=512, patch_size=16,
                               hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                               stride_size=16, proj_fn="SW"), **model),
            "train": {"precision": "float32"}, "data": {"param": "log_g"}}


def _both_captures(cfg, batch=6, seed=0, sample_rate=0.15):
    """vit_tpu's capture -> reduce_intermediates -> extract_diagnostics and
    the port's, from the same weights and inputs: ((logits, diag), (logits,
    diag), numpy activations of layer 0)."""
    jb = jbuilder.get_model(copy.deepcopy(cfg))
    vc = jb.vit_config
    x = np.random.default_rng(seed).standard_normal((batch, vc.image_size)).astype(np.float32)
    params = jb.module.init(jax.random.PRNGKey(seed), x[:1])["params"]
    logits, state = jb.module.apply({"params": params}, x, deterministic=True, capture=True,
                                    mutable=["intermediates"])
    reduced = jdiag.reduce_intermediates(state["intermediates"], vc.num_hidden_layers,
                                         sample_rate)
    ref = (np.asarray(logits), jdiag.extract_diagnostics(jax.device_get(reduced)))
    act0 = np.asarray(state["intermediates"]["encoder"]["layer_0"]["mlp_activation"][0])
    pb = pbuilder.get_model(copy.deepcopy(cfg))
    pb.module.load_state_dict(
        from_flax_params(jax.tree_util.tree_map(np.asarray, params), pb.vit_config),
        strict=True)
    got = pdiag.capture_diagnostics(pb.module.train(), torch.from_numpy(x), sample_rate)
    assert pb.module.training  # the capture gives the module its mode back
    return ref, got, act0


def _assert_diag_close(got, ref, tol):
    assert len(got["attn"]) == len(ref["attn"])
    for a, b in zip(got["attn"], ref["attn"]):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)
    assert set(got["mlp"]) == set(ref["mlp"])
    for layer, stats in ref["mlp"].items():
        assert set(got["mlp"][layer]) == set(stats)
        for k, v in stats.items():
            np.testing.assert_allclose(got["mlp"][layer][k], np.asarray(v, np.float32),
                                       atol=tol, rtol=0, err_msg=f"{layer}/{k}")
    assert set(got["cls_hidden"]) == set(ref["cls_hidden"])
    for k, v in ref["cls_hidden"].items():
        np.testing.assert_allclose(got["cls_hidden"][k], v, atol=tol, rtol=0)
    np.testing.assert_allclose(got["cls_embedding"], ref["cls_embedding"], atol=tol, rtol=0)


@pytest.mark.parametrize("model", [dict(attn_impl="xla"), dict(attn_impl="flash"),
                                   dict(attn_impl="flash", fused_mlp=True, remat="mlp")],
                         ids=["xla", "flash", "fused_mlp"])
def test_capture_matches_vit_tpu(model):
    """Flash falls back to the xla math and the fused MLP to its dense path
    under capture, in both packages; the activation sample takes vit_tpu's
    coprime-step indices."""
    (ref_logits, ref), (logits, got), act0 = _both_captures(_small(**model))
    np.testing.assert_allclose(logits, ref_logits, atol=CAPTURE_TOL, rtol=0)
    _assert_diag_close(got, ref, CAPTURE_TOL)
    flat = act0.reshape(-1)
    n, k = flat.size, got["mlp"]["layer_0"]["sample"].size
    step = 7_368_787
    while np.gcd(step, n) != 1:
        step += 1
    idx = np.arange(k, dtype=np.int64) * step % n
    assert len(np.unique(idx % act0.shape[-1])) == act0.shape[-1]  # every neuron column
    np.testing.assert_allclose(got["mlp"]["layer_0"]["sample"], flat[idx], atol=CAPTURE_TOL,
                               rtol=0)


def test_capture_adds_nothing_to_the_plain_forward():
    """The logits with capture equal those without (one head: the flash
    path's smallest head_dim is 16)."""
    pb = pbuilder.get_model(_small(attn_impl="flash", fused_mlp=True, num_attention_heads=1))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 512)).astype(np.float32))
    tree = {}
    with torch.no_grad():
        plain = pb.module.eval()(x)
        captured = pb.module(x, capture=tree)
    torch.testing.assert_close(captured, plain, atol=CAPTURE_TOL, rtol=0)
    assert sorted(tree) == ["cls_embedding", "encoder"]
    assert sorted(tree["encoder"]) == ["cls_hidden_0", "cls_hidden_1", "layer_0", "layer_1"]
    assert tree["encoder"]["layer_1"]["attention"]["attention_probs"].shape == (1, 33, 33)
    assert tree["encoder"]["layer_1"]["mlp_activation"].shape == (3, 33, 64)


def _grid():
    for t in (17, 129, 1025, 4066):
        for h in (1, 2, 12):
            for inter in (64, 512, 3072):
                for mb in (64, 512, 4096):
                    yield t, h, inter, mb * 1024**2


@pytest.mark.parametrize("path", CONFIGS + ("grid",))
def test_capture_cap_and_step_flops_are_vit_tpus(path):
    if path == "grid":
        for t, h, inter, budget in _grid():
            assert (pdiag.capture_batch_cap(t, h, inter, budget)
                    == jdiag.capture_batch_cap(t, h, inter, budget))
        for kw in (dict(), dict(hidden_size=64, stride_size=1, num_hidden_layers=4),
                   dict(proj_fn="C1D", num_labels=3, task_type="cls"),
                   dict(moe_experts=4, moe_top_k=2)):
            cfg = _small()
            cfg["model"].update(kw)
            for batch in (1, 16):
                for train in (True, False):
                    assert (pbuilder.step_matmul_flops(pbuilder.get_vit_config(cfg), batch, train)
                            == jbuilder.step_matmul_flops(jbuilder.get_vit_config(cfg), batch,
                                                          train))
        return
    cfg = load_config(os.path.join(ROOT, path))
    pvc, jvc = pbuilder.get_vit_config(cfg), jbuilder.get_vit_config(cfg)
    batch = int(cfg["train"]["batch_size"])
    assert pbuilder.step_matmul_flops(pvc, batch) == jbuilder.step_matmul_flops(jvc, batch)
    budget = int(float((cfg.get("viz") or {}).get("capture_memory_mb", 512)) * 1024**2)
    args = (pvc.seq_len, pvc.num_attention_heads, pvc.intermediate_size, budget)
    assert pdiag.capture_batch_cap(*args) == jdiag.capture_batch_cap(*args)
    if path.endswith("stride1.yaml"):
        assert pdiag.capture_batch_cap(*args) == 3  # T4066, the cap chip_smoke asserts


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_cka_and_cka_matrix_are_vit_tpus(kernel):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((40, 16)).astype(np.float32)
    b = (a @ rng.standard_normal((16, 8)) + 0.3 * rng.standard_normal((40, 8))).astype(
        np.float32)
    for debiased in (True, False):
        got = compute_cka(a, b, kernel=kernel, debiased=debiased)
        assert got == pytest.approx(jax_compute_cka(a, b, kernel=kernel, debiased=debiased),
                                    abs=CKA_TOL)
    assert compute_cka(torch.from_numpy(a), b, kernel=kernel) == pytest.approx(
        compute_cka(a, b, kernel=kernel), abs=CKA_TOL)
    reps = {"x": a, "y": b, "z": rng.standard_normal((40, 4))}
    np.testing.assert_allclose(pdiag.cka_matrix(reps, reps, kernel),
                               jdiag.cka_matrix(reps, reps, kernel), atol=CKA_TOL, rtol=0)
    with pytest.raises(ValueError):
        compute_cka(a, b[:10])


# -- ports of tests/test_viz.py -------------------------------------------------
def test_denormalize_roundtrips():
    y = np.random.default_rng(0).random((20, 2))
    mn, mx = np.array([1.0, -3.0]), np.array([5.0, 7.0])
    np.testing.assert_allclose(denormalize(y, "minmax", label_min=mn, label_max=mx),
                               y * (mx - mn) + mn)
    mean, std = np.array([2.0, 0.0]), np.array([3.0, 1.0])
    np.testing.assert_allclose(denormalize(y, "zscore", label_mean=mean, label_std=std),
                               y * std + mean)
    np.testing.assert_allclose(denormalize(y, "none"), y)


def test_calculate_metrics_perfect_prediction():
    y = np.random.default_rng(1).random((50, 3))
    m = calculate_metrics(y, y)
    assert len(m) == 3
    for mm in m:
        assert mm["mae"] == 0.0 and mm["r2"] == pytest.approx(1.0)


@pytest.mark.parametrize("quick", [False, True])
def test_regression_plotter_writes_pngs(tmp_path, monkeypatch, quick):
    """The full report, or quick mode without the expensive figures."""
    monkeypatch.setenv("PLOT_DIR", str(tmp_path))
    rng = np.random.default_rng(2)
    labels = rng.random((100, 2))
    preds = labels + rng.normal(0, 0.05, labels.shape)
    plotter = RegressionPlotter(param_names=["T_eff", "log_g"], model_name="m",
                                quick_mode=quick)
    metrics = plotter.generate_all_plots(preds, labels)
    out = tmp_path / "m"
    for name in ("pred_vs_true", "residual_hist", "summary"):
        assert (out / f"{name}.png").exists(), name
    for name in ("error_vs_true", "metric_bars", "residual_corr", "qq_residuals"):
        assert (out / f"{name}.png").exists() != quick, name
    assert metrics["T_eff"]["r2"] > 0.8


def _fake_diag(B=16, H=2, T=9, D=8, layers=2, seed=0):
    rng = np.random.default_rng(seed)
    probs = rng.random((layers, H, T, T))
    probs = probs / probs.sum(-1, keepdims=True)
    return {
        "attn": [probs[i] for i in range(layers)],
        "mlp": {f"layer_{i}": rng.standard_normal((B, T, 4 * D)) for i in range(layers)},
        "cls_hidden": {f"layer_{i}": rng.standard_normal((B, D)) for i in range(layers)},
        "cls_embedding": rng.standard_normal((B, D)),
    }


def test_viz_diagnostics_builds_frames_and_gifs(tmp_path):
    cfg = {"enable": True, "save_dir": str(tmp_path), "embedding_method": "pca",
           "gif_duration": 100}
    viz = VizDiagnostics(cfg, model_name="m", param_names=["log_g"])
    rng = np.random.default_rng(0)
    for epoch in range(3):
        viz.on_validation_epoch(epoch, rng.random((16, 1)), rng.random((16, 1)),
                                _fake_diag(seed=epoch))
    assert len(viz.frames["distribution"]) == 3
    assert len(viz.frames["attention"]) == 3
    written = viz.on_train_end()
    for key in ("distribution", "activation", "attention", "attention_analytics",
                "embedding", "collinearity"):
        assert key in written and os.path.exists(written[key]), key
        assert os.path.exists(str(tmp_path / "m" / f"{key}_final.png"))


def test_label_axis_bounds():
    labels = np.array([[0.0, 10.0], [2.0, 30.0], [1.0, 20.0]])
    b = label_axis_bounds(labels, label_norm="minmax", label_min=[-1.0, 5.0],
                          label_max=[3.0, 40.0])
    assert b == [(-1.0, 3.0), (5.0, 40.0)]
    b2 = label_axis_bounds(labels)
    assert b2[0][0] == pytest.approx(0.0 - 0.1)
    assert b2[0][1] == pytest.approx(2.0 + 0.1)
    assert b2[1] == (pytest.approx(9.0), pytest.approx(31.0))


def test_distribution_frames_share_axes():
    """The same VizDiagnostics pins its bounds on the first epoch."""
    viz = VizDiagnostics({"create_distribution_gif": True}, model_name="t", param_names=["a"])
    rng = np.random.default_rng(0)
    labels = rng.random((32, 1))
    viz.on_validation_epoch(0, rng.random((32, 1)), labels, {})
    first_bounds = viz.label_bounds
    assert first_bounds is not None
    viz.on_validation_epoch(1, rng.random((32, 1)) * 100, labels, {})
    assert viz.label_bounds == first_bounds
    assert len(viz.frames["distribution"]) == 2
    assert viz.frames["distribution"][0].size == viz.frames["distribution"][1].size


def test_cka_monitor_flags_frozen_layers():
    cka = CKAMonitor(threshold=0.95)
    diag0 = _fake_diag(seed=0)
    assert cka.on_validation_epoch(0, diag0)["cka/mean"] == 1.0  # CKA(init, init)
    out = cka.on_validation_epoch(1, diag0)
    assert out["cka/mean"] == pytest.approx(1.0, rel=1e-6)
    assert out["cka/unchanged_count"] == 3.0  # 2 layers + cls_embedding
    assert cka.on_validation_epoch(2, _fake_diag(seed=99))["cka/mean"] < 0.5


def _viz_experiment(tiny_config, tmp_path, monkeypatch, task="reg", ep=2, train=None, **viz):
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
    cfg = copy.deepcopy(tiny_config)
    if task == "cls":
        cfg["model"].update(task_type="cls", num_labels=2)
    cfg["train"].update(ep=ep, batch_size=16, **(train or {}))
    cfg["viz"] = dict({"enable": True, "save_local": True, "save_dir": str(tmp_path / "viz"),
                       "embedding_method": "pca", "gif_duration": 100}, **viz)
    return Experiment(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("case", ["epochs", "steps", "cls"])
def test_experiment_viz_integration(tiny_config, tmp_path, monkeypatch, capsys, case):
    """viz.enable: GIFs, CKA metrics and the CKA report from fit; every
    ``log_every_n_steps`` steps on the per-step path; and on a cls run,
    where logits (n, C) meet integer labels."""
    kw = {"epochs": dict(log_every_n_epochs=1, num_viz_samples=16),
          "steps": dict(ep=1, log_every_n_steps=3, num_viz_samples=8, compute_cka=False,
                        train={"fused_epoch": False}),
          "cls": dict(ep=1, task="cls", num_viz_samples=16)}[case]
    exp = _viz_experiment(tiny_config, tmp_path, monkeypatch, **kw)
    calls = []
    capture = exp._run_capture_eval
    exp._run_capture_eval = lambda *a: calls.append(1) or capture(*a)
    metrics = exp.fit()
    assert "diagnostics skipped" not in capsys.readouterr().out
    assert len(calls) == {"epochs": 2, "steps": 2, "cls": 1}[case]  # 96 samples: 6 steps
    gif_dir = tmp_path / "viz" / exp.bundle.model_name
    assert (gif_dir / "distribution.gif").exists()
    if case != "steps":
        assert "cka/mean" in metrics  # the first capture reports CKA(init, init)
    if case == "epochs":  # the report plots the history from the second capture on
        assert (gif_dir / "attention.gif").exists()
        assert (gif_dir / "cka_report.png").exists()


def test_extract_diagnostics_structure():
    pb = pbuilder.get_model(_small())
    x = torch.ones(4, 512)
    logits, diag = pdiag.capture_diagnostics(pb.module, x, 0.15)
    assert logits.shape == (4, 1)
    assert len(diag["attn"]) == 2
    assert diag["attn"][0].shape == (2, 33, 33)
    assert diag["cls_embedding"].shape == (4, 16)
    assert set(diag["mlp"]) == {"layer_0", "layer_1"}
    assert {"mean", "std", "sparsity", "dead_frac", "sat_frac", "sample"} <= set(
        diag["mlp"]["layer_0"])
    again = extract_diagnostics({"attn": [torch.ones(2, 3, 3, dtype=torch.bfloat16)]})
    assert again["attn"][0].dtype == np.float32 and again["cls_embedding"] is None


def test_sample_rate_changes_transferred_bytes():
    """viz.sample_rate scales the elements that cross to the host."""
    pb = pbuilder.get_model(_small())
    x = torch.ones(4, 512)
    n = {rate: pdiag.capture_diagnostics(pb.module, x, rate)[1]["mlp"]["layer_0"]["sample"].size
         for rate in (0.05, 0.5)}
    assert n[0.05] < n[0.5]
    assert n[0.5] == pytest.approx(10 * n[0.05], rel=0.25)


def test_capture_batch_cap_token_scaling():
    short = pdiag.capture_batch_cap(seq_len=129, num_heads=2, intermediate_size=128)
    long = pdiag.capture_batch_cap(seq_len=4065, num_heads=2, intermediate_size=128)
    assert short > long >= 1
    assert long * 4 * (2 * 4065 * 4065 + 4065 * 128) <= 512 * 1024**2


def test_cli_runs_baseline_with_diagnostics(tmp_path):
    """baseline.yaml as a user runs it (viz on, -w 1 without wandb), cut to
    1024 pixels, 64 spectra and 2 epochs: the console fallback, the GIFs,
    the CKA plot and the regression report."""
    from vit_tpu_torch.data.synthetic import write_dummy_h5

    h5 = tmp_path / "dataset.h5"
    write_dummy_h5(str(h5), n=64, length=1024, seed=0)
    cfg = load_config(os.path.join(ROOT, "configs/exp/att_clp/baseline.yaml"))
    cfg["model"]["image_size"] = 1024
    cfg["data"].update(file_path=str(h5), val_path=str(h5), test_path=str(h5),
                       num_samples=64, num_test_samples=64)
    cfg["train"]["ep"] = 2
    cfg["viz"].update(save_dir=str(tmp_path / "viz"), embedding_method="tsne")
    path = tmp_path / "baseline.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, CKPT_DIR=str(tmp_path / "ckpt"), PLOT_DIR=str(tmp_path / "plots"),
               OMP_NUM_THREADS="2")
    run = subprocess.run([sys.executable, "-m", "vit_tpu_torch", "run", "-c", str(path),
                          "-w", "1", "--device", "cpu", "--save"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    out = run.stdout
    assert "[logger] wandb not installed — console logging only" in out
    assert "epoch 1: train_loss=" in out and "cka/mean=" in out and "test_mae=" in out
    assert "skipped" not in out
    name = "ViT_p32_h32_l3_a2_s32_pSW"
    gifs = tmp_path / "viz" / name
    for key in ("distribution", "activation", "attention", "attention_analytics",
                "embedding", "collinearity"):
        assert (gifs / f"{key}.gif").exists(), key
    assert (gifs / "cka_report.png").exists()
    for fig in ("pred_vs_true", "residual_hist", "error_vs_true", "metric_bars",
                "qq_residuals", "summary"):
        assert (tmp_path / "plots" / name / f"{fig}.png").exists(), fig
