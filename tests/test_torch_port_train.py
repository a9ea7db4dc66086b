"""The port's training path against vit_tpu's: the step, whole epochs, resume,
serving what training wrote, and the data and optimizer pieces beneath.

Everything runs on the CPU in fp32 with the plain versions of the kernels.
Dropout is off where the two packages are compared (vit_tpu derives its
dropout seeds from flax keys, which the port cannot reproduce); the resume
test keeps it on, since the port alone must reproduce itself exactly.
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

from vit_tpu.data import datasets as jds
from vit_tpu.data import hdf5 as jh5
from vit_tpu.data import pipeline as jpipe
from vit_tpu.train import optim as jopt
from vit_tpu.train.loop import Experiment as JaxExperiment
from vit_tpu.train.loop import TrainState, make_train_step
from vit_tpu_torch.data import datasets as pds
from vit_tpu_torch.data import hdf5 as ph5
from vit_tpu_torch.data import pipeline as ppipe
from vit_tpu_torch.train import optim as popt
from vit_tpu_torch.train.loop import Experiment
from vit_tpu_torch.train.torch_bridge import from_flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Losses after a few AdamW steps: fp32 sums in another order, amplified a
# little by Adam's normalisation; measured gaps are ~1e-7.
LOSS_TOL = 1e-5
PARAM_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """These tests run many small CPU ops; torch's thread pool, one per core
    in each of the parallel test workers, would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_dropout(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["model"].update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return cfg


def _jax_init(jexp):
    """vit_tpu's initial params for this Experiment (its own _init_state)."""
    spec = jopt.OptSpec.from_config(jexp.config, 1)
    jexp.state = jexp._init_state(jopt.build_optimizer(spec))
    return jax.tree_util.tree_map(np.asarray, jax.device_get(jexp.state.params))


@pytest.mark.parametrize("accum", [1, 2])
def test_three_steps_match_make_train_step(tiny_config, accum):
    cfg = _no_dropout(tiny_config)
    cfg["model"].update(attn_impl="flash", fused_mlp=True)
    cfg["train"]["accumulate_steps"] = accum
    jexp = JaxExperiment(cfg)
    params = _jax_init(jexp)
    spec = jopt.OptSpec.from_config(cfg, 6)
    tx = jopt.build_optimizer(spec)
    state = TrainState(step=jax.numpy.zeros((), jax.numpy.int32), params=jexp.state.params,
                       opt_state=tx.init(jexp.state.params), rng=jax.random.PRNGKey(0),
                       plateau_scale=jax.numpy.ones(()), frozen=jax.numpy.zeros(()))
    step = make_train_step(jexp.bundle, tx, spec, 0.0, accum_steps=accum)

    exp = Experiment(cfg, device="cpu")
    exp.module.load_state_dict(from_flax_params(params, exp.bundle.vit_config), strict=True)
    pspec = popt.OptSpec.from_config(cfg, 6)
    exp.optimizer = popt.build_optimizer(pspec, exp.module.parameters())
    schedule = popt.schedule_scale(pspec)
    exp.module.train()

    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = {"x": rng.standard_normal((16, 512)).astype(np.float32),
                 "label": rng.random((16, 1)).astype(np.float32)}
        state, m = step(state, batch)
        loss, lr = exp.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                                  pspec, schedule)
        assert abs(float(m["loss"]) - loss.item()) <= LOSS_TOL
        assert lr == pytest.approx(float(m["lr"]), rel=1e-6)
    want = from_flax_params(jax.tree_util.tree_map(np.asarray, state.params),
                            exp.bundle.vit_config)
    for k, v in exp.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=PARAM_TOL, rtol=0,
                                   err_msg=k)


def _record_epochs(exp, monkeypatch):
    """The metrics of every epoch the Experiment's logger prints, in order."""
    epochs = []
    monkeypatch.setattr(exp.logger, "log_epoch",
                        lambda epoch, metrics, step=None: epochs.append(dict(metrics)))
    return epochs


def test_two_epochs_match_vit_tpu_experiment(tiny_config, monkeypatch):
    """tiny_config, dropout off, two epochs from the same initial weights:
    per-epoch train loss and validation metrics agree, and the logged metric
    keys are equal."""
    cfg = _no_dropout(tiny_config)
    jexp = JaxExperiment(copy.deepcopy(cfg))
    params = _jax_init(jexp)
    jlog = _record_epochs(jexp, monkeypatch)
    jexp.fit()

    exp = Experiment(copy.deepcopy(cfg), device="cpu")
    exp.module.load_state_dict(from_flax_params(params, exp.bundle.vit_config), strict=True)
    plog = _record_epochs(exp, monkeypatch)
    exp.fit()
    assert len(plog) == len(jlog) == 2
    for jm, pm in zip(jlog, plog):
        assert set(pm) == set(jm)
        for key in ("train_loss", "val_loss", "val_mae", "val_mse", "val_r2", "val_p90"):
            assert pm[key] == pytest.approx(jm[key], rel=1e-4, abs=1e-6), key
        assert pm["lr"] == pytest.approx(jm["lr"], rel=1e-6)


def _train(cfg, ckpt_dir, monkeypatch, epochs, ckpt_path=None):
    monkeypatch.setenv("CKPT_DIR", str(ckpt_dir))
    cfg = copy.deepcopy(cfg)
    cfg["train"].update(ep=epochs, save=True)
    exp = Experiment(cfg, device="cpu", ckpt_path=ckpt_path)
    exp.fit()
    return exp


@pytest.fixture()
def resumable(tiny_config):
    """Dropout on, noise injection on, plateau that fires every epoch."""
    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(attn_impl="flash", fused_mlp=True, remat="mlp")
    cfg["opt"].update(lr_sch="plateau", factor=0.5, patience=0)
    cfg["noise"]["noise_level"] = 0.5
    return cfg


def test_resume_from_last_equals_the_uninterrupted_run(resumable, tmp_path, monkeypatch):
    whole = _train(resumable, tmp_path / "a", monkeypatch, 2)
    _train(resumable, tmp_path / "b", monkeypatch, 1)
    resumed = _train(resumable, tmp_path / "b", monkeypatch, 2, ckpt_path="last")
    assert resumed.step == whole.step == 12
    assert resumed.plateau_scale == whole.plateau_scale
    for (k, a), (_, b) in zip(whole.module.state_dict().items(),
                              resumed.module.state_dict().items()):
        assert torch.equal(a, b), k
    a, b = whole.callback_metrics, resumed.callback_metrics
    assert a["train_loss"] == b["train_loss"] and a["val_mae"] == b["val_mae"]


def test_predictor_serves_what_training_wrote(resumable, tmp_path, monkeypatch):
    from vit_tpu_torch.serve import Predictor
    from vit_tpu_torch.viz.viz_utils import denormalize

    exp = _train(resumable, tmp_path, monkeypatch, 1)
    meta = yaml.safe_load(open(os.path.join(exp.ckpt.dir, "meta.yaml")))
    assert meta["monitor"] == "val_mae" and meta["best_epoch"] == exp.ckpt.best_epoch == 0
    assert meta["label_norm"] == "minmax" and meta["last_epoch"] == 0
    assert {"early_stop_state", "plateau_state", "config"} <= set(meta)
    pred = Predictor.from_checkpoint(resumable, ckpt="best", device="cpu", batch_size=8)
    x = exp.datamodule.val.model_input[:20]
    best = torch.load(exp.ckpt.resolve("best"), weights_only=True)["state_dict"]
    exp.module.load_state_dict(best)
    with torch.no_grad():
        logits = exp.module.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(pred._batched_logits(x), logits, atol=1e-6, rtol=0)
    stats = exp.datamodule.train.norm_stats()
    np.testing.assert_allclose(pred.predict(x), denormalize(logits, "minmax", **stats),
                               atol=1e-5, rtol=0)


def test_cli_trains_and_tests_on_the_cpu(tiny_config, tmp_path):
    cfg = copy.deepcopy(tiny_config)
    cfg["train"]["ep"] = 1
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, CKPT_DIR=str(tmp_path / "ckpt"))
    run = subprocess.run([sys.executable, "-m", "vit_tpu_torch", "run", "-c", str(path),
                          "--device", "cpu", "--save"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "epoch 0: train_loss=" in run.stdout and "test_mae=" in run.stdout
    test = subprocess.run([sys.executable, "-m", "vit_tpu_torch", "test", "-c", str(path),
                           "--device", "cpu", "--ckpt", "last"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert test.returncode == 0, test.stderr
    assert "'test_mae'" in test.stdout


# -- data and optimizer pieces ------------------------------------------------
@pytest.mark.parametrize("n, bs, shuffle, eval_mode", [(10, 4, True, False), (10, 4, False, True),
                                                       (3, 8, True, False), (16, 4, True, False)])
def test_batcher_is_vit_tpus(n, bs, shuffle, eval_mode):
    cols = {"x": np.arange(n * 2, dtype=np.float32).reshape(n, 2), "label": np.arange(n)}
    a = jpipe.Batcher(cols, bs, shuffle=shuffle, seed=7, eval_mode=eval_mode)
    b = ppipe.Batcher(cols, bs, shuffle=shuffle, seed=7, eval_mode=eval_mode)
    for epoch in range(3):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        for ba, bb in zip(a, b, strict=True):
            assert ba.keys() == bb.keys()
            for k in ba:
                assert np.array_equal(ba[k], bb[k])
    for e in range(3):
        assert np.array_equal(jpipe.epoch_permutation(n, bs, 5, 42, e),
                              ppipe.epoch_permutation(n, bs, 5, 42, e))


def test_prefetch_to_device_keeps_order_and_values():
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]
    out = list(ppipe.prefetch_to_device(iter(batches), "cpu", size=2))
    assert [int(b["x"][0, 0]) for b in out] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in out)


@pytest.mark.parametrize("task, norm", [("reg", "minmax"), ("reg", "zscore"), ("cls", "none")])
def test_datasets_are_vit_tpus(tiny_config, task, norm):
    cfg = copy.deepcopy(tiny_config)
    cfg["model"]["task_type"] = task
    cfg["data"].update(label_norm=norm, param="log_g, T_eff" if task == "reg" else "log_g")
    cfg["noise"]["noise_level"] = 0.3
    a, b = jds.SpecDataModule(cfg), pds.SpecDataModule(cfg)
    for stage in ("fit", "test"):
        a.setup(stage)
        b.setup(stage)
    for split in ("train", "val", "test"):
        da, db = getattr(a, split), getattr(b, split)
        for k, v in da.arrays().items():
            assert np.array_equal(v, db.arrays()[k]), (split, k)
        assert np.array_equal(da.snr, db.snr)
        if task == "reg":
            for k, v in da.norm_stats().items():
                assert (v is None and db.norm_stats()[k] is None) or np.array_equal(
                    v, db.norm_stats()[k])
    assert a.val_batch_size == b.val_batch_size


def test_in_memory_source_equals_the_file(tiny_config):
    from vit_tpu_torch.data.synthetic import make_dummy_spectra

    data = make_dummy_spectra(n=96, length=512, seed=0)  # what dummy_h5 holds
    a, b = pds.SpecDataModule(tiny_config), pds.SpecDataModule(tiny_config, source=data)
    for dm in (a, b):
        dm.setup("fit")
        dm.setup("test")
    for split in ("train", "val", "test"):
        for k, v in getattr(a, split).arrays().items():
            assert np.array_equal(v, getattr(b, split).arrays()[k]), (split, k)


def test_read_params_table_is_vit_tpus(dummy_h5):
    a, b = jh5.read_params_table(dummy_h5, 40), ph5.read_params_table(dummy_h5, 40)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k])


@pytest.mark.parametrize("opt", [
    {"lr_sch": "cosine", "T_max": 7}, {"lr_sch": "cosine", "warmup_epochs": 2, "eta_min": 1e-5},
    {"lr_sch": "onecycle"}, {"lr_sch": "constant", "factor": 0.3, "total_iters": 2},
    {"lr_sch": "plateau", "warmup_ratio": 0.05}, {"lr_sch": "none"},
])
def test_schedule_and_spec_are_vit_tpus(opt):
    cfg = {"opt": dict(opt, lr=2e-3), "train": {"ep": 5}}
    a, b = jopt.OptSpec.from_config(cfg, 7), popt.OptSpec.from_config(cfg, 7)
    assert a.__dict__ == b.__dict__
    fa, fb = jopt.schedule_scale(a), popt.schedule_scale(b)
    for step in range(0, 5 * 7 + 3):
        # vit_tpu evaluates in float32, the port in float64
        assert fb(step) == pytest.approx(float(fa(step)), rel=2e-6, abs=1e-7), step


def test_plateau_and_early_stopping_are_vit_tpus():
    values = [1.0, 0.9, 0.95, 0.95, 0.899, float("nan"), 0.97, 0.5, 0.6, 0.7, 0.8]
    pa, pb = jopt.PlateauScheduler(0.5, 1), popt.PlateauScheduler(0.5, 1)
    ea = jopt.EarlyStopping(patience=3, divergence_threshold=5.0)
    eb = popt.EarlyStopping(patience=3, divergence_threshold=5.0)
    for v in values:
        assert pa.step(v) == pb.step(v)
        assert ea.step(v) == eb.step(v)
        assert pa.state_dict() == pb.state_dict() and ea.state_dict() == eb.state_dict()


def test_optimizers_and_clip_follow_optax():
    """adamw/adam/sgd with optax's defaults, and optax's clip rule; the
    other optimizers build and step."""
    import optax

    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(6).astype(np.float32)
    grads = [rng.standard_normal(6).astype(np.float32) for _ in range(4)]
    for name, wd in (("adamw", 0.0), ("adamw", 0.05), ("adam", 0.01), ("sgd", 0.0)):
        spec = popt.OptSpec(lr=0.01, opt_type=name, weight_decay=wd)
        tx = jopt.build_optimizer(jopt.OptSpec(lr=0.01, opt_type=name, weight_decay=wd))
        jp, state = jax.numpy.asarray(p0), None
        state = tx.init(jp)
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = popt.build_optimizer(spec, [p])
        for g in grads:
            upd, state = tx.update(jax.numpy.asarray(g), state, jp)
            jp = optax.apply_updates(jp, upd)
            p.grad = torch.from_numpy(g.copy())
            popt.clip_by_global_norm([p.grad], spec.grad_clip)
            opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), atol=1e-6, rtol=0,
                                   err_msg=f"{name} wd={wd}")
    g = torch.tensor([3.0, 4.0])
    popt.clip_by_global_norm([g], 0.5)
    assert torch.equal(g, torch.tensor([3.0, 4.0]) / 5.0 * 0.5)
    small = torch.tensor([0.1, 0.2])
    popt.clip_by_global_norm([small], 0.5)
    assert torch.equal(small, torch.tensor([0.1, 0.2]))
    for name in ("rmsprop", "lbfgs", "asgd"):  # ported: tests/test_torch_port_optim.py
        opt = popt.build_optimizer(popt.OptSpec(opt_type=name), [p])
        p.grad = torch.ones_like(p)
        opt.step()
        assert torch.isfinite(p).all()


# -- train.async_ckpt (tests/test_async_ckpt.py) ---------------------------------
def test_async_fit_artifacts_match_sync(tiny_config, monkeypatch, tmp_path):
    """Same config and seed, async and sync saving: the same metrics, the
    same restored weights through a fresh Experiment, the same bytes."""
    from vit_tpu_torch.train.checkpoint import STATE_FILE

    def run(async_ckpt, sub):
        monkeypatch.setenv("CKPT_DIR", str(tmp_path / sub))
        cfg = copy.deepcopy(tiny_config)
        cfg["train"].update(save=True, async_ckpt=async_ckpt)
        exp = Experiment(copy.deepcopy(cfg), device="cpu", seed=0)
        assert exp.ckpt.async_save is async_ckpt
        m = exp.fit()
        exp2 = Experiment(copy.deepcopy(cfg), device="cpu", seed=1)
        t = exp2.test(ckpt="best")
        with open(os.path.join(exp.ckpt.best_path, STATE_FILE), "rb") as f:
            blob = f.read()
        return m, t, exp2.module.regressor.weight.detach().clone(), blob

    m_a, t_a, k_a, blob_a = run(True, "async")
    m_s, t_s, k_s, blob_s = run(False, "sync")
    assert m_a["train_loss"] == m_s["train_loss"] and m_a["val_mae"] == m_s["val_mae"]
    assert t_a["test_mae"] == t_s["test_mae"]
    assert torch.equal(k_a, k_s)
    assert blob_a == blob_s


def test_async_manager_wait_fences(tmp_path):
    """wait() blocks until the background write has landed and the pointers
    flipped; what is written is the state as it was at the save, whatever
    the caller does to its tensors afterwards."""
    from vit_tpu_torch.train.checkpoint import CheckpointManager

    w = torch.arange(1024, dtype=torch.float32).reshape(32, 32)
    state = {"w": w, "nested": {"b": torch.ones(32)}, "step": 3}
    mgr = CheckpointManager(str(tmp_path), "m", async_save=True)
    mgr.on_epoch_end(state, epoch=0, metric_value=1.0)
    w.add_(1.0)  # the next step's in-place update
    mgr.wait()
    assert os.path.islink(mgr.best_path) and os.path.islink(mgr.last_path)
    restored = torch.load(mgr.resolve("last"), weights_only=True)
    assert torch.equal(restored["w"], w - 1.0) and restored["step"] == 3
    assert torch.equal(restored["nested"]["b"], torch.ones(32))


def test_async_overwrite_sequence(tmp_path):
    """Back-to-back saves replace best and last without racing the writer:
    each save waits for the one before, and superseded versions go."""
    from vit_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), "m", async_save=True)
    for epoch in range(4):
        mgr.on_epoch_end({"w": torch.full((16, 16), float(epoch))}, epoch=epoch,
                         metric_value=-float(epoch))  # improves every epoch
    mgr.wait()
    best = torch.load(mgr.resolve("best"), weights_only=True)
    assert torch.equal(best["w"], torch.full((16, 16), 3.0))
    assert mgr.best_epoch == 3
    assert sorted(os.listdir(os.path.join(mgr.dir, ".versions"))) == [
        os.path.basename(os.path.realpath(mgr.best_path)),
        os.path.basename(os.path.realpath(mgr.last_path))]
