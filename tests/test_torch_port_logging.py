"""The port's logging, preemption guard, ``train.log_mfu`` and
``train.profile``: ports of ``tests/test_wandb_surface.py`` and
``tests/test_preempt.py`` run against ``vit_tpu_torch``.

wandb is not installed here: a ``sys.modules`` double stands in for it, as
in ``tests/test_wandb_surface.py``. Everything runs on the CPU.
"""

import copy
import json
import os
import signal
import subprocess
import sys
import time
import types

import pytest
import torch

from vit_tpu.models.builder import get_vit_config as jax_vit_config
from vit_tpu.models.builder import step_matmul_flops as jax_step_flops
from vit_tpu_torch.train.logging import MetricLogger
from vit_tpu_torch.train.loop import Experiment
from vit_tpu_torch.train.preempt import PreemptionGuard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeRun:
    def __init__(self, **kwargs):
        self.kwargs = kwargs
        self.logged = []
        self.artifacts = []
        self.finished = False

    def log(self, metrics, step=None):
        self.logged.append((dict(metrics), step))

    def log_artifact(self, art, aliases=None):
        self.artifacts.append((art, list(aliases or [])))

    def finish(self):
        self.finished = True


class _FakeArtifact:
    def __init__(self, name, type=None, metadata=None):
        self.name, self.type, self.metadata = name, type, metadata
        self.dirs = []

    def add_dir(self, path):
        self.dirs.append(path)


@pytest.fixture()
def fake_wandb(monkeypatch):
    mod = types.ModuleType("wandb")
    mod.runs = []

    def init(**kwargs):
        run = _FakeRun(**kwargs)
        mod.runs.append(run)
        return run

    mod.init = init
    mod.Artifact = _FakeArtifact
    mod.Video = lambda p: ("video", p)
    mod.Image = lambda f: ("image", str(type(f)))
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def _config(tiny_config, tmp_path, monkeypatch, **train):
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
    cfg = copy.deepcopy(tiny_config)
    cfg["train"].update(batch_size=16, **train)
    return cfg


# -- W&B (ports of tests/test_wandb_surface.py) ---------------------------------
def test_metric_key_names_and_artifacts(fake_wandb, tiny_config, tmp_path, monkeypatch):
    """use_wandb + save: vit_tpu's key names logged, best/last checkpoints
    uploaded as model artifacts at train end, the run finished by run()."""
    monkeypatch.setenv("WANDB_DIR", str(tmp_path / "wandb"))
    cfg = _config(tiny_config, tmp_path, monkeypatch, ep=2, save=True)
    exp = Experiment(cfg, use_wandb=True, seed=0, device="cpu")
    exp.run()
    run = fake_wandb.runs[-1]
    assert run.kwargs == dict(project=cfg["project"], name=exp.bundle.model_name,
                              dir=str(tmp_path / "wandb"), config=cfg, reinit=True)
    logged_keys = set().union(*(set(m) for m, _ in run.logged))
    for key in ("train_loss", "val_mae", "val_mse", "val_r2", "lr", "num_params(M)",
                "val_bias_median", "val_p90", "val_beta", "test_mae"):
        assert key in logged_keys, key
    assert [s for m, s in run.logged if "train_loss" in m] == [6, 12]  # (epoch + 1) * steps
    aliases = {a for _, al in run.artifacts for a in al}
    assert aliases == {"best", "last"}
    art = run.artifacts[0][0]
    assert art.type == "model" and art.name == f"model-{exp.bundle.model_name}"
    assert art.dirs and "ckpt" in art.dirs[0]
    assert run.finished


def test_no_artifacts_without_save(fake_wandb, tiny_config, tmp_path, monkeypatch):
    cfg = _config(tiny_config, tmp_path, monkeypatch, ep=1, save=False)
    Experiment(cfg, use_wandb=True, seed=0, device="cpu").fit()
    assert fake_wandb.runs[-1].artifacts == []


@pytest.mark.parametrize("how", ["absent", "init_fails"])
def test_console_fallback_without_a_wandb_run(how, monkeypatch, capsys):
    """vit_tpu's two messages; the logger then prints epochs and uploads
    nothing."""
    if how == "absent":
        monkeypatch.setitem(sys.modules, "wandb", None)  # import raises ImportError
        expect = "[logger] wandb not installed — console logging only"
    else:
        mod = types.ModuleType("wandb")

        def init(**kwargs):
            raise RuntimeError("no network")

        mod.init = init
        monkeypatch.setitem(sys.modules, "wandb", mod)
        expect = "[logger] wandb init failed (no network) — console logging only"
    logger = MetricLogger(name="m", use_wandb=True, save_artifacts=True)
    logger.log_epoch(0, {"train_loss": 0.5})
    logger.log_checkpoint(ROOT, "best")
    logger.finish()
    out = capsys.readouterr().out.splitlines()
    assert out == [expect, "[m] epoch 0: train_loss=0.5"]
    assert logger._wandb is None


# -- preemption (ports of tests/test_preempt.py) --------------------------------
def test_guard_latches_and_restores_handler():
    guard = PreemptionGuard(enabled=True, signals=(signal.SIGUSR1,))
    prev = signal.getsignal(signal.SIGUSR1)
    guard.install()
    assert not guard.triggered
    os.kill(os.getpid(), signal.SIGUSR1)
    assert guard.triggered
    assert signal.getsignal(signal.SIGUSR1) == prev  # one-shot
    guard.uninstall()


def test_guard_disabled_is_inert():
    guard = PreemptionGuard(enabled=False, signals=(signal.SIGUSR1,))
    prev = signal.getsignal(signal.SIGUSR1)
    guard.install()
    assert signal.getsignal(signal.SIGUSR1) == prev
    guard.uninstall()


# A long run (500 epochs, 0.1 s a step at least) with train.save on, for
# the parent to preempt.
_WORKER = r"""
import os, sys, time
import torch
from vit_tpu_torch.train.loop import Experiment
torch.set_num_threads(1)
cfg = {
    "project": "vit-tpu-test",
    "model": {"name": "vit", "task_type": "reg", "image_size": 512, "patch_size": 32,
              "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
              "stride_size": 32, "proj_fn": "SW"},
    "train": {"batch_size": 16, "ep": 500, "save": True},
    "loss": {"name": "mae"},
    "opt": {"type": "AdamW", "lr": 1e-3, "lr_sch": "none"},
    "data": {"file_path": sys.argv[1], "val_path": sys.argv[1], "num_samples": 96,
             "param": "log_g", "label_norm": "minmax"},
    "noise": {"noise_level": 0},
    "viz": {"enable": False},
}
exp = Experiment(cfg, seed=0, device="cpu")
step = exp.train_step
exp.train_step = lambda *a: time.sleep(0.1) or step(*a)
metrics = exp.fit()
print(f"WORKER_DONE step={exp.step} config={__import__('json').dumps(cfg)}", flush=True)
"""


def _worker(dummy_h5, ckpt_dir):
    env = dict(os.environ, PYTHONPATH=ROOT, CKPT_DIR=ckpt_dir, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", _WORKER, dummy_h5], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _preempt(proc, signals: int, after_epochs: int = 2):
    """A SIGTERM once ``after_epochs`` epoch lines are out, and with
    ``signals=2`` a second one as soon as the guard says it has the first;
    the whole output after the process ends."""
    lines, seen, deadline = [], 0, time.time() + 240
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if " epoch " in line and "train_loss=" in line:
            seen += 1
            if seen == after_epochs:
                proc.send_signal(signal.SIGTERM)
        if line.startswith("[preempt] signal") and signals == 2:
            proc.send_signal(signal.SIGTERM)
    lines.append(proc.stdout.read() or "")
    proc.wait(timeout=120)
    return "".join(lines)


def test_sigterm_stops_at_epoch_boundary_and_resumes(dummy_h5, tmp_path, monkeypatch):
    """SIGTERM mid-run: exit 0 at an epoch boundary with `last` saved; a
    resume from `last` gives bit for bit the parameters of the
    uninterrupted run."""
    ckpt_dir = str(tmp_path / "ckpt")
    proc = _worker(dummy_h5, ckpt_dir)
    out = _preempt(proc, signals=1)
    assert proc.returncode == 0, out
    assert "[preempt] signal 15 received" in out and "preemption stop at epoch" in out, out
    done = out.split("WORKER_DONE step=")[1]
    stop_step, cfg = int(done.split()[0]), json.loads(done.split("config=", 1)[1])
    steps_per_epoch = 6  # 96 samples at batch 16
    assert stop_step % steps_per_epoch == 0 and stop_step < 400 * steps_per_epoch
    epochs = stop_step // steps_per_epoch + 1

    monkeypatch.setenv("CKPT_DIR", ckpt_dir)
    cfg["train"]["ep"] = epochs
    resumed = Experiment(copy.deepcopy(cfg), ckpt_path="last", seed=0, device="cpu")
    resumed.fit()
    assert resumed.step == epochs * steps_per_epoch
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "whole"))
    whole = Experiment(copy.deepcopy(cfg), seed=0, device="cpu")
    whole.fit()
    for (k, a), (_, b) in zip(whole.module.state_dict().items(),
                              resumed.module.state_dict().items()):
        assert torch.equal(a, b), k


def test_second_sigterm_terminates(dummy_h5, tmp_path):
    proc = _worker(dummy_h5, str(tmp_path / "ckpt"))
    out = _preempt(proc, signals=2, after_epochs=1)
    assert proc.returncode == -signal.SIGTERM, out
    assert "[preempt] signal 15 received" in out and "WORKER_DONE" not in out


def test_preemption_off_leaves_the_handler(tiny_config, tmp_path, monkeypatch):
    """train.handle_preemption: false installs nothing during fit."""
    cfg = _config(tiny_config, tmp_path, monkeypatch, ep=1, handle_preemption=False)
    exp = Experiment(cfg, seed=0, device="cpu")
    handlers = []
    step = exp.train_step
    exp.train_step = lambda *a: handlers.append(signal.getsignal(signal.SIGTERM)) or step(*a)
    before = signal.getsignal(signal.SIGTERM)
    exp.fit()
    assert handlers and set(handlers) == {before}
    assert not exp._preempt.triggered


# -- train.log_mfu and train.profile --------------------------------------------
def test_log_mfu_reports_tflops_and_mfu(tiny_config, tmp_path, monkeypatch):
    cfg = _config(tiny_config, tmp_path, monkeypatch, ep=1, log_mfu=True, peak_tflops=989)
    exp = Experiment(cfg, seed=0, device="cpu")
    m = exp.fit()
    flops = jax_step_flops(jax_vit_config(cfg), 16, train=True)
    assert m["tflops_per_s"] == pytest.approx(6 * flops / m["epoch_time_s"] / 1e12, rel=1e-9)
    assert m["mfu"] == pytest.approx(m["tflops_per_s"] / 989, rel=1e-12)
    cfg["train"].pop("peak_tflops")
    m = Experiment(cfg, seed=0, device="cpu").fit()
    assert "tflops_per_s" in m and "mfu" not in m


@pytest.mark.parametrize("ep", [1, 2])
def test_profile_traces_the_steady_state_epoch(tiny_config, tmp_path, monkeypatch, capsys, ep):
    """The second epoch when there is one, else the first (with the
    warm-up note); a Chrome trace whose path is printed."""
    cfg = _config(tiny_config, tmp_path, monkeypatch, ep=ep, profile=str(tmp_path / "prof"))
    exp = Experiment(cfg, seed=0, device="cpu")
    exp.fit()
    out = capsys.readouterr().out
    path = tmp_path / "prof" / f"{exp.bundle.model_name}_epoch{ep - 1}.json"
    assert os.listdir(tmp_path / "prof") == [path.name]
    note = " (includes warm-up)" if ep == 1 else ""
    assert f"[experiment] profiler trace written to {path}{note}\n" in out
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
