"""The port's LR sweep (``python -m vit_tpu_torch lr``) and W&B agent
(``python -m vit_tpu_torch sweep``) against vit_tpu's
``opt/parallel_sweep.py`` and ``scripts/sweep.py`` (ports of
``tests/test_parallel_sweep.py``), and the preemption guard's order.

Everything runs on the CPU; wandb is not installed here, so a
``sys.modules`` double stands in for it where a run is needed.
"""

import copy
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from vit_tpu.opt import parallel_sweep as jsweep
from vit_tpu_torch.opt import agent as pagent
from vit_tpu_torch.opt import parallel_sweep as psweep
from vit_tpu_torch.train import preempt as ppreempt
from vit_tpu_torch.train.preempt import PreemptionGuard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def sweep_base_config(tiny_config, tmp_path):
    cfg = copy.deepcopy(tiny_config)
    cfg["train"] = dict(tiny_config["train"], ep=2, batch_size=16)
    path = tmp_path / "base.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


GRID = dict(lr_values=[1e-4, 1e-3], schedulers=["plateau", "cosine", "none"],
            plateau_factors=[0.8, 0.5], plateau_patience=[10])


def test_grid_opt_configs_and_scales_are_vit_tpus(sweep_base_config, tmp_path):
    port = psweep.ParallelSweepRunner(sweep_base_config, engine="sequential",
                                      results_dir=str(tmp_path), **GRID)
    ref = jsweep.ParallelSweepRunner(sweep_base_config, engine="sequential",
                                     results_dir=str(tmp_path), **GRID)
    assert [c.to_dict() for c in port.sweep_configs] == [c.to_dict() for c in ref.sweep_configs]
    assert [c.to_opt_config() for c in port.sweep_configs] == \
        [c.to_opt_config() for c in ref.sweep_configs]
    assert len(port.sweep_configs) == 8 and port.cosine_T_max == 2  # from train.ep
    jconfigs = ref.sweep_configs
    for epoch in range(6):
        for warm in (0, 3):
            plateau = {0: 0.5, 2: 0.25}
            np.testing.assert_array_equal(
                psweep.sweep_epoch_scales(port.sweep_configs, epoch, warm, plateau, 5),
                jsweep.sweep_epoch_scales(jconfigs, epoch, warm, plateau, 5))


def test_dry_run_leaves_no_artifacts(sweep_base_config, tmp_path, capsys):
    runner = psweep.ParallelSweepRunner(sweep_base_config, lr_values=[1e-3],
                                        results_dir=str(tmp_path / "runs"), engine="sequential")
    assert runner.run(dry_run=True) is None
    assert not os.path.exists(runner.run_dir)
    assert "[Dry run] Would execute the following configurations:" in capsys.readouterr().out


def _ref_summary_keys(sweep_base_config, tmp_path):
    """The keys of the summary vit_tpu's runner writes, from its own writer."""
    ref = jsweep.ParallelSweepRunner(sweep_base_config, lr_values=[1e-3], engine="sequential",
                                     results_dir=str(tmp_path / "ref"))
    os.makedirs(ref.run_dir)
    res = jsweep.SweepResult(ref.sweep_configs[0], 0.5, 1.0)
    ref._write_summary([res], res)
    with open(ref.summary_path) as f:
        return yaml.safe_load(f)


def test_sequential_sweep_end_to_end(sweep_base_config, tmp_path):
    """Four trials on the tiny config: vit_tpu's summary schema, the best
    config read back, best = the smallest ok metric, and each trial's
    metric that of a standalone Experiment with seed + idx."""
    from vit_tpu_torch.train.loop import Experiment

    runner = psweep.ParallelSweepRunner(
        sweep_base_config, lr_values=[1e-4, 1e-3], schedulers=["none", "plateau"],
        plateau_patience=[0], results_dir=str(tmp_path / "runs"), seed=3, engine="sequential",
        device="cpu", gpu_ids=[0])
    best = runner.run()
    with open(runner.summary_path) as f:
        summary = yaml.safe_load(f)
    ref = _ref_summary_keys(sweep_base_config, tmp_path)
    assert list(summary) == list(ref)
    assert set(summary["search_space"]) == set(ref["search_space"])
    assert set(summary["results"][0]) == set(ref["results"][0]) == set(summary["best"])
    assert summary["num_configs"] == 4 and summary["engine"] == "sequential"
    assert summary["gpus"] == [0]
    metrics = [r["metric"] for r in summary["results"] if r["status"] == "ok"]
    assert len(metrics) == 4 and summary["best"]["metric"] == min(metrics) == best.metric
    with open(runner.best_config_path) as f:
        best_cfg = yaml.safe_load(f)
    assert best_cfg["opt"]["lr"] == summary["best"]["config"]["lr"]
    assert best_cfg["_meta"]["generator"] == "vit_tpu_torch.opt.parallel_sweep"
    assert best_cfg["_meta"]["best_metric"] == best.metric

    c = runner.sweep_configs[3]  # lr 1e-3, plateau
    cfg = psweep._SequentialSweepEngine(runner.base_config, [c], "val_mae", "minimize",
                                        3).trial_config(c)
    alone = Experiment(cfg, seed=3 + c.idx, device="cpu").fit()["val_mae"]
    assert alone == summary["results"][3]["metric"]


def test_failing_trial_is_isolated(sweep_base_config, tmp_path):
    """One diverging trial (absurd lr, no clip) is status='error'; the other
    wins (vit_tpu's test_sequential_engine_isolates_trial_failure)."""
    with open(sweep_base_config) as f:
        cfg = yaml.safe_load(f)
    cfg["train"].update(grad_clip=0.0, ep=1)
    path = tmp_path / "noclip.yaml"
    path.write_text(yaml.safe_dump(cfg))
    runner = psweep.ParallelSweepRunner(str(path), lr_values=[1e-3, 1e6], seed=0,
                                        results_dir=str(tmp_path / "runs"), engine="sequential",
                                        device="cpu")
    assert runner.run().config.lr == 1e-3
    with open(runner.summary_path) as f:
        statuses = {r["config"]["lr"]: r["status"] for r in yaml.safe_load(f)["results"]}
    assert statuses == {1e-3: "ok", 1e6: "error"}


def test_engine_validated_and_vmap_raises(sweep_base_config, tmp_path):
    """A bad engine raises; vit_tpu's default engine, vmap, is the default
    and runs (it raised before the vmapped engine was ported)."""
    with pytest.raises(ValueError, match="engine"):
        psweep.ParallelSweepRunner("/nonexistent.yaml", engine="bogus")
    runner = psweep.ParallelSweepRunner(sweep_base_config, lr_values=[1e-3], device="cpu",
                                        results_dir=str(tmp_path / "runs"))
    assert runner.engine == "vmap"
    assert runner.run().metric is not None
    with open(runner.summary_path) as f:
        assert yaml.safe_load(f)["engine"] == "vmap"


def test_lr_cli_dry_run_and_vmap(sweep_base_config, tmp_path):
    cmd = [sys.executable, "-m", "vit_tpu_torch", "lr", sweep_base_config, "--lr", "1e-4",
           "1e-3", "--schedulers", "none", "cosine", "--dry-run", "--device", "cpu",
           "--results-dir", str(tmp_path / "runs")]
    run = subprocess.run(cmd + ["--engine", "sequential"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "4 configs" in run.stdout and "[Dry run]" in run.stdout
    assert not os.path.exists(tmp_path / "runs")
    vmap = subprocess.run(cmd[:5] + ["--lr", "1e-3", "--device", "cpu", "--results-dir",
                                     str(tmp_path / "runs")],
                          cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert vmap.returncode == 0, vmap.stderr
    assert "vmapped replicas" in vmap.stdout and "[sweep] epoch 1:" in vmap.stdout
    (run_dir,) = os.listdir(tmp_path / "runs")
    with open(tmp_path / "runs" / run_dir / "summary.yaml") as f:
        assert yaml.safe_load(f)["engine"] == "vmap"


# -- the W&B agent ----------------------------------------------------------------
class _Run:
    def __init__(self, **kwargs):
        self.kwargs, self.name, self.logged = kwargs, None, []

    def log(self, metrics, step=None):
        self.logged.append(dict(metrics))

    def finish(self):
        pass


def _fake_wandb(monkeypatch, params):
    mod = types.ModuleType("wandb")
    mod.runs, mod.agents = [], []
    mod.config = dict(params)

    def init(**kwargs):
        mod.runs.append(_Run(**kwargs))
        return mod.runs[-1]

    def agent(sweep_id, function, entity=None, project=None, count=None):
        mod.agents.append((sweep_id, entity, project, count))
        for _ in range(count or 1):
            function()

    mod.init, mod.agent = init, agent
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def test_sweep_agent_applies_overrides(sweep_base_config, tmp_path, monkeypatch):
    """--vit_config through $VIT_CONFIG, dotted overrides from wandb.config
    (reserved keys skipped), Experiment(use_wandb, sweep) and the run named
    after the model; --sweep_id registers an agent."""
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.delenv("VIT_CONFIG", raising=False)
    mod = _fake_wandb(monkeypatch, {"opt.lr": 0.005, "train.ep": 1, "_wandb": {"x": 1},
                                    "model.hidden_dropout_prob": 0.0})
    seen = []
    from vit_tpu_torch.train import loop

    real = loop.Experiment

    def spy(config, **kw):
        seen.append((copy.deepcopy(config), kw))
        return real(config, **kw)

    monkeypatch.setattr(loop, "Experiment", spy)
    from vit_tpu_torch.__main__ import main

    assert main(["sweep", "--sweep_id", "abc", "--count", "1", "-e", "ent", "-p", "proj",
                 "--vit_config", sweep_base_config, "--device", "cpu",
                 "--train.ep=1"]) == 0
    assert os.environ["VIT_CONFIG"] == sweep_base_config
    assert mod.agents == [("abc", "ent", "proj", 1)]
    (config, kw), = seen
    assert config["opt"]["lr"] == 0.005 and config["train"]["ep"] == 1
    assert config["model"]["hidden_dropout_prob"] == 0.0 and "_wandb" not in config
    assert kw == dict(use_wandb=True, sweep=True, num_devices=1, device="cpu")
    sweep_run = mod.runs[0]
    assert sweep_run.name is not None and sweep_run.name.startswith("ViT_")


def test_sweep_without_wandb_exits_2_with_vit_tpus_message():
    env = dict(os.environ, PYTHONPATH=ROOT)
    ours = subprocess.run([sys.executable, "-m", "vit_tpu_torch", "sweep"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    ref = subprocess.run([sys.executable, "scripts/sweep.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert ours.returncode == ref.returncode == 2, (ours.stderr, ref.stderr)
    assert ours.stdout == ref.stdout and "wandb is not installed" in ours.stdout
    assert pagent.RESERVED_KEYS == {"vit_config", "_wandb"}


# -- the preemption guard ---------------------------------------------------------
def test_guard_restores_the_handler_before_it_prints(monkeypatch):
    """The line a caller waits for is printed only once the previous handler
    is back, so a second SIGTERM sent on reading it terminates."""
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard(enabled=True, signals=(signal.SIGTERM,)).install()
    at_print = []
    monkeypatch.setattr(ppreempt, "print",
                        lambda *a, **k: at_print.append(signal.getsignal(signal.SIGTERM)),
                        raising=False)
    try:
        assert signal.getsignal(signal.SIGTERM) == guard._handle
        guard._handle(signal.SIGTERM, None)
    finally:
        guard.uninstall()
        signal.signal(signal.SIGTERM, prev)
    assert guard.triggered and at_print == [prev]
