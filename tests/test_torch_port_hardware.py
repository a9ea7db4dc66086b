"""The port's hardware helpers against vit_tpu/hardware.py, on the CPU.

The prefetch depth is vit_tpu's rule ($NUM_WORKERS, else train.num_workers,
each clipped to [1, 8], else 2), and the port's Experiment takes it from
there; before, the Experiment computed ``num_workers or 2`` itself, which
gave 2 for ``num_workers: 0`` (vit_tpu: 1) and ignored $NUM_WORKERS.
"""

import copy
import os

import pytest
import torch

import vit_tpu.hardware as jhw
import vit_tpu_torch.hardware as hw

WORKERS = [None, 0, 3, 12]  # train.num_workers: unset, the old gap, inside, clipped to 8
ENVS = [None, "4"]  # $NUM_WORKERS: unset, set


def _config(workers):
    return {} if workers is None else {"train": {"num_workers": workers}}


def _set_env(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("NUM_WORKERS", raising=False)
    else:
        monkeypatch.setenv("NUM_WORKERS", env)


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("workers", WORKERS)
def test_prefetch_depth_is_vit_tpus(monkeypatch, workers, env):
    _set_env(monkeypatch, env)
    cfg = _config(workers)
    assert hw.get_prefetch_depth(cfg) == jhw.get_prefetch_depth(cfg)


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("workers", WORKERS)
def test_experiment_prefetch_depth_is_vit_tpus(tiny_config, monkeypatch, workers, env):
    from vit_tpu_torch.train.loop import Experiment

    _set_env(monkeypatch, env)
    cfg = copy.deepcopy(tiny_config)
    if workers is not None:
        cfg["train"]["num_workers"] = workers
    want = jhw.get_prefetch_depth(cfg)  # what vit_tpu's Experiment calls (loop.py:616-618)
    assert Experiment(cfg, device="cpu", seed=0).prefetch_depth == want
    if workers == 0 and env is None:
        assert want == 1
    if env is not None:
        assert want == 4


def test_strategy_rule():
    for n in (0, 1, 2, 8):
        assert hw.get_training_strategy(n) == jhw.get_training_strategy(n)


def test_detect_accelerators_without_a_card():
    info = hw.detect_accelerators()
    assert info == {"backend": "cpu", "device_count": 0, "device_kind": "none",
                    "memory_bytes": None, "process_count": 1, "local_device_count": 0}
    assert set(jhw.detect_accelerators()) <= set(info)


def test_select_devices_raises_for_cuda_unless_cpu_is_asked():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hw.select_accelerator_and_devices()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hw.select_accelerator_and_devices(2, device="cuda")
    assert hw.select_accelerator_and_devices(3, device="cpu") == ("cpu", [torch.device("cpu")])


def test_compilation_cache_reports_the_kernels_build_dir(monkeypatch):
    from vit_tpu_torch.ops import _build

    monkeypatch.delenv("VIT_TPU_NO_CACHE", raising=False)
    before = os.path.exists(_build.BUILD_ROOT) and sorted(os.listdir(_build.BUILD_ROOT))
    got = hw.enable_compilation_cache()
    assert got == _build.build_dir() == os.path.dirname(_build.KERNELS["flash_fwd"].lib_path)
    assert (os.path.exists(_build.BUILD_ROOT) and sorted(os.listdir(_build.BUILD_ROOT))) == before
    off = {"train": {"compilation_cache": False}}
    assert hw.enable_compilation_cache(off) is None
    assert jhw.enable_compilation_cache(off) is None
    monkeypatch.setenv("VIT_TPU_NO_CACHE", "1")
    assert hw.enable_compilation_cache() is None
    assert jhw.enable_compilation_cache() is None
