"""Ground rules of the port: no JAX at run time, explicit device, no hidden
fallback from a kernel to its plain version."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vit_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import vit_tpu_torch
names = ["vit_tpu_torch"] + [m.name for m in pkgutil.walk_packages(vit_tpu_torch.__path__, "vit_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "vit_tpu"))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_vit_tpu():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(count) >= 15 and bad == "[]", proc.stdout


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(tmp_path):
    assert not torch.cuda.is_available()
    from vit_tpu_torch.serve import Predictor, resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor.from_checkpoint({"model": {}}, ckpt=str(tmp_path / "m.pt"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "vit_tpu_torch", "predict", "-f", "x.yaml", "--ckpt", "m.pt",
         "--input", "x.npz"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    from vit_tpu_torch.train.loop import Experiment

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment({"model": {}})
    for cmd in ("run", "test"):
        proc = subprocess.run([sys.executable, "-m", "vit_tpu_torch", cmd, "-c", "x.yaml"],
                              cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and "CUDA is not available" in proc.stderr


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    kernel = _build.Kernel("flash_fwd", "x", _build.KERNELS["flash_fwd"].argtypes)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.fn()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.launch()
    assert kernel.launches == 0
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_every_kernel_has_a_source_and_names_its_pallas_kernel():
    assert sorted(_build.KERNELS) == ["flash_bwd", "flash_fwd", "fused_mlp_bwd",
                                      "fused_mlp_fwd", "hash_dropout", "short_bwd", "short_fwd"]
    assert _build.KERNELS["flash_bwd"].replaces == "vit_tpu/ops/flash_attention.py:459,496"
    # hash_dropout ports no Pallas kernel: it names the jnp function XLA fuses
    assert _build.KERNELS["hash_dropout"].replaces == "vit_tpu/ops/dropout.py:77"
    for k in _build.KERNELS.values():
        assert os.path.isfile(k.source)
        with open(k.source) as f:
            text = f.read()
        assert f'extern "C" int {k.name}(' in text
        path, lines = k.replaces.split(":")
        with open(os.path.join(ROOT, path)) as f:
            source = f.read().splitlines()
        for line in lines.split(","):
            assert ("def hash_dropout(" if k.name == "hash_dropout" else "def _") in source[
                int(line) - 1]


def test_cpu_tensors_run_the_plain_versions_and_leave_the_counts():
    from vit_tpu_torch.ops.flash_attention import flash_attention
    from vit_tpu_torch.ops.fused_mlp import fused_mlp

    _build.reset_launches()
    g = torch.Generator().manual_seed(0)
    for t in (600, 50):  # streaming and short kernels, forward and backward
        q = torch.randn(2, 2, t, 32, generator=g, requires_grad=True)
        flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=1).sum().backward()
    x = torch.randn(40, 32, generator=g, requires_grad=True)
    fused_mlp(x, torch.randn(64, 32, generator=g), torch.zeros(64),
              torch.randn(32, 64, generator=g), torch.zeros(32)).sum().backward()
    assert {k.launches for k in _build.KERNELS.values()} == {0}


def test_training_mode_and_unported_paths_raise(tmp_path, monkeypatch, capsys):
    """What is ported runs (training, diagnostics, W&B with its console
    fallback, log_mfu, profile, RoPE, the covariance preprocessors, the
    nn.Dropout streams, every optimizer, MoE, ring attention and the
    parallel modes' checks); what is not raises."""
    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.train import optim
    from vit_tpu_torch.train.loop import Experiment

    cfg = {"model": {"task_type": "reg", "image_size": 64, "patch_size": 8,
                     "hidden_size": 16, "num_hidden_layers": 1, "num_attention_heads": 2},
           "data": {"param": "log_g"}}
    model = get_model(cfg).module
    x = torch.from_numpy(np.zeros((1, 64), np.float32))
    seeds = list(range(model.num_dropout_sites))
    assert model.train()(x, dropout_seeds=seeds).shape == (1, 1)  # training is ported
    assert model.eval()(x).shape == (1, 1)
    slow = get_model(dict(cfg, model=dict(cfg["model"], fast_dropout=False))).module
    assert slow.train()(x, dropout_seeds=seeds).shape == (1, 1)  # nn.Dropout streams
    rope = get_model(dict(cfg, model=dict(cfg["model"], pos_encoding_type="rope"))).module
    assert rope.train()(x, dropout_seeds=seeds).shape == (1, 1)
    ring = get_model(dict(cfg, model=dict(cfg["model"], attn_impl="ring"))).module
    with pytest.raises(RuntimeError, match="needs the training mesh"):
        ring.train()(x, dropout_seeds=seeds)  # the ring is ported: it needs its mesh
    from vit_tpu_torch.parallel.mesh import active_mesh_scope, make_mesh

    with active_mesh_scope(make_mesh()):  # a one-rank ring is the whole attention
        assert ring.train()(x, dropout_seeds=seeds).shape == (1, 1)
    from vit_tpu_torch.models.vit import train_forward

    moe = get_model(dict(cfg, model=dict(cfg["model"], moe_experts=4, moe_top_k=2))).module
    logits, reg = train_forward(moe.train(), x, seeds)  # the MoE family builds and trains
    (logits.sum() + reg).backward()
    assert logits.shape == (1, 1) and moe.vit.encoder.layer[0].moe.router.weight.grad.any()
    s16 = get_model(dict(cfg, model=dict(cfg["model"], name="vit-s16", num_hidden_layers=1,
                                         task_type="cls", num_labels=3))).module
    images = torch.zeros((1, 64, 64, 3))  # the image family is ported
    assert s16.train()(images, dropout_seeds=list(range(s16.num_dropout_sites))).shape == (1, 3)
    from vit_tpu_torch.prepca.stats import compute_covariance_stats

    cov = str(tmp_path / "cov.npz")
    compute_covariance_stats(np.random.default_rng(0).standard_normal((80, 64)), save_path=cov,
                             device="cpu")
    pca = get_model(dict(cfg, model=dict(cfg["model"]), warmup={"preprocessor": "pca",
                                                                 "cov_path": cov, "r": 32}))
    assert pca.module.train()(x, dropout_seeds=seeds).shape == (1, 1)
    with pytest.raises(ValueError, match="patch dim"):  # a spectra basis is no patch basis
        get_model(dict(cfg, model=dict(cfg["model"], input_kind="image"),
                       warmup={"preprocessor": "pca", "cov_path": cov}))
    for name in ("rmsprop", "adadelta", "adagrad", "adamax", "lbfgs", "rprop", "asgd",
                 "sparseadam"):
        opt = optim.build_optimizer(optim.OptSpec(opt_type=name), model.parameters())
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
    # Parallelism is ported: one process is a one-rank mesh, so the modes
    # that split a model axis raise vit_tpu's make_mesh error, and gpus and
    # ZeRO-1 run on the one rank (tests/test_torch_port_parallel.py runs two).
    two_layers = dict(cfg["model"], num_hidden_layers=2)
    for train in ({"model_parallel": 2}, {"sequence_parallel": 2}, {"pipeline_parallel": 2}):
        with pytest.raises(ValueError, match="must divide device count 1"):
            Experiment(dict(cfg, model=two_layers, train=train), device="cpu")
    for train in ({"gpus": 4}, {"opt_state_sharding": True}):
        assert Experiment(dict(cfg, train=train), device="cpu").mesh.shape == {"data": 1,
                                                                               "model": 1}
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed
    ported = dict(cfg, data={"param": "log_g", "num_samples": 16},
                  train={"batch_size": 8, "ep": 1, "log_mfu": True, "peak_tflops": 989,
                              "profile": str(tmp_path / "prof")},
                  viz={"enable": True, "save_local": True, "save_dir": str(tmp_path / "viz"),
                       "embedding_method": "pca"})
    dm = SpecDataModule(ported, source=make_dummy_spectra(n=16, length=64, seed=0))
    metrics = Experiment(ported, device="cpu", use_wandb=True, datamodule=dm).fit()
    out = capsys.readouterr().out
    assert "wandb not installed" in out and "skipped" not in out
    assert {"tflops_per_s", "mfu", "cka/mean"} <= set(metrics)
    assert os.listdir(tmp_path / "prof") and os.listdir(tmp_path / "viz")


_PTXAS = """ptxas info    : Compiling entry function '_ZN3vtt11attn_fwd_tc12flash_kernelILi64EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN3vtt11attn_fwd_tc12flash_kernelILi64EEEvv
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 512 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvv' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers"""


def test_chip_smoke_reads_ptxas_registers_and_spills():
    import chip_smoke

    assert chip_smoke.ptxas_report(_PTXAS) == {
        "_ZN3vtt11attn_fwd_tc12flash_kernelILi64EEEvv": {"registers": 90, "spill_stores": 8},
        "_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvv": {"registers": 64, "spill_stores": 0},
    }


def _sass_counts():
    """Per-function tensor-core instruction counts as chip_smoke reads them
    from cuobjdump, for the seven tensor-core libraries built as intended."""
    def name(ns, kernel, args):
        return f"_ZN3vtt{len(ns)}{ns}{len(kernel)}{kernel}I{args}EEvv"

    def counts(ns, kernel, hgmma, flag=""):
        tc = {name(ns, kernel, f"Li{d}E{flag}"): {"HGMMA": n, "HMMA": 0}
              for d, n in hgmma.items()}
        fp32 = {f"_ZN12_GLOBAL__N_1fp32_{kernel}IfLi{d}EEEvv": {"HGMMA": 0, "HMMA": 0}
                for d in hgmma}
        return {**tc, **fp32}

    fwd = {16: 5, 32: 6, 64: 8, 128: 12}
    dq, dkv = {16: 6, 32: 8, 64: 12, 128: 20}, {16: 10, 32: 12, 64: 16, 128: 24}
    fused = {16: 14, 32: 16, 64: 20, 128: 28}  # S, dP (d/16 each), dV, dK, dQ (4 each)
    mlp = {**counts("fused_mlp_tc", "fwd_kernel", {16: 5, 32: 6, 64: 8, 128: 16}, "Li1E"),
           **counts("fused_mlp_tc", "fwd_kernel", {16: 5, 32: 6, 64: 8, 128: 16}, "Li2E")}
    mlp["_ZN12_GLOBAL__N_120fused_mlp_fwd_kernelI13__nv_bfloat16Li2EEEvv"] = {"HGMMA": 0,
                                                                             "HMMA": 0}
    # K7: its dx and weight passes per (box width, boxes a tile); the FMA
    # body's kernels beside them.
    widths = ((16, 1), (32, 1), (64, 1), (64, 2))
    mlp_bwd = {name("fused_mlp_bwd_tc", "dx_kernel", f"Li{bw}ELi{nb}E"):
               {"HGMMA": 4 + 2 * bw // 16, "HMMA": 0} for bw, nb in widths}
    mlp_bwd.update({name("fused_mlp_bwd_tc", "wgt_kernel", f"Li{bw}ELi{nb}E"):
                    {"HGMMA": 8 + 2 * bw // 16, "HMMA": 0} for bw, nb in widths})
    for fma in ("act_kernelIf", "act_kernelI13__nv_bfloat16", "dx_kernelIf",
                "tn_partial_kernelI13__nv_bfloat16"):
        mlp_bwd[f"_ZN12_GLOBAL__N_1{len(fma.split('I')[0])}{fma}EEvv"] = {"HGMMA": 0, "HMMA": 0}
    # K3's and K7's wide route (128 < D <= 1024): K3's act and out passes,
    # K7's act, out and weight-gradient passes.
    wide = "fused_mlp_wide_tc"
    mlp[name(wide, "act_kernel", "Lb0ELi256E")] = {"HGMMA": 4, "HMMA": 0}
    mlp[name(wide, "out_kernel", "Lb0ELi256E")] = {"HGMMA": 4, "HMMA": 0}
    mlp_bwd[name(wide, "act_kernel", "Lb1ELi64E")] = {"HGMMA": 8, "HMMA": 0}
    mlp_bwd[name(wide, "out_kernel", "Lb1ELi256E")] = {"HGMMA": 4, "HMMA": 0}
    mlp_bwd[_K7_WIDE_WGT] = {"HGMMA": 4, "HMMA": 0}
    return {"flash_fwd": counts("attn_fwd_tc", "flash_kernel", fwd),
            "short_fwd": counts("attn_fwd_tc", "short_kernel", fwd),
            "fused_mlp_fwd": mlp,
            "flash_bwd": counts("attn_bwd_fused_tc", "bwd_kernel", fused),
            "short_bwd": {**counts("attn_bwd_tc", "dq_kernel", dq),
                          **counts("attn_bwd_tc", "dkv_kernel", dkv)},
            "fused_mlp_bwd": mlp_bwd}


_K45_FUSED = "_ZN3vtt17attn_bwd_fused_tc10bwd_kernelILi{}EEEvv"  # .format(d)
_K6_DKV64 = "_ZN3vtt11attn_bwd_tc10dkv_kernelILi64EEEvv"
_K7_DX = "_ZN3vtt16fused_mlp_bwd_tc9dx_kernelILi64ELi2EEEvv"
_K3_WIDE_OUT = "_ZN3vtt17fused_mlp_wide_tc10out_kernelILb0ELi256EEEvv"
_K7_WIDE_WGT = "_ZN3vtt17fused_mlp_wide_tc10wgt_kernelILi256EEEvv"


@pytest.mark.parametrize("fault", [None, "fp32 holds HGMMA", "bf16 holds none",
                                   "K4 count drifts", "K5 count drifts",
                                   "instantiation missing", "K3 bf16 holds none",
                                   "K3 FMA body holds HMMA", "K6 dq count drifts",
                                   "K6 dkv count drifts", "K6 pass missing",
                                   "K6 fp32 holds HGMMA", "K7 bf16 holds none",
                                   "K7 FMA body holds HGMMA", "K7 pass missing",
                                   "K3 wide pass missing", "K7 wide pass holds none"])
def test_chip_smoke_sass_check_catches_each_fault(fault):
    """chip_smoke's build phase fails unless every bf16 tensor-core
    instantiation of K1-K7 holds HGMMA (the dQ and dK/dV passes of K4, K5 and
    K6 their exact counts; every pass of K3's and K7's wide route there) and
    no other instantiation holds any tensor-core instruction."""
    import chip_smoke

    mma = _sass_counts()
    if fault == "fp32 holds HGMMA":
        mma["short_fwd"]["_ZN12_GLOBAL__N_1fp32_short_kernelIfLi32EEEvv"]["HMMA"] = 2
    elif fault == "bf16 holds none":
        mma["flash_fwd"]["_ZN3vtt11attn_fwd_tc12flash_kernelILi128EEEvv"]["HGMMA"] = 0
    elif fault == "K4 count drifts":  # K4 and K5 are one kernel, flash_bwd
        mma["flash_bwd"][_K45_FUSED.format(64)]["HGMMA"] = 16
    elif fault == "K5 count drifts":
        mma["flash_bwd"][_K45_FUSED.format(16)]["HGMMA"] = 10
    elif fault == "instantiation missing":
        del mma["short_fwd"]["_ZN3vtt11attn_fwd_tc12short_kernelILi16EEEvv"]
    elif fault == "K3 bf16 holds none":
        mma["fused_mlp_fwd"]["_ZN3vtt12fused_mlp_tc10fwd_kernelILi128ELi2EEEvv"]["HGMMA"] = 0
    elif fault == "K3 FMA body holds HMMA":
        mma["fused_mlp_fwd"]["_ZN12_GLOBAL__N_120fused_mlp_fwd_kernelI13__nv_bfloat16Li2EEEvv"][
            "HMMA"] = 4
    elif fault == "K6 dq count drifts":
        mma["short_bwd"]["_ZN3vtt11attn_bwd_tc9dq_kernelILi32EEEvv"]["HGMMA"] = 12
    elif fault == "K6 dkv count drifts":
        mma["short_bwd"][_K6_DKV64]["HGMMA"] = 12
    elif fault == "K6 pass missing":
        del mma["short_bwd"][_K6_DKV64]
    elif fault == "K6 fp32 holds HGMMA":
        mma["short_bwd"]["_ZN12_GLOBAL__N_1fp32_dkv_kernelIfLi128EEEvv"]["HGMMA"] = 24
    elif fault == "K7 bf16 holds none":
        mma["fused_mlp_bwd"][_K7_DX]["HGMMA"] = 0
    elif fault == "K7 FMA body holds HGMMA":
        mma["fused_mlp_bwd"]["_ZN12_GLOBAL__N_110act_kernelI13__nv_bfloat16EEvv"]["HGMMA"] = 3
    elif fault == "K7 pass missing":
        del mma["fused_mlp_bwd"]["_ZN3vtt16fused_mlp_bwd_tc10wgt_kernelILi32ELi1EEEvv"]
    elif fault == "K3 wide pass missing":
        del mma["fused_mlp_fwd"][_K3_WIDE_OUT]
    elif fault == "K7 wide pass holds none":
        mma["fused_mlp_bwd"][_K7_WIDE_WGT]["HGMMA"] = 0
    if fault is None:
        chip_smoke.check_tensor_cores(mma)
    else:
        with pytest.raises(SystemExit, match="FAILED"):
            chip_smoke.check_tensor_cores(mma)
