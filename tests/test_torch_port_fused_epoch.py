"""The port's fused epoch (``train.fused_epoch``) against its per-step path
and against vit_tpu's fused epoch, and the device-scalar dropout seeds the
CUDA graph of the step needs.

On the CPU the fused epoch runs the same step body eagerly, with the
epoch's data, permutation, dropout seeds, noise and learning rates taken
from device buffers: it must give the per-step path's parameters, losses
and validation metrics bit for bit. The CUDA graph itself is held on the
card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` runs (p)-(q)).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops.flash_attention import hash_dropout_mask as jax_attention_mask
from vit_tpu.ops.dropout import hash_keep_mask as jax_hash_keep_mask
from vit_tpu.train.loop import Experiment as JaxExperiment
from vit_tpu_torch.models.builder import get_model
from vit_tpu_torch.ops import dropout as pdrop
from vit_tpu_torch.ops import flash_attention as pflash
from vit_tpu_torch.train import fused as pfused
from vit_tpu_torch.train.loop import Experiment
from vit_tpu_torch.train.torch_bridge import from_flax_params


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def resumable(tiny_config):
    """tests/test_torch_port_train.py's fixture: flash, the fused MLP,
    remat: mlp, dropout on, noise injection on, a plateau of patience 0."""
    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(attn_impl="flash", fused_mlp=True, remat="mlp")
    cfg["opt"].update(lr_sch="plateau", factor=0.5, patience=0)
    cfg["noise"]["noise_level"] = 0.5
    return cfg


def _fit(cfg, monkeypatch, tmp_path, fused, ckpt_path=None, **train):
    """(Experiment after fit, the metrics of every epoch it logged)."""
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
    cfg = copy.deepcopy(cfg)
    cfg["train"].update(fused_epoch=fused, **train)
    exp = Experiment(cfg, device="cpu", seed=0, ckpt_path=ckpt_path)
    epochs = []
    monkeypatch.setattr(exp.logger, "log_epoch",
                        lambda epoch, metrics, step=None: epochs.append((epoch, dict(metrics))))
    exp.fit()
    return exp, epochs


_TIMES = ("epoch_time_s", "samples_per_s")


def _assert_same_run(a, b):
    """Bit for bit: parameters, step, plateau scale, generators and every
    logged metric but the clock's."""
    (ea, la), (eb, lb) = a, b
    assert ea.step == eb.step and ea.plateau_scale == eb.plateau_scale
    for (k, x), (_, y) in zip(ea.module.state_dict().items(), eb.module.state_dict().items()):
        assert torch.equal(x, y), k
    assert torch.equal(ea.dropout_gen.get_state(), eb.dropout_gen.get_state())
    assert torch.equal(ea.noise_gen.get_state(), eb.noise_gen.get_state())
    assert [e for e, _ in la] == [e for e, _ in lb]
    for (_, ma), (_, mb) in zip(la, lb):
        assert {k: v for k, v in ma.items() if k not in _TIMES} == \
            {k: v for k, v in mb.items() if k not in _TIMES}


@pytest.mark.parametrize("gather, accum", [("step", 1), ("block", 1), ("step", 2)])
def test_fused_epoch_equals_per_step_bit_for_bit(resumable, monkeypatch, tmp_path, gather,
                                                 accum):
    """Two epochs of the dropout + noise + plateau fixture: both gather
    modes, and accumulate_steps 2."""
    per_step = _fit(resumable, monkeypatch, tmp_path / "a", False, ep=2, accumulate_steps=accum)
    fused = _fit(resumable, monkeypatch, tmp_path / "b", True, ep=2, epoch_gather=gather,
                 accumulate_steps=accum)
    assert per_step[0].fused is None and fused[0].fused is not None
    assert fused[0].fused.eager_steps == 12  # the CPU runs the step body eagerly
    _assert_same_run(per_step, fused)


def test_stream_dropout_fused_equals_per_step(resumable, monkeypatch, tmp_path):
    """model.fast_dropout: false (nn.Dropout generators seeded from the
    sites' seeds) on the CPU, where the fused epoch runs eagerly."""
    cfg = copy.deepcopy(resumable)
    cfg["model"].update(fast_dropout=False, attn_impl="xla", fused_mlp=False)
    _assert_same_run(_fit(cfg, monkeypatch, tmp_path / "a", False, ep=2),
                     _fit(cfg, monkeypatch, tmp_path / "b", True, ep=2))


@pytest.mark.parametrize("remat", [False, True])
def test_stream_masks_per_step_device_seed_and_replica_agree(tiny_config, remat):
    """fast_dropout: false draws its nn.Dropout masks from the sites' seeds
    on the device: the per-step path's int seeds, the fused epoch's (sites,)
    device tensor and replica r of a vmapped step (its row of the (R,
    sites) seeds, as the sweep hands them) give the same forward: bit for
    bit for the first two, and for the vmapped replica to rel 1e-6 (its
    products are batched ones, summed in another order), against a change
    of seed that moves it by far more; the masks themselves bit for bit
    under vmap, at the layer function."""
    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(fast_dropout=False, attn_impl="xla", remat=remat,
                        hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    m = get_model(cfg, generator=torch.Generator().manual_seed(2)).module.train()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 512)).astype(np.float32))
    R, sites = 3, m.num_dropout_sites
    seeds = np.random.default_rng(1).integers(-2**31, 2**31, (R, sites)).astype(np.int32)
    per_step = [m(x, dropout_seeds=[int(s) for s in row]) for row in seeds]
    device = [m(x, dropout_seeds=torch.from_numpy(row)) for row in seeds]
    params = {n: p.detach()[None].expand((R,) + p.shape) for n, p in m.named_parameters()}
    replicas = torch.func.vmap(lambda p, s: torch.func.functional_call(
        m, p, (x,), {"dropout_seeds": s}))(params, torch.from_numpy(seeds))
    for r in range(R):
        assert torch.equal(per_step[r], device[r])
        torch.testing.assert_close(replicas[r], per_step[r], rtol=1e-6, atol=1e-7)
    other = m(x, dropout_seeds=[int(s) + 1 for s in seeds[0]])
    assert (other - per_step[0]).abs().max() > 100 * 1e-6 * per_step[0].abs().max()
    y = torch.randn(R, 8, 40, generator=torch.Generator().manual_seed(3))
    stacked = torch.func.vmap(lambda s, yr: pdrop.stream_dropout(yr, 0.1, s))(
        torch.from_numpy(seeds[:, 0]), y)
    for r in range(R):
        assert torch.equal(stacked[r], pdrop.stream_dropout(y[r], 0.1, int(seeds[r, 0])))


def test_zca_freeze_schedule_fused_equals_per_step(tiny_config, monkeypatch, tmp_path):
    """A ZCA preprocessor frozen for epoch 0 (freeze_epochs: 1): the frozen
    and released steps of the fused epoch equal the per-step path's."""
    from vit_tpu.data.hdf5 import load_spectra
    from vit_tpu_torch.prepca.stats import compute_covariance_stats

    flux = load_spectra(tiny_config["data"]["file_path"], 96)["flux"]
    path = str(tmp_path / "cov.npz")
    compute_covariance_stats(flux, save_path=path, device="cpu")
    cfg = copy.deepcopy(tiny_config)
    cfg["warmup"] = {"cov_path": path, "preprocessor": "zca", "shrinkage": 0.1,
                     "freeze_epochs": 1}
    a = _fit(cfg, monkeypatch, tmp_path / "a", False, ep=2)
    b = _fit(cfg, monkeypatch, tmp_path / "b", True, ep=2)
    _assert_same_run(a, b)
    assert [m["preprocessor_frozen"] for _, m in b[1]] == [1.0, 0.0]


def test_resume_from_last_across_the_two_paths(resumable, monkeypatch, tmp_path):
    """`last` written by the per-step path resumes on the fused one and the
    other way round; each equals the uninterrupted run."""
    whole = _fit(resumable, monkeypatch, tmp_path / "w", True, ep=2, save=True)
    for first, then in ((False, True), (True, False)):
        d = tmp_path / f"r{int(first)}"
        _fit(resumable, monkeypatch, d, first, ep=1, save=True)
        resumed = _fit(resumable, monkeypatch, d, then, ep=2, save=True, ckpt_path="last")
        assert resumed[0].step == whole[0].step == 12
        for (k, x), (_, y) in zip(whole[0].module.state_dict().items(),
                                  resumed[0].module.state_dict().items()):
            assert torch.equal(x, y), k
        assert resumed[1][-1][1]["val_mae"] == whole[1][-1][1]["val_mae"]


def test_epochs_per_dispatch_blocks_and_tail(tiny_config, monkeypatch, tmp_path, capsys):
    """epochs_per_dispatch 2 over 3 epochs: one block of two, then the tail
    epoch alone; the trajectory equals one epoch a dispatch (no plateau, as
    in vit_tpu's test: the scale would apply at block boundaries)."""
    cfg = copy.deepcopy(tiny_config)
    one = _fit(cfg, monkeypatch, tmp_path / "a", True, ep=3)
    two = _fit(cfg, monkeypatch, tmp_path / "b", True, ep=3, epochs_per_dispatch=2, save=True)
    _assert_same_run(one, two)
    assert "epochs_per_dispatch" not in capsys.readouterr().out
    assert two[0].ckpt.read_meta()["last_epoch"] == 2


def test_early_stop_flushes_to_the_block_boundary(tiny_config, monkeypatch, tmp_path, capsys):
    """A stop inside a block logs the block's remaining epochs and stops at
    its end, on the state the device holds; one epoch a dispatch stops at
    once."""
    cfg = copy.deepcopy(tiny_config)
    cfg["train"]["divergence_threshold"] = 0.0  # every val_mae "diverges"
    exp, epochs = _fit(cfg, monkeypatch, tmp_path / "b", True, ep=5, epochs_per_dispatch=2,
                       save=True)
    out = capsys.readouterr().out
    assert "[experiment] early stopping triggered at epoch 0; flushing to the block boundary" \
        in out and "[experiment] early stopping at epoch 1" in out
    assert [e for e, _ in epochs] == [0, 1] and exp.step == 12
    assert exp.ckpt.read_meta()["last_epoch"] == 1
    exp, epochs = _fit(cfg, monkeypatch, tmp_path / "a", True, ep=5)
    assert [e for e, _ in epochs] == [0] and exp.step == 6


def test_selection_rule_and_notes_are_vit_tpus(tiny_config, monkeypatch, tmp_path, capsys):
    """The spellings, the auto gate, debug, and vit_tpu's notes, word for
    word from a vit_tpu run of the same config."""
    assert [pfused.fused_epoch_setting(v) for v in
            (True, False, "auto", " Auto ", "yes", "TRUE", "on", "1", "0", "no", 1, 0, None)] \
        == [True, False, "auto", "auto", True, True, True, True, False, False, True, False,
            False]
    for value, fused in (("yes", True), ("off", False), ("auto", True)):
        exp, _ = _fit(tiny_config, monkeypatch, tmp_path / value, value, ep=1)
        assert (exp.fused is not None) is fused, value
    cfg = copy.deepcopy(tiny_config)
    cfg["train"].update(debug=1, fused_epoch=True, epochs_per_dispatch=2)
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "j"))
    JaxExperiment(copy.deepcopy(cfg), seed=0).fit()
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[experiment] train.")]
    Experiment(copy.deepcopy(cfg), seed=0, device="cpu").fit()
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("[experiment] train.")]
    assert got == want and len(want) == 2, (got, want)

    viz = copy.deepcopy(tiny_config)
    viz["viz"] = {"enable": True, "save_local": False, "log_every_n_steps": 6,
                  "compute_cka": False, "num_viz_samples": 8}
    _fit(viz, monkeypatch, tmp_path / "v", True, ep=1, epochs_per_dispatch=2)
    out = capsys.readouterr().out
    assert "[viz] fused-epoch mode: log_every_n_steps -> every 1 epoch(s)" in out
    assert "[experiment] train.epochs_per_dispatch=2 ignored: viz.enable requires " \
           "per-epoch states; running one dispatch per epoch" in out
    with pytest.raises(ValueError, match="epoch_gather"):
        _fit(tiny_config, monkeypatch, tmp_path / "x", True, ep=1, epoch_gather="bogus")
    import vit_tpu_torch.train.loop as ploop

    monkeypatch.setattr(ploop, "FUSED_DATA_BYTES", 1)
    capsys.readouterr()
    assert _fit(tiny_config, monkeypatch, tmp_path / "g", "auto", ep=1)[0].fused is None
    assert "fused_epoch" not in capsys.readouterr().out  # auto falls back without a note
    _fit(tiny_config, monkeypatch, tmp_path / "t", True, ep=1)
    assert "[experiment] train.fused_epoch=true ignored: epoch data 0.0 GB exceeds the " \
           "4 GB HBM gate" in capsys.readouterr().out


def test_fused_epochs_match_vit_tpu_experiment(tiny_config, monkeypatch):
    """test_torch_port_train.py's two-epoch comparison with fused_epoch true
    on both sides: dropout off, the same initial weights."""
    from vit_tpu.train import optim as jopt

    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg["train"]["fused_epoch"] = True
    jexp = JaxExperiment(copy.deepcopy(cfg))
    jexp.state = jexp._init_state(jopt.build_optimizer(jopt.OptSpec.from_config(cfg, 1)))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jexp.state.params))
    jlog = []
    monkeypatch.setattr(jexp.logger, "log_epoch",
                        lambda epoch, metrics, step=None: jlog.append(dict(metrics)))
    jexp.fit()
    exp = Experiment(copy.deepcopy(cfg), device="cpu")
    exp.module.load_state_dict(from_flax_params(params, exp.bundle.vit_config), strict=True)
    plog = []
    monkeypatch.setattr(exp.logger, "log_epoch",
                        lambda epoch, metrics, step=None: plog.append(dict(metrics)))
    exp.fit()
    assert exp.fused is not None and len(plog) == len(jlog) == 2
    for jm, pm in zip(jlog, plog):
        assert set(pm) == set(jm)
        for key in ("train_loss", "val_loss", "val_mae", "val_mse", "val_r2", "val_p90"):
            assert pm[key] == pytest.approx(jm[key], rel=1e-4, abs=1e-6), key


# -- device-scalar seeds -----------------------------------------------------
SEEDS = (0, -1, 2**31 - 1, -123456789)


@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_seeds_give_the_int_seeds_masks(seed):
    """A 0-d int32 tensor seed through hash_dropout, the attention mask and
    each attention wrapper's plain version gives exactly the int seed's
    result, which is vit_tpu's mask."""
    ts = torch.tensor(seed, dtype=torch.int32)
    shape = (3, 5, 7)
    want = np.asarray(jax_hash_keep_mask(shape, 0.3, jnp.int32(seed)))
    assert np.array_equal(pdrop.hash_keep_mask(shape, 0.3, ts).numpy(), want)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    assert torch.equal(pdrop.hash_dropout(x, 0.3, ts), pdrop.hash_dropout(x, 0.3, seed))
    want = np.asarray(jax_attention_mask(70, 70, jnp.arange(3), jnp.int32(seed), 0.2))
    assert np.array_equal(pdrop.hash_dropout_mask(70, 70, torch.arange(3), ts, 0.2).numpy(),
                          want)
    g = torch.Generator().manual_seed(2)
    for t, fwd, bwd in ((70, pflash.short_fwd, pflash.short_bwd),
                        (600, pflash.flash_fwd, pflash.flash_bwd)):
        q, k, v, do = (torch.randn(3, t, 16, generator=g) for _ in range(4))
        outs = {}
        for s in (seed, ts):
            o, lse = fwd(q, k, v, 0.25, 0.2, s)
            delta = (do * o).sum(-1)
            outs[type(s)] = (o, lse, *bwd(q, k, v, do, lse, delta, 0.25, 0.2, s))
        assert all(torch.equal(a, b) for a, b in zip(*outs.values()))


def test_model_takes_a_seed_tensor(tiny_config):
    """SpecViT's dropout_seeds as a (sites,) int32 tensor: the int list's
    output and gradients, through flash, the fused MLP and remat."""
    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(attn_impl="flash", fused_mlp=True, remat="mlp")
    model = get_model(cfg).module.train()
    seeds = list(range(7, 7 + model.num_dropout_sites))
    x = torch.randn(4, 512, generator=torch.Generator().manual_seed(0))
    outs = []
    for s in (seeds, torch.tensor(seeds, dtype=torch.int32)):
        model.zero_grad()
        y = model(x, dropout_seeds=s)
        y.sum().backward()
        outs.append([y.detach()] + [p.grad.clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
