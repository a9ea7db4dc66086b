"""The port's GPipe pipeline (``vit_tpu_torch.parallel.pipeline``) against
vit_tpu's, mirroring ``tests/test_pipeline.py`` and ``tests/test_pp_resident.py``.

vit_tpu runs on the virtual CPU mesh of ``conftest.py``; the port on gloo
ranks (``torch_ranks.Ranks``, four started once for the module): two
stages, or two stages of two tensor-parallel ranks each. Weights are vit_tpu's init carried across by ``from_flax_params``;
inputs are seeded numpy. Deterministic forwards at M = 1, 2, 4
microbatches are held against vit_tpu's pipelined forward and the port's
monolithic one (1e-5); a pipelined training step's gradients against the
one-rank port's with dropout on (the pipeline draws the global masks;
1e-4 per tensor, relative to the larger of its norm and 1e-3 of the
global norm) and against vit_tpu's pipelined gradients with dropout off.

The replicated layout (``train.pipeline_stage_params: false``): its first
step against vit_tpu's Experiment under the same layout (with ZeRO-1 on
data 2 x pipe 2), its parameters bit for bit the stage-resident run's
and ZeRO-1's the same run's without it, and checkpoints that resume
across the layouts and into one rank.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from torch_ranks import Ranks, first_step, fit, pipeline_forward, restored_state
from vit_tpu.models.builder import get_model as jax_get_model
from vit_tpu.models.vit import compute_loss as jax_loss
from vit_tpu.parallel.pipeline import apply_pipelined as jax_apply_pipelined
from vit_tpu.parallel.pipeline import resident_param_shardings as jax_resident_shardings
from vit_tpu.parallel.pipeline import stage_resident_params as jax_stage_resident
from vit_tpu.train import optim as jopt
from vit_tpu.train.loop import Experiment as JaxExperiment
from vit_tpu.train.loop import _make_grads_fn
from vit_tpu_torch.models.builder import get_model
from vit_tpu_torch.parallel import pipeline as pp
from vit_tpu_torch.parallel.mesh import make_mesh
from vit_tpu_torch.serve import Predictor
from vit_tpu_torch.train.loop import Experiment, draw_seeds
from vit_tpu_torch.train.torch_bridge import from_flax_params

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(4)  # two stages; four for pipeline x tensor parallelism
    yield r
    r.close()


def _config(layers=4, hidden=32, heads=2, dropout=0.0, **model_extra):
    return {
        "project": "pp-test",
        "model": {"name": "vit", "task_type": "reg", "image_size": 256, "patch_size": 32,
                  "hidden_size": hidden, "num_hidden_layers": layers,
                  "num_attention_heads": heads, "stride_size": 32, "proj_fn": "SW",
                  "hidden_dropout_prob": dropout, "attention_probs_dropout_prob": dropout,
                  **model_extra},
        "train": {"batch_size": 8, "ep": 1},
        "loss": {"name": "mae"},
        "opt": {"type": "AdamW", "lr": 1e-3, "lr_sch": "none"},
        "data": {"param": "log_g", "label_norm": "minmax"},
        "noise": {"noise_level": 0},
        "viz": {"enable": False},
    }


def _init(config, batch=8, seed=0):
    bundle = jax_get_model(copy.deepcopy(config))
    x = np.random.default_rng(seed).standard_normal(
        (batch, config["model"]["image_size"])).astype(np.float32)
    params = bundle.module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    sd = {k: v.numpy() for k, v in from_flax_params(params, bundle.vit_config).items()}
    return bundle, params, x, sd


def _jax_mesh():
    return JaxMesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "pipe"))


def _port(config, sd):
    module = get_model(copy.deepcopy(config)).module
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return module.eval()


def _encoder(sd):
    return {k[len("vit.encoder."):]: torch.from_numpy(v) for k, v in sd.items()
            if k.startswith("vit.encoder.")}


def test_stack_unstack_roundtrip():
    _, _, _, sd = _init(_config(layers=4))
    enc = _encoder(sd)
    stacked = pp.stack_stage_params(enc, 2)
    assert all(t.shape[:2] == (2, 2) for t in stacked.values())
    name = "attention.attention.query.weight"
    for i in range(4):  # layer i at stage i // 2, slot i % 2, as vit_tpu stacks
        assert torch.equal(stacked[name][i // 2, i % 2], enc[f"layer.{i}.{name}"])
    back = pp.unstack_stage_params(stacked)
    assert back.keys() == enc.keys() and all(torch.equal(back[k], enc[k]) for k in enc)
    full = {k: torch.from_numpy(v) for k, v in sd.items()}
    again = pp.canonical_params(pp.stage_resident_params(full, 2))
    assert again.keys() == full.keys() and all(torch.equal(again[k], full[k]) for k in full)
    with pytest.raises(ValueError, match="divisible by the"):
        pp.stack_stage_params(enc, 3)


def test_resident_shardings_follow_vit_tpus_rule():
    """Per stacked leaf: the stage dim over pipe, and under tp = 2 the same
    leaves split over model as vit_tpu's resident layout splits."""
    config = _config(layers=4)
    _, params, _, sd = _init(config)
    jmesh = JaxMesh(np.array(jax.devices()[:4]).reshape(1, 2, 2), ("data", "model", "pipe"))
    jspecs = jax_resident_shardings(jax_stage_resident(params, 2), jmesh, tp_axis="model")
    jsplit = sorted(np.prod([s for s, a in zip(leaf.shape, sh.spec) if a == "model"] or [0])
                    for leaf, sh in zip(jax.tree_util.tree_leaves(jax_stage_resident(params, 2)),
                                        jax.tree_util.tree_leaves(jspecs)))
    mesh = make_mesh(devices=range(4), model_parallel=2, pipeline_parallel=2)
    resident = pp.stage_resident_params({k: torch.from_numpy(v) for k, v in sd.items()}, 2)
    specs = pp.resident_param_shardings(resident, mesh, tp_axis="model")
    for name, sh in specs.items():
        assert (sh.spec[:1] == ("pipe",)) == name.startswith("vit.encoder.")
    split = sorted(np.prod([s for s, a in zip(resident[n].shape, sh.spec) if a == "model"]
                           or [0]) for n, sh in specs.items())
    assert split == jsplit  # the same split axes, by their sizes
    moments = {"mu": {n: t * 0 for n, t in resident.items()}, "count": torch.zeros(())}
    canon = pp.convert_params_shaped(moments, list(resident), pp.canonical_params)
    assert canon["mu"].keys() == set(sd) and canon["count"] is moments["count"]


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_pipelined_forward_matches_vit_tpu_and_monolithic(ranks, microbatches):
    config = _config(layers=4)
    bundle, params, x, sd = _init(config)
    want = np.asarray(jax_apply_pipelined(bundle.module, params, jnp.asarray(x),
                                          mesh=_jax_mesh(), num_microbatches=microbatches))
    with torch.no_grad():
        mono = _port(config, sd)(torch.from_numpy(x)).numpy()
    got = ranks.run(pipeline_forward, config, sd, x, microbatches, False)[:2]
    assert [g[2] for g in got] == [["0", "1"], ["2", "3"]]  # each stage holds its layers
    for logits, _, _ in got:
        np.testing.assert_allclose(logits, want, atol=FWD_TOL)
        np.testing.assert_allclose(logits, mono, atol=FWD_TOL)


def test_moe_pipelined_forward_and_stats(ranks):
    """MoE: the pipelined stats are the monolithic (L, 3), the microbatch
    mean of per-row means; the logits are vit_tpu's pipelined ones."""
    config = _config(layers=2, moe_experts=4, moe_top_k=2, moe_aux_weight=0.01)
    bundle, params, x, sd = _init(config)
    want, _ = jax_apply_pipelined(bundle.module, params, jnp.asarray(x), mesh=_jax_mesh(),
                                  num_microbatches=2)
    with torch.no_grad():
        mono, stats = _port(config, sd)(torch.from_numpy(x), moe_stats=True)
    for logits, got_stats, _ in ranks.run(pipeline_forward, config, sd, x, 2, True)[:2]:
        np.testing.assert_allclose(logits, np.asarray(want), atol=FWD_TOL)
        np.testing.assert_allclose(logits, mono.numpy(), atol=FWD_TOL)
        np.testing.assert_allclose(got_stats, stats.numpy(), atol=1e-6)


def _rel_errors(got: dict, want: dict) -> dict:
    glob = np.sqrt(sum(float((w.astype(np.float64) ** 2).sum()) for w in want.values()))
    assert got.keys() == want.keys()
    return {k: float(np.linalg.norm(got[k] - want[k])
                     / max(np.linalg.norm(want[k]), 1e-3 * glob)) for k in want}


def _batch(config, x, seed=1):
    y = np.random.default_rng(seed).random((x.shape[0], 1)).astype(np.float32)
    return {"x": x, "label": y}


@pytest.mark.parametrize("moe,tp", [(False, 1), (True, 1), (False, 2), (True, 2)])
def test_pipelined_step_matches_the_one_rank_step(ranks, moe, tp):
    """Dropout 0.1 on: the two stages' step (with ``tp`` 2, each stage's
    layers split over two more ranks; an MoE model's experts) equals the
    one-rank step over the same batch and seeds (the same masks), loss and
    every gradient."""
    extra = dict(moe_experts=4, moe_top_k=2, moe_aux_weight=0.01) if moe else {}
    config = _config(layers=4, dropout=0.1, **extra)
    _, _, x, sd = _init(config)
    batch = _batch(config, x)
    sites = get_model(copy.deepcopy(config)).module.num_dropout_sites
    seeds = draw_seeds(torch.Generator().manual_seed(0), 1, sites)
    loss1, want, _ = first_step(config, None, sd, batch, seeds)
    cfg2 = copy.deepcopy(config)
    cfg2["train"].update(pipeline_parallel=2, pipeline_microbatches=4, model_parallel=tp)
    loss2, got, split = ranks.run(first_step, cfg2, 2 * tp, sd, batch, seeds)[0]
    assert bool(split) == (tp > 1)
    assert abs(loss2 - loss1) < 1e-6
    errs = _rel_errors(got, want)
    assert max(errs.values()) < GRAD_TOL, max(errs.items(), key=lambda kv: kv[1])


def test_pipelined_grads_match_vit_tpus(ranks):
    """Dropout off: the port's two-stage gradients against jax.grad of
    vit_tpu's pipelined loss on its mesh."""
    config = _config(layers=4)
    bundle, params, x, sd = _init(config)
    batch = _batch(config, x)

    def loss_pp(p):
        logits = jax_apply_pipelined(bundle.module, p, jnp.asarray(x), mesh=_jax_mesh(),
                                     num_microbatches=2)
        return jax_loss(logits, jnp.asarray(batch["label"]), "reg", "mae")

    grads = jax.jit(jax.grad(loss_pp))(params)
    want = {k: v.numpy() for k, v in from_flax_params(grads, bundle.vit_config).items()}
    cfg2 = copy.deepcopy(config)
    cfg2["train"].update(pipeline_parallel=2, pipeline_microbatches=2)
    _, got, _ = ranks.run(first_step, cfg2, 2, sd, batch, [[]])[0]
    errs = _rel_errors(got, want)
    assert max(errs.values()) < GRAD_TOL, max(errs.items(), key=lambda kv: kv[1])


# -- the replicated layout (train.pipeline_stage_params: false) ---------------------
_REPLICATED = dict(pipeline_parallel=2, pipeline_microbatches=2, pipeline_stage_params=False)


def _vit_tpu_first_step(config, batch):
    """vit_tpu's Experiment's first-step loss and gradients under its mesh
    and layout (its init, its pipelined training forward), with its weights,
    both in the port's names."""
    jexp = JaxExperiment(copy.deepcopy(config), seed=0)
    jexp.state = jexp._init_state(jopt.build_optimizer(jopt.OptSpec.from_config(jexp.config, 1)))
    grads_fn = _make_grads_fn(jexp.bundle, 0.0, apply_fn=jexp._train_apply_fn())
    key = jax.random.PRNGKey(0)
    with jexp.mesh:
        b = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, jexp.batch_shard)
        loss, grads = jax.jit(grads_fn)(jexp.state.params, b, key, key)
    vc = jexp.bundle.vit_config
    as_np = lambda tree: {k: v.numpy() for k, v in  # noqa: E731
                          from_flax_params(jax.device_get(tree), vc).items()}
    return float(loss), as_np(jexp.state.params), as_np(grads), jexp


@pytest.mark.parametrize("gpus, zero1", [(2, False), (4, True)], ids=["data1_pipe2",
                                                                       "data2_pipe2_zero1"])
def test_replicated_first_step_matches_vit_tpus(ranks, gpus, zero1):
    """Dropout off: the replicated layout's first step (loss, and every
    gradient once the stages have shared theirs) against vit_tpu's under
    pipeline_stage_params: false on its CPU mesh, with ZeRO-1 on data 2."""
    config = _config(layers=4)
    config["train"].update(gpus=gpus, opt_state_sharding=zero1, **_REPLICATED)
    x = np.random.default_rng(0).standard_normal((8, 256)).astype(np.float32)
    batch = _batch(config, x)
    loss_j, sd, want, jexp = _vit_tpu_first_step(config, batch)
    assert not jexp.pp_resident and jexp.zero1 == zero1
    assert dict(jexp.mesh.shape) == {"data": gpus // 2, "model": 1, "pipe": 2}
    res = ranks.run(first_step, config, gpus, sd, batch, [[]])
    loss, got, _ = res[0]
    assert abs(loss - loss_j) < 1e-5
    errs = _rel_errors(got, want)
    assert max(errs.values()) < GRAD_TOL, max(errs.items(), key=lambda kv: kv[1])


def _fit_config(**train):
    config = _config(layers=4, dropout=0.1)
    config["train"].update(ep=2, **train)
    return config


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_replicated_matches_resident_bit_for_bit(ranks, tmp_path):
    """Two steps with dropout on: the replicated layout's parameters are the
    stage-resident run's bit for bit (the same schedule, each layer stepped
    from the same gradient under the same global norm), on both stages."""
    out = {}
    for stage_params in (True, False):
        cfg = _fit_config(pipeline_parallel=2, pipeline_microbatches=2,
                          pipeline_stage_params=stage_params)
        out[stage_params] = ranks.run(fit, cfg, 2, 16, 256, 0, str(tmp_path / str(stage_params)))
    (m_res, sd_res, bytes_res), (m_rep, sd_rep, bytes_rep) = out[True][0], out[False][0]
    _same(sd_rep, sd_res)
    _same(out[False][1][1], sd_rep)
    assert m_rep["train_loss"] == m_res["train_loss"]
    assert bytes_rep > 1.5 * bytes_res  # every layer's moments against one stage's


def test_replicated_zero1_is_bit_equal_without_it(ranks, tmp_path):
    """Data 2 x pipe 2: ZeRO-1 over each stage's data group leaves the
    parameters bit for bit those of the same mesh without it, on every
    rank, at about half the optimizer bytes a rank."""
    out = {}
    for zero1 in (False, True):
        cfg = _fit_config(opt_state_sharding=zero1, **_REPLICATED)
        out[zero1] = ranks.run(fit, cfg, 4, 16, 256, 0, str(tmp_path / str(zero1)))
    for (m0, sd0, bytes0), (m1, sd1, bytes1) in zip(out[False], out[True]):
        _same(sd1, sd0)
        _same(sd0, out[False][0][1])
        assert m1["train_loss"] == m0["train_loss"]
        assert bytes1 < 0.6 * bytes0


def _file_state(root) -> dict:
    for dirpath, _, files in os.walk(root):
        if "state.pt" in files and os.path.basename(dirpath).startswith("last"):
            path = os.path.join(dirpath, "state.pt")
            state = torch.load(path, map_location="cpu", weights_only=True)
            opt = {i: {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in st.items()}
                   for i, st in state["optimizer"]["state"].items()}
            return {"state_dict": {k: v.numpy() for k, v in state["state_dict"].items()},
                    "optimizer": opt, "step": state["step"], "path": path}
    raise FileNotFoundError(f"no last checkpoint under {root}")


def test_checkpoints_resume_across_layouts(ranks, tmp_path):
    """Stage-resident for one epoch, resumed replicated for the second: the
    uninterrupted stage-resident run's parameters bit for bit. The replicated run's checkpoint, written with no gather,
    restores into one rank (weights, moments, step as written) and serves
    from its ``.pt``."""
    resident = dict(pipeline_parallel=2, pipeline_microbatches=2, save=True)
    whole = ranks.run(fit, _fit_config(**resident), 2, 16, 256, 0, str(tmp_path / "whole"))
    first = _fit_config(**resident)
    first["train"]["ep"] = 1
    ranks.run(fit, first, 2, 16, 256, 0, str(tmp_path / "split"))
    replicated = _fit_config(save=True, **_REPLICATED)
    resumed = ranks.run(fit, replicated, 2, 16, 256, 0, str(tmp_path / "split"), "last")
    for _, sd, _ in resumed[:2]:
        _same(sd, whole[0][1])
    written = _file_state(tmp_path / "split")
    assert written["step"] == 2
    one = _fit_config()
    got = ranks.run(restored_state, one, 1, 16, 256, 0, str(tmp_path / "split"), "last")[0]
    _same(got["state_dict"], written["state_dict"])
    assert got["step"] == written["step"] and got["optimizer"].keys() == written["optimizer"].keys()
    for i, st in written["optimizer"].items():
        for k, v in st.items():
            np.testing.assert_array_equal(got["optimizer"][i][k], v, err_msg=f"{i}.{k}")
    x = np.random.default_rng(2).standard_normal((3, 256)).astype(np.float32)
    module = _port(one, written["state_dict"])
    served = Predictor.from_checkpoint(copy.deepcopy(one), ckpt=written["path"], device="cpu")
    _same({k: v.numpy() for k, v in served.module.state_dict().items()}, written["state_dict"])
    with torch.no_grad():  # the served batch is padded to its size: fp32 sums in another order
        np.testing.assert_allclose(served._batched_logits(x), module(torch.from_numpy(x)).numpy(),
                                   atol=1e-6, rtol=0)


def test_replicated_layout_keeps_vit_tpus_raises():
    """vit_tpu's own raises, word for word: model_parallel without the
    stage-resident layout, and ZeRO-1 with it."""
    config = _config(layers=4)
    for train in (dict(model_parallel=2, pipeline_parallel=2, pipeline_stage_params=False),
                  dict(opt_state_sharding=True, pipeline_parallel=2)):
        cfg = copy.deepcopy(config)
        cfg["train"].update(gpus=4, **train)
        with pytest.raises(ValueError) as jerr:
            JaxExperiment(copy.deepcopy(cfg), seed=0)
        with pytest.raises(ValueError) as perr:
            Experiment(copy.deepcopy(cfg), device="cpu", datamodule=object())
        assert str(perr.value) == str(jerr.value)
    assert "set train.pipeline_stage_params: false to combine zero1" in str(perr.value)
