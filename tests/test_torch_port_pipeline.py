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
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from torch_ranks import Ranks, first_step, pipeline_forward
from vit_tpu.models.builder import get_model as jax_get_model
from vit_tpu.models.vit import compute_loss as jax_loss
from vit_tpu.parallel.pipeline import apply_pipelined as jax_apply_pipelined
from vit_tpu.parallel.pipeline import resident_param_shardings as jax_resident_shardings
from vit_tpu.parallel.pipeline import stage_resident_params as jax_stage_resident
from vit_tpu_torch.models.builder import get_model
from vit_tpu_torch.parallel import pipeline as pp
from vit_tpu_torch.parallel.mesh import make_mesh
from vit_tpu_torch.train.loop import draw_seeds
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
