"""The port's meshes, layouts and parallel training steps
(``vit_tpu_torch.parallel``, ``Experiment`` under ``train.gpus``,
``model_parallel``, ``opt_state_sharding``) against vit_tpu's, mirroring
``tests/test_{mesh_topology,model_parallel,zero1,multihost}.py`` and
``tests/test_moe.py::test_moe_expert_parallel_sharding``.

vit_tpu runs on the 8-device virtual CPU mesh of ``conftest.py``; the port
on two gloo ranks (``torch_ranks.Ranks``, started once for the module).
Weights are vit_tpu's own initialisation (its ``_init_state`` under its
mesh) carried across by ``from_flax_params``; batches are seeded numpy.
First-step losses and gradients are held per tensor at 1e-4 (relative L2,
against the larger of the tensor's norm and 1e-3 of the global norm):
against vit_tpu's sharded step with dropout off (vit_tpu draws its seeds
from flax keys), and against the one-rank port with dropout on, where the
ranks must draw the global masks.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_ranks import Ranks, first_step, fit
from vit_tpu.parallel.mesh import active_mesh_scope as jax_mesh_scope
from vit_tpu.parallel.mesh import infer_param_shardings as jax_infer
from vit_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vit_tpu.parallel.mesh import zero1_shard_opt_state as jax_zero1
from vit_tpu.train import optim as jopt
from vit_tpu.train.loop import Experiment as JaxExperiment
from vit_tpu.train.loop import _make_grads_fn
from vit_tpu_torch.models.builder import get_model
from vit_tpu_torch.parallel import mesh as pm
from vit_tpu_torch.train.loop import draw_seeds
from vit_tpu_torch.train.torch_bridge import from_flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(2)
    yield r
    r.close()


def _cfg(tiny_config, dropout=0.0, moe=False, **train):
    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
    if moe:
        cfg["model"].update(moe_experts=4, moe_top_k=2, moe_aux_weight=0.01)
    cfg["train"].update(train)
    cfg["opt"] = {"type": "AdamW", "lr": 3e-3, "lr_sch": "none"}
    return cfg


def _batch(n=16, length=512, seed=3):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, length)).astype(np.float32),
            "label": rng.random((n, 1)).astype(np.float32)}


def _vit_tpu_step(cfg, batch):
    """vit_tpu's first-step loss and gradients under its own mesh (its
    Experiment's init and grads function, GSPMD-sharded), and its weights;
    the two in the port's names and layouts."""
    jexp = JaxExperiment(copy.deepcopy(cfg), seed=0)
    jexp.state = jexp._init_state(jopt.build_optimizer(jopt.OptSpec.from_config(jexp.config, 1)))
    grads_fn = _make_grads_fn(jexp.bundle, 0.0, apply_fn=jexp._train_apply_fn())
    key = jax.random.PRNGKey(0)
    with jexp.mesh, jax_mesh_scope(jexp.mesh):
        b = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, jexp.batch_shard)
        loss, grads = jax.jit(grads_fn)(jexp.state.params, b, key, key)
    vc = jexp.bundle.vit_config
    as_np = lambda tree: {k: v.numpy() for k, v in  # noqa: E731
                          from_flax_params(jax.device_get(tree), vc).items()}
    return float(loss), as_np(jexp.state.params), as_np(grads), jexp


def _rel_errors(got: dict, want: dict) -> dict:
    assert got.keys() == want.keys()
    glob = np.sqrt(sum(float((w.astype(np.float64) ** 2).sum()) for w in want.values()))
    return {k: float(np.linalg.norm(got[k] - want[k])
                     / max(np.linalg.norm(want[k]), 1e-3 * glob)) for k in want}


def _worst(errs):
    return max(errs.items(), key=lambda kv: kv[1])


# -- meshes and layout rules ------------------------------------------------------
@pytest.mark.parametrize("n,tp,pp", [(8, 1, 1), (8, 2, 1), (8, 2, 2), (4, 1, 2), (2, 2, 1)])
def test_make_mesh_matches_vit_tpu(n, tp, pp):
    want = jax_make_mesh(num_devices=n, model_parallel=tp, pipeline_parallel=pp)
    got = pm.make_mesh(devices=range(8), num_devices=n, model_parallel=tp,
                       pipeline_parallel=pp)
    assert got.shape == dict(want.shape) and got.axis_names == tuple(want.axis_names)
    ids = np.vectorize(lambda d: d.id)(want.devices)  # the CPU's enumeration order
    np.testing.assert_array_equal(got.devices, ids)
    assert pm.num_data_shards(got) == n // (tp * pp)


def test_make_mesh_errors_match_vit_tpu():
    for kw in ({"model_parallel": 3}, {"model_parallel": 2, "pipeline_parallel": 3},
               {"model_parallel": 0}):
        with pytest.raises(ValueError) as jerr:
            jax_make_mesh(num_devices=8, **kw)
        with pytest.raises(ValueError) as perr:
            pm.make_mesh(devices=range(8), num_devices=8, **kw)
        assert str(perr.value) == str(jerr.value)


def test_batch_and_replicated_shardings():
    mesh = pm.make_mesh(devices=range(1))
    x = torch.arange(12.0).reshape(6, 2)
    assert pm.batch_sharding(mesh).spec == ("data",)
    assert pm.replicated_sharding(mesh).spec == ()
    assert torch.equal(pm.batch_sharding(mesh).shard(x), x)
    four = pm.make_mesh(devices=range(4))  # a layout of 4 ranks, seen from rank 0
    assert torch.equal(pm.batch_sharding(four).shard(x[:4]), x[:1])
    with pytest.raises(ValueError, match="does not divide"):
        pm.batch_sharding(four).shard(x)


def test_maybe_initialize_distributed_noop_without_torchrun(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    pm.maybe_initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()


def _flax_and_port(cfg):
    import vit_tpu.models.builder as jb

    bundle = jb.get_model(copy.deepcopy(cfg))
    x = jnp.zeros((1, cfg["model"]["image_size"]))
    params = jax.device_get(bundle.module.init(jax.random.PRNGKey(0), x)["params"])
    return bundle, params


@pytest.mark.parametrize("moe", [False, True])
def test_infer_param_shardings_match_vit_tpus(tiny_config, moe):
    """Per leaf (through the port's bridge): the same tensors split over
    ``model``, along the same axis. The axis is found by carrying an arange
    along vit_tpu's split axis through ``from_flax_params``."""
    cfg = _cfg(tiny_config, moe=moe)
    bundle, params = _flax_and_port(cfg)
    jmesh = jax_make_mesh(num_devices=4, model_parallel=2)
    specs = jax_infer(params, jmesh)

    def marker(leaf, sh):
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(tuple(sh.spec)))
        if "model" not in spec:
            return np.zeros(leaf.shape, np.float32)
        axis = spec.index("model")
        shape = [1] * leaf.ndim
        shape[axis] = leaf.shape[axis]
        return np.broadcast_to(np.arange(leaf.shape[axis], dtype=np.float32).reshape(shape) + 1,
                               leaf.shape).copy()

    markers = jax.tree_util.tree_map(marker, params, specs)
    want = from_flax_params(markers, bundle.vit_config)
    module = get_model(copy.deepcopy(cfg)).module
    got = pm.infer_param_shardings(dict(module.named_parameters()),
                                   pm.make_mesh(devices=range(4), model_parallel=2))
    assert got.keys() == want.keys()
    split = 0
    for name, sh in got.items():
        m = want[name].numpy()
        varying = [d for d in range(m.ndim) if m.shape[d] > 1 and np.ptp(m, axis=d).max() > 0]
        expect = varying[0] if varying else None
        dim = sh.spec.index("model") if "model" in sh.spec else None
        assert dim == expect, (name, sh.spec, varying)
        split += dim is not None
    assert split > 0


def test_zero1_layout_rule(tiny_config):
    """A leaf's leading dim splits over ``data`` where it divides; scalars and
    the rest replicate, vit_tpu's rule (the port's leading dims are torch's:
    a Linear weight leads with its output features)."""
    cfg = _cfg(tiny_config)
    bundle, params = _flax_and_port(cfg)
    jmesh = jax_make_mesh(num_devices=2)
    opt_state = jopt.build_optimizer(jopt.OptSpec.from_config(cfg, 1)).init(params)
    jspecs = [tuple(s.sharding.spec) for s in jax.tree_util.tree_leaves(
        jax_zero1(opt_state, jmesh))]
    assert ("data", None) in jspecs and () in jspecs
    mesh = pm.make_mesh(devices=range(2))
    module = get_model(copy.deepcopy(cfg)).module
    state = {"step": torch.zeros(()), "odd": torch.zeros(3, 4),
             **{n: torch.zeros_like(p) for n, p in module.named_parameters()}}
    specs = pm.zero1_shard_opt_state(state, mesh)
    for name, t in state.items():
        split = t.dim() >= 1 and t.shape[0] % 2 == 0
        assert specs[name].spec == (("data",) + (None,) * (t.dim() - 1) if split else ())


@pytest.mark.parametrize("short", [True, False])
def test_plain_kernels_with_an_offset_are_the_full_batchs_slice(short):
    """K1/K2's and K4+K5/K6's plain versions for rows [2, 4) of a batch of
    4 (2 heads) at bh_offset 4 are the full call's heads 4..7, bit for bit."""
    from vit_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    t, h, lo = (129, 2, 2) if short else (600, 2, 2)
    q, k, v, do = (torch.randn(4 * h, t, 16, generator=g) for _ in range(4))
    fwd, bwd = ((fa.short_fwd, fa.short_bwd) if short else (fa.flash_fwd, fa.flash_bwd))
    o, lse = fwd(q, k, v, 0.25, 0.2, 9)
    part = [x[lo * h:] for x in (q, k, v, do)]
    o2, lse2 = fwd(*part[:3], 0.25, 0.2, 9, bh_offset=lo * h)
    assert torch.equal(o2, o[lo * h:]) and torch.equal(lse2, lse[lo * h:])
    delta = (do * o).sum(-1)
    full = bwd(q, k, v, do, lse, delta, 0.25, 0.2, 9)
    mine = bwd(*part, lse[lo * h:], delta[lo * h:], 0.25, 0.2, 9, bh_offset=lo * h)
    for a, b in zip(mine, full):
        assert torch.equal(a, b[lo * h:])


@pytest.mark.parametrize("replicas,devices", [(7, 8), (8, 8), (12, 8), (6, 4), (5, 1), (3, 2)])
def test_replica_devices_are_vit_tpus(replicas, devices):
    from vit_tpu.opt.parallel_sweep import _replica_devices as jax_rd
    from vit_tpu_torch.opt.parallel_sweep import _replica_devices

    assert _replica_devices(replicas, devices) == jax_rd(replicas, devices)


# -- two-rank steps ----------------------------------------------------------------
_MODES = {
    "dp": dict(gpus=2),
    "tp": dict(gpus=2, model_parallel=2),
    "ep": dict(gpus=2, model_parallel=2),
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_first_step_matches_vit_tpus_sharded_step(ranks, tiny_config, mode):
    cfg = _cfg(tiny_config, moe=mode == "ep", **_MODES[mode])
    batch = _batch()
    loss, sd, want, jexp = _vit_tpu_step(cfg, batch)
    assert dict(jexp.mesh.shape) == ({"data": 2, "model": 1} if mode == "dp"
                                     else {"data": 1, "model": 2})
    got_loss, got, split = ranks.run(first_step, cfg, 2, sd, batch, [[]])[0]
    assert abs(got_loss - loss) < 1e-5
    errs = _rel_errors(got, want)
    assert max(errs.values()) < GRAD_TOL, _worst(errs)
    if mode != "dp":  # the wide kernels (and an MoE model's experts) are split
        assert any(n.endswith("query.weight") for n in split)
        assert (mode == "ep") == any(n.endswith("moe.wi") for n in split)


@pytest.mark.parametrize("mode", [*_MODES, "dp_flash"])
def test_first_step_with_dropout_matches_one_rank(ranks, tiny_config, mode):
    """Dropout 0.1 and two micro-batches: the two ranks' rows of each
    micro-batch draw their rows of the one-rank masks (``dp_flash``: through
    the attention kernels' plain versions and the fused MLP's, with the
    rank's head offset)."""
    cfg = _cfg(tiny_config, dropout=0.1, moe=mode == "ep", accumulate_steps=2)
    if mode == "dp_flash":
        cfg["model"].update(attn_impl="flash", fused_mlp=True)
    _, sd, _, _ = _vit_tpu_step(_cfg(tiny_config, moe=mode == "ep"), _batch())
    batch = _batch()
    sites = get_model(copy.deepcopy(cfg)).module.num_dropout_sites
    seeds = draw_seeds(torch.Generator().manual_seed(0), 2, sites)
    loss1, want, _ = first_step(cfg, None, sd, batch, seeds)
    cfg2 = copy.deepcopy(cfg)
    cfg2["train"].update(_MODES.get(mode, _MODES["dp"]))
    loss2, got, _ = ranks.run(first_step, cfg2, 2, sd, batch, seeds)[0]
    assert abs(loss2 - loss1) < 1e-6
    errs = _rel_errors(got, want)
    assert max(errs.values()) < GRAD_TOL, _worst(errs)


def test_zero1_matches_data_parallel(ranks, tiny_config, tmp_path):
    """Two epochs of fit with dropout on: ZeRO-1's parameters are plain data
    parallelism's bit for bit, with about half the optimizer state a rank;
    both ranks hold the same parameters."""
    out = {}
    for zero1 in (False, True):
        cfg = _cfg(tiny_config, dropout=0.1, ep=2, opt_state_sharding=zero1)
        out[zero1] = ranks.run(fit, cfg, 2, 64, 512, 0, str(tmp_path / str(zero1)))
    for (m0, sd0, bytes0), (m1, sd1, bytes1) in zip(out[False], out[True]):
        for k in sd0:
            np.testing.assert_array_equal(sd1[k], sd0[k], err_msg=k)
        assert m1["train_loss"] == m0["train_loss"]
        assert bytes1 < 0.6 * bytes0
    for k, v in out[False][0][1].items():
        np.testing.assert_array_equal(out[False][1][1][k], v, err_msg=k)


def test_tensor_parallel_checkpoint_is_canonical(ranks, tiny_config, tmp_path):
    """A TP run's checkpoint holds the one-rank layout: it loads strict into
    a one-rank model, with the ranks' parameters."""
    cfg = _cfg(tiny_config, ep=1, model_parallel=2, save=True)
    res = ranks.run(fit, cfg, 2, 32, 512, 0, str(tmp_path))
    module = get_model(copy.deepcopy(cfg)).module
    path = os.path.join(tmp_path, module.__class__.__name__)
    state = torch.load(_last(tmp_path), map_location="cpu", weights_only=True)
    module.load_state_dict(state["state_dict"], strict=True)
    for k, v in res[0][1].items():
        np.testing.assert_array_equal(state["state_dict"][k].numpy(), v, err_msg=k)
    assert len(state["optimizer"]["state"]) == len(list(module.parameters())), path


@pytest.mark.parametrize("train", [dict(opt_state_sharding=True), dict(model_parallel=2),
                                   dict(pipeline_parallel=2)])
def test_resume_from_a_parallel_checkpoint_is_the_uninterrupted_run(ranks, tiny_config,
                                                                     tmp_path, train):
    """Two epochs against one epoch, saved, then resumed from ``last`` for
    the second: ZeRO-1's moments gathered and split again, TP's blocks
    gathered and cut again, the stages' layers merged and taken again; the
    parameters bit for bit the uninterrupted run's (dropout on)."""
    cfg = _cfg(tiny_config, dropout=0.1, ep=2, save=True, **train)
    whole = ranks.run(fit, cfg, 2, 32, 512, 0, str(tmp_path / "whole"))
    first = copy.deepcopy(cfg)
    first["train"]["ep"] = 1
    ranks.run(fit, first, 2, 32, 512, 0, str(tmp_path / "split"))
    resumed = ranks.run(fit, cfg, 2, 32, 512, 0, str(tmp_path / "split"), "last")
    for (_, want, _), (_, got, _) in zip(whole, resumed):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _last(root) -> str:
    for dirpath, _, files in os.walk(root):
        if "state.pt" in files and os.path.basename(dirpath).startswith("last"):
            return os.path.join(dirpath, "state.pt")
    raise FileNotFoundError(f"no last checkpoint under {root}")


def test_cli_runs_two_ranks_and_its_checkpoint_loads(tiny_config, tmp_path):
    """``run --gpus 2 --device cpu``: two local ranks on gloo train one epoch;
    rank 0's checkpoint loads strict=True into a one-rank model."""
    cfg = _cfg(tiny_config, ep=1)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, CKPT_DIR=str(tmp_path / "ckpt"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "vit_tpu_torch", "run", "-c", str(path),
                           "--gpus", "2", "--device", "cpu", "--save"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("test_loss") >= 1
    state = torch.load(_last(tmp_path / "ckpt"), map_location="cpu", weights_only=True)
    get_model(copy.deepcopy(cfg)).module.load_state_dict(state["state_dict"], strict=True)
