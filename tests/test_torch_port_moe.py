"""The port's Mixture-of-Experts ViT (``vit_tpu_torch.models.moe``) against
vit_tpu's, mirroring ``tests/test_moe.py``.

Both packages get the same seeded numpy inputs and the same weights (vit_tpu's
init carried across by ``from_flax_params``). Every parity case first checks
that the routing (each token's chosen experts and which choices found a
slot) is identical, then compares the outputs: a near-tie flipped by the
order of a sum would change the output by a whole expert's contribution.
Everything runs on the CPU in fp32 with the plain versions of the kernels.
Dropout and router jitter are off where the packages are compared (vit_tpu
draws them from flax keys); the port's own training paths keep them on.

Expert parallelism (``tests/test_moe.py::test_moe_expert_parallel_sharding``)
is held on two ranks by ``tests/test_torch_port_parallel.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vit_tpu.models.builder import get_model as jax_get_model
from vit_tpu.models.builder import get_vit_config as jax_vit_config
from vit_tpu.models.builder import step_matmul_flops as jax_flops
from vit_tpu.models.moe import MoEMLP as JaxMoEMLP
from vit_tpu_torch.models.builder import get_model, get_vit_config, step_matmul_flops
from vit_tpu_torch.models.moe import MoEMLP, moe_capacity
from vit_tpu_torch.models.vit import compute_loss, train_forward
from vit_tpu_torch.train.torch_bridge import from_flax_params

# The whole model's first-step gradients against jax.grad of vit_tpu's
# objective, relative L2 per tensor (floored at 1e-3 of the global norm):
# measured 2.4e-7 at most (the patch embedding's; the logits 1.5e-8 apart).
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(experts=4, top_k=1, cf=1.25, layers=2, hidden=32, **extra):
    """tests/test_moe.py's config."""
    return {
        "project": "moe-test",
        "model": {
            "name": "vit", "task_type": "reg", "image_size": 256,
            "patch_size": 32, "hidden_size": hidden, "num_hidden_layers": layers,
            "num_attention_heads": 2, "stride_size": 32, "proj_fn": "SW",
            "moe_experts": experts, "moe_top_k": top_k,
            "moe_capacity_factor": cf, **extra,
        },
        "train": {"batch_size": 8, "ep": 1},
        "loss": {"name": "mae"},
        "opt": {"type": "AdamW", "lr": 1e-3, "lr_sch": "none"},
        "data": {"param": "log_g", "label_norm": "minmax"},
        "noise": {"noise_level": 0},
        "viz": {"enable": False},
    }


def _layer_pair(x, experts=4, top_k=1, cf=1.25, hidden=16, **extra):
    """vit_tpu's MoEMLP with its init params, and the port's with them."""
    cfg = _cfg_dict(experts, top_k, cf, hidden=hidden, **extra)
    jm = JaxMoEMLP(jax_vit_config(copy.deepcopy(cfg)))
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    pm = MoEMLP(get_vit_config(copy.deepcopy(cfg)))
    pm.load_state_dict(_moe_state(params))
    return jm, params, pm.eval()


def _moe_state(p):
    sd = {"router.weight": torch.tensor(np.asarray(p["router"]["kernel"]).T),
          "router.bias": torch.tensor(np.asarray(p["router"]["bias"]))}
    sd.update({n: torch.tensor(np.asarray(p[n])) for n in ("wi", "wi_bias", "wo", "wo_bias")})
    return sd


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_routing(x, p, experts, top_k, cf):
    """vit_tpu's routing of ``x`` (moe.py:109-137): (gate_idx, keep)."""
    b, t, _ = x.shape
    logits = jnp.asarray(x) @ p["router"]["kernel"] + p["router"]["bias"]
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    sel = jax.nn.one_hot(idx, experts, dtype=jnp.float32)
    prio = sel.transpose(0, 2, 1, 3).reshape(b, top_k * t, experts)
    pos = jnp.cumsum(prio, axis=1) - 1.0
    keep = (pos < moe_capacity(t, experts, top_k, cf)) * prio
    return np.asarray(idx), np.asarray(keep)


def _port_routing(pm, x):
    with torch.no_grad():
        _, _, _, idx = pm.route(x)
        _, keep, _ = pm.slots(idx, x.shape[1])
    return idx.numpy(), keep.numpy()


def _japply(jm, params, x, mutable=("losses",)):
    """vit_tpu's deterministic layer forward, jitted: (out, collections)."""
    return jax.jit(lambda p, x: jm.apply({"params": p}, x, mutable=list(mutable)))(
        params, jnp.asarray(x))


def _sown(cols, collection):
    return float(jax.tree_util.tree_leaves(cols[collection])[0])


# -- the layer ----------------------------------------------------------------------
@pytest.mark.parametrize("top_k,cf", [(1, 1.0), (2, 1.0), (1, 0.4), (2, 0.3), (3, 1.0),
                                      (4, 0.5)])
def test_moe_matches_vit_tpu(top_k, cf):
    """tests/test_moe.py::test_moe_matches_bruteforce's cases, capacity drops
    at tight cf included: identical routing, outputs within 1e-5 (measured
    3.7e-9 at most), the load-balance loss and dropped share vit_tpu's."""
    x = _x((3, 10, 16), 0)
    jm, params, pm = _layer_pair(x, 4, top_k, cf)
    out, cols = _japply(jm, params, x, ("losses", "moe_stats"))
    jidx, jkeep = _jax_routing(x, params, 4, top_k, cf)
    idx, keep = _port_routing(pm, torch.from_numpy(x))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(keep, jkeep)
    with torch.no_grad():
        y, stats = pm(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(out), rtol=0, atol=1e-5)
    assert float(stats[0]) == pytest.approx(_sown(cols, "losses"), rel=1e-5)
    assert float(stats[2]) == pytest.approx(_sown(cols, "moe_stats"), abs=1e-6)


def test_moe_aux_loss_balanced_router_is_one():
    """A zero router: every probability 1/E, the aux loss exactly 1, and the
    ties broken toward the lower expert as lax.top_k breaks them (the
    outputs vit_tpu's)."""
    x = _x((2, 8, 16), 1)
    jm, params, pm = _layer_pair(x, 4, 1, 4.0)
    params["router"] = {k: np.zeros_like(v) for k, v in params["router"].items()}
    pm.load_state_dict(_moe_state(params))
    out, cols = _japply(jm, params, x)
    with torch.no_grad():
        y, stats = pm(torch.from_numpy(x))
    assert float(stats[0]) == pytest.approx(1.0, abs=1e-6) and _sown(cols, "losses") == 1.0
    np.testing.assert_array_equal(_port_routing(pm, torch.from_numpy(x))[0], 0)
    np.testing.assert_allclose(y.numpy(), np.asarray(out), rtol=0, atol=1e-6)


def _task_grads(jm, params, pm, x):
    """Gradients of mean(out**2) (no aux term) in both packages, the
    port's as vit_tpu's layout (router kernel (D, E))."""
    def task(p):
        out, _ = jm.apply({"params": p}, jnp.asarray(x), mutable=["losses"])
        return (out**2).mean()

    jg = jax.device_get(jax.jit(jax.grad(task))(params))
    pm.zero_grad()
    (pm(torch.from_numpy(x))[0] ** 2).mean().backward()
    pg = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    pg["router.weight"] = pg["router.weight"].T
    return jg, pg


def test_moe_top1_router_gets_task_gradient():
    """Top-1 keeps the raw probability as the gate: the task loss alone
    reaches the router (~2e-6 here; a renormalised constant gate gives
    ~1e-13), as much as it reaches vit_tpu's."""
    x = _x((2, 8, 16), 3)
    jm, params, pm = _layer_pair(x, 4, 1, 4.0)
    jg, pg = _task_grads(jm, params, pm, x)
    assert np.abs(pg["router.weight"]).max() > 1e-8
    np.testing.assert_allclose(pg["router.weight"], np.asarray(jg["router"]["kernel"]),
                               rtol=1e-4, atol=1e-11)


def test_moe_grads_reach_all_experts():
    """Top-2 of 2 experts with ample capacity: every parameter, both
    experts' and the router's, gets a gradient, and each is vit_tpu's."""
    x = _x((2, 6, 16), 2)
    jm, params, pm = _layer_pair(x, 2, 2, 2.0)
    jg, pg = _task_grads(jm, params, pm, x)
    want = {"router.weight": jg["router"]["kernel"], "router.bias": jg["router"]["bias"],
            **{n: jg[n] for n in ("wi", "wi_bias", "wo", "wo_bias")}}
    for name, g in pg.items():
        assert np.abs(g).max() > 0, name
        np.testing.assert_allclose(g, np.asarray(want[name]), rtol=1e-4, atol=1e-9,
                                   err_msg=name)


def test_moe_z_loss_is_vit_tpus():
    """moe_z_weight > 0: the z-loss statistic is vit_tpu's sown
    mean(logsumexp(logits)^2); with weight 0 it is 0 and takes no part in
    the objective."""
    x = _x((2, 8, 16), 4)
    jm, params, pm = _layer_pair(x, 4, 1, 4.0, moe_z_weight=1e-3)
    _, cols = _japply(jm, params, x)
    flat, _ = jax.tree_util.tree_flatten_with_path(cols["losses"])
    (z,) = [float(v) for p, v in flat if "moe_z" in jax.tree_util.keystr(p)]
    with torch.no_grad():
        _, stats = pm(torch.from_numpy(x))
    assert float(stats[1]) == pytest.approx(z, rel=1e-5)
    _, _, off = _layer_pair(x, 4, 1, 4.0)
    with torch.no_grad():
        assert float(off(torch.from_numpy(x))[1][1]) == 0.0
    model = get_model(_cfg_dict(4, 1, 4.0, moe_z_weight=0.0)).module.eval()
    xs = torch.from_numpy(_x((2, 256), 4))
    with torch.no_grad():
        _, st = model(xs, moe_stats=True)
        assert float(train_forward(model, xs, None)[1]) == pytest.approx(
            0.01 * float(st[:, 0].mean()), rel=1e-6)


def test_moe_router_jitter_training_only():
    """Jitter perturbs training forwards only: evaluation is jitter-free and
    vit_tpu's; training forwards follow their seed (an int and the same
    value as a 0-d tensor draw the same noise; two seeds differ). The noise
    is uniform in [1-j, 1+j) as vit_tpu's jax.random.uniform: with the
    router reading the first E inputs, the logits over the inputs give the
    multipliers, whose mean and spread match vit_tpu's draw of the same
    size (their bits cannot: a declared difference)."""
    j = 0.5
    x = _x((2, 16, 16), 5)
    jm, params, pm = _layer_pair(x, 4, 1, 1.0, moe_router_jitter=j)
    det, _ = _japply(jm, params, x)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_allclose(pm(xt)[0].numpy(), np.asarray(det), rtol=0, atol=1e-5)
        assert torch.equal(pm(xt)[0], pm(xt)[0])
        pm.train()
        a, b = pm(xt, 1)[0], pm(xt, 2)[0]
        assert torch.equal(a, pm(xt, torch.tensor(1, dtype=torch.int32))[0])
        assert not torch.equal(a, b)
        with pytest.raises(ValueError, match="jitter"):
            pm(xt)

        pm.router.weight.copy_(torch.eye(4, 16))
        pm.router.bias.zero_()
        mult = (pm.route(xt, 7)[0] / xt[..., :4]).numpy().ravel()
    jmult = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), mult.shape, jnp.float32,
                                          1.0 - j, 1.0 + j))
    assert mult.min() >= 1.0 - j - 1e-5 and mult.max() <= 1.0 + j + 1e-5
    assert mult.mean() == pytest.approx(jmult.mean(), abs=0.06)
    assert mult.std() == pytest.approx(jmult.std(), rel=0.15)


def test_moe_dropped_frac_is_vit_tpus():
    """Ample capacity drops nothing; a tight one drops exactly vit_tpu's share."""
    x = _x((3, 10, 16), 6)
    for cf, positive in ((4.0, False), (0.3, True)):
        jm, params, pm = _layer_pair(x, 4, 2, cf)
        _, cols = _japply(jm, params, x, ("losses", "moe_stats"))
        with torch.no_grad():
            got = float(pm(torch.from_numpy(x))[1][2])
        assert got == pytest.approx(_sown(cols, "moe_stats"), abs=1e-6)
        assert (got > 0.0) == positive


def test_moe_rejections_and_flops(tiny_config):
    """An invalid top_k raises as vit_tpu's; the FLOPs count is vit_tpu's and
    grows with the slots; expert parallelism (train.model_parallel: 2) needs
    two ranks, and a single process raises vit_tpu's make_mesh error (the
    two-rank runs are tests/test_torch_port_parallel.py's)."""
    from vit_tpu_torch.train.loop import Experiment

    with pytest.raises(ValueError, match="moe_top_k"):
        get_model(_cfg_dict(experts=4, top_k=5))
    for cf in (1.0, 2.0):
        for k in (1, 2):
            cfg = _cfg_dict(experts=4, top_k=k, cf=cf)
            assert (step_matmul_flops(get_vit_config(copy.deepcopy(cfg)), 8)
                    == jax_flops(jax_vit_config(copy.deepcopy(cfg)), 8))
    assert (step_matmul_flops(get_vit_config(_cfg_dict(experts=4, cf=2.0)), 8)
            > step_matmul_flops(get_vit_config(_cfg_dict(experts=0)), 8))
    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(moe_experts=4)
    cfg["train"]["model_parallel"] = 2
    with pytest.raises(ValueError, match="model_parallel=2 x pipeline_parallel=1 must divide"):
        Experiment(cfg, device="cpu")


# -- the whole model --------------------------------------------------------------
@pytest.fixture(scope="module")
def carried():
    """vit_tpu's 2-layer MoE ViT (E 4, top-2, cf 1, z-loss on, dropout off)
    with its init, and the port's model with those weights."""
    cfg = _cfg_dict(experts=4, top_k=2, cf=1.0, moe_z_weight=1e-3, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    bundle = jax_get_model(copy.deepcopy(cfg))
    params = jax.device_get(jax.jit(bundle.module.init)(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 256)))["params"])
    model = get_model(copy.deepcopy(cfg)).module
    model.load_state_dict(from_flax_params(params, bundle.vit_config), strict=True)
    return cfg, bundle, params, model


def test_bridge_keys_are_the_documented_ones(carried):
    """An MoE layer's keys: moe.router.{weight (E, D), bias}, moe.{wi, wi_bias,
    wo, wo_bias}; no intermediate/output."""
    _, _, _, model = carried
    keys = [k[len("vit.encoder.layer.0."):] for k in model.state_dict()
            if k.startswith("vit.encoder.layer.0.") and "attention" not in k]
    assert sorted(keys) == sorted(["layernorm_before.weight", "layernorm_before.bias",
                                   "layernorm_after.weight", "layernorm_after.bias",
                                   "moe.router.weight", "moe.router.bias", "moe.wi",
                                   "moe.wi_bias", "moe.wo", "moe.wo_bias"])
    assert model.vit.encoder.layer[0].moe.router.weight.shape == (4, 32)
    assert model.vit.encoder.layer[0].moe.wi.shape == (4, 32, 128)


def _routing_hooks(model):
    seen = []

    def hook(mod, args, out):
        seen.append(_port_routing(mod, args[0]))

    return seen, [layer.moe.register_forward_hook(hook) for layer in model.vit.encoder.layer]


def test_specvit_moe_forward_and_first_step_match_vit_tpu(carried):
    """The whole model: each layer's routing identical to vit_tpu's (its
    router on its own layernorm_after output), the logits within 1e-5, and
    the first step's loss and every parameter gradient of the training
    objective (task loss + pre-weighted router regulariser) against
    jax.grad of make_train_forward's, per tensor within GRAD_TOL."""
    from vit_tpu.models.vit import compute_loss as jax_loss
    from vit_tpu.train.loop import make_train_forward

    cfg, bundle, params, model = carried
    x = _x((4, 256), 7)
    y = np.random.default_rng(8).random((4, 1)).astype(np.float32)
    want, inter = jax.jit(lambda p, x: bundle.module.apply(
        {"params": p}, x, deterministic=True, capture_intermediates=True))(params, jnp.asarray(x))
    seen, hooks = _routing_hooks(model)
    try:
        with torch.no_grad():
            logits = model.eval()(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    for i, (idx, keep) in enumerate(seen):
        layer = params["encoder"][f"layer_{i}"]["moe"]
        h = np.asarray(inter["intermediates"]["encoder"][f"layer_{i}"]["layernorm_after"]
                       ["__call__"][0])
        jidx, jkeep = _jax_routing(h, layer, 4, 2, 1.0)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    apply_fn, weight = make_train_forward(bundle)

    def objective(p):
        out, reg = apply_fn(p, jnp.asarray(x), jax.random.PRNGKey(0))
        return jax_loss(out, jnp.asarray(y), "reg", "mae") + weight * reg

    jloss, jgrads = jax.jit(jax.value_and_grad(objective))(params)
    want = from_flax_params(jax.device_get(jgrads), bundle.vit_config)
    model.train()
    model.zero_grad()
    out, reg = train_forward(model, torch.from_numpy(x), list(range(model.num_dropout_sites)))
    loss = compute_loss(out, torch.from_numpy(y), "reg", "mae") + reg
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-6)
    total = float(np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values())))
    for name, p in model.named_parameters():
        w = want[name]
        err = float((p.grad - w).norm()) / max(float(w.norm()), 1e-3 * total)
        assert err <= GRAD_TOL, (name, err)
    assert model.vit.encoder.layer[1].moe.router.weight.grad.abs().max() > 0


@pytest.mark.parametrize("remat", ["mlp", True])
def test_remat_gives_the_same_reg_and_gradients(remat):
    """remat: mlp and remat: true recompute the MoE sublayer in the
    backward: the statistics come out of the checkpointed function, so the
    regulariser and every gradient equal the run without remat, with
    dropout and router jitter redrawn from the same seeds."""
    grads, regs = [], []
    for r in (False, remat):
        cfg = _cfg_dict(experts=4, top_k=2, cf=1.0, remat=r, moe_router_jitter=0.2,
                        moe_z_weight=1e-3)
        model = get_model(cfg, generator=torch.Generator().manual_seed(1)).module.train()
        x = torch.from_numpy(_x((3, 256), 9))
        out, reg = train_forward(model, x, list(range(100, 100 + model.num_dropout_sites)))
        (compute_loss(out, torch.zeros(3, 1), "reg", "mae") + reg).backward()
        grads.append([p.grad for p in model.parameters()])
        regs.append(reg.detach())
    assert model.num_dropout_sites == 1 + 4 * 2
    assert torch.equal(regs[0], regs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_quant_table_is_vit_tpus_on_an_moe_model():
    """int8 on an MoE model quantizes exactly the Dense layers vit_tpu's
    interceptor reaches (attention's: the router is excluded by name, the
    stacked experts are no Dense), bit for bit; a quantized Predictor
    serves it close to the unquantized model."""
    from vit_tpu.ops import quant as jquant
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.serve import Predictor

    cfg = _cfg_dict(experts=4, top_k=2, cf=2.0, hidden=64)
    bundle = jax_get_model(copy.deepcopy(cfg))
    params = jax.device_get(jax.jit(bundle.module.init)(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 256)))["params"])
    model = get_model(copy.deepcopy(cfg)).module
    model.load_state_dict(from_flax_params(params, bundle.vit_config), strict=True)
    jtable = jquant.quantize_dense_params(params)
    table = quant.quantize_dense_params(model)
    leaf = {"query": "attention.query", "key": "attention.key", "value": "attention.value",
            "out": "output.dense"}
    names = {}
    for path in jtable:
        _, layer, _, name = path.split("/")
        names[path] = f"vit.encoder.layer.{layer.split('_')[1]}.attention.{leaf[name]}"
    assert sorted(names.values()) == sorted(table) and len(table) == 8
    for path, name in names.items():
        np.testing.assert_array_equal(table[name]["wq"].numpy(), np.asarray(jtable[path]["wq"]).T)
        np.testing.assert_array_equal(table[name]["scale"].numpy(),
                                      np.asarray(jtable[path]["scale"]))
    x = _x((8, 256), 10)
    with torch.no_grad():
        ref = model.eval()(torch.from_numpy(x)).numpy()
    p = Predictor(copy.deepcopy(model), get_vit_config(copy.deepcopy(cfg)), batch_size=8,
                  quantize="int8-wo")
    assert sorted(p._qtable) == sorted(table)
    np.testing.assert_allclose(p._batched_logits(x), ref, rtol=0, atol=2e-3)


def test_stacked_replicas_train_the_full_objective(tiny_config):
    """The vmapped sweep's step (ReplicaEpochs._losses) on MoE replicas with
    dropout, router jitter and the z-loss on: each replica's loss is its
    model's task loss plus its regulariser, and its gradients that model's."""
    from vit_tpu_torch.train.fused import ReplicaEpochs

    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(moe_experts=4, moe_top_k=2, moe_router_jitter=0.1, moe_z_weight=1e-3,
                        attn_impl="flash")
    R, bs, L = 2, 4, cfg["model"]["image_size"]
    mods = [get_model(copy.deepcopy(cfg), generator=torch.Generator().manual_seed(i)).module
            for i in range(R)]
    names = [n for n, _ in mods[0].named_parameters()]
    params = {n: torch.stack([dict(m.named_parameters())[n].detach() for m in mods])
              .requires_grad_(True) for n in names}
    ep = ReplicaEpochs.__new__(ReplicaEpochs)
    ep.module, ep.params = mods[0].train(), params
    ep.loss_fn = lambda lg, y: compute_loss(lg, y, "reg", "mae")
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(R, bs, L, generator=g), torch.rand(R, bs, 1, generator=g)
    seeds = torch.randint(0, 2**31 - 1, (R, mods[0].num_dropout_sites), generator=g,
                          dtype=torch.int32)
    losses = ep._losses(x, y, seeds)
    grads = torch.autograd.grad(losses.sum(), list(params.values()))
    for r, m in enumerate(mods):
        m.train()
        out, reg = train_forward(m, x[r], seeds[r])
        loss = compute_loss(out, y[r], "reg", "mae") + reg
        loss.backward()
        assert float(reg) > 0
        assert losses[r].item() == pytest.approx(loss.item(), rel=1e-6, abs=1e-7)
        for (name, p), gr in zip(m.named_parameters(), grads):
            np.testing.assert_allclose(gr[r].numpy(), p.grad.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=name)


def test_vmapped_sweep_matches_its_sequential_trials(tiny_config, tmp_path):
    """``lr --engine vmap`` on an MoE config (dropout off, top-1) against the
    sequential engine's Experiments, which train the full objective:
    each replica's metric within rel 1e-4 of its trial."""
    from vit_tpu_torch.opt import parallel_sweep as psweep

    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(moe_experts=4, moe_top_k=1, moe_capacity_factor=2.0,
                        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg["train"].update(ep=1, batch_size=16)
    path = tmp_path / "moe.yaml"
    path.write_text(yaml.safe_dump(cfg))
    results = {}
    for engine in ("vmap", "sequential"):
        runner = psweep.ParallelSweepRunner(str(path), lr_values=[1e-3, 3e-3],
                                            results_dir=str(tmp_path / engine), device="cpu",
                                            seed=0, engine=engine)
        runner.run()
        with open(runner.summary_path) as f:
            results[engine] = yaml.safe_load(f)["results"]
    for a, b in zip(results["vmap"], results["sequential"]):
        assert a["status"] == b["status"] == "ok"
        assert a["metric"] == pytest.approx(b["metric"], rel=1e-4)


# -- Experiment, serving, export ------------------------------------------------------
@pytest.fixture(scope="module")
def fitted(dummy_h5, tmp_path_factory):
    """One MoE Experiment (flash attention, top-2 at cf 0.3 so the capacity
    drops, router jitter and dropout on), two epochs through the fused epoch
    with checkpoints, its logged epochs, and the same run per step."""
    from vit_tpu_torch.train.loop import Experiment

    tmp = tmp_path_factory.mktemp("moe")
    cfg = _cfg_dict(experts=4, top_k=2, cf=0.3, attn_impl="flash", moe_router_jitter=0.1)
    cfg["model"].update(image_size=512)
    cfg["train"].update(batch_size=16, ep=2, save=True)
    cfg["data"].update(file_path=dummy_h5, val_path=dummy_h5, test_path=dummy_h5,
                       num_samples=96, num_test_samples=32)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CKPT_DIR", str(tmp / "ckpt"))
        for fused in (True, False):
            c = copy.deepcopy(cfg)
            c["train"]["fused_epoch"] = fused
            c["train"]["save"] = fused
            exp = Experiment(c, device="cpu", seed=0)
            logged = []
            mp.setattr(exp.logger, "log_epoch",
                       lambda epoch, metrics, step=None, _l=logged: _l.append(dict(metrics)))
            exp.fit()
            runs[fused] = (exp, logged)
    return dict(cfg=cfg, tmp=tmp, exp=runs[True][0], logged=runs[True][1],
                per_step=runs[False][0])


def test_fit_logs_moe_dropped_frac_each_epoch(fitted):
    """Experiment.fit end to end: finite losses, and each epoch's
    moe_dropped_frac (cf 0.3 at top-2 over 4 experts must drop) is the
    deterministic forward's over the first validation batch."""
    exp, logged = fitted["exp"], fitted["logged"]
    assert exp.fused is not None and len(logged) == 2
    for m in logged:
        assert np.isfinite(m["train_loss"]) and 0.0 < m["moe_dropped_frac"] <= 1.0
    assert logged[-1]["moe_dropped_frac"] == exp._moe_dropped_frac()


def test_fused_epoch_equals_the_per_step_path(fitted):
    """The fused epoch (eager on the CPU, the step the card captures) and the
    per-step path from one seed, dropout and router jitter on: the same
    parameters bit for bit."""
    a, b = fitted["exp"].module.state_dict(), fitted["per_step"].module.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_moe_checkpoint_serves_and_eval_is_deterministic(fitted):
    """The run's state.pt loads with strict=True into Predictor and into a
    fresh Experiment's test; the served logits are the module's eval
    forward; evaluation draws no jitter (two forwards equal)."""
    from vit_tpu_torch.serve import Predictor
    from vit_tpu_torch.train.loop import Experiment

    cfg, exp = fitted["cfg"], fitted["exp"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CKPT_DIR", str(fitted["tmp"] / "ckpt"))
        pred = Predictor.from_checkpoint(copy.deepcopy(cfg), ckpt="last", batch_size=16,
                                         device="cpu")
        tested = Experiment(copy.deepcopy(cfg), device="cpu").test(ckpt="last")
    x = exp.datamodule.val.model_input[:16]
    module = copy.deepcopy(exp.module).eval()
    module.load_state_dict(pred.module.state_dict())
    with torch.no_grad():
        direct = module(torch.from_numpy(x)).numpy()
        assert np.array_equal(direct, module(torch.from_numpy(x)).numpy())
    np.testing.assert_allclose(pred._batched_logits(x), direct, rtol=1e-5, atol=1e-6)
    assert np.isfinite(tested["test_mae"])


def test_moe_export_round_trip(fitted, tmp_path):
    """Predictor.export of the MoE checkpoint: the loaded program predicts
    as the live Predictor and keeps K2 as its custom operator."""
    import re

    from vit_tpu_torch.export import load_exported
    from vit_tpu_torch.serve import Predictor

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CKPT_DIR", str(fitted["tmp"] / "ckpt"))
        pred = Predictor.from_checkpoint(copy.deepcopy(fitted["cfg"]), ckpt="last",
                                         batch_size=8, device="cpu")
    path = str(tmp_path / "moe.vittxpt")
    pred.export(path)
    loaded = load_exported(path, device="cpu")
    x = fitted["exp"].datamodule.val.model_input[:19]
    np.testing.assert_allclose(loaded.predict(x), pred.predict(x), rtol=1e-6, atol=1e-6)
    ops = set(re.findall(r"torch\.ops\.vit_tpu_torch\.(\w+)", loaded.program.graph_module.code))
    assert ops == {"short_fwd"}
