"""The port's vmapped LR sweep (``python -m vit_tpu_torch lr``, the default
``--engine vmap``) against vit_tpu's ``_VmapSweepEngine``: the engine end to
end from the same carried weights, one stacked step against
``jax.vmap(jax.value_and_grad(...))``, the per-replica dropout masks, and
ports of ``tests/test_parallel_sweep.py``'s vmap cases.

Everything runs on the CPU in fp32 with the plain versions of the kernels.
Dropout and noise are off where the two packages are compared: vit_tpu draws
them from ``jax.random`` keys, the port from ``torch.Generator``s.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vit_tpu.opt import parallel_sweep as jsweep
from vit_tpu_torch.opt import parallel_sweep as psweep
from vit_tpu_torch.train.torch_bridge import from_flax_params

# vit_tpu's test_two_epochs_match_vit_tpu_experiment tolerance.
REL, ABS = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(cfg, path):
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture()
def sweep_base_config(tiny_config, tmp_path):
    cfg = copy.deepcopy(tiny_config)
    cfg["train"] = dict(tiny_config["train"], ep=2, batch_size=16)
    return _write(cfg, tmp_path / "base.yaml")


def _no_dropout(path, tmp_path, **train):
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["model"].update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg["train"].update(train)
    return cfg


def _record_metrics(monkeypatch, module):
    """Every regression_metrics result ``module``'s engine computes, in order."""
    seen = []
    real = module.regression_metrics

    def spy(logits, labels):
        out = real(logits, labels)
        seen.append(out)
        return out

    monkeypatch.setattr(module, "regression_metrics", spy)
    return seen


def _vit_tpu_inits(cfg, configs, seed):
    """The weights vit_tpu's engine draws for each trial: module.init with
    PRNGKey(seed + idx) on one dummy spectrum."""
    from vit_tpu.models.builder import get_model

    bundle = get_model(copy.deepcopy(cfg))
    dummy = jnp.zeros((1, cfg["model"]["image_size"]), jnp.float32)
    return [jax.tree_util.tree_map(
        np.asarray, bundle.module.init(jax.random.PRNGKey(seed + c.idx), dummy)["params"])
        for c in configs], bundle.vit_config


def _engine_parity(path, grid, tmp_path, monkeypatch):
    """Run vit_tpu's engine and the port's on ``path`` over ``grid`` (the
    port from vit_tpu's inits carried across); hold each replica's
    validation metrics, epoch by epoch, and the summaries within REL."""
    import vit_tpu.train.metrics as jmetrics
    import vit_tpu_torch.train.metrics as pmetrics

    jseen = _record_metrics(monkeypatch, jmetrics)
    jrun = jsweep.ParallelSweepRunner(path, results_dir=str(tmp_path / "j"), **grid)
    jrun.run()
    inits, vc = _vit_tpu_inits(jrun.base_config, jrun.sweep_configs, grid["seed"])

    real = psweep._VmapSweepEngine.init_replica

    def carried(self, cfg_, c):
        m = real(self, cfg_, c)
        m.load_state_dict(from_flax_params(inits[c.idx], m.cfg), strict=True)
        return m

    monkeypatch.setattr(psweep._VmapSweepEngine, "init_replica", carried)
    pseen = _record_metrics(monkeypatch, pmetrics)
    prun = psweep.ParallelSweepRunner(path, results_dir=str(tmp_path / "p"), device="cpu",
                                      **grid)
    best = prun.run()
    R = len(prun.sweep_configs)
    assert len(pseen) == len(jseen) == prun.base_config["train"]["ep"] * R
    for j, (jm, pm) in enumerate(zip(jseen, pseen)):
        for key in ("mae", "mse", "r2"):
            assert pm[key] == pytest.approx(jm[key], rel=REL, abs=ABS), (j, key)
    with open(prun.summary_path) as f:
        summary = yaml.safe_load(f)
    with open(jrun.summary_path) as f:
        jsummary = yaml.safe_load(f)
    assert list(summary) == list(jsummary) and summary["engine"] == "vmap"
    for r, jr in zip(summary["results"], jsummary["results"]):
        assert set(r) == set(jr) and r["status"] == jr["status"] == "ok"
        assert r["metric"] == pytest.approx(jr["metric"], rel=REL, abs=ABS)
    assert best.config.idx == jsummary["best"]["config"]["idx"]
    return R


def test_engine_matches_vit_tpu_replica_by_replica(sweep_base_config, tmp_path, monkeypatch):
    """Dropout and noise off, none/plateau/cosine trials with a warmup: each
    replica's validation metric, epoch by epoch, within rel 1e-4 of
    vit_tpu's engine, from vit_tpu's own inits carried across."""
    cfg = _no_dropout(sweep_base_config, tmp_path)
    cfg["warmup"] = {"epochs": 1}
    cfg["train"]["ep"] = 3
    path = _write(cfg, tmp_path / "cmp.yaml")
    grid = dict(lr_values=[1e-4, 3e-3], schedulers=["none", "plateau", "cosine"],
                plateau_patience=[0], seed=5)
    assert _engine_parity(path, grid, tmp_path, monkeypatch) == 6


def test_lbfgs_engine_matches_vit_tpu_replica_by_replica(sweep_base_config, tmp_path,
                                                         monkeypatch):
    """opt.type lbfgs under the vmapped engine against vit_tpu's
    (optax.lbfgs(lr, linesearch=None) under jax.vmap), dropout off, weight
    decay on, one full-batch step an epoch: each replica's metrics within
    rel 1e-4 (measured 4.8e-8). The engines part after that step: the
    second step's curvature pair is the difference of two nearly equal
    gradients, which the two libraries sum in their own fp32 orders, and
    without a line search the ViT's L-BFGS amplifies that to 0.5-2.5% of
    the metric even at lr 1e-5. The memory and ring over many steps are
    held by test_stacked_lbfgs_matches_optax_under_jax_vmap."""
    cfg = _no_dropout(sweep_base_config, tmp_path, ep=1, batch_size=128)
    cfg["opt"].update(type="lbfgs", weight_decay=1e-4)
    path = _write(cfg, tmp_path / "lbfgs.yaml")
    grid = dict(lr_values=[1e-4, 1e-3, 1e-2], schedulers=["none"], seed=3)
    assert _engine_parity(path, grid, tmp_path, monkeypatch) == 3


def test_stacked_lbfgs_matches_optax_under_jax_vmap():
    """The replica L-BFGS (one flat vector, memory of 10, ring slot and
    first-step scale a replica; weight decay; an (R,) learning rate; one
    replica held by ``active`` for steps 5-7) against vit_tpu's optimizer
    chain (build_optimizer: clip, add_decayed_weights, lbfgs; rates
    injected) under jax.vmap, on a convex quadratic a replica, 14 steps,
    past the memory: within rel 1e-4 (measured 2.6e-6 of the largest value)."""
    import dataclasses

    import optax

    from vit_tpu.train import optim as jopt
    from vit_tpu_torch.train.optim import ReplicaOptimizer

    R, n = 3, 24
    rng = np.random.default_rng(0)
    a = rng.standard_normal((R, n, n)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1) / n + np.eye(n, dtype=np.float32)
    b = rng.standard_normal((R, n)).astype(np.float32)
    x0 = rng.standard_normal((R, 4, 6)).astype(np.float32)
    lrs = np.array([0.05, 0.2, 0.5], np.float32)
    spec = dataclasses.replace(jopt.OptSpec(opt_type="lbfgs", weight_decay=1e-3), lr=1.0,
                               scheduler=None, grad_clip=1e9)
    tx = jopt.build_optimizer(spec)
    jx = jnp.asarray(x0)
    st = jax.vmap(jopt.set_learning_rate)(jax.vmap(tx.init)(jx), jnp.asarray(lrs))
    px = torch.from_numpy(x0.copy())
    opt = ReplicaOptimizer([px], "lbfgs", R, weight_decay=1e-3)
    opt.param_groups[0]["lr"].copy_(torch.from_numpy(lrs))
    for step in range(14):
        active = np.array([1.0, 0.0 if 5 <= step < 8 else 1.0, 1.0], np.float32)
        g = jnp.einsum("rij,rj->ri", a, jx.reshape(R, n)) - b
        upd, new = jax.vmap(tx.update)(g.reshape(jx.shape), st, jx)
        keep = jnp.asarray(active) > 0
        st = jax.tree_util.tree_map(
            lambda nw, old: jnp.where(keep.reshape((R,) + (1,) * (nw.ndim - 1)), nw, old),
            new, st)
        jx = jnp.where(keep[:, None, None], optax.apply_updates(jx, upd), jx)
        px.grad = (torch.einsum("rij,rj->ri", torch.from_numpy(a), px.reshape(R, n))
                   - torch.from_numpy(b)).reshape(px.shape)
        opt.active.copy_(torch.from_numpy(active))
        opt.step()
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-6,
                                   err_msg=f"step {step}")
    assert float(opt.state[px]["count"][1]) == 11  # the held replica's count stood still


def _bridge_stacked(tree, vc, R):
    """A replica-stacked flax tree as the port's stacked state dict."""
    per = [from_flax_params(jax.tree_util.tree_map(lambda a: np.asarray(a)[r], tree), vc)
           for r in range(R)]
    return {k: torch.stack([d[k] for d in per]) for k in per[0]}


def _stacked(modules, device="cpu"):
    names = [n for n, _ in modules[0].named_parameters()]
    return {n: torch.stack([dict(m.named_parameters())[n].detach() for m in modules])
            .to(device).requires_grad_(True) for n in names}


def _epochs(module, params, spec, cols, steps, bs, val_x=None, noise_level=0.0, frozen=()):
    from vit_tpu_torch.models.vit import compute_loss
    from vit_tpu_torch.train.fused import ReplicaEpochs
    from vit_tpu_torch.train.optim import build_replica_optimizer

    opt = build_replica_optimizer(spec, params.values(), len(next(iter(params.values()))))
    task, loss_name = module.cfg.task_type, "mae"
    return ReplicaEpochs(module.train(), params, opt,
                         lambda lg, y: compute_loss(lg, y, task, loss_name), cols, steps, bs,
                         noise_level, spec.grad_clip, frozen, val_x, bs)


def _stacked_step(tiny_config, opt_type, weight_decay):
    """One step of three replicas, each on its own batch, with distinct
    learning rates and one replica's gradient norm above the clip, in
    vit_tpu under jax.vmap and in the port's ReplicaEpochs, from the same
    carried weights. Returns what both computed."""
    import dataclasses

    from vit_tpu.models.builder import get_model as jget_model
    from vit_tpu.models.vit import compute_loss as jloss
    from vit_tpu.train import optim as jopt
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.train import optim as popt

    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                        attn_impl="flash", fused_mlp=True)
    cfg["opt"].update(type=opt_type, weight_decay=weight_decay)
    R, bs, L = 3, 8, cfg["model"]["image_size"]
    jb = jget_model(copy.deepcopy(cfg))
    params = [jb.module.init(jax.random.PRNGKey(i), jnp.zeros((1, L)))["params"] for i in range(R)]
    jparams = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *params)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((R, bs, L)).astype(np.float32)
    x[2] *= 40.0  # a larger gradient norm for one replica
    y = rng.random((R, bs, 1)).astype(np.float32)

    def loss(p, xb, yb):
        return jloss(jb.module.apply({"params": p}, xb, deterministic=True), yb, "reg", "mae")

    jl, jg = jax.vmap(jax.value_and_grad(loss))(jparams, jnp.asarray(x), jnp.asarray(y))
    norms = np.sqrt(sum(np.square(np.asarray(g)).reshape(R, -1).sum(1)
                        for g in jax.tree_util.tree_leaves(jg)))
    clip = float(np.sort(norms)[1] * 1.01)  # replicas above this clip, the rest not
    assert (norms > clip).sum() == 1
    spec = dataclasses.replace(jopt.OptSpec.from_config(cfg, 1), lr=1.0, scheduler=None,
                               grad_clip=clip)
    tx = jopt.build_optimizer(spec)
    lrs = jnp.asarray([1e-3, 3e-3, 1e-2], jnp.float32)
    st = jax.vmap(tx.init)(jparams)
    st = jax.vmap(jopt.set_learning_rate)(st, lrs)
    upd, _ = jax.vmap(tx.update)(jg, st, jparams)

    vc = get_model(copy.deepcopy(cfg)).vit_config
    modules = []
    for p in params:
        m = get_model(copy.deepcopy(cfg)).module
        m.load_state_dict(from_flax_params(jax.tree_util.tree_map(np.asarray, p), vc))
        modules.append(m)
    stacked = _stacked(modules)
    before = {n: p.detach().clone() for n, p in stacked.items()}
    pspec = dataclasses.replace(popt.OptSpec.from_config(cfg, 1), lr=1.0, scheduler=None,
                                grad_clip=clip)
    cols = {"x": x.reshape(R * bs, L), "label": y.reshape(R * bs, 1)}
    ep = _epochs(modules[0], stacked, pspec, cols, 1, bs)
    losses = ep._losses(torch.from_numpy(x), torch.from_numpy(y),
                        torch.zeros((R, ep.sites), dtype=torch.int32))
    grads = torch.autograd.grad(losses.sum(), list(stacked.values()))
    perms = np.arange(R * bs).reshape(R, bs)
    ep.prepare(perms, torch.zeros((R, 1, ep.sites)), None, np.asarray(lrs), np.ones(R), 0.0)
    ep.run_step()
    return dict(R=R, vc=vc, clip=clip, norms=norms, lrs=np.asarray(lrs), jl=np.asarray(jl),
                jg=jg, jparams=jparams, upd=upd, stacked=stacked, before=before,
                losses=losses.detach(), grads=dict(zip(stacked, grads)),
                step_losses=ep.losses[:, 0].clone())


def test_stacked_step_matches_jax_vmap_value_and_grad(tiny_config):
    """One step of three replicas, each on its own batch: losses and
    per-replica gradients against jax.vmap(jax.value_and_grad(...)) over
    stacked vit_tpu parameters; the per-replica clip of those gradients
    against optax.clip_by_global_norm under jax.vmap (one replica clipped,
    two not); then the AdamW update with distinct learning rates."""
    import optax

    from vit_tpu_torch.train.optim import clip_by_global_norm

    run = _stacked_step(tiny_config, "AdamW", 0.05)
    R, vc, clip = run["R"], run["vc"], run["clip"]
    np.testing.assert_allclose(run["losses"].numpy(), run["jl"], rtol=1e-5, atol=1e-6)
    jgrads = _bridge_stacked(run["jg"], vc, R)
    for name, g in run["grads"].items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    clipper = optax.clip_by_global_norm(clip)
    jclipped = _bridge_stacked(jax.vmap(lambda g: clipper.update(g, clipper.init(g))[0])(
        run["jg"]), vc, R)
    clipped = {n: g.clone() for n, g in run["grads"].items()}
    norm = clip_by_global_norm(clipped.values(), clip, per_replica=True)
    np.testing.assert_allclose(norm.numpy(), run["norms"], rtol=1e-4)
    for name, g in clipped.items():
        np.testing.assert_allclose(g.numpy(), jclipped[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        scale = (g.flatten(1).norm(dim=1) / run["grads"][name].flatten(1).norm(dim=1)).numpy()
        held = run["norms"] < clip  # clipped replicas shrink, the others stay as they are
        np.testing.assert_allclose(scale, np.where(held, 1.0, clip / run["norms"]), rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(run["step_losses"].numpy(), run["jl"], rtol=1e-5, atol=1e-6)
    want = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), run["jparams"], run["upd"])
    wantp = _bridge_stacked(want, vc, R)
    for name, p in run["stacked"].items():
        np.testing.assert_allclose(p.detach().numpy(), wantp[name].numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


def test_stacked_sgd_step_clips_each_replica(tiny_config):
    """The engine's own step with SGD, whose update is -lr * the clipped
    gradient, so the clip shows in the parameters: each replica's update
    against vit_tpu's under jax.vmap, to the fp32 rounding of the two
    parameter sums and the gradients' tolerance (rtol 1e-4, atol 1e-6)
    times the replica's lr. Neither no clip nor one clip over all replicas
    together stays within that."""
    run = _stacked_step(tiny_config, "SGD", 0.0)
    R, vc, lrs, norms, clip = run["R"], run["vc"], run["lrs"], run["norms"], run["clip"]
    want = _bridge_stacked(run["upd"], vc, R)
    scales = {"unclipped": np.ones(R),
              "one clip over all replicas": np.full(R, min(1.0, clip / np.sqrt((norms**2).sum())))}
    worst = dict.fromkeys(scales, 0.0)
    for name, p in run["stacked"].items():
        shape = (R,) + (1,) * (p.dim() - 1)
        lr = lrs.reshape(shape)
        before = run["before"][name].numpy()
        applied = p.detach().numpy() - before
        w = want[name].numpy()
        limit = 2 * np.spacing(np.abs(before)) + lr * (1e-6 + 1e-4 * np.abs(w / lr))
        np.testing.assert_array_less(np.abs(applied - w), limit, err_msg=name)
        g = run["grads"][name].numpy()
        for alt, scale in scales.items():
            other = -lr * g * scale.reshape(shape)
            worst[alt] = max(worst[alt], float((np.abs(other - w) / limit).max()))
    assert min(worst.values()) > 10, worst


@pytest.mark.parametrize("seed", [0, 2**31 - 1, -7])
def test_stacked_masks_are_vit_tpus_per_replica(seed):
    """An (R,) seed vector: the attention mask and the model-body mask of
    each replica bit for bit vit_tpu's under jax.vmap, and the attention
    wrappers' stacked call bit for bit R single calls."""
    from vit_tpu.ops import dropout as jdrop
    from vit_tpu.ops.flash_attention import hash_dropout_mask as jmask
    from vit_tpu_torch.ops import dropout as pdrop
    from vit_tpu_torch.ops import flash_attention as pflash

    seeds = np.asarray([seed, 12345, 0, 99], np.int32)
    R, bh, t, rate = len(seeds), 6, 40, 0.1
    want = jax.vmap(lambda s: jmask(t, t, jnp.arange(bh), s, rate))(
        jnp.asarray(seeds))
    got = pdrop.hash_dropout_mask(t, t, torch.arange(bh), torch.from_numpy(seeds), rate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = np.random.default_rng(1).standard_normal((R, 3, 5, 16)).astype(np.float32)
    want = jax.vmap(lambda xr, s: jdrop.hash_dropout(xr, rate, s))(jnp.asarray(x),
                                                                   jnp.asarray(seeds))
    got = pdrop.hash_dropout(torch.from_numpy(x), rate, torch.from_numpy(seeds))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The engine's path: each replica's 0-d seed under torch.func.vmap.
    under_vmap = torch.func.vmap(lambda xr, s: pdrop.hash_dropout(xr, rate, s))(
        torch.from_numpy(x), torch.from_numpy(seeds))
    np.testing.assert_array_equal(under_vmap.numpy(), np.asarray(want))
    for r in range(R):  # and a replica alone, with its int seed
        np.testing.assert_array_equal(
            pdrop.hash_dropout(torch.from_numpy(x[r]), rate, int(seeds[r])).numpy(),
            np.asarray(want[r]))

    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(R * bh, t, 16, generator=g) for _ in range(4))
    sv = torch.from_numpy(seeds)
    for fwd, bwd in ((pflash.short_fwd, pflash.short_bwd), (pflash.flash_fwd, pflash.flash_bwd)):
        o, lse = fwd(q, k, v, 0.25, rate, sv, bh_per_seed=bh)
        delta = (do * o).sum(-1)
        grads = bwd(q, k, v, do, lse, delta, 0.25, rate, sv, bh_per_seed=bh)
        for r in range(R):
            sl = slice(r * bh, (r + 1) * bh)
            o1, lse1 = fwd(q[sl], k[sl], v[sl], 0.25, rate, int(seeds[r]))
            g1 = bwd(q[sl], k[sl], v[sl], do[sl], lse1, delta[sl], 0.25, rate, int(seeds[r]))
            assert torch.equal(o[sl], o1) and torch.equal(lse[sl], lse1)
            for a, b in zip(grads, g1):
                assert torch.equal(a[sl], b)


@pytest.mark.parametrize("remat", [False, "mlp", True])
def test_vmapped_model_is_r_single_models(tiny_config, remat):
    """torch.func.vmap of the model's loss over stacked replicas, dropout
    on, flash and the fused MLP (each with its vmap rule) and remat: the
    losses and gradients of R single models with their own seeds."""
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.models.vit import compute_loss

    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(attn_impl="flash", fused_mlp=True, remat=remat,
                        hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    R, bs, L = 3, 4, cfg["model"]["image_size"]
    mods = [get_model(copy.deepcopy(cfg), generator=torch.Generator().manual_seed(i)).module
            for i in range(R)]
    params = _stacked(mods)
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(R, bs, L, generator=g), torch.rand(R, bs, 1, generator=g)
    seeds = torch.randint(0, 2**31 - 1, (R, mods[0].num_dropout_sites), generator=g,
                          dtype=torch.int32)
    m0 = mods[0].train()

    def one(p, xr, yr, s):
        out = torch.func.functional_call(m0, p, (xr,), {"dropout_seeds": s})
        return compute_loss(out, yr, "reg", "mae")

    losses = torch.func.vmap(one)(params, x, y, seeds)
    grads = torch.autograd.grad(losses.sum(), list(params.values()))
    for r, m in enumerate(mods):
        m.train()
        m.zero_grad()
        loss = compute_loss(m(x[r], dropout_seeds=seeds[r]), y[r], "reg", "mae")
        loss.backward()
        assert losses[r].item() == pytest.approx(loss.item(), rel=1e-6, abs=1e-7)
        for (name, p), gr in zip(m.named_parameters(), grads):
            np.testing.assert_allclose(gr[r].numpy(), p.grad.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=name)


def test_replica_epochs_equal_single_replica_steps(tiny_config):
    """ReplicaEpochs (the step the card captures and replays, run eagerly
    here) over three replicas with dropout, noise and a held replica: each
    active replica's parameters after the epoch equal the same steps run
    alone (R = 1); the held one's parameters and optimizer state unchanged
    bit for bit."""
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.train import optim as popt
    import dataclasses

    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(attn_impl="flash", fused_mlp=True)
    R, bs, steps, L = 3, 8, 3, cfg["model"]["image_size"]
    mods = [get_model(copy.deepcopy(cfg), generator=torch.Generator().manual_seed(i)).module
            for i in range(R)]
    spec = dataclasses.replace(popt.OptSpec.from_config(cfg, steps), lr=1.0, scheduler=None)
    rng = np.random.default_rng(0)
    n = 40
    cols = {"x": rng.standard_normal((n, L)).astype(np.float32),
            "error": rng.random((n, L)).astype(np.float32),
            "label": rng.random((n, 1)).astype(np.float32)}
    perms = np.stack([rng.permutation(n)[:steps * bs] for _ in range(R)])
    seeds = torch.randint(0, 2**31 - 1, (R, steps, mods[0].num_dropout_sites), dtype=torch.int32)
    noise = torch.randn(R, steps, bs, L)
    lrs = np.asarray([1e-3, 2e-3, 5e-3], np.float32)
    active = np.asarray([1, 0, 1], np.float32)
    full = _epochs(mods[0], _stacked(mods), spec, cols, steps, bs, noise_level=0.1)
    full.prepare(perms, seeds, noise, lrs, np.ones(R), 0.0)
    full.run_step()  # one step with every replica, then replica 1 stops
    before = {n: p.detach().clone() for n, p in full.params.items()}
    state = {n: {k: v.clone() for k, v in full.optimizer.state[p].items()}
             for n, p in full.params.items()}
    full.optimizer.active.copy_(torch.from_numpy(active))
    for _ in range(steps - 1):
        full.run_step()
    for name, p in full.params.items():
        assert torch.equal(p[1], before[name][1]), name
        for k, v in full.optimizer.state[p].items():
            assert torch.equal(v[1], state[name][k][1]), (name, k)
    for r in (0, 2):
        alone = _epochs(mods[r], _stacked([mods[r]]), spec, cols, steps, bs, noise_level=0.1)
        alone.prepare(perms[r:r + 1], seeds[r:r + 1], noise[r:r + 1], lrs[r:r + 1], np.ones(1),
                      0.0)
        for _ in range(steps):
            alone.run_step()
        np.testing.assert_allclose(full.losses[r].numpy(), alone.losses[0].numpy(), rtol=1e-5)
        for name, p in full.params.items():
            np.testing.assert_allclose(p[r].detach().numpy(),
                                       alone.params[name][0].detach().numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)


def _runner(path, tmp_path, sub="runs", **kw):
    kw.setdefault("seed", 0)
    return psweep.ParallelSweepRunner(path, results_dir=str(tmp_path / sub), device="cpu", **kw)


def _summary(runner):
    with open(runner.summary_path) as f:
        return yaml.safe_load(f)


def test_vmapped_sweep_end_to_end(sweep_base_config, tmp_path):
    """Eight replicas, mixed schedulers, dropout on: vit_tpu's artifacts,
    best = the smallest ok metric, independent replicas."""
    runner = _runner(sweep_base_config, tmp_path, lr_values=[1e-5, 1e-4, 1e-3, 1e-2],
                     schedulers=["none", "plateau"], plateau_factors=[0.8],
                     plateau_patience=[0])
    best = runner.run()
    summary = _summary(runner)
    assert summary["num_configs"] == 8 == len(summary["results"])
    assert summary["engine"] == "vmap" and "lr" in summary["best"]["config"]
    metrics = [r["metric"] for r in summary["results"] if r["status"] == "ok"]
    assert len(metrics) == 8 and summary["best"]["metric"] == min(metrics) == best.metric
    assert len({round(m, 8) for m in metrics}) > 1
    with open(runner.best_config_path) as f:
        best_cfg = yaml.safe_load(f)
    assert best_cfg["opt"]["lr"] == summary["best"]["config"]["lr"]
    assert best_cfg["_meta"]["generator"] == "vit_tpu_torch.opt.parallel_sweep"


def test_diverged_replica_isolated(sweep_base_config, tmp_path):
    """lr 1e6 without a clip diverges: that replica alone is 'error'
    (non-finite), and the other's metric is what it is without it."""
    cfg = _no_dropout(sweep_base_config, tmp_path, grad_clip=0.0)
    path = _write(cfg, tmp_path / "noclip.yaml")
    runner = _runner(path, tmp_path, lr_values=[1e-3, 1e6])
    assert runner.run().config.lr == 1e-3
    by_lr = {r["config"]["lr"]: r for r in _summary(runner)["results"]}
    assert by_lr[1e-3]["status"] == "ok" and by_lr[1e6]["status"] == "error"
    assert "non-finite" in by_lr[1e6]["message"]
    assert all(r["duration_sec"] > 0 for r in by_lr.values())
    alone = _runner(path, tmp_path, "alone", lr_values=[1e-3])
    alone.run()
    assert _summary(alone)["results"][0]["metric"] == pytest.approx(by_lr[1e-3]["metric"],
                                                                     rel=1e-6)


def test_early_stop_masks_replicas(sweep_base_config, tmp_path, monkeypatch):
    """With patience 1 every replica stops and the remaining epochs are
    skipped: the message records the stop."""
    import vit_tpu_torch.train.optim as popt

    cfg = _no_dropout(sweep_base_config, tmp_path, ep=30)
    path = _write(cfg, tmp_path / "es.yaml")
    real = popt.EarlyStopping.__init__

    def tiny_patience(es, patience=100, mode="min", divergence_threshold=None):
        real(es, patience=1, mode=mode, divergence_threshold=divergence_threshold)

    monkeypatch.setattr(popt.EarlyStopping, "__init__", tiny_patience)
    runner = _runner(path, tmp_path, lr_values=[1e-3, 0.3])
    best = runner.run()
    assert "early-stopped" in (best.message or "")
    assert runner.engine_run.epochs.replays + runner.engine_run.epochs.eager_steps < 30 * 6


def test_sweep_substitutes_xla_for_ring(sweep_base_config, tmp_path, capsys):
    with open(sweep_base_config) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["attn_impl"] = "ring"
    cfg["train"].update(ep=1, pipeline_parallel=2)
    runner = _runner(_write(cfg, tmp_path / "ring.yaml"), tmp_path, lr_values=[1e-3])
    assert runner.run().metric is not None
    out = capsys.readouterr().out
    assert "ring -> xla" in out and "pipeline_parallel -> 1" in out


def test_per_replica_shuffles(sweep_base_config, tmp_path, monkeypatch):
    """Two replicas at the same lr gather their own batch orders (seed +
    idx), train differently, and the sweep reproduces bit for bit."""
    seen = []
    real = psweep.epoch_permutation

    def spy(n, batch_size, steps, seed, epoch):
        out = real(n, batch_size, steps, seed, epoch)
        seen.append((seed, epoch, out.copy()))
        return out

    monkeypatch.setattr(psweep, "epoch_permutation", spy)
    first = _runner(sweep_base_config, tmp_path, "a", lr_values=[1e-3, 1e-3])
    first.run()
    by_epoch = {}
    for seed, epoch, perm in seen:
        by_epoch.setdefault(epoch, []).append((seed, perm))
    assert set(by_epoch) == {0, 1}
    for entries in by_epoch.values():
        assert [s for s, _ in entries] == [0, 1]
        assert not np.array_equal(entries[0][1], entries[1][1])
    metrics = [r["metric"] for r in _summary(first)["results"]]
    assert metrics[0] != metrics[1]
    again = _runner(sweep_base_config, tmp_path, "b", lr_values=[1e-3, 1e-3])
    again.run()
    assert [r["metric"] for r in _summary(again)["results"]] == metrics


def test_sweep_preemption_stops_at_epoch_boundary(sweep_base_config, tmp_path, monkeypatch,
                                                  capsys):
    from vit_tpu_torch.train.preempt import PreemptionGuard

    real = psweep._VmapSweepEngine.run

    def patched(self):
        guard = PreemptionGuard(enabled=False)
        guard.triggered = True  # as if SIGTERM landed during epoch 0
        self.preempt_guard = guard
        return real(self)

    monkeypatch.setattr(psweep._VmapSweepEngine, "run", patched)
    runner = _runner(sweep_base_config, tmp_path, lr_values=[1e-4, 1e-3])
    assert runner.run().metric is not None
    assert "preemption stop at epoch 0" in capsys.readouterr().out
    results = _summary(runner)["results"]
    assert len(results) == 2
    for r in results:
        assert r["status"] == "ok" and "preemption stop" in r["message"]
        assert r["metric"] is not None


def test_engine_resolves_warmup_from_config(sweep_base_config, tmp_path, monkeypatch):
    with open(sweep_base_config) as f:
        cfg = yaml.safe_load(f)
    cfg["warmup"] = {"epochs": 1}
    seen = []
    real = psweep.sweep_epoch_scales

    def spy(configs, epoch, warmup_epochs, plateau_scales, max_epochs):
        seen.append((epoch, warmup_epochs))
        return real(configs, epoch, warmup_epochs, plateau_scales, max_epochs)

    monkeypatch.setattr(psweep, "sweep_epoch_scales", spy)
    runner = _runner(_write(cfg, tmp_path / "warm.yaml"), tmp_path, lr_values=[1e-3, 1e-2])
    assert runner.run() is not None
    assert seen and all(w == 1 for _, w in seen) and {e for e, _ in seen} == {0, 1}


def test_run_test_and_failed_dispatch(sweep_base_config, tmp_path, monkeypatch):
    """--run-test adds each ok replica's test metric to its message; a step
    that raises marks the active replicas 'error' and keeps the artifacts'
    schema (every trial failed: the runner raises, as vit_tpu's)."""
    runner = _runner(sweep_base_config, tmp_path, lr_values=[1e-3], skip_test=False)
    assert "test_mae=" in runner.run().message
    from vit_tpu_torch.train.fused import ReplicaEpochs

    def boom(self):
        raise RuntimeError("device lost")

    monkeypatch.setattr(ReplicaEpochs, "run_step", boom)
    failing = _runner(sweep_base_config, tmp_path, "f", lr_values=[1e-3, 1e-2])
    with pytest.raises(RuntimeError, match="All trials failed"):
        failing.run()


def test_lbfgs_and_stream_dropout_sweep_end_to_end(sweep_base_config, tmp_path):
    """The two settings the engine once refused: opt.type lbfgs, and
    model.fast_dropout: false with dropout on (each replica's nn.Dropout
    masks from its 0-d site seeds). Each sweeps to ok replicas in
    vit_tpu's schema; with both, the dropout streams still differ by replica
    seed, so a second run is bit-equal and one without dropout is not."""
    with open(sweep_base_config) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["fast_dropout"] = False
    cfg["model"].update(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                        attn_impl="xla")
    results = {}
    for name, opt in (("stream", "AdamW"), ("lbfgs", "lbfgs")):
        c = copy.deepcopy(cfg)
        c["opt"]["type"] = opt
        runner = _runner(_write(c, tmp_path / f"{name}.yaml"), tmp_path, name,
                         lr_values=[1e-4, 1e-3])
        assert runner.run() is not None
        rows = _summary(runner)["results"]
        assert [r["status"] for r in rows] == ["ok", "ok"]
        results[name] = [r["metric"] for r in rows]
    again = _runner(_write(cfg, tmp_path / "again.yaml"), tmp_path, "again",
                    lr_values=[1e-4, 1e-3])
    again.run()
    assert [r["metric"] for r in _summary(again)["results"]] == results["stream"]
    off = copy.deepcopy(cfg)
    off["model"].update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    plain = _runner(_write(off, tmp_path / "off.yaml"), tmp_path, "off", lr_values=[1e-4, 1e-3])
    plain.run()
    assert [r["metric"] for r in _summary(plain)["results"]] != results["stream"]


def test_image_config_sweep_end_to_end(tmp_path):
    """The engine sweeps anything Experiment accepts: an image config (the
    synthetic images of vit_tpu's fallback) ranks by val_acc."""
    cfg = {
        "project": "vit-tpu-test",
        "model": {"name": "vit", "task_type": "cls", "input_kind": "image", "image_size": 16,
                  "patch_size": 8, "hidden_size": 32, "num_hidden_layers": 1,
                  "num_attention_heads": 2, "num_labels": 4, "num_channels": 3,
                  "pos_encoding_type": "learned", "attn_impl": "flash", "fused_mlp": True},
        "train": {"batch_size": 16, "ep": 2, "save": False},
        "loss": {"name": "ce"},
        "opt": {"type": "AdamW", "lr": 1e-3, "lr_sch": "none"},
        "data": {"num_samples": 64},
        "noise": {"noise_level": 0},
        "viz": {"enable": False},
    }
    runner = _runner(_write(cfg, tmp_path / "img.yaml"), tmp_path, lr_values=[1e-3, 1e-2],
                     metric_name="val_acc", metric_goal="maximize")
    best = runner.run()
    assert best is not None and best.metric is not None
    results = _summary(runner)["results"]
    assert len(results) == 2 and all(r["status"] == "ok" for r in results)
    # The default val_mae on a cls config ranks by val_acc, as vit_tpu's does.
    mae = _runner(_write(cfg, tmp_path / "img2.yaml"), tmp_path, "mae", lr_values=[1e-3])
    assert mae.run().metric == pytest.approx(results[0]["metric"])
