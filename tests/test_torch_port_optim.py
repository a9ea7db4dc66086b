"""The port's optimizers against vit_tpu's, which are optax's: every name of
``opt.type`` over five steps with and without weight decay, the learning
rate set before each step as the training step sets it; the fallback and
"no effect" messages; ``opt.moment_dtype`` (tests/test_optim.py:158-230).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_tpu.train import optim as jopt
from vit_tpu_torch.train import optim as popt

NAMES = ("rmsprop", "adadelta", "adagrad", "adamax", "lbfgs", "rprop", "asgd", "sparseadam",
         "adam", "adamw", "sgd")
# Five steps of fp32 updates in the same order as optax's (adam/adamw/sgd:
# torch.optim's, which fold the bias correction differently): measured gaps
# are 0 to 5e-7 on parameters of size ~1.
PARAM_TOL = 1e-6
SHAPES = [(6,), (3, 4), (5,)]


def _run(name, wd, moment_dtype=None, steps=5):
    """(port params, vit_tpu params) after ``steps`` updates of the same
    gradients, the learning rate changed before every step."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES] for _ in range(steps)]
    lrs = [0.01 * (1.0 - 0.1 * i) for i in range(steps)]
    spec = jopt.OptSpec(lr=lrs[0], opt_type=name, weight_decay=wd, moment_dtype=moment_dtype,
                        grad_clip=0.0)
    tx = jopt.build_optimizer(spec)
    jp = [jnp.asarray(x) for x in p0]
    state = tx.init(jp)
    ps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    opt = popt.build_optimizer(popt.OptSpec(lr=lrs[0], opt_type=name, weight_decay=wd,
                                            moment_dtype=moment_dtype), ps)
    for lr, gs in zip(lrs, grads):
        state = jopt.set_learning_rate(state, jnp.asarray(lr, jnp.float32))
        upd, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g.copy())
        popt.set_learning_rate(opt, lr)
        opt.step()
    return [p.detach().numpy() for p in ps], [np.asarray(x) for x in jp], opt


@pytest.mark.parametrize("wd", [0.0, 0.05])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_vit_tpu(name, wd):
    got, want, _ = _run(name, wd)
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=PARAM_TOL, rtol=0, err_msg=f"{name} wd={wd}")


@pytest.mark.parametrize("wd", [0.0, 0.05])
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_bf16_first_moment_matches_vit_tpu(name, wd):
    """optax rounds b1 * mu in bf16 and stores mu in bf16; the port too,
    operation for operation."""
    got, want, opt = _run(name, wd, moment_dtype="bf16")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=PARAM_TOL, rtol=0, err_msg=f"{name} wd={wd}")
    assert all(st["exp_avg"].dtype == torch.bfloat16 for st in opt.state.values())


def test_fallback_and_no_effect_messages_are_vit_tpus(capsys):
    params = [torch.nn.Parameter(torch.ones(4))]
    for name, fallback in (("asgd", "sgd"), ("sparseadam", "adam")):
        opt = popt.build_optimizer(popt.OptSpec(opt_type=name), params)
        assert capsys.readouterr().out == (
            f"[optim] '{name}' has no optax equivalent; using '{fallback}'\n")
        assert isinstance(opt, torch.optim.SGD if fallback == "sgd" else torch.optim.Adam)
    jopt._core_optimizer("rmsprop", 1e-3, 0.0, "bf16")
    want = capsys.readouterr().out
    popt.build_optimizer(popt.OptSpec(opt_type="rmsprop", moment_dtype="bf16"), params)
    assert capsys.readouterr().out == want and "no effect" in want
    with pytest.raises(ValueError, match="Unknown optimizer type 'lamb'"):
        popt.build_optimizer(popt.OptSpec(opt_type="lamb"), params)


def test_moment_dtype_bf16_halves_mu_storage():
    """The first moment in bf16 takes half the bytes; the second stays fp32."""
    spec = popt.OptSpec.from_config(
        {"opt": {"type": "AdamW", "lr": 1e-3, "moment_dtype": "bf16"}, "train": {"ep": 1}},
        steps_per_epoch=1)
    assert spec.moment_dtype == "bf16"
    spec32 = popt.OptSpec.from_config({"opt": {"type": "AdamW", "lr": 1e-3},
                                       "train": {"ep": 1}}, steps_per_epoch=1)
    sizes = {}
    for key, s in (("bf16", spec), ("fp32", spec32)):
        p = torch.nn.Parameter(torch.ones(64, 64))
        opt = popt.build_optimizer(s, [p])
        p.grad = torch.full_like(p, 0.1)
        opt.step()
        st = opt.state[p]
        sizes[key] = (st["exp_avg"].nbytes, st["exp_avg_sq"].nbytes, popt.state_bytes(opt))
    assert sizes["bf16"][0] * 2 == sizes["fp32"][0] == 64 * 64 * 4
    assert sizes["bf16"][1] == sizes["fp32"][1]
    # the whole state: bf16 first moment and fp32 second; each adds a 4-byte
    # step counter per parameter (torch's AdamW, and optax's count kept on
    # the device by OptaxOptimizer)
    assert sizes["bf16"][2] == 64 * 64 * (2 + 4) + 4 and sizes["fp32"][2] == 64 * 64 * 8 + 4


def test_moment_dtype_bf16_training_step_stays_finite():
    p = torch.nn.Parameter(torch.ones(8))
    opt = popt.build_optimizer(popt.OptSpec(lr=1e-2, opt_type="adam", moment_dtype="bfloat16"),
                               [p])
    for _ in range(3):
        p.grad = torch.full((8,), 0.1)
        opt.step()
    assert torch.isfinite(p).all() and (p < 1).all()


def test_moment_dtype_inert_outside_adam_family(capsys):
    for name in ("adamax", "rmsprop", "sgd", "lbfgs"):
        p = torch.nn.Parameter(torch.ones(4))
        opt = popt.build_optimizer(popt.OptSpec(lr=1e-3, opt_type=name, moment_dtype="bf16"),
                                   [p])
        p.grad = torch.ones(4)
        opt.step()
        assert not [v for st in opt.state.values() for v in st.values()
                    if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16]
        assert "no effect" in capsys.readouterr().out, name


def test_moment_dtype_rejects_unknown():
    with pytest.raises(ValueError, match="moment_dtype"):
        popt.build_optimizer(popt.OptSpec(opt_type="adamw", moment_dtype="fp8"),
                             [torch.nn.Parameter(torch.ones(2))])
    for name in ("fp32", "float32", None):
        popt.build_optimizer(popt.OptSpec(opt_type="adamw", moment_dtype=name),
                             [torch.nn.Parameter(torch.ones(2))])


@pytest.mark.parametrize("name, moment_dtype", [("lbfgs", None), ("rprop", None),
                                                ("adagrad", None), ("adamw", "bf16")])
def test_state_dict_round_trip_resumes_exactly(name, moment_dtype):
    """A resumed optimizer (its state_dict loaded into a fresh one) continues
    as the uninterrupted one does: the checkpoint path of --ckpt last."""
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(6).astype(np.float32) for _ in range(4)]

    def fresh():
        p = torch.nn.Parameter(torch.ones(6))
        return p, popt.build_optimizer(popt.OptSpec(lr=0.05, opt_type=name,
                                                     moment_dtype=moment_dtype), [p])

    def step(p, opt, g):
        p.grad = torch.from_numpy(g.copy())
        opt.step()

    a, oa = fresh()
    for g in grads:
        step(a, oa, g)
    b, ob = fresh()
    for g in grads[:2]:
        step(b, ob, g)
    c, oc = fresh()
    with torch.no_grad():
        c.copy_(b)
    oc.load_state_dict(ob.state_dict())
    for g in grads[2:]:
        step(c, oc, g)
    assert torch.equal(a, c)
    assert all(v.dtype == w.dtype for k in ("exp_avg", "exp_avg_sq")
               for v, w in [(oa.state[a].get(k, a), oc.state[c].get(k, c))])


def test_lbfgs_uses_its_memory():
    """After the first step L-BFGS scales by the curvature pairs it keeps: on
    a quadratic it moves toward the minimum faster than its first step."""
    a = torch.diag(torch.tensor([1.0, 10.0, 100.0]))
    p = torch.nn.Parameter(torch.tensor([1.0, 1.0, 1.0]))
    opt = popt.build_optimizer(popt.OptSpec(lr=1.0, opt_type="lbfgs"), [p])
    values = []
    for _ in range(12):
        p.grad = (a @ p).detach()
        opt.step()
        values.append(float(0.5 * p.detach() @ a @ p.detach()))
    assert values[-1] < 1e-6 * values[0]
    assert opt.state[p]["count"] == 12 and int((opt.state[p]["weights"] != 0).sum()) == 10
    jax_p = jnp.ones(3)
    tx = optax.lbfgs(1.0, linesearch=None)
    st = tx.init(jax_p)
    for _ in range(12):
        u, st = tx.update(jnp.asarray(a.numpy()) @ jax_p, st, jax_p)
        jax_p = optax.apply_updates(jax_p, u)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_p), atol=1e-6, rtol=0)
    assert jax.tree_util.tree_leaves(st)  # optax's state is its own
