"""vit_tpu's fused-MLP envelope in the port: the rule, the line it prints,
``library_mlp`` (the port's ``_jnp_mlp``) against vit_tpu's ``_jnp_mlp``
and its ``jax.grad``, and the model's route on each side of the rule.

``vit_tpu`` runs its Pallas MLP only while ``(16 + 2·itemsize)·D·F`` is at
most 12 MiB (``vit_tpu/ops/fused_mlp.py:247-261``) and ``_jnp_mlp``
outside, printing one line a process; off the TPU it always runs
``_jnp_mlp``, so its model is the reference on both sides here.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.models.builder import get_model as jax_get_model
from vit_tpu.ops import fused_mlp as ref
from vit_tpu_torch.models.builder import get_model
from vit_tpu_torch.ops import fused_mlp as port
from vit_tpu_torch.train.torch_bridge import from_flax_params

FP32_TOL = 1e-5
MODEL_FP32_TOL = 1e-4  # logits, as tests/test_torch_port_model.py holds them


def _bf16_tol(want: np.ndarray, capped: bool = True) -> float:
    """The port's bf16 limit: the smaller of 2e-2 and four bf16 ulps of the
    largest value (chip_smoke.kernel_tol). The weight gradients come out
    of a cast to bf16 in both (its transpose), but the port also rounds the
    pre-activation's gradient to bf16 before the product (as a cast's
    gradient does, and K7); vit_tpu's jax.grad sums it in fp32. They part
    by up to a bf16 ulp of the largest (~5 here), so they keep the four
    ulps without the 2e-2 cap, which is for outputs of size <= 2."""
    ulps = 4 * 2.0**-8 * float(np.abs(want).max())
    return min(2e-2, ulps) if capped else ulps


def _vit_tpu_resident(d, f, dtype):
    """vit_tpu's test, as written at fused_mlp.py:252-253."""
    return (16 + 2 * jnp.dtype(dtype).itemsize) * d * f > 12 * 1024**2


@pytest.mark.parametrize("d, f, dtype, inside", [
    (384, 1536, torch.bfloat16, True),   # ViT-S/16 bf16: 11.25 MiB
    (384, 1536, torch.float32, False),   # ViT-S/16 fp32: 14.2 MB
    (768, 3072, torch.bfloat16, False),  # ViT-B/16: 47 MB
    (1024, 4096, torch.bfloat16, False),  # ViT-L/16: 84 MB
    (128, 512, torch.float32, True),     # the spectra configs
    (384, 1638, torch.bfloat16, True),   # 12,579,840 B: one step under 12 MiB
    (384, 1639, torch.bfloat16, False),  # 12,587,520 B: one step over
])
def test_envelope_rule_is_vit_tpus(d, f, dtype, inside):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    assert port.in_envelope(d, f, dtype) is inside
    assert _vit_tpu_resident(d, f, jdt) is not inside
    assert port.resident_bytes(d, f, dtype) == (16 + 2 * jnp.dtype(jdt).itemsize) * d * f


def _operands(r, d, f, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((r, d)).astype(np.float32),
            (rng.standard_normal((d, f)) * 0.5 / np.sqrt(d)).astype(np.float32),
            (rng.standard_normal(f) * 0.1).astype(np.float32),
            (rng.standard_normal((f, d)) * 0.5 / np.sqrt(f)).astype(np.float32),
            (rng.standard_normal(d) * 0.1).astype(np.float32),
            rng.standard_normal((r, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_library_mlp_matches_jnp_mlp_and_its_grad(dtype):
    """Forward and every gradient, the fp32 weights cast to the compute
    dtype inside (as both models cast them): fp32 within 1e-5 (weight
    gradients: 1e-5 of their largest value), bf16 within the port's bf16
    limit (:func:`_bf16_tol`)."""
    x, w1, b1, w2, b2, dy = _operands(70, 96, 384)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def fn(x_, w1_, b1_, w2_, b2_):
        return ref._jnp_mlp(x_, w1_.astype(jdt), b1_.astype(jdt), w2_.astype(jdt),
                            b2_.astype(jdt))

    args = (jnp.asarray(x, jdt), *map(jnp.asarray, (w1, b1, w2, b2)))
    grads = jax.grad(lambda *a: (fn(*a).astype(jnp.float32) * jnp.asarray(dy)).sum(),
                     argnums=range(5))(*args)
    want = [np.asarray(fn(*args).astype(jnp.float32))]
    want += [np.asarray(g.astype(jnp.float32)) for g in grads]
    want[2], want[4] = want[2].T, want[4].T  # to nn.Linear's (out, in)

    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    ws = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
          for a in (w1.T, b1, w2.T, b2)]
    y = port.library_mlp(tx, *ws)
    assert y.dtype == dtype and y.shape == x.shape
    (y.float() * torch.from_numpy(dy)).sum().backward()
    got = [y.detach(), tx.grad] + [w.grad for w in ws]
    assert all(g.dtype == torch.float32 for g in got[2:])  # the parameters' own dtype
    for name, g, w in zip(("y", "dx", "dW1", "db1", "dW2", "db2"), got, want):
        g = g.float().numpy()
        if dtype == torch.bfloat16:
            tol = _bf16_tol(w, capped=name in ("y", "dx"))
        else:
            tol = FP32_TOL if name in ("y", "dx") else 1e-5 * max(1.0, np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)


def _config(hidden, mlp, precision="float32", layers=1, heads=2):
    return {
        "model": dict(name="vit", task_type="reg", image_size=128, patch_size=16,
                      hidden_size=hidden, intermediate_size=mlp, num_hidden_layers=layers,
                      num_attention_heads=heads, stride_size=16, proj_fn="SW",
                      fused_mlp=True, attn_impl="xla"),
        "train": {"precision": precision},
        "data": {"param": "log_g"},
    }


def _carried(cfg, seed=0):
    jb = jax_get_model(copy.deepcopy(cfg))
    x = np.random.default_rng(seed).standard_normal((3, 128)).astype(np.float32)
    params = jb.module.init(jax.random.PRNGKey(seed), x[:1])["params"]
    want = np.asarray(jb.module.apply({"params": params}, x, deterministic=True), np.float32)
    tb = get_model(copy.deepcopy(cfg))
    tb.module.load_state_dict(from_flax_params(jax.tree_util.tree_map(np.asarray, params),
                                               tb.vit_config), strict=True)
    return tb.module.eval(), x, want


def test_model_at_d768_takes_library_mlp_and_prints_vit_tpus_line(monkeypatch, capsys):
    """fused_mlp: true at ViT-B/16's width (D768, F3072) in fp32: the MLP
    leaves the kernels for library_mlp, the logits are vit_tpu's, and
    vit_tpu's line is printed once however many forwards run."""
    monkeypatch.setattr(port, "_ENVELOPE_NOTED", False)
    monkeypatch.setattr(port, "fused_mlp", lambda *a: pytest.fail("a kernel wrapper was called"))
    module, x, want = _carried(_config(768, 3072, heads=12))
    capsys.readouterr()
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
        module(torch.from_numpy(x[:1]))
    np.testing.assert_allclose(got, want, atol=MODEL_FP32_TOL, rtol=0)
    out = capsys.readouterr().out
    line = ("[fused_mlp] d=768, f=3072 exceeds the kernel's VMEM envelope "
            "(~57 MB resident); using the XLA path")
    assert out.count("[fused_mlp]") == 1 and line in out


@pytest.mark.parametrize("hidden, mlp, precision, fused", [
    (384, 1536, "bf16", True),       # ViT-S/16 in bf16: inside, the kernel's wrapper
    (384, 1536, "float32", False),   # ViT-S/16 in fp32: outside
    (64, 256, "float32", True),      # a spectra width: inside
])
def test_model_route_follows_the_envelope(monkeypatch, capsys, hidden, mlp, precision, fused):
    calls = {"fused_mlp": 0, "library_mlp": 0}
    for name in calls:
        real = getattr(port, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(port, name, counted)
    monkeypatch.setattr(port, "_ENVELOPE_NOTED", False)
    module, x, want = _carried(_config(hidden, mlp, precision, heads=hidden // 64))
    with torch.no_grad():
        got = module(torch.from_numpy(x)).float().numpy()
    assert calls == {"fused_mlp": int(fused), "library_mlp": int(not fused)}
    assert ("[fused_mlp]" in capsys.readouterr().out) is not fused
    tol = MODEL_FP32_TOL if precision == "float32" else 1e-2  # test_torch_port_model's limits
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
