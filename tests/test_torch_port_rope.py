"""RoPE in the port against vit_tpu's: the tables and rotation, attention with
rotated q and k on each route, and the whole SpecViT with each position
encoding (logits and every parameter gradient).

vit_tpu's flash route runs its plain XLA math on the CPU, as its own model
tests run it; the port's takes its plain PyTorch version for CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.models import rope as jrope
from vit_tpu.models.attention import MultiHeadSelfAttention as JaxAttention
from vit_tpu.models.builder import get_model as jax_get_model
from vit_tpu.train.torch_bridge import to_torch_state_dict
from vit_tpu_torch.models import rope
from vit_tpu_torch.models.attention import MultiHeadSelfAttention
from vit_tpu_torch.models.builder import get_model
from vit_tpu_torch.train.torch_bridge import from_flax_params

TABLE_TOL = 1e-6  # fp32 tables and rotation: the same operations in the same order
FP32_TOL = 1e-5
# bf16: both rotate in bf16 with tables cast first; the attention products
# round in different places (one bf16 ulp of outputs of size ~0.1-1).
BF16_TOL = 2e-2


@pytest.mark.parametrize("t, dim", [(8, 16), (129, 16), (600, 64), (33, 128)])
def test_tables_and_rotation_match_vit_tpu(t, dim):
    cos, sin = rope.rope_tables(t, dim)
    jcos, jsin = jrope.rope_tables(t, dim)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=TABLE_TOL, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=TABLE_TOL, rtol=0)
    rng = np.random.default_rng(t)
    q, k = (rng.standard_normal((2, 3, t, dim)).astype(np.float32) for _ in range(2))
    got = rope.apply_rope_qk(torch.from_numpy(q), torch.from_numpy(k), base=500.0)
    want = jrope.apply_rope_qk(jnp.asarray(q), jnp.asarray(k), base=500.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TABLE_TOL, rtol=0)


def test_bf16_tables_are_cast_before_the_rotation():
    cos, sin = rope.rope_tables(64, 32, dtype=torch.bfloat16)
    jcos, jsin = jrope.rope_tables(64, 32, dtype=jnp.bfloat16)
    assert cos.dtype == sin.dtype == torch.bfloat16
    assert np.array_equal(cos.float().numpy(), np.asarray(jcos.astype(jnp.float32)))
    assert np.array_equal(sin.float().numpy(), np.asarray(jsin.astype(jnp.float32)))
    x = np.random.default_rng(0).standard_normal((2, 64, 32)).astype(np.float32)
    got = rope.apply_rope(torch.from_numpy(x).bfloat16(), cos, sin).float().numpy()
    want = np.asarray(jrope.apply_rope(jnp.asarray(x, jnp.bfloat16), jcos, jsin)
                      .astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=2**-7 * np.abs(want).max(), rtol=0)


def test_rope_rotation_identities():
    """Position 0 is the identity; norms are kept (tests/test_models.py)."""
    cos, sin = rope.rope_tables(8, 16)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8, 16)).astype(np.float32))
    y = rope.apply_rope(x, cos, sin)
    np.testing.assert_allclose(y[:, 0].numpy(), x[:, 0].numpy(), atol=1e-6)
    np.testing.assert_allclose(y.norm(dim=-1).numpy(), x.norm(dim=-1).numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="even"):
        rope.rope_tables(8, 15)


def test_rope_relative_property():
    """q_m . k_n depends on the positions only through m - n."""
    dim = 32
    cos, sin = rope.rope_tables(16, dim)
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 1, dim)).astype(np.float32)).expand(1, 16, dim)
    k = torch.from_numpy(rng.standard_normal((1, 1, dim)).astype(np.float32)).expand(1, 16, dim)
    dots = torch.einsum("bqd,bkd->bqk", rope.apply_rope(q, cos, sin),
                        rope.apply_rope(k, cos, sin))[0].numpy()
    np.testing.assert_allclose(dots[3, 1], dots[7, 5], rtol=1e-4)
    np.testing.assert_allclose(dots[2, 6], dots[5, 9], rtol=1e-4)


def _attention_both(impl, t, dtype, fused_qkv=False, hidden=64, heads=2, seed=0):
    """(port output, vit_tpu output) of one RoPE attention block, eval mode."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jmod = JaxAttention(hidden_size=hidden, num_heads=heads, use_rope=True, rope_base=10000.0,
                        impl=impl, dtype=jdt, fused_qkv=fused_qkv)
    x = np.random.default_rng(seed).standard_normal((2, t, hidden)).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(seed), x[:1])["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))
    mod = MultiHeadSelfAttention(hidden, heads, impl=impl, dtype=dtype, use_rope=True,
                                 fused_qkv=fused_qkv, out_dropout_rate=0.0)
    sd = {}
    for src, dst in (("query", "attention.query"), ("key", "attention.key"),
                     ("value", "attention.value"), ("out", "output.dense")):
        sd[f"{dst}.weight"] = torch.from_numpy(np.array(params[src]["kernel"]).T.copy())
        sd[f"{dst}.bias"] = torch.from_numpy(np.array(params[src]["bias"]))
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = mod.eval()(torch.from_numpy(x)).float().numpy()
    return got, want


@pytest.mark.parametrize("impl, t, fused_qkv", [("xla", 33, False), ("xla", 129, True),
                                                ("flash", 129, False), ("flash", 600, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_attention_matches_vit_tpu(impl, t, fused_qkv, dtype):
    got, want = _attention_both(impl, t, dtype, fused_qkv)
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_rope_changes_attention_and_capture_sees_rotated_qk():
    """Rotating q and k changes the output; the capture route (xla math under
    the flash impl) gives the same output as the flash route."""
    mod = MultiHeadSelfAttention(32, 2, impl="flash", use_rope=True, out_dropout_rate=0.0)
    for p in mod.parameters():
        torch.nn.init.normal_(p, std=0.3, generator=torch.Generator().manual_seed(p.numel()))
    x = torch.randn(2, 50, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        flash = mod.eval()(x)
        captured = {}
        xla = mod(x, capture=captured)
        mod.use_rope = False
        plain = mod(x)
    np.testing.assert_allclose(flash.numpy(), xla.numpy(), atol=FP32_TOL, rtol=0)
    assert captured["attention_probs"].shape == (2, 50, 50)
    assert (flash - plain).abs().max().item() > 100 * FP32_TOL


def _spec_config(pos, attn_impl="flash", precision="float32"):
    return {"model": dict(name="vit", task_type="reg", image_size=256, patch_size=16,
                          hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                          stride_size=8, proj_fn="SW", attn_impl=attn_impl,
                          pos_encoding_type=pos, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0),
            "train": {"precision": precision}, "data": {"param": "log_g"},
            "loss": {"name": "mae"}}


@pytest.mark.parametrize("pos", [None, "learned", "rope"])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_specvit_logits_and_grads_match_vit_tpu(pos, attn_impl):
    """SpecViT logits (1e-4) and every parameter gradient, per tensor
    ||port - jax|| <= 1e-4 of the larger of ||jax|| and 1e-3 of the global
    norm (the key bias's gradient is zero in exact arithmetic). The port
    loads vit_tpu's weights through to_torch_state_dict with strict=True."""
    from vit_tpu.models.vit import compute_loss as jax_loss
    from vit_tpu_torch.models.vit import compute_loss

    cfg = _spec_config(pos, attn_impl)
    jb = jax_get_model(dict(cfg, model=dict(cfg["model"])))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    y = rng.random((3, 1)).astype(np.float32)
    params = jb.module.init(jax.random.PRNGKey(3), x[:1])["params"]
    logits = np.asarray(jb.module.apply({"params": params}, x))

    def loss_fn(p):
        return jax_loss(jb.module.apply({"params": p}, x, deterministic=False,
                                        rngs={"dropout": jax.random.PRNGKey(1)}),
                        y, "reg", "mae")

    jl, jg = jax.value_and_grad(loss_fn)(params)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tb = get_model(dict(cfg, model=dict(cfg["model"])))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in to_torch_state_dict(np_params, jb.vit_config).items()}
    tb.module.load_state_dict(sd, strict=True)
    for k, v in from_flax_params(np_params, tb.vit_config).items():
        assert torch.equal(v, sd[k]), k
    with torch.no_grad():
        got = tb.module.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, logits, atol=1e-4, rtol=0)
    loss = compute_loss(tb.module.train()(torch.from_numpy(x)), torch.from_numpy(y), "reg", "mae")
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-6
    want = to_torch_state_dict(jax.tree_util.tree_map(np.asarray, jg), jb.vit_config)
    grads = {k: p.grad.numpy() for k, p in tb.module.named_parameters()}
    assert set(grads) == set(want)
    total = np.sqrt(sum(np.sum(np.asarray(w) ** 2) for w in want.values()))
    for k, g in grads.items():
        w = np.asarray(want[k])
        assert np.linalg.norm(g - w) <= 1e-4 * max(np.linalg.norm(w), 1e-3 * total), k


def test_specvit_rope_bf16_matches_vit_tpu():
    cfg = _spec_config("rope", "flash", "bf16")
    jb = jax_get_model(dict(cfg, model=dict(cfg["model"])))
    x = np.random.default_rng(9).standard_normal((3, 256)).astype(np.float32)
    params = jb.module.init(jax.random.PRNGKey(4), x[:1])["params"]
    want = np.asarray(jb.module.apply({"params": params}, x))
    tb = get_model(dict(cfg, model=dict(cfg["model"])))
    tb.module.load_state_dict(from_flax_params(jax.tree_util.tree_map(np.asarray, params),
                                               tb.vit_config), strict=True)
    with torch.no_grad():
        got = tb.module.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)  # test_torch_port_model's bf16 limit
