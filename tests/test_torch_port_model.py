"""The port's SpecViT against vit_tpu's, with weights carried by from_flax_params.

Both models see the same numpy inputs. vit_tpu's flash and fused-MLP paths
run their plain XLA math on the CPU; the port's take their plain PyTorch
versions for CPU tensors.
"""

import jax
import numpy as np
import pytest
import torch

from vit_tpu.models.builder import get_model as jax_get_model
from vit_tpu.train.torch_bridge import to_torch_state_dict
from vit_tpu_torch.models.builder import get_model
from vit_tpu_torch.train.torch_bridge import from_flax_params

FP32_TOL = 1e-4
# bf16 rounds after every product and LayerNorm in both frameworks, but not
# always at the same place (XLA fuses some casts away, torch's GELU rounds
# once where XLA may round per op). Measured gap on these inputs: at most
# 1.2e-3 on logits of size 0.03-0.2 (seeds 0-2); the limit leaves 8x room.
BF16_TOL = 1e-2


def _config(hidden=32, heads=2, layers=2, image_size=256, patch=16, stride=8,
            proj="SW", precision="float32", task="reg", **model):
    return {
        "model": dict(name="vit", task_type=task, image_size=image_size, patch_size=patch,
                      hidden_size=hidden, num_hidden_layers=layers,
                      num_attention_heads=heads, stride_size=stride, proj_fn=proj,
                      **model),
        "train": {"precision": precision},
        "data": {"param": "log_g"},
    }


def _both(cfg, batch=3, seed=0):
    """(jax logits, port logits, vit_config) on one input."""
    jb = jax_get_model(dict(cfg, model=dict(cfg["model"])))
    vc = jb.vit_config
    x = np.random.default_rng(seed).standard_normal((batch, vc.image_size)).astype(np.float32)
    params = jb.module.init(jax.random.PRNGKey(seed), x[:1])["params"]
    ref = np.asarray(jb.module.apply({"params": params}, x, deterministic=True), np.float32)
    tb = get_model(dict(cfg, model=dict(cfg["model"])))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tb.module.load_state_dict(from_flax_params(np_params, tb.vit_config), strict=True)
    with torch.no_grad():
        got = tb.module.eval()(torch.from_numpy(x)).float().numpy()
    return ref, got, vc


CASES = {
    "sw_xla_h32": dict(attn_impl="xla"),
    "sw_flash_h32": dict(attn_impl="flash"),
    "sw_flash_fused_mlp_qkv_h128": dict(hidden=128, attn_impl="flash", fused_mlp=True,
                                        fused_qkv=True),
    "sw_xla_fused_mlp_h128": dict(hidden=128, attn_impl="xla", fused_mlp=True),
    "c1d_xla_fused_qkv_h32": dict(proj="C1D", attn_impl="xla", fused_qkv=True),
    "c1d_flash_h128": dict(proj="C1D", hidden=128, attn_impl="flash"),
    "lin_flash_fused_mlp_h32": dict(proj="LIN", attn_impl="flash", fused_mlp=True),
    "lin_auto_learned_pos_cls_h32": dict(proj="LIN", pos_encoding_type="learned", num_labels=3,
                                         task="cls"),
    "sw_flash_streaming_t586": dict(image_size=600, stride=1, attn_impl="flash"),
    "sw_auto_no_qkv_bias_h128": dict(hidden=128, qkv_bias=False, gelu_approximate=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_logits_match_vit_tpu_fp32(name):
    ref, got, vc = _both(_config(**CASES[name]))
    assert got.shape == ref.shape == (3, vc.num_labels)
    np.testing.assert_allclose(got, ref, atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("fused_mlp", [False, True])
def test_logits_match_vit_tpu_bf16(fused_mlp):
    ref, got, _ = _both(_config(hidden=128, precision="bf16", attn_impl="flash",
                                   fused_mlp=fused_mlp))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=BF16_TOL, rtol=0)


@pytest.mark.parametrize("name", ["sw_flash_fused_mlp_qkv_h128", "c1d_xla_fused_qkv_h32",
                                  "lin_auto_learned_pos_cls_h32", "sw_auto_no_qkv_bias_h128"])
def test_state_dict_keys_equal_bridge_keys(name):
    cfg = _config(**CASES[name])
    jb = jax_get_model(dict(cfg, model=dict(cfg["model"])))
    params = jb.module.init(jax.random.PRNGKey(0), np.zeros((1, jb.vit_config.image_size)))
    keys = set(to_torch_state_dict(params["params"], jb.vit_config))
    port = get_model(dict(cfg, model=dict(cfg["model"]))).module
    assert set(port.state_dict()) == keys


def test_stride1_width_and_seeded_init():
    """stride1.yaml's shapes: 4066 tokens, MLP 128 -> 512, auto -> flash."""
    cfg = _config(hidden=128, layers=1, image_size=4096, patch=32, stride=1)
    a = get_model(dict(cfg, model=dict(cfg["model"])), generator=torch.Generator().manual_seed(3))
    b = get_model(dict(cfg, model=dict(cfg["model"])), generator=torch.Generator().manual_seed(3))
    vc = a.vit_config
    assert vc.seq_len == 4066 and vc.intermediate_size == 512 and vc.head_dim == 64
    layer = a.module.vit.encoder.layer[0]
    assert layer.intermediate.dense.weight.shape == (512, 128)
    for (ka, va), (kb, vb) in zip(a.module.state_dict().items(), b.module.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert float(a.module.vit.embeddings.cls_token.detach().std()) > 0.5  # N(0, 1), not 0.02


# -- training mode -----------------------------------------------------------
def _grads_both(cfg, batch=3, seed=0):
    """(jax loss, port loss, {key: (port grad, jax grad)}) with dropout off,
    the 'mae' loss name (which trains MSE in both)."""
    from vit_tpu.models.vit import compute_loss as jax_loss
    from vit_tpu_torch.models.vit import compute_loss

    cfg = dict(cfg, loss={"name": "mae"},
               model=dict(cfg["model"], hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    jb = jax_get_model(dict(cfg, model=dict(cfg["model"])))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, jb.vit_config.image_size)).astype(np.float32)
    y = rng.random((batch, 1)).astype(np.float32)
    params = jb.module.init(jax.random.PRNGKey(seed), x[:1])["params"]

    def loss_fn(p):
        logits = jb.module.apply({"params": p}, x, deterministic=False,
                                 rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_loss(logits, y, "reg", "mae")

    jl, jg = jax.value_and_grad(loss_fn)(params)
    want = to_torch_state_dict(jax.tree_util.tree_map(np.asarray, jg), jb.vit_config)
    tb = get_model(dict(cfg, model=dict(cfg["model"])))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tb.module.load_state_dict(from_flax_params(np_params, tb.vit_config), strict=True)
    tb.module.train()
    loss = compute_loss(tb.module(torch.from_numpy(x)), torch.from_numpy(y), "reg", "mae")
    loss.backward()
    got = {k: p.grad.numpy() for k, p in tb.module.named_parameters()}
    assert set(got) == set(want)
    return float(jl), loss.item(), {k: (got[k], np.asarray(want[k])) for k in got}


GRAD_CASES = {  # remat "mlp" is held against no remat, dropout on, below
    "xla": dict(attn_impl="xla"),
    "flash_fused_mlp": dict(attn_impl="flash", fused_mlp=True),
    "flash_remat_layer": dict(attn_impl="flash", remat=True),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_parameter_grads_match_vit_tpu_fp32(name):
    """Every parameter gradient against jax.grad of vit_tpu's loss. Per
    tensor, ||port - jax|| <= 1e-4 of the larger of ||jax|| and 1e-3 of the
    global gradient norm: the floor covers gradients that are zero in exact
    arithmetic (the key bias: softmax ignores a per-row constant), which
    both compute as ~1e-12 noise."""
    jl, pl, grads = _grads_both(_config(**GRAD_CASES[name]))
    assert abs(jl - pl) <= 1e-6
    total = np.sqrt(sum(np.sum(w**2) for _, w in grads.values()))
    for key, (g, w) in grads.items():
        err = np.linalg.norm(g - w)
        assert err <= 1e-4 * max(np.linalg.norm(w), 1e-3 * total), (key, err, np.linalg.norm(w))


def test_dropout_masks_follow_the_seeds_and_survive_remat():
    """In training mode the same seeds give the same loss and gradients, with
    or without activation checkpointing (a recomputed forward draws the same
    hash masks); other seeds give another loss."""
    from vit_tpu_torch.models.vit import compute_loss

    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 256)).astype(np.float32))
    y = torch.rand(4, 1, generator=torch.Generator().manual_seed(4))

    def run(remat, impl, seeds):
        m = get_model(_config(attn_impl=impl, fused_mlp=True, remat=remat),
                      generator=torch.Generator().manual_seed(5)).module.train()
        loss = compute_loss(m(x, dropout_seeds=seeds), y, "reg", "mae")
        loss.backward()
        return loss.item(), [p.grad.clone() for p in m.parameters()]

    m0 = get_model(_config()).module
    seeds = list(range(100, 100 + m0.num_dropout_sites))
    assert m0.num_dropout_sites == 1 + 3 * 2
    for impl in ("flash", "xla"):
        base = run(False, impl, seeds)
        for remat in ("mlp", True):
            other = run(remat, impl, seeds)
            assert other[0] == base[0]
            assert all(torch.equal(a, b) for a, b in zip(other[1], base[1]))
        assert run(False, impl, [s + 1 for s in seeds])[0] != base[0]
    with pytest.raises(ValueError, match="dropout_seeds"):
        m0.train()(x)
    assert m0.eval()(x).shape == (4, 1)  # eval needs no seeds
