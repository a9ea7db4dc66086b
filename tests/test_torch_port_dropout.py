"""The port's hash dropout against vit_tpu's, bit for bit; and its
``nn.Dropout`` streams (``model.fast_dropout: false``) against flax's
``nn.Dropout`` in distribution.

Both hash masks come from an int32 seed and each element's coordinates;
the same seed must give the same mask (vit_tpu's flax-key seed derivation
cannot be reproduced, so the parity is per seed). No tolerance: the masks
and the dropped tensors are compared for equality. The stream masks come
from each framework's own generator: their keep share must lie within 4
standard deviations of 1 - rate, and kept values are x / (1 - rate)
exactly, the divisor rounded to x's dtype as flax rounds it.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops import dropout as ref
from vit_tpu_torch.ops import dropout as port

ref_fa = importlib.import_module("vit_tpu.ops.flash_attention")

SEEDS = [0, -1, 2**31 - 1, -(2**31), 1234567, -987654321]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape, offsets", [
    ((4096,), None),
    ((7,), (2**31 - 5,)),
    ((3, 5), (2, -3)),
    ((2, 3, 4), None),
    ((2, 2, 3, 5), (0, 1, None, 4096)),
    ((2, 2, 3, 5, 1), None),
    ((2, 1, 2, 3, 2, 2), (1, 2, 3, 4, 5, 6)),
])
def test_hash_keep_mask_is_vit_tpus(seed, shape, offsets):
    want = np.asarray(ref.hash_keep_mask(shape, 0.3, jnp.int32(seed), offsets))
    got = port.hash_keep_mask(shape, 0.3, seed, offsets).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_dropout_is_vit_tpus(rate, dtype):
    x = np.random.default_rng(0).standard_normal((3, 33, 16)).astype(np.float32)
    for seed in SEEDS[:3] + [int(np.random.default_rng(1).integers(-2**31, 2**31))]:
        want = np.asarray(ref.hash_dropout(jnp.asarray(x, dtype), rate, jnp.int32(seed))
                          .astype(jnp.float32))
        got = port.hash_dropout(torch.from_numpy(x).to(getattr(torch, dtype)), rate, seed)
        assert np.array_equal(got.float().numpy(), want)


def test_hash_dropout_edge_rates():
    x = torch.ones(4, 5)
    assert port.hash_dropout(x, 0.0, 3) is x
    assert torch.equal(port.hash_dropout(x, 1.0, 3), torch.zeros(4, 5))


@pytest.mark.parametrize("seed", SEEDS[:3] + [int(np.random.default_rng(2).integers(0, 2**31))])
def test_attention_mask_is_vit_tpus(seed):
    # scalar bh up to 31; the full T = 4066 by 4096 coordinates at bh = 31
    for bh, t in ((0, 300), (7, 300), (31, 4066)):
        want = np.asarray(ref_fa.hash_dropout_mask(t, 4096, bh, jnp.int32(seed), 0.1))
        got = port.hash_dropout_mask(t, 4096, bh, seed, 0.1).numpy()
        assert np.array_equal(got, want)
    # a (BH,) vector of heads adds a leading dimension
    heads = np.arange(32, dtype=np.int32)
    want = np.asarray(ref_fa.hash_dropout_mask(129, 129, jnp.asarray(heads), jnp.int32(seed), 0.5))
    got = port.hash_dropout_mask(129, 129, torch.from_numpy(heads), seed, 0.5).numpy()
    assert got.shape == (32, 129, 129) and np.array_equal(got, want)


@pytest.mark.parametrize("rate", [0.0, 1e-9, 0.1, 0.5, 0.999999])
def test_keep_threshold_is_vit_tpus(rate):
    threshold, inv_keep = port.keep_params(rate)
    assert threshold == int(ref_fa._keep_threshold(rate))
    assert inv_keep == 1.0 / (1.0 - rate)


# -- nn.Dropout streams (fast_dropout: false) -------------------------------------
def _within_4_sigma(share, keep, n):
    return abs(share - keep) <= 4 * np.sqrt(keep * (1 - keep) / n)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_dropout_keep_share_and_scaling_match_flax(rate, dtype):
    import jax
    from flax import linen as nn

    x = torch.rand(64, 129, 32, generator=torch.Generator().manual_seed(0)) + 0.5
    x = x.to(dtype)
    got = port.stream_dropout(x, rate, 77)
    kept = got != 0
    n, keep = x.numel(), 1.0 - rate
    assert _within_4_sigma(kept.float().mean().item(), keep, n)
    scale = torch.tensor(keep, dtype=dtype)  # flax divides in x's dtype
    assert torch.equal(got[kept], (x / scale)[kept])
    assert torch.equal(port.stream_dropout(x, rate, 77), got)  # the seed fixes the mask
    assert not torch.equal(port.stream_dropout(x, rate, 78) != 0, kept)
    jdt = jax.numpy.bfloat16 if dtype == torch.bfloat16 else jax.numpy.float32
    jx = jax.numpy.asarray(x.float().numpy(), jdt)
    want = np.asarray(nn.Dropout(rate).apply({}, jx, deterministic=False,
                                             rngs={"dropout": jax.random.PRNGKey(0)})
                      .astype(jax.numpy.float32))
    jkept = want != 0
    assert _within_4_sigma(jkept.mean(), keep, n)
    np.testing.assert_array_equal(want[jkept], (x / scale).float().numpy()[jkept])


def test_stream_dropout_edge_rates_and_dispatch():
    x = torch.ones(3, 4)
    assert port.stream_dropout(x, 0.0, 1) is x
    assert torch.equal(port.stream_dropout(x, 1.0, 1), torch.zeros_like(x))
    assert torch.equal(port.site_dropout(x, 0.5, -5, fast=True), port.hash_dropout(x, 0.5, -5))
    assert torch.equal(port.site_dropout(x, 0.5, -5, fast=False),
                       port.stream_dropout(x, 0.5, -5))


def _slow_model(remat, impl="flash", fast=False):
    from vit_tpu_torch.models.builder import get_model

    cfg = {"model": dict(name="vit", task_type="reg", image_size=256, patch_size=16,
                         hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                         stride_size=8, attn_impl=impl, fast_dropout=fast, remat=remat),
           "data": {"param": "log_g"}}
    return get_model(cfg, generator=torch.Generator().manual_seed(5)).module.train()


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_stream_masks_survive_remat(impl):
    """fast_dropout: false with remat: each site's generator is seeded from
    its own seed, so the recomputed forward draws the same masks: the loss
    and every gradient equal the run without remat; other seeds differ."""
    from vit_tpu_torch.models.vit import compute_loss

    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 256)).astype(np.float32))
    y = torch.rand(4, 1, generator=torch.Generator().manual_seed(4))

    def run(remat, seeds):
        m = _slow_model(remat, impl)
        loss = compute_loss(m(x, dropout_seeds=seeds), y, "reg", "mae")
        loss.backward()
        return loss.item(), [p.grad.clone() for p in m.parameters()]

    seeds = list(range(200, 200 + _slow_model(False).num_dropout_sites))
    base = run(False, seeds)
    for remat in ("mlp", True):
        other = run(remat, seeds)
        assert other[0] == base[0]
        assert all(torch.equal(a, b) for a, b in zip(other[1], base[1]))
    assert run(False, [s + 1 for s in seeds])[0] != base[0]
    fast = _slow_model(False, impl, fast=True)
    assert compute_loss(fast(x, dropout_seeds=seeds), y, "reg", "mae").item() != base[0]


def test_flash_route_keeps_the_hash_mask_for_the_probabilities():
    """On the flash route the probabilities' dropout is the kernels' hash mask
    whatever fast_dropout says; the xla route draws it from the stream."""
    from vit_tpu_torch.models.attention import MultiHeadSelfAttention

    x = torch.randn(2, 40, 32, generator=torch.Generator().manual_seed(0))
    out = {}
    for impl in ("flash", "xla"):
        for fast in (True, False):
            mod = MultiHeadSelfAttention(32, 2, impl=impl, dropout_rate=0.5,
                                         out_dropout_rate=0.0, fast_dropout=fast)
            for p in mod.parameters():
                torch.nn.init.normal_(p, std=0.3, generator=torch.Generator().manual_seed(1))
            out[impl, fast] = mod.train()(x, seeds=(11, 12))
    assert torch.equal(out["flash", True], out["flash", False])
    assert not torch.allclose(out["xla", False], out["xla", True], atol=1e-3)
