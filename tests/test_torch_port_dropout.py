"""The port's hash dropout against vit_tpu's, bit for bit.

Both draw a keep mask from an int32 seed and each element's coordinates;
the same seed must give the same mask (vit_tpu's flax-key seed derivation
cannot be reproduced, so the parity is per seed). No tolerance: the masks
and the dropped tensors are compared for equality.
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
