"""The port's ring attention (``vit_tpu_torch.ops.ring_attention``) against
vit_tpu's, mirroring ``tests/test_ring_attention.py``.

vit_tpu runs on the 8-device virtual CPU mesh of ``conftest.py``; the port
on four gloo ranks (one process each, ``torch_ranks.Ranks``, started once
for the module). The same seeded numpy q, k, v and output cotangent go
through both; the forward and dq, dk, dv are held within 1e-5 of the
largest reference value (fp32, sums in other orders). With dropout the two
must draw the same masks: one dropped element moves an output by a whole
probability, far above the limit, and the ring's block masks are also held
bit for bit against vit_tpu's ``hash_keep_mask`` at the same offsets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import Ranks, ring
from vit_tpu.ops.dropout import hash_keep_mask as jax_keep_mask
from vit_tpu.ops.ring_attention import ring_attention as jax_ring
from vit_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vit_tpu_torch.ops import ring_attention as pr
from vit_tpu_torch.ops.dropout import hash_keep_mask
from vit_tpu_torch.parallel.mesh import make_mesh

TOL = 1e-5  # of max |reference|


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(4)
    yield r
    r.close()


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _vit_tpu(n, data, q, k, v, g, rate, seed, block_k):
    mesh = jax_make_mesh(num_devices=n * data, model_parallel=n)

    def f(q, k, v):
        return jax_ring(q, k, v, mesh=mesh, axis="model",
                        batch_axis="data" if data > 1 else None, dropout_rate=rate,
                        dropout_seed=None if seed is None else jnp.int32(seed),
                        block_k=block_k)

    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _check(results, ref):
    seen = 0
    for res in results:
        if res is None:
            continue
        rows, *got = res
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
            want = b[rows]
            err = np.abs(a - want).max() / np.abs(b).max()
            assert err < TOL, (name, err)
        seen += 1
    return seen


@pytest.mark.parametrize("n,shape", [(2, (2, 2, 256, 16)), (4, (2, 2, 256, 16)),
                                     (2, (1, 4, 512, 32)), (4, (1, 4, 512, 32))])
def test_ring_matches_vit_tpu(ranks, n, shape):
    q, k, v, g = _inputs(shape, 0)
    ref = _vit_tpu(n, 1, q, k, v, g, 0.0, None, None)
    assert _check(ranks.run(ring, n, 1, q, k, v, g, 0.0, None, None), ref) == n


def test_ring_block_without_a_power_of_two_divisor(ranks):
    """T_local = 105 = 3·5·7: block_k 64 falls to 35, three blocks a shard."""
    assert pr._pick_block(64, 105) == 35
    q, k, v, g = _inputs((1, 2, 210, 16), 3)
    ref = _vit_tpu(2, 1, q, k, v, g, 0.0, None, 64)
    assert _check(ranks.run(ring, 2, 1, q, k, v, g, 0.0, None, 64), ref) == 2


@pytest.mark.parametrize("seed", [7, -3])
def test_ring_dropout_draws_vit_tpus_masks(ranks, seed):
    q, k, v, g = _inputs((2, 2, 256, 16), 4)
    ref = _vit_tpu(4, 1, q, k, v, g, 0.3, seed, 32)
    assert _check(ranks.run(ring, 4, 1, q, k, v, g, 0.3, seed, 32), ref) == 4


def test_ring_data_times_sequence_parallel(ranks):
    """A (2 data, 2 model) mesh: each rank holds half the batch and half the
    sequence; the batch offset enters the dropout mask."""
    q, k, v, g = _inputs((4, 2, 128, 16), 5)
    ref = _vit_tpu(2, 2, q, k, v, g, 0.25, 11, None)
    assert _check(ranks.run(ring, 2, 2, q, k, v, g, 0.25, 11, None), ref) == 4


@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (2, 0, 128, 96), (1, 0, 4066, 2033)])
def test_block_masks_are_vit_tpus_bit_for_bit(offsets):
    shape, rate, seed = (2, 3, 64, 32), 0.1, 12345
    want = np.asarray(jax_keep_mask(shape, rate, jnp.int32(seed), offsets=offsets))
    got = hash_keep_mask(shape, rate, seed, offsets=offsets).numpy()
    np.testing.assert_array_equal(got, want)


def test_ring_helpers_and_errors():
    x = torch.arange(2 * 3 * 12 * 4, dtype=torch.float32).reshape(2, 3, 12, 4)
    blocks = pr._split_blocks(x, 3, 4)
    assert blocks.shape == (3, 2, 3, 4, 4)
    assert torch.equal(pr._merge_blocks(blocks), x)
    assert pr._pick_block(None, 2033) == 2033 and pr._pick_block(512, 2033) == 107
    assert pr._offsets(3, 8, 100) == (8, 300)
    mesh = make_mesh(devices=range(4), model_parallel=4)
    q = torch.zeros(1, 2, 130, 16)
    with pytest.raises(ValueError, match="divisible"):
        pr.ring_attention(q, q, q, mesh, axis="model")
