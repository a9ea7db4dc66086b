"""The flash backward's plain version against vit_tpu's Pallas backward in bf16.

The main path (configs/exp/att_clp/stride1.yaml) trains in bf16 at T = 4066 =
63*64 + 34; the card holds the one-pass CUDA kernel (csrc/flash_bwd.cu)
against ``flash_bwd_plain`` (tests/test_torch_port_cuda.py, chip_smoke.py),
so here ``flash_bwd_plain`` is held against vit_tpu's ``_flash_bwd`` (K4 and
K5, interpret mode) on the same seeded inputs in bf16, at T = 546 = 8*64 + 34,
stride1's ragged residue of 34 keys. The Pallas side is padded to 128 rows
and lanes as vit_tpu pads it. Tolerance: the bf16 one of
tests/test_torch_port_flash.py, the smaller of 2e-2 and four roundings to
bf16 (4 * 2**-8) of the largest reference value: the two walk key blocks of
64 and 128 and round dS and P~ to bf16 after sums in another order.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu_torch.ops import flash_attention as port

ref = importlib.import_module("vit_tpu.ops.flash_attention")

BF16_TOL = 2e-2
BF16_ROUNDINGS = 4 * 2**-8
T_RAGGED = 546  # 8 * 64 + 34: the residue of stride1's T = 4066 = 63 * 64 + 34


def _pad(x, t_pad, d_pad):
    bh, t, d = x.shape
    return jnp.pad(jnp.asarray(x), ((0, 0), (0, t_pad - t), (0, d_pad - d)))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_flash_backward_matches_pallas_in_bf16(rate):
    b, h, t, d, seed = 2, 2, T_RAGGED, 64, 13
    rng = np.random.default_rng(21)
    q, k, v, do = (rng.standard_normal((b * h, t, d)).astype(np.float32) for _ in range(4))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    scale = d**-0.5
    o, lse = port.flash_fwd_plain(tq, tk, tv, scale, rate, seed)
    delta = (tdo.float() * o.float()).sum(-1)
    got = port.flash_bwd_plain(tq, tk, tv, tdo, lse, delta, scale, rate, seed)

    t_pad = -(-t // 128) * 128
    jq, jk, jv, jdo, jo = (_pad(x.float().numpy(), t_pad, 128).astype(jnp.bfloat16)
                           for x in (tq, tk, tv, tdo, o))
    jlse = jnp.pad(jnp.asarray(lse.numpy()), ((0, 0), (0, t_pad - t)))[..., None]
    want = ref._flash_bwd(jq, jk, jv, jo, jlse, jdo, jnp.full((1,), seed, jnp.int32), 128, 128,
                          scale, t, rate, interpret=True)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w.astype(jnp.float32))[:, :t, :d]
        assert a.dtype == torch.bfloat16 and a.shape == (b * h, t, d)
        tol = min(BF16_TOL, BF16_ROUNDINGS * np.abs(w).max())
        np.testing.assert_allclose(a.float().numpy(), w, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("bh, t, d, workspace, counters", [
    (32, 4066, 64, (32, 4096, 64), (32, 64)),  # stride1: B16 H2, 64 query tiles a head
    (96, 4066, 64, (96, 4096, 64), (96, 64)),  # three stacked replicas: heads R * BH
    (4, T_RAGGED, 64, (4, 576, 64), (4, 9)),
    (3, 1, 16, (3, 64, 16), (3, 1)),
    (3, 640, 128, (3, 640, 128), (3, 10)),
])
def test_bwd_scratch_sizes_the_dq_workspace_and_counters(bh, t, d, workspace, counters):
    """The bf16 kernel's dQ workspace holds every query tile's 64 rows (T
    rounded up to 64), its counters one per (head, query tile); fp32 needs
    neither."""
    assert port.bwd_scratch(bh, t, d, torch.bfloat16) == (workspace, counters)
    assert port.bwd_scratch(bh, t, d, torch.float32) is None


def test_flash_bwd_on_the_cpu_is_the_plain_version_and_launches_nothing():
    from vit_tpu_torch.ops._build import KERNELS

    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 70, 32)).astype(np.float32))
                   .bfloat16() for _ in range(4))
    o, lse = port.flash_fwd(q, k, v, 32**-0.5, 0.1, 5)
    delta = (do.float() * o.float()).sum(-1)
    before = KERNELS["flash_bwd"].launches
    got = port.flash_bwd(q, k, v, do, lse, delta, 32**-0.5, 0.1, 5)
    want = port.flash_bwd_plain(q, k, v, do, lse, delta, 32**-0.5, 0.1, 5)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert KERNELS["flash_bwd"].launches == before
