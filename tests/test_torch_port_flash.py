"""The port's plain attention, forward and backward, against vit_tpu's Pallas kernels.

vit_tpu runs its kernels in interpret mode on the CPU, as its own tests do
(gradients through its custom_vjp run the Pallas backward kernels K4/K5 or
K6 the same way). The port's wrappers take their plain versions for these
CPU tensors; the CUDA kernels are held against the same plain versions on
the card by chip_smoke.py and tests/test_torch_port_cuda.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu_torch.ops import flash_attention as port
from vit_tpu_torch.ops._build import KERNELS

# vit_tpu.ops re-exports the function under the module's name
ref = importlib.import_module("vit_tpu.ops.flash_attention")

FP32_TOL = 1e-5
# bf16: q*scale and P are rounded to bf16 in both; the Pallas kernel's
# key blocks (128 here) and the port's (64 streaming, whole row short) round
# P against different running maxima, so O differs by about one bf16 ulp.
# The limit is four roundings to bf16 (4 * 2**-8) of the largest |O|, at
# most 2e-2: with randn inputs |O| is typically ~sqrt(e/T), 0.03-0.15 here,
# so a fixed 2e-2 would be most of a typical value.
BF16_TOL = 2e-2
BF16_ROUNDINGS = 4 * 2**-8


def _qkv(b, h, t, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t", [129, 300, 640])
@pytest.mark.parametrize("d", [16, 64])
def test_flash_attention_matches_pallas_fp32(t, d):
    q, k, v = _qkv(2, 2, t, d)
    want = np.asarray(ref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=True))
    got = port.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert got.shape == (2, 2, t, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("t", [129, 640])
def test_flash_attention_matches_pallas_bf16(t):
    q, k, v = _qkv(1, 2, t, 64, seed=1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(ref.flash_attention(jq, jk, jv, interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = port.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    tol = min(BF16_TOL, BF16_ROUNDINGS * np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def _pad(x, t_pad, d_pad):
    bh, t, d = x.shape
    return jnp.pad(jnp.asarray(x), ((0, 0), (0, t_pad - t), (0, d_pad - d)))


@pytest.mark.parametrize("t, short", [(300, True), (640, False)])
def test_plain_versions_match_pallas_lse(t, short):
    """O and the per-row logsumexp of each plain version against its Pallas
    kernel called directly (lse feeds the training slice's backward)."""
    q, k, v = (x.reshape(4, t, 64) for x in _qkv(2, 2, t, 64, seed=2))
    t_pad = -(-t // 128) * 128
    jq, jk, jv = (_pad(x, t_pad, 128) for x in (q, k, v))
    seed = jnp.zeros((1,), jnp.int32)
    if short:
        o, lse = ref._short_fwd(jq, jk, jv, seed, 64**-0.5, t, 0.0, interpret=True)
        got_o, got_lse = port.short_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), 64**-0.5)
    else:
        o, lse = ref._flash_fwd(jq, jk, jv, seed, 128, 128, 64**-0.5, t, 0.0, interpret=True)
        got_o, got_lse = port.flash_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), 64**-0.5)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o)[:, :t, :64], atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[:, :t, 0], atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("t", [129, 513])
def test_streaming_and_short_plain_versions_agree(t):
    q, k, v = (torch.from_numpy(x.reshape(2, t, 32)) for x in _qkv(1, 2, t, 32, seed=3))
    a = port.flash_fwd_plain(q, k, v, 32**-0.5)
    b = port.short_fwd_plain(q, k, v, 32**-0.5)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("t, name", [(129, "short_fwd"), (512, "short_fwd"), (513, "flash_fwd"), (4066, "flash_fwd")])
def test_dispatch_rule_is_vit_tpus(t, name, monkeypatch):
    """T rounded up to 128 at most 512 -> short kernel, else streaming. The
    forward without a gradient calls each kernel through its custom operator
    (``_short_fwd_op`` / ``_flash_fwd_op``, what an exported program holds)."""
    called = []
    for fn in ("short_fwd", "flash_fwd"):
        monkeypatch.setattr(port, f"_{fn}_op",
                            lambda q, k, v, s, *a, fn=fn: (called.append(fn), (q, None))[1])
    q = torch.zeros(1, 1, t, 16)
    port.flash_attention(q, q, q)
    assert called == [name]
    assert (-(-t // 128) * 128 <= ref._SHORT_T_MAX) == (name == "short_fwd")


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_scaled_q_rounds_nothing_where_the_scale_is_a_power_of_two(d):
    """bf16(d**-0.5) is a power of two at d = 16 and 64, so q * bf16(scale)
    rounds nothing there: ``_scaled_q`` equals q.float() * bf16(scale) bit for
    bit, which is why K5 may multiply Q as it is and fold the scale into the
    exponent (``csrc/attn_bwd_tc.cuh``). At d = 32 and 128 it rounds, and the
    kernels scale a copy of Q instead."""
    q = torch.from_numpy(np.random.default_rng(d).standard_normal((3, 50, d)).astype(
        np.float32)).to(torch.bfloat16)
    scale = torch.tensor(d**-0.5, dtype=torch.bfloat16).float()
    power_of_two = d in (16, 64)
    assert (scale.item() in (0.25, 0.125)) == power_of_two
    got = port._scaled_q(q, d**-0.5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), q.float() * scale) == power_of_two


def test_aligned_copies_only_unaligned_tensors():
    """The bf16 kernels read q, k, v (and dO) through TMA, which needs
    16-byte aligned bases."""
    x = torch.arange(4 * 64, dtype=torch.float32).to(torch.bfloat16)
    assert x.data_ptr() % 16 == 0 and port._aligned(x) is x
    y = x[1:]
    z = port._aligned(y)
    assert y.data_ptr() % 16 != 0 and z.data_ptr() % 16 == 0
    assert z is not y and torch.equal(z, y)


def test_wrappers_validate_inputs():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        port.flash_fwd(q, q, torch.zeros(2, 8, 32), 0.25)
    with pytest.raises(TypeError):
        port.flash_fwd(q.double(), q.double(), q.double(), 0.25)
    with pytest.raises(ValueError):
        port.flash_fwd(torch.zeros(2, 8, 24), torch.zeros(2, 8, 24), torch.zeros(2, 8, 24), 0.2)
    with pytest.raises(ValueError):
        port.short_fwd(torch.zeros(1, 513, 16), torch.zeros(1, 513, 16),
                       torch.zeros(1, 513, 16), 0.25)
    with pytest.raises(ValueError, match="dropout_seed"):
        port.flash_attention(q[None], q[None], q[None], dropout_rate=0.1)
    port.flash_attention(q[None], q[None], q[None], dropout_rate=0.1, dropout_seed=-3)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = {n: k.launches for n, k in KERNELS.items()}
    q = torch.randn(1, 2, 700, 16, generator=torch.Generator().manual_seed(0))
    port.flash_attention(q, q, q)
    port.flash_attention(q[:, :, :100], q[:, :, :100], q[:, :, :100])
    assert {n: k.launches for n, k in KERNELS.items()} == before


# Gradients: fp32 within 1e-5 (measured gap at these sizes <= 5e-7 on
# gradients of size ~1); bf16 by the rule above, four roundings to bf16 of
# the largest reference value, capped at 2e-2 (measured gap: one bf16 ulp).
GRAD_CASES = [(t, d, rate) for t in (129, 300, 640) for d in (16, 64) for rate in (0.0, 0.1)]


def _jax_vjp(q, k, v, g, rate, seed, dtype):
    """vit_tpu's O and (dq, dk, dv) for cotangent g, kernels in interpret mode."""
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    o, vjp = jax.vjp(lambda a, b, c: ref.flash_attention(
        a, b, c, interpret=True, dropout_rate=rate, dropout_seed=seed), *args)
    grads = vjp(jnp.asarray(g, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _port_vjp(q, k, v, g, rate, seed, dtype):
    args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o = port.flash_attention(*args, dropout_rate=rate, dropout_seed=seed)
    o.backward(torch.from_numpy(g).to(dtype))
    return [x.detach().float().numpy() for x in (o, *(a.grad for a in args))]


@pytest.mark.parametrize("t, d, rate", GRAD_CASES)
def test_attention_grads_match_pallas_fp32(t, d, rate):
    q, k, v, g = _qkv(2, 2, t, d, seed=4) + [np.random.default_rng(5).standard_normal(
        (2, 2, t, d)).astype(np.float32)]
    want = _jax_vjp(q, k, v, g, rate, -7, jnp.float32)
    got = _port_vjp(q, k, v, g, rate, -7, torch.float32)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=FP32_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("t, d, rate", GRAD_CASES)
def test_attention_grads_match_pallas_bf16(t, d, rate):
    q, k, v, g = _qkv(1, 2, t, d, seed=6) + [np.random.default_rng(7).standard_normal(
        (1, 2, t, d)).astype(np.float32)]
    want = _jax_vjp(q, k, v, g, rate, 2**31 - 1, jnp.bfloat16)
    got = _port_vjp(q, k, v, g, rate, 2**31 - 1, torch.bfloat16)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        tol = min(BF16_TOL, BF16_ROUNDINGS * np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("t, short, rate", [(300, True, 0.0), (300, True, 0.2),
                                            (640, False, 0.0), (640, False, 0.2)])
def test_plain_backwards_match_pallas_backwards(t, short, rate):
    """flash_bwd_plain against ref._flash_bwd (K4 + K5) and short_bwd_plain
    against ref._short_bwd (K6), called directly on the same lse, with the
    Pallas side padded to 128 rows and lanes as vit_tpu pads it."""
    q, k, v, do = (x.reshape(4, t, 64) for x in _qkv(2, 2, t, 64, seed=8) + [
        np.random.default_rng(9).standard_normal((2, 2, t, 64)).astype(np.float32)])
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    scale = 64**-0.5
    fwd = port.short_fwd_plain if short else port.flash_fwd_plain
    o, lse = fwd(tq, tk, tv, scale, rate, 11)
    t_pad = -(-t // 128) * 128
    jq, jk, jv, jdo, jo = (_pad(x, t_pad, 128) for x in (q, k, v, do, o.numpy()))
    jlse = jnp.pad(jnp.asarray(lse.numpy()), ((0, 0), (0, t_pad - t)))[..., None]
    seed = jnp.full((1,), 11, jnp.int32)
    if short:
        want = ref._short_bwd(jq, jk, jv, jo, jlse, jdo, seed, scale, t, rate, interpret=True)
        got = port.short_bwd_plain(tq, tk, tv, tdo, lse, (tdo * o).sum(-1), scale, rate, 11)
    else:
        want = ref._flash_bwd(jq, jk, jv, jo, jlse, jdo, seed, 128, 128, scale, t, rate,
                              interpret=True)
        got = port.flash_bwd_plain(tq, tk, tv, tdo, lse, (tdo * o).sum(-1), scale, rate, 11)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :t, :64], atol=FP32_TOL, rtol=0,
                                   err_msg=name)


def test_plain_forwards_apply_the_dropout_mask():
    """With V the identity and Q = 0, O is P*M/keep = M/(keep*T): zero exactly
    where hash_dropout_mask drops, for both plain forwards."""
    from vit_tpu_torch.ops.dropout import hash_dropout_mask

    t = d = 128
    q = torch.zeros(3, t, d)
    v = torch.eye(t).expand(3, t, d).contiguous()
    for fwd in (port.short_fwd_plain, port.flash_fwd_plain):
        for seed in (0, -1, 2**31 - 1):
            o, _ = fwd(q, q, v, d**-0.5, 0.5, seed)
            mask = hash_dropout_mask(t, t, torch.arange(3), seed, 0.5)
            assert torch.equal(o == 0, mask == 0)
            torch.testing.assert_close(o, mask / t, atol=1e-7, rtol=0)


@pytest.mark.parametrize("seed", [0, -1, 2**31 - 1, 12345])
def test_plain_backward_dropout_mask_constructions(seed):
    """The algebra of chip_smoke.py's bf16 K4/K5 mask check, on the CPU: with
    lse = log T and delta = 0, P = 1/T. K4: Q = 0, K = V = I, dO = 1 give
    dQ = scale * M/(keep*T); K5: Q = K = 0, dO = I give dV[j, c] =
    M[c, j]/(keep*T); both exact in bf16, zero exactly where
    hash_dropout_mask drops."""
    from vit_tpu_torch.ops.dropout import hash_dropout_mask

    t = d = 32
    bh, scale, bf = 3, d**-0.5, torch.bfloat16
    zeros = torch.zeros(bh, t, d, dtype=bf)
    eye = torch.eye(t, dtype=bf).expand(bh, t, d).contiguous()
    lse = torch.full((bh, t), float(np.log(np.float32(t))))
    delta = torch.zeros(bh, t)
    mask = hash_dropout_mask(t, t, torch.arange(bh), seed, 0.5)
    dq, _, _ = port.flash_bwd_plain(zeros, eye, eye, torch.ones_like(zeros), lse, delta, scale,
                                    0.5, seed)
    _, _, dv = port.flash_bwd_plain(zeros, zeros, zeros, eye, lse, delta, scale, 0.5, seed)
    assert 0 < int((mask == 0).sum()) < mask.numel()
    assert torch.equal(dq == 0, mask == 0)
    assert torch.equal(dq, (mask / t * scale).to(bf))
    assert torch.equal(dv == 0, mask.transpose(1, 2) == 0)
    assert torch.equal(dv, (mask / t).transpose(1, 2).to(bf))


@pytest.mark.parametrize("seed", [0, -1, 2**31 - 1, 12345])
def test_plain_short_backward_dropout_mask_constructions(seed):
    """The algebra of chip_smoke.py's bf16 K6 mask check, on the CPU, with
    lse = log T and delta = 0 (P = 1/T): dQ and dV by K4's and K5's
    constructions, and dK with Q = K6_Q * I, K = 0, V = I, dO = 1:
    dK[j, c] = M[c, j]/(keep*T) * bf16(K6_Q * bf16(scale)), K6's rounding of
    Q*scale. K6_Q is chosen so that K5's rounding, bf16(K6_Q * scale), gives
    other bits: the check tells the two dK formulas apart."""
    import chip_smoke
    from vit_tpu_torch.ops.dropout import hash_dropout_mask

    t = d = 32
    bh, scale, bf = 3, d**-0.5, torch.bfloat16
    zeros = torch.zeros(bh, t, d, dtype=bf)
    eye = torch.eye(t, dtype=bf).expand(bh, t, d).contiguous()
    ones = torch.ones_like(zeros)
    lse = torch.full((bh, t), float(np.log(np.float32(t))))
    delta = torch.zeros(bh, t)
    mask = hash_dropout_mask(t, t, torch.arange(bh), seed, 0.5)
    dq = port.short_bwd_plain(zeros, eye, eye, ones, lse, delta, scale, 0.5, seed)[0]
    dv = port.short_bwd_plain(zeros, zeros, zeros, eye, lse, delta, scale, 0.5, seed)[2]
    q = (chip_smoke.K6_Q * eye).contiguous()
    dk = port.short_bwd_plain(q, zeros, eye, ones, lse, delta, scale, 0.5, seed)[1]
    k6 = float((chip_smoke.K6_Q * torch.tensor(scale, dtype=bf).float()).to(bf))
    k5 = float(torch.tensor(chip_smoke.K6_Q * scale, dtype=torch.float32).to(bf))
    assert k6 != k5
    assert torch.equal(dq, (mask / t * scale).to(bf))
    assert torch.equal(dv, (mask / t).transpose(1, 2).to(bf))
    assert torch.equal(dk == 0, mask.transpose(1, 2) == 0)
    assert torch.equal(dk, ((mask / t).transpose(1, 2) * k6).to(bf))
