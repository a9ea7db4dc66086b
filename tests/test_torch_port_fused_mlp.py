"""The port's plain fused MLP against vit_tpu's Pallas kernel (interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops import fused_mlp as ref
from vit_tpu_torch.ops import fused_mlp as port
from vit_tpu_torch.ops._build import KERNELS

FP32_TOL = 1e-5
# bf16: the GELU output and y are rounded to bf16 in both; an fp32 sum in
# another order can move a value across a rounding boundary: one bf16 ulp
# (2**-8 relative) of outputs of size <= 2.
BF16_TOL = 2e-2


def _operands(r, d, f, seed=0, scale=0.5):
    """x, w1 (D, F), b1, w2 (F, D), b2 in the Pallas kernel's layout."""
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((r, d)).astype(np.float32),
        (rng.standard_normal((d, f)) * scale / np.sqrt(d)).astype(np.float32),
        (rng.standard_normal(f) * 0.1).astype(np.float32),
        (rng.standard_normal((f, d)) * scale / np.sqrt(f)).astype(np.float32),
        (rng.standard_normal(d) * 0.1).astype(np.float32),
    )


def _port_operands(x, w1, b1, w2, b2, dtype=torch.float32):
    """The same operands as torch tensors, weights in nn.Linear's (out, in)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
                 for a in (x, w1.T, b1, w2.T, b2))


@pytest.mark.parametrize("r, d, f", [(200, 32, 128), (300, 128, 512), (77, 48, 96)])
def test_fused_mlp_matches_pallas_fp32(r, d, f):
    ops = _operands(r, d, f)
    want = np.asarray(ref.fused_mlp(*(jnp.asarray(x) for x in ops), interpret=True))
    got = port.fused_mlp(*_port_operands(*ops))
    assert got.shape == (r, d)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=0)


def test_fused_mlp_matches_pallas_bf16():
    ops = _operands(200, 128, 512, seed=1)
    want = ref.fused_mlp(*(jnp.asarray(x, jnp.bfloat16) for x in ops), interpret=True)
    got = port.fused_mlp(*_port_operands(*ops, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=0)


def test_plain_forward_matches_jnp_mlp_bf16_at_the_stride1_width():
    """fused_mlp_plain against vit_tpu's _jnp_mlp at the stride-1 MLP (D128
    F512) in bf16, R = 1000 rows (not a multiple of the kernels' 64-row
    tiles). h and y are rounded to bf16 in both; an fp32 sum in another
    order can move a value across a rounding boundary: one bf16 ulp of h
    times |W2| in y, and one ulp (2**-8 relative) of y itself, so the limit
    is 2**-7 of the largest |y| (measured: 0.0039 against 0.025)."""
    ops = _operands(1000, 128, 512, seed=4, scale=1.0)
    want = np.asarray(ref._jnp_mlp(*(jnp.asarray(x, jnp.bfloat16) for x in ops)).astype(
        jnp.float32))
    got = port.fused_mlp_plain(*_port_operands(*ops, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (1000, 128)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2**-7 * np.abs(want).max(),
                               rtol=0)


# The image family's widths, where the port's kernels take their wide route
# (ViT-B/16's D768 F3072, ViT-L/16's D1024 F4096), with a ragged row count:
# vit_tpu pads 72 rows to one 128-row block; the port's plain version runs
# here, and tests/test_torch_port_cuda.py holds the kernels to it on the card.
WIDE = [(72, 768, 3072), (72, 1024, 4096)]


@pytest.mark.parametrize("r, d, f", WIDE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_matches_pallas_at_the_image_widths(r, d, f, dtype):
    ops = _operands(r, d, f, seed=11)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = ref.fused_mlp(*(jnp.asarray(x, jdt) for x in ops), interpret=True)
    got = port.fused_mlp(*_port_operands(*ops, dtype=dtype))
    assert got.dtype == dtype and got.shape == (r, d)
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0)


def test_fused_mlp_keeps_leading_dims():
    x, w1, b1, w2, b2 = _operands(2 * 37, 32, 64, seed=2)
    want = np.asarray(ref.fused_mlp(jnp.asarray(x.reshape(2, 37, 32)), *map(jnp.asarray, (w1, b1, w2, b2)),
                                    interpret=True))
    _, *weights = _port_operands(x, w1, b1, w2, b2)
    got = port.fused_mlp(torch.from_numpy(x.reshape(2, 37, 32)), *weights)
    assert got.shape == (2, 37, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=0)


def test_erf_as_equals_vit_tpus_and_is_close_to_erf():
    x = np.linspace(-6, 6, 10001).astype(np.float32)
    mine = port.erf_as(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(mine, np.asarray(ref._erf_f32(jnp.asarray(x))), atol=2e-7, rtol=0)
    # 1.5e-7 is the formula's bound in exact arithmetic; fp32 evaluation adds
    # a few ulp of 1.0 (6e-8 each).
    np.testing.assert_allclose(mine, torch.erf(torch.from_numpy(x)).numpy(), atol=5e-7, rtol=0)
    assert port.erf_as(torch.zeros(1)).item() == 0.0


def test_fused_mlp_validates_and_counts_nothing_on_cpu():
    x, w1, b1, w2, b2 = _port_operands(*_operands(10, 32, 64))
    before = KERNELS["fused_mlp_fwd"].launches
    port.fused_mlp(x, w1, b1, w2, b2)
    assert KERNELS["fused_mlp_fwd"].launches == before
    with pytest.raises(ValueError):
        port.fused_mlp(x, w1.t(), b1, w2, b2)
    # the weights are cast to x's dtype; x itself must be fp32 or bf16
    xb = x.to(torch.bfloat16)
    y = port.fused_mlp(xb, w1, b1, w2, b2)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, port.fused_mlp(xb, *(w.to(torch.bfloat16) for w in (w1, b1, w2, b2))))
    with pytest.raises(TypeError):
        port.fused_mlp(x.to(torch.float16), w1, b1, w2, b2)


# Backward: dx, dW1, db1, dW2, db2 against jax.vjp through vit_tpu's
# custom_vjp (its _bwd_kernel in interpret mode). fp32: the weight
# gradients are sums over every row, taken in another order, so the limit
# is relative to their largest value (1e-5 of it); dx within FP32_TOL.
def _vjp_both(r, d, f, dtype, seed=3):
    x, w1, b1, w2, b2 = _operands(r, d, f, seed=seed)
    dy = np.random.default_rng(seed + 1).standard_normal((r, d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def fn(x_, w1_, b1_, w2_, b2_):  # fp32 weights cast inside, as the model does
        return ref.fused_mlp(x_, w1_.astype(jdt), b1_.astype(jdt), w2_.astype(jdt),
                             b2_.astype(jdt), interpret=True)

    _, vjp = jax.vjp(fn, jnp.asarray(x, jdt), *map(jnp.asarray, (w1, b1, w2, b2)))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy, jdt))]
    want = [want[0], want[1].T, want[2], want[3].T, want[4]]  # to nn.Linear layout

    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    ws = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
          for a in (w1.T, b1, w2.T, b2)]
    y = port.fused_mlp(tx, *ws)
    y.backward(torch.from_numpy(dy).to(dtype))
    got = [tx.grad] + [w.grad for w in ws]
    assert all(g.dtype == torch.float32 for g in got[1:])  # fp32, unrounded
    return [g.float().numpy() for g in got], want


@pytest.mark.parametrize("r, d, f", [(200, 32, 128), (300, 128, 512), (77, 48, 96)])
def test_fused_mlp_grads_match_pallas_fp32(r, d, f):
    got, want = _vjp_both(r, d, f, torch.float32)
    for name, a, b in zip(("dx", "dW1", "db1", "dW2", "db2"), got, want):
        tol = FP32_TOL if name == "dx" else 1e-5 * max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("r, d, f", WIDE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_grads_match_pallas_at_the_image_widths(r, d, f, dtype):
    """dx and the fp32 weight gradients at D768 and D1024 against
    vit_tpu's _bwd_kernel in interpret mode: fp32 as above, bf16 by the
    limits below (dx BF16_TOL, the weight gradients 1e-3 of their largest
    value)."""
    got, want = _vjp_both(r, d, f, dtype, seed=13)
    for name, a, b in zip(("dx", "dW1", "db1", "dW2", "db2"), got, want):
        if dtype == torch.bfloat16:
            tol = _bf16_tol(name, b)
        else:
            tol = FP32_TOL if name == "dx" else 1e-5 * max(1.0, np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)


# bf16 in: dx by the bf16 rule; the fp32 weight gradients are sums of
# products of bf16-rounded g and dh, which round alike in both except where
# an fp32 pre-activation summed in another order sits on a rounding
# boundary: each such flip moves dW by one bf16 ulp of g or dh times |dy| or
# |x|. Measured: dW2 4.3e-4 of its largest value, the others <= 7e-6. The
# limit, 1e-3 of the largest value, lies between that and the 2.0e-3 to
# 3.3e-3 that rounding the weight gradients to bf16 gives on these inputs.
K7_BF16_REL = 1e-3
GRAD_NAMES = ("dx", "dW1", "db1", "dW2", "db2")


@pytest.fixture(scope="module")
def bf16_grads():
    return _vjp_both(200, 128, 512, torch.bfloat16, seed=5)


def _bf16_tol(name, want):
    return BF16_TOL if name == "dx" else K7_BF16_REL * np.abs(want).max()


def test_fused_mlp_grads_match_pallas_bf16(bf16_grads):
    got, want = bf16_grads
    for name, a, b in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(a, b, atol=_bf16_tol(name, b), rtol=0, err_msg=name)


def test_bf16_weight_gradients_reach_fp32_unrounded(bf16_grads):
    """The fault to catch: dW rounded through bf16 before it reaches the
    fp32 parameter. The port's weight gradients carry bits below bf16's, and
    the same gradients rounded to bf16 and back fail the limit above."""
    got, want = bf16_grads
    rounded = [torch.from_numpy(a).bfloat16().float().numpy() for a in got[1:]]
    for name, a, r in zip(GRAD_NAMES[1:], got[1:], rounded):
        assert not np.array_equal(a, r), f"{name} is representable in bf16"
    failed = [name for name, r, b in zip(GRAD_NAMES[1:], rounded, want[1:])
              if np.abs(r - b).max() > _bf16_tol(name, b)]
    assert failed == list(GRAD_NAMES[1:])


def test_plain_backward_is_the_autograd_backward():
    x, w1, b1, w2, b2 = _port_operands(*_operands(50, 32, 64, seed=7))
    dy = torch.randn(50, 32, generator=torch.Generator().manual_seed(8))
    dx, dw1, db1, dw2, db2 = port.fused_mlp_bwd_plain(x, dy, w1, b1, w2)
    args = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    port.fused_mlp(*args).backward(dy)
    for a, b in zip((dx, dw1, db1, dw2, db2), (t.grad for t in args)):
        assert torch.equal(a, b)
    # and the same gradients as autograd through the plain forward
    ref_args = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    port.fused_mlp_plain(*ref_args).backward(dy)
    for a, b in zip((dx, dw1, db1, dw2, db2), (t.grad for t in ref_args)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# K3's and K7's bodies and scratch, decided on the host by mlp_body, bwd_plan,
# _fwd_scratch and _bwd_scratch (the kernels themselves run only on the card:
# tests/test_torch_port_cuda.py).
@pytest.mark.parametrize("d, f", [(16, 64), (32, 128), (64, 256), (128, 512), (384, 1536),
                                  (512, 2048), (48, 96), (768, 3072), (1024, 4096)])
def test_bwd_plan_takes_the_tensor_cores_for_bf16_at_k3s_widths(d, f):
    """bf16 with D and F multiples of 16 (K3's rule) and D <= 1024 takes the
    tensor cores; the same widths in fp32 keep the FMA body. Segments are
    whole 64-row blocks and none is empty."""
    r = 4097
    tc, n_seg = port.bwd_plan(r, d, f, torch.bfloat16)
    assert tc
    blocks = -(-r // 64)
    per_seg = -(-blocks // n_seg)
    assert 1 <= n_seg <= blocks and (n_seg - 1) * per_seg < blocks
    assert not port.bwd_plan(r, d, f, torch.float32)[0]


@pytest.mark.parametrize("d, f", [(40, 160), (100, 30), (128, 520), (2048, 8192)])
def test_bwd_plan_keeps_the_fma_body_off_the_rule(d, f):
    assert not port.bwd_plan(300, d, f, torch.bfloat16)[0]


def test_bwd_plan_fills_two_waves_at_the_stride1_shape():
    """R 65056 (16 x 4066 tokens), D 128, F 512: 8 F chunks x 33 segments of
    31 blocks = 264 weight-gradient CTAs, two waves of 132 SMs."""
    assert port.bwd_plan(65056, 128, 512, torch.bfloat16) == (True, 33)
    assert port.bwd_plan(1, 16, 32, torch.bfloat16) == (True, 1)


@pytest.mark.parametrize("dtype, r, d, f", [(torch.bfloat16, 4097, 128, 512),
                                            (torch.bfloat16, 2064, 32, 128),
                                            (torch.float32, 4097, 128, 512),
                                            (torch.bfloat16, 300, 100, 30),
                                            (torch.bfloat16, 8320, 384, 1536),
                                            (torch.bfloat16, 12608, 768, 3072)])
def test_bwd_scratch_holds_no_rf_tensor_on_the_tensor_cores(dtype, r, d, f):
    """The on-chip tensor-core body (D <= 128) keeps g and dh in registers:
    its only scratch is the (n_seg, 2FD + F + D) fp32 partials. The wide
    body (128 < D <= 1024) and the FMA body add g and dh, (R, F) each in the
    input dtype; the wide body needs the partials only with more than one
    segment (one segment writes the gradients themselves)."""
    body, n_seg, g, dh, part = port._bwd_scratch(r, d, f, dtype, "cpu")
    assert body == port.mlp_body(d, f, dtype)
    assert (body != "fma", n_seg) == port.bwd_plan(r, d, f, dtype)
    if body == "tc":
        assert g is None and dh is None
    else:
        assert g.shape == dh.shape == (r, f) and g.dtype == dh.dtype == dtype
    if body == "wide" and n_seg == 1:
        assert part is None
    else:
        assert part.shape == (n_seg, 2 * f * d + f + d) and part.dtype == torch.float32


# Every route's plan at the widths the repo configures and around them: D128
# (stride1), D384 (ViT-S/16), D512, D768 (ViT-B/16), D1024 (ViT-L/16), D400
# (a multiple of 16 that is not one of 64: the wide route, its tiles
# zero-filled past D), and off the rule F1000 (not a multiple of 16) and
# D2048 (past the wide route's D_MAX).
PLAN_CASES = [  # (d, f, body in bf16, bf16 segments at R 8320, at R 12608)
    (128, 512, "tc", 33, 33),
    (384, 1536, "wide", 6, 6),
    (512, 2048, "wide", 4, 4),
    (768, 3072, "wide", 2, 2),
    (1024, 4096, "wide", 1, 1),
    (400, 1600, "wide", 5, 5),
    (384, 1000, "fma", 3, 3),
    (2048, 8192, "fma", 1, 1),
]


@pytest.mark.parametrize("d, f, body, seg_s, seg_b", PLAN_CASES)
def test_plan_of_every_route(d, f, body, seg_s, seg_b):
    """mlp_body picks one body for K3 and K7 by dtype and width; bwd_plan's
    segments fill about two waves of 132 SMs with the body's weight-gradient
    tiles (on-chip: an F chunk of 64 by one D tile; wide: both products'
    128 x 256 tiles, the count nearest two waves; FMA: 64 x 64 tiles) and
    none is empty; K3's scratch is h (R, F) on the wide route only, K7's g
    and dh on the wide and FMA ones."""
    assert port.mlp_body(d, f, torch.bfloat16) == body
    assert port.mlp_body(d, f, torch.float32) == "fma"
    for r, want in ((8320, seg_s), (12608, seg_b)):
        tc, n_seg = port.bwd_plan(r, d, f, torch.bfloat16)
        assert (tc, n_seg) == (body != "fma", want)
        if body == "wide":
            tiles = -(-f // 128) * -(-d // 256) + -(-d // 128) * -(-f // 256)
            blocks = -(-r // 64)
            assert abs(tiles * n_seg - 264) <= tiles / 2 or n_seg == blocks
            assert (n_seg - 1) * -(-blocks // n_seg) < blocks
        h = port._fwd_scratch(r, d, f, torch.bfloat16, "meta")
        assert (h is not None) == (body == "wide")
        if h is not None:
            assert h.shape == (r, f) and h.dtype == torch.bfloat16
        _, _, g, dh, _ = port._bwd_scratch(r, d, f, torch.bfloat16, "meta")
        assert (g is None) == (dh is None) == (body == "tc")
