"""The port's CUDA kernels, forward and backward, against their plain versions, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA card and
nvcc and skips without them. The file imports no JAX; on the machine with
the card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerances: fp32 max-abs 1e-4 (true fp32 on both sides: TF32 is off);
bf16 on O and y the smaller of 2e-2 and four roundings to bf16 (4 * 2**-8)
of the largest reference value, because the kernel and the plain version
sum in another order before rounding. With randn inputs |O| is typically
~sqrt(e/T), so a fixed 2e-2 would be most of a typical value at long T.
The fused MLP's fp32 weight gradients are sums over every row: fp32 inputs
1e-5 of the largest value, bf16 inputs 1e-3 of it, as in chip_smoke.py (a
bf16-rounded g or dh that lands on the other side of a rounding boundary
moves dW by one ulp times |x| or |dy|; dW rounded to bf16 would be off by
up to 2**-9 of it, which the limit must catch).
"""

import pytest
import torch

from vit_tpu_torch.ops import flash_attention as fa
from vit_tpu_torch.ops import fused_mlp as fm
from vit_tpu_torch.ops._build import KERNELS

pytestmark = pytest.mark.cuda

FP32_TOL = 1e-4
BF16_TOL = 2e-2
LSE_TOL = 1e-3
DTYPES = [torch.float32, torch.bfloat16]
RATES = [0.0, 0.1]


def _tol(ref):
    if ref.dtype != torch.bfloat16:
        return FP32_TOL
    return min(BF16_TOL, 4 * 2**-8 * ref.float().abs().max().item())


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, bh, t, d, dtype):
    return [torch.randn(bh, t, d, generator=gen, device="cuda").to(dtype) for _ in range(3)]


def _check_attention(name, kernel, plain, q, k, v):
    before = KERNELS[name].launches
    o, lse = kernel(q, k, v, q.shape[-1] ** -0.5)
    torch.cuda.synchronize()
    assert KERNELS[name].launches == before + 1
    o_ref, lse_ref = plain(q, k, v, q.shape[-1] ** -0.5)
    assert o.dtype == q.dtype and lse.shape == q.shape[:2]
    assert (o.float() - o_ref.float()).abs().max().item() <= _tol(o_ref)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("t", [1, 31, 32, 33, 64, 65, 129, 512])
def test_short_fwd_matches_plain(gen, t, d, dtype):
    _check_attention("short_fwd", fa.short_fwd, fa.short_fwd_plain, *_qkv(gen, 3, t, d, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 129, 513, 1000, 4066])
def test_flash_fwd_matches_plain(gen, t, d, dtype):
    _check_attention("flash_fwd", fa.flash_fwd, fa.flash_fwd_plain, *_qkv(gen, 3, t, d, dtype))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("t, short", [(65, True), (197, True), (65, False), (1000, False)])
def test_fwd_bf16_is_bit_repeatable(gen, t, short, d, rate):
    """K1 and K2 in bf16 sum each output row in one CTA and write it once."""
    q, k, v = _qkv(gen, 3, t, d, torch.bfloat16)
    fwd = fa.short_fwd if short else fa.flash_fwd
    first = fwd(q, k, v, d**-0.5, rate, 3)
    again = fwd(q, k, v, d**-0.5, rate, 3)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("short", [True, False])
def test_fwd_bf16_takes_unaligned_inputs(gen, short):
    """The bf16 kernels read through TMA, which needs 16-byte aligned bases:
    the wrapper copies q, k, v that start 2 bytes off."""
    t, d = 129, 64
    q, k, v = (x.flatten() for x in _qkv(gen, 3, t, d, torch.bfloat16))
    views = [torch.cat([x[:1], x])[1:].view(3, t, d) for x in (q, k, v)]
    assert all(x.data_ptr() % 16 != 0 for x in views)
    kernel, plain = ((fa.short_fwd, fa.short_fwd_plain) if short
                     else (fa.flash_fwd, fa.flash_fwd_plain))
    _check_attention("short_fwd" if short else "flash_fwd", kernel, plain, *views)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r, d, f", [(1, 16, 32), (65, 48, 96), (200, 128, 512),
                                     (130, 384, 1536), (64, 1024, 4096), (70, 100, 30)])
def test_fused_mlp_fwd_matches_plain(gen, r, d, f, dtype):
    x = torch.randn(r, d, generator=gen, device="cuda").to(dtype)
    w1 = (torch.randn(f, d, generator=gen, device="cuda") / d**0.5).to(dtype)
    b1 = (0.1 * torch.randn(f, generator=gen, device="cuda")).to(dtype)
    w2 = (torch.randn(d, f, generator=gen, device="cuda") / f**0.5).to(dtype)
    b2 = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    before = KERNELS["fused_mlp_fwd"].launches
    y = fm.fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert KERNELS["fused_mlp_fwd"].launches == before + 1
    want = fm.fused_mlp_plain(x, w1, b1, w2, b2)
    assert (y.float() - want.float()).abs().max().item() <= _tol(want)


def _mlp_operands(gen, r, d, f, dtype=torch.bfloat16):
    x = torch.randn(r, d, generator=gen, device="cuda").to(dtype)
    w1 = (torch.randn(f, d, generator=gen, device="cuda") / d**0.5).to(dtype)
    b1 = (0.1 * torch.randn(f, generator=gen, device="cuda")).to(dtype)
    w2 = (torch.randn(d, f, generator=gen, device="cuda") / f**0.5).to(dtype)
    b2 = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("r", [65, 1000, 2064, 65056])
@pytest.mark.parametrize("d", [32, 64, 128, 384])
def test_fused_mlp_tc_matches_plain_and_repeats(gen, r, d):
    """K3's tensor-core body (bf16, D and F multiples of 16) at the widths
    the repo configures, F = 4D: within the bf16 limit of the plain version,
    equal bits on a second call (no atomics) and from an x that starts 2
    bytes off (the wrapper copies it for TMA)."""
    x, w1, b1, w2, b2 = _mlp_operands(gen, r, d, 4 * d)
    before = KERNELS["fused_mlp_fwd"].launches
    y = fm.fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert KERNELS["fused_mlp_fwd"].launches == before + 1
    want = fm.fused_mlp_plain(x, w1, b1, w2, b2)
    assert (y.float() - want.float()).abs().max().item() <= _tol(want)
    assert torch.equal(y, fm.fused_mlp(x, w1, b1, w2, b2))
    off = torch.cat([x.flatten()[:1], x.flatten()])[1:].view(r, d)
    assert off.data_ptr() % 16 != 0
    assert torch.equal(y, fm.fused_mlp(off, w1, b1, w2, b2))


# K3 and K7 on the wide route (bf16, 128 < D <= 1024): the image family's
# shapes (ViT-S/16 R8320 D384, ViT-B/16 R12608 D768, ViT-L/16 R6304 D1024)
# and ragged ones: R off the 128-row tiles, F off the 128- and 256-column
# tiles (F a multiple of 16 only), D400 off the 64-column boxes. At D1024
# and R of about a hundred, one g or dh that rounds to the other bf16 side
# than the plain version's (the plain version's own fp32 sums do so against
# float64 in 1e-4 of the elements) times |dy| or |x| is near K7's 1e-3
# limit, so the ragged D1024 case takes 1000 rows; R 64 at D1024 is
# test_fused_mlp_bwd_matches_plain_and_repeats's, and the rounding itself is
# held against float64 below, whatever R.
WIDE_MLP = [(8320, 384, 1536), (77, 384, 1552), (12608, 768, 3072), (1000, 768, 3088),
            (6304, 1024, 4096), (1000, 1024, 4112), (300, 400, 1600)]


@pytest.mark.parametrize("r, d, f", WIDE_MLP)
def test_fused_mlp_wide_route_matches_plain_and_repeats(gen, r, d, f):
    """One launch of K3 and one of K7 a call, each within the limits of its
    plain version (_check_mlp_bwd's for K7), and equal bits on a second
    call (no atomics)."""
    assert fm.mlp_body(d, f, torch.bfloat16) == "wide"
    x, w1, b1, w2, b2 = _mlp_operands(gen, r, d, f)
    before = KERNELS["fused_mlp_fwd"].launches
    y = fm.fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert KERNELS["fused_mlp_fwd"].launches == before + 1
    want = fm.fused_mlp_plain(x, w1, b1, w2, b2)
    assert (y.float() - want.float()).abs().max().item() <= _tol(want)
    assert torch.equal(y, fm.fused_mlp(x, w1, b1, w2, b2))
    dy = torch.randn(r, d, generator=gen, device="cuda").to(torch.bfloat16)
    _check_mlp_bwd(x, dy, w1, b1, w2)


def test_wide_route_rounds_g_and_dh_as_well_as_the_plain_version(gen):
    """K7's act pass rounds g and dh to bf16 from its fp32 pre and dg. Where
    those sit on a bf16 rounding boundary any fp32 summation order can land
    on either side, so against a float64 reference (bf16 of the float64
    GELU, and of dg times its derivative, of float64 sums) the plain
    version's g and dh differ too. The kernel's must not differ more often
    than 1.25 times the plain version's: at R 2000, D 1024 each count is
    some hundreds of 8.2 M elements, a few percent of spread. (Left to the
    tensor cores' own running sum over D1024, as K3's h is, they differ
    about three times as often: chip_smoke.py's rounding row.)"""
    r, d, f = 2000, 1024, 4096
    x, dy, w1, b1, w2 = _mlp_bwd_operands(gen, r, d, f, torch.bfloat16)
    body, n_seg, g, dh, part = fm._bwd_scratch(r, d, f, torch.bfloat16, x.device)
    assert body == "wide"
    dx = torch.empty_like(x)
    grads = torch.empty(2 * f * d + f + d, dtype=torch.float32, device="cuda")
    KERNELS["fused_mlp_bwd"].launch(
        x.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        dx.data_ptr(), g.data_ptr(), dh.data_ptr(), None if part is None else part.data_ptr(),
        grads.data_ptr(), r, d, f, n_seg, 1, fm.BODIES.index(body),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    pre64 = x.double() @ w1.double().t() + b1.double()
    dg64 = dy.double() @ w2.double()
    pre32 = x.float() @ w1.float().t() + b1.float()
    dg32 = dy.float() @ w2.float()
    want = (fm.gelu_as(pre64).bfloat16(), (dg64 * fm.dgelu_as(pre64)).bfloat16())
    plain = (fm.gelu_as(pre32).bfloat16(), (dg32 * fm.dgelu_as(pre32)).bfloat16())
    for name, got, p, w in zip(("g", "dh"), (g, dh), plain, want):
        kernel_off, plain_off = (got != w).sum().item(), (p != w).sum().item()
        assert 0 < plain_off and kernel_off <= 1.25 * plain_off, (name, kernel_off, plain_off)


@pytest.mark.parametrize("name, passes", [("fused_mlp_fwd", ("act_kernel", "out_kernel")),
                                          ("fused_mlp_bwd", ("act_kernel", "out_kernel",
                                                             "wgt_kernel"))])
def test_wide_route_runs_every_pass_on_the_tensor_cores(gen, name, passes):
    """Every pass of the wide route is compiled and holds HGMMA (cuobjdump's
    SASS, as chip_smoke.py reads it): K3 forms h then y, K7 forms g and dh,
    then dx, then the weight gradients."""
    import chip_smoke

    KERNELS[name].fn()  # built if need be
    counts = chip_smoke.tensor_core_instructions(KERNELS[name].lib_path)
    for kernel in passes:
        found = {f: c["HGMMA"] for f, c in counts.items()
                 if "fused_mlp_wide_tc" in f and kernel in f}
        assert found and all(n > 0 for n in found.values()), (kernel, counts)


def test_fused_mlp_bf16_width_off_the_tensor_core_rule_keeps_the_fma_body(gen):
    """D = 40 is not a multiple of 16: the bf16 forward runs the FMA body,
    still one launch of K3, within the same limit."""
    x, w1, b1, w2, b2 = _mlp_operands(gen, 300, 40, 160)
    before = KERNELS["fused_mlp_fwd"].launches
    y = fm.fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert KERNELS["fused_mlp_fwd"].launches == before + 1
    want = fm.fused_mlp_plain(x, w1, b1, w2, b2)
    assert (y.float() - want.float()).abs().max().item() <= _tol(want)


def test_flash_attention_dispatches_to_the_kernels(gen):
    before = {n: k.launches for n, k in KERNELS.items()}
    q = torch.randn(2, 2, 600, 64, generator=gen, device="cuda")
    fa.flash_attention(q, q, q)
    fa.flash_attention(q[:, :, :200], q[:, :, :200], q[:, :, :200])
    assert KERNELS["flash_fwd"].launches == before["flash_fwd"] + 1
    assert KERNELS["short_fwd"].launches == before["short_fwd"] + 1


def test_mixed_devices_and_bad_shapes_raise(gen):
    q = torch.randn(2, 64, 16, generator=gen, device="cuda")
    with pytest.raises(ValueError):
        fa.flash_fwd(q, q.cpu(), q, 0.25)
    with pytest.raises(ValueError):
        fa.short_fwd(q[:, :, :8].contiguous(), q[:, :, :8].contiguous(),
                     q[:, :, :8].contiguous(), 0.25)
    x = torch.randn(4, 16, generator=gen, device="cuda")
    with pytest.raises(ValueError):
        fm.fused_mlp(x, torch.zeros(32, 16), torch.zeros(32), torch.zeros(16, 32),
                     torch.zeros(16))


@pytest.mark.parametrize("fused_mlp, attn_impl", [(False, "flash"), (True, "flash"),
                                                  (True, "xla")])
def test_model_on_the_card_matches_the_cpu(gen, fused_mlp, attn_impl):
    from vit_tpu_torch.models.builder import get_model

    cfg = {"model": dict(task_type="reg", image_size=1100, patch_size=16, hidden_size=64,
                         num_hidden_layers=2, num_attention_heads=2, stride_size=2,
                         attn_impl=attn_impl, fused_mlp=fused_mlp),
           "data": {"param": "log_g"}}
    model = get_model(cfg, generator=torch.Generator().manual_seed(1)).module.eval()
    x = torch.randn(3, 1100, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(x)
        got = model.cuda()(x.cuda()).cpu()
    assert (got - want).abs().max().item() <= 1e-4


def _check_backward(bwd, plain, q, k, v, rate, seed=7, names=()):
    d = q.shape[-1]
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                     device="cuda").to(q.dtype)
    fwd = fa.short_fwd if bwd is fa.short_bwd else fa.flash_fwd
    o, lse = fwd(q, k, v, d**-0.5, rate, seed)
    delta = (do.float() * o.float()).sum(-1)
    before = {n: KERNELS[n].launches for n in names}
    got = bwd(q, k, v, do, lse, delta, d**-0.5, rate, seed)
    torch.cuda.synchronize()
    assert all(KERNELS[n].launches == before[n] + 1 for n in names)
    want = plain(q, k, v, do, lse, delta, d**-0.5, rate, seed)
    for a, b in zip(got, want):
        assert a.dtype == q.dtype and a.shape == q.shape
        # At T = 1, dq and dk are zero in exact arithmetic (P = 1, so
        # ds = dP - delta = 0) and both sides hold fp32 noise ~1e-8: a limit
        # relative to that noise is meaningless, hence the FP32_TOL floor.
        assert (a.float() - b.float()).abs().max().item() <= max(_tol(b), FP32_TOL)


@pytest.mark.parametrize("short", [True, False])
def test_bwd_bf16_takes_unaligned_inputs(gen, short):
    """The bf16 backward kernels read q, k, v and dO through TMA as well:
    the wrappers copy the ones that start 2 bytes off."""
    t, d = 129, 64
    views = [torch.cat([x[:1], x])[1:].view(3, t, d) for x in (
        torch.randn(3 * t * d, generator=gen, device="cuda").bfloat16() for _ in range(4))]
    assert all(x.data_ptr() % 16 != 0 for x in views)
    q, k, v, do = views
    fwd, bwd, plain = ((fa.short_fwd, fa.short_bwd, fa.short_bwd_plain) if short
                       else (fa.flash_fwd, fa.flash_bwd, fa.flash_bwd_plain))
    o, lse = fwd(q, k, v, d**-0.5)
    delta = (do.float() * o.float()).sum(-1)
    got = bwd(q, k, v, do, lse, delta, d**-0.5)
    want = plain(q, k, v, do, lse, delta, d**-0.5)
    for a, b in zip(got, want):
        assert (a.float() - b.float()).abs().max().item() <= _tol(b)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 129, 513, 1000])
def test_flash_bwd_matches_plain(gen, t, d, dtype, rate):
    _check_backward(fa.flash_bwd, fa.flash_bwd_plain, *_qkv(gen, 3, t, d, dtype), rate,
                    names=("flash_bwd",))


@pytest.mark.parametrize("rate", RATES)
def test_flash_bwd_matches_plain_at_the_stride1_shape(gen, rate):
    """T = 4066 = 63*64 + 34, the main path's ragged edge, in bf16."""
    _check_backward(fa.flash_bwd, fa.flash_bwd_plain, *_qkv(gen, 4, 4066, 64, torch.bfloat16),
                    rate, names=("flash_bwd",))


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("t", [65, 1000])
def test_flash_bwd_bf16_is_bit_repeatable(gen, t, d):
    """dK and dV are summed in one CTA and written once; dQ's key blocks add
    into the workspace in a fixed order (no atomics in a free order)."""
    q, k, v = _qkv(gen, 3, t, d, torch.bfloat16)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = fa.flash_fwd(q, k, v, d**-0.5, 0.1, 3)
    delta = (do.float() * o.float()).sum(-1)
    first = fa.flash_bwd(q, k, v, do, lse, delta, d**-0.5, 0.1, 3)
    again = fa.flash_bwd(q, k, v, do, lse, delta, d**-0.5, 0.1, 3)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _grads(gen, bh, t, d, rate, seed, **launch):
    """(q, k, v, do, lse, delta, grads): the bf16 flash forward and backward
    of seeded inputs, with ``launch``'s seeds and offset."""
    q, k, v = _qkv(gen, bh, t, d, torch.bfloat16)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = fa.flash_fwd(q, k, v, d**-0.5, rate, seed, **launch)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, lse, delta, fa.flash_bwd(q, k, v, do, lse, delta, d**-0.5, rate, seed,
                                                 **launch)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("t", [65, 300, 4066])
def test_flash_bwd_stacked_launch_is_each_replica_alone(gen, t, d):
    """Three replicas stacked in one bf16 launch (bh_per_seed), a seed each,
    give each replica's own launch bit for bit: the key blocks of one head
    add dQ in their order whatever the other heads of the launch do."""
    seeds, per = [7, -1, 2**31 - 1], 4
    sv = torch.tensor(seeds, dtype=torch.int32, device="cuda")
    q, k, v, do, lse, delta, grads = _grads(gen, len(seeds) * per, t, d, 0.1, sv,
                                            bh_per_seed=per)
    for i, s in enumerate(seeds):
        sl = slice(i * per, (i + 1) * per)
        alone = fa.flash_bwd(q[sl], k[sl], v[sl], do[sl], lse[sl], delta[sl], d**-0.5, 0.1, s)
        assert all(torch.equal(a[sl], b) for a, b in zip(grads, alone))


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("t", [65, 1000, 4066])
def test_flash_bwd_offset_launch_is_the_full_launchs_slice(gen, t, d):
    """Heads [4, 8) of 8 launched alone with bh_offset 4 give the full
    launch's heads bit for bit in bf16, with dropout: the rank's mask rows
    and the same dQ order."""
    q, k, v, do, lse, delta, full = _grads(gen, 8, t, d, 0.1, 3)
    part = fa.flash_bwd(*(x[4:].contiguous() for x in (q, k, v, do, lse, delta)), d**-0.5, 0.1,
                        3, bh_offset=4)
    assert all(torch.equal(a, b[4:]) for a, b in zip(part, full))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_bwd_is_one_launch(gen, dtype):
    """One flash_bwd call adds exactly one launch to the fused kernel's
    count (the fp32 route's two passes behind the same entry count once)."""
    q, k, v = _qkv(gen, 2, 300, 64, dtype)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    o, lse = fa.flash_fwd(q, k, v, 0.125, 0.1, 9)
    delta = (do.float() * o.float()).sum(-1)
    before = {n: kk.launches for n, kk in KERNELS.items()}
    fa.flash_bwd(q, k, v, do, lse, delta, 0.125, 0.1, 9)
    torch.cuda.synchronize()
    after = {n: kk.launches for n, kk in KERNELS.items()}
    assert {n: after[n] - before[n] for n in after} == {n: int(n == "flash_bwd") for n in after}


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("t", [1, 31, 32, 33, 64, 65, 129, 512])
def test_short_bwd_matches_plain(gen, t, d, dtype, rate):
    _check_backward(fa.short_bwd, fa.short_bwd_plain, *_qkv(gen, 3, t, d, dtype), rate,
                    names=("short_bwd",))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("t", [65, 129, 197, 512])
def test_short_bwd_bf16_matches_plain_and_repeats(gen, t, d, rate):
    """K6 in bf16 on the tensor cores (K4's dQ pass and K5's dK/dV pass with
    K6's dK rounding): within the bf16 limit, equal bits on a second call."""
    q, k, v = _qkv(gen, 4, t, d, torch.bfloat16)
    _check_backward(fa.short_bwd, fa.short_bwd_plain, q, k, v, rate, names=("short_bwd",))
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = fa.short_fwd(q, k, v, d**-0.5, rate, 3)
    delta = (do.float() * o.float()).sum(-1)
    first = fa.short_bwd(q, k, v, do, lse, delta, d**-0.5, rate, 3)
    again = fa.short_bwd(q, k, v, do, lse, delta, d**-0.5, rate, 3)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("t, short", [(1, True), (129, True), (512, True), (65, False),
                                      (1000, False)])
def test_forward_dropout_matches_plain(gen, t, short, d, dtype):
    q, k, v = _qkv(gen, 3, t, d, dtype)
    kernel, plain = ((fa.short_fwd, fa.short_fwd_plain) if short
                     else (fa.flash_fwd, fa.flash_fwd_plain))
    o, lse = kernel(q, k, v, d**-0.5, 0.1, -5)
    o_ref, lse_ref = plain(q, k, v, d**-0.5, 0.1, -5)
    assert (o.float() - o_ref.float()).abs().max().item() <= _tol(o_ref)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("short", [True, False])
@pytest.mark.parametrize("seed", [0, -1, 2**31 - 1])
def test_kernel_dropout_mask_is_hash_dropout_mask(gen, short, seed):
    """V the identity and Q = 0: O = P*M/keep with P = 1/T, so O is zero
    exactly where hash_dropout_mask drops; a single wrong bit fails."""
    from vit_tpu_torch.ops.dropout import hash_dropout_mask

    t = d = 128
    q = torch.zeros(32, t, d, device="cuda")
    v = torch.eye(t, device="cuda").expand(32, t, d).contiguous()
    o, _ = (fa.short_fwd if short else fa.flash_fwd)(q, q, v, d**-0.5, 0.5, seed)
    mask = hash_dropout_mask(t, t, torch.arange(32), seed, 0.5).cuda()
    assert torch.equal(o == 0, mask == 0)


@pytest.mark.parametrize("short", [True, False])
@pytest.mark.parametrize("seed", [0, -1, 2**31 - 1])
def test_bf16_kernel_dropout_mask_is_hash_dropout_mask(gen, short, seed):
    """As above in bf16: P = 1 (S = 0), l = T, and O = M/(keep*T) is exact in
    bf16, so O is held bit for bit."""
    from vit_tpu_torch.ops.dropout import hash_dropout_mask

    t = d = 128
    q = torch.zeros(32, t, d, device="cuda", dtype=torch.bfloat16)
    v = torch.eye(t, device="cuda", dtype=torch.bfloat16).expand(32, t, d).contiguous()
    o, _ = (fa.short_fwd if short else fa.flash_fwd)(q, q, v, d**-0.5, 0.5, seed)
    mask = hash_dropout_mask(t, t, torch.arange(32), seed, 0.5).cuda()
    assert torch.equal(o == 0, mask == 0)
    assert torch.equal(o, (mask / t).to(torch.bfloat16))


@pytest.mark.parametrize("seed", [0, -1, 2**31 - 1])
def test_bf16_backward_dropout_mask_is_hash_dropout_mask(gen, seed):
    """The flash backward in bf16 with lse = log T and delta = 0, so P = 1/T
    and every value below is exact in bf16. Q = 0, K = V = I, dO = 1 give
    dQ = scale * M/(keep*T); Q = K = 0, dO = I give dV[j, c] =
    M[c, j]/(keep*T). Each is zero exactly where hash_dropout_mask drops."""
    from vit_tpu_torch.ops.dropout import hash_dropout_mask

    t = d = 128
    bh, scale, bf = 32, d**-0.5, torch.bfloat16
    zeros = torch.zeros(bh, t, d, device="cuda", dtype=bf)
    eye = torch.eye(t, device="cuda", dtype=bf).expand(bh, t, d).contiguous()
    lse = torch.full((bh, t), float(torch.log(torch.tensor(float(t)))), device="cuda")
    delta = torch.zeros(bh, t, device="cuda")
    mask = hash_dropout_mask(t, t, torch.arange(bh), seed, 0.5).cuda()  # 0 or 1/keep
    dq, _, _ = fa.flash_bwd(zeros, eye, eye, torch.ones_like(zeros), lse, delta, scale, 0.5,
                            seed)
    _, _, dv = fa.flash_bwd(zeros, zeros, zeros, eye, lse, delta, scale, 0.5, seed)
    assert torch.equal(dq == 0, mask == 0)
    assert torch.equal(dq, (mask / t * scale).to(bf))
    assert torch.equal(dv == 0, mask.transpose(1, 2) == 0)
    assert torch.equal(dv, (mask / t).transpose(1, 2).to(bf))


def _mlp_bwd_operands(gen, r, d, f, dtype):
    x, dy = (torch.randn(r, d, generator=gen, device="cuda").to(dtype) for _ in range(2))
    w1 = (torch.randn(f, d, generator=gen, device="cuda") / d**0.5).to(dtype)
    b1 = (0.1 * torch.randn(f, generator=gen, device="cuda")).to(dtype)
    w2 = (torch.randn(d, f, generator=gen, device="cuda") / f**0.5).to(dtype)
    return x, dy, w1, b1, w2


def _check_mlp_bwd(x, dy, w1, b1, w2):
    """One launch of K7 within the limits of the plain version: dx by the
    kernel limit, the fp32 weight gradients within 1e-5 (fp32 inputs) or
    1e-3 (bf16) of their largest value; and bit-repeatable (no atomics)."""
    dtype = x.dtype
    before = KERNELS["fused_mlp_bwd"].launches
    got = fm.fused_mlp_bwd(x, dy, w1, b1, w2)
    torch.cuda.synchronize()
    assert KERNELS["fused_mlp_bwd"].launches == before + 1
    want = fm.fused_mlp_bwd_plain(x, dy, w1, b1, w2)
    assert got[0].dtype == dtype and all(g.dtype == torch.float32 for g in got[1:])
    assert (got[0].float() - want[0].float()).abs().max().item() <= _tol(want[0])
    rel = 1e-5 if dtype == torch.float32 else 1e-3
    for a, b in zip(got[1:], want[1:]):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= rel * max(1.0, b.abs().max().item())
    again = fm.fused_mlp_bwd(x, dy, w1, b1, w2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r, d, f", [(1, 16, 32), (65, 48, 96), (200, 128, 512),
                                     (130, 384, 1536), (64, 1024, 4096), (70, 100, 30),
                                     (5000, 128, 512), (4097, 128, 512), (65056, 128, 512),
                                     (2064, 32, 128)])
def test_fused_mlp_bwd_matches_plain_and_repeats(gen, r, d, f, dtype):
    """Every width, fp32 and bf16; R 4097 puts a ragged 64-row block at the
    end of a segment, R 65056 and 2064 are the stride-1 and baseline MLPs
    of the training runs."""
    _check_mlp_bwd(*_mlp_bwd_operands(gen, r, d, f, dtype))


@pytest.mark.parametrize("r, d, f", [(65056, 128, 512), (2064, 32, 128), (300, 100, 30),
                                     (8320, 384, 1536), (12608, 768, 3072)])
def test_fused_mlp_bwd_bf16_scratch_follows_the_route(gen, r, d, f):
    """bf16 at K3's widths runs a tensor-core body. At D <= 128 it keeps g
    and dh on chip: beyond dx, the fp32 gradients and the partials, the
    call's peak device memory holds less than one (R, F) bf16 tensor. The
    wide body (128 < D <= 1024) writes g and dh once, two such tensors, and
    with one segment no partials. D = 100, F = 30 (not multiples of 16) keep
    the FMA body, which moves g and dh through two such tensors; each is
    one launch of K7 within the same limits."""
    ops = _mlp_bwd_operands(gen, r, d, f, torch.bfloat16)
    tc, n_seg = fm.bwd_plan(r, d, f, torch.bfloat16)
    body = fm.mlp_body(d, f, torch.bfloat16)
    assert tc == (d % 16 == 0 and f % 16 == 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fm.fused_mlp_bwd(*ops)
    torch.cuda.synchronize()
    n = 2 * f * d + f + d
    partials = 0 if body == "wide" and n_seg == 1 else n_seg * n * 4
    scratch = torch.cuda.max_memory_allocated() - base - (r * d * 2 + n * 4 + partials)
    rf = r * f * 2
    assert scratch < rf if body == "tc" else scratch >= 2 * rf
    _check_mlp_bwd(*ops)


@pytest.mark.parametrize("fused_mlp, attn_impl, t_image", [(True, "flash", 1100),
                                                          (True, "flash", 256),
                                                          (False, "xla", 256)])
def test_training_step_on_the_card_matches_the_cpu(gen, fused_mlp, attn_impl, t_image):
    """Loss and every parameter gradient of one training step with dropout
    on, on the card and on the CPU from the same weights and seeds (fp32):
    per tensor within 1e-4 of the larger of its norm and 1e-3 of the global
    norm (the floor covers gradients that are zero in exact arithmetic)."""
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.train.loop import loss_and_grads

    cfg = {"model": dict(task_type="reg", image_size=t_image, patch_size=16, hidden_size=64,
                         num_hidden_layers=2, num_attention_heads=2, stride_size=2,
                         attn_impl=attn_impl, fused_mlp=fused_mlp, remat="mlp"),
           "data": {"param": "log_g"}}
    model = get_model(cfg, generator=torch.Generator().manual_seed(1)).module.train()
    batch = {"x": torch.randn(3, t_image, generator=torch.Generator().manual_seed(2)),
             "label": torch.rand(3, 1, generator=torch.Generator().manual_seed(3))}
    seeds = [list(range(11, 11 + model.num_dropout_sites))]
    loss_cpu = loss_and_grads(model, batch, "reg", "mae", seeds).item()
    want = [p.grad.clone() for p in model.parameters()]
    model.cuda()
    loss = loss_and_grads(model, {k: v.cuda() for k, v in batch.items()}, "reg", "mae", seeds)
    assert abs(loss.item() - loss_cpu) <= 1e-5
    total = torch.sqrt(sum(w.square().sum() for w in want))
    for p, w in zip(model.parameters(), want):
        err = (p.grad.cpu() - w).norm()
        assert err <= 1e-4 * max(w.norm(), 1e-3 * total)


@pytest.mark.parametrize("seed", [0, -1, 2**31 - 1])
def test_bf16_short_backward_dropout_mask_is_hash_dropout_mask(gen, seed):
    """K6 in bf16 with lse = log T and delta = 0 (P = 1/T): dQ and dV by K4's
    and K5's constructions above, and dK with Q = K6_Q * I, K = 0, V = I,
    dO = 1, which gives dK[j, c] = M[c, j]/(keep*T) * bf16(K6_Q *
    bf16(scale)) (K6's rounding of Q*scale; K5's would give other bits).
    All exact in bf16, held bit for bit."""
    from chip_smoke import K6_Q
    from vit_tpu_torch.ops.dropout import hash_dropout_mask

    t = d = 128
    bh, scale, bf = 32, d**-0.5, torch.bfloat16
    zeros = torch.zeros(bh, t, d, device="cuda", dtype=bf)
    eye = torch.eye(t, device="cuda", dtype=bf).expand(bh, t, d).contiguous()
    ones = torch.ones_like(zeros)
    lse = torch.full((bh, t), float(torch.log(torch.tensor(float(t)))), device="cuda")
    delta = torch.zeros(bh, t, device="cuda")
    mask = hash_dropout_mask(t, t, torch.arange(bh), seed, 0.5).cuda()
    dq = fa.short_bwd(zeros, eye, eye, ones, lse, delta, scale, 0.5, seed)[0]
    dv = fa.short_bwd(zeros, zeros, zeros, eye, lse, delta, scale, 0.5, seed)[2]
    dk = fa.short_bwd((K6_Q * eye).contiguous(), zeros, eye, ones, lse, delta, scale, 0.5,
                      seed)[1]
    qs = float((K6_Q * torch.tensor(scale, dtype=bf).float()).to(bf))
    assert torch.equal(dq, (mask / t * scale).to(bf))
    assert torch.equal(dv, (mask / t).transpose(1, 2).to(bf))
    assert torch.equal(dk == 0, mask.transpose(1, 2) == 0)
    assert torch.equal(dk, ((mask / t).transpose(1, 2) * qs).to(bf))


@pytest.mark.parametrize("seed", [0, -1, 2**31 - 1])
def test_device_seed_gives_the_int_seeds_masks(gen, seed):
    """K1, K2, K4, K5 and K6 read their seed from device memory: a 0-d
    int32 seed on the card gives bit for bit the int seed's outputs, and the
    masks of hash_dropout_mask (Q = 0, V = I: O = M/(keep*T) in fp32)."""
    from vit_tpu_torch.ops.dropout import hash_dropout_mask

    t = d = 128
    bh, scale = 8, d**-0.5
    dev = torch.tensor(seed, dtype=torch.int32, device="cuda")
    q = torch.zeros(bh, t, d, device="cuda")
    v = torch.eye(t, device="cuda").expand(bh, t, d).contiguous()
    mask = hash_dropout_mask(t, t, torch.arange(bh), seed, 0.5).cuda()
    for fwd in (fa.short_fwd, fa.flash_fwd):
        o = fwd(q, q, v, scale, 0.5, dev)[0]
        assert torch.equal(o, fwd(q, q, v, scale, 0.5, seed)[0])
        assert torch.equal(o == 0, mask == 0)
    x = [torch.randn(bh, t, d, generator=gen, device="cuda", dtype=torch.bfloat16)
         for _ in range(4)]
    lse = torch.randn(bh, t, generator=gen, device="cuda").abs() + 3.0
    delta = torch.randn(bh, t, generator=gen, device="cuda")
    for bwd in (fa.short_bwd, fa.flash_bwd):
        a = bwd(*x, lse, delta, scale, 0.5, dev)
        b = bwd(*x, lse, delta, scale, 0.5, seed)
        assert all(torch.equal(u, w) for u, w in zip(a, b))


def test_captured_step_replays_equal_to_eager(gen, tmp_path, monkeypatch):
    """A tiny model (the short kernels and the fused MLP, dropout and noise
    on) trained two epochs through the CUDA graph of its step and through
    the per-step path from one seed: the same parameters within vit_tpu's
    fused-epoch bound (rel 1e-6, abs 1e-7), the graph replayed."""
    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.train.loop import Experiment

    monkeypatch.setenv("CKPT_DIR", str(tmp_path))
    cfg = {"model": dict(name="vit", task_type="reg", image_size=256, patch_size=16,
                         hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                         stride_size=16, attn_impl="flash", fused_mlp=True, remat="mlp"),
           "train": {"batch_size": 8, "ep": 2, "save": False},
           "loss": {"name": "mae"}, "opt": {"type": "AdamW", "lr": 1e-3, "lr_sch": "none"},
           "data": {"file_path": "in-memory", "val_path": "in-memory", "param": "log_g",
                    "num_samples": 64, "label_norm": "minmax"},
           "noise": {"noise_level": 0.5}, "viz": {"enable": False}}
    data = make_dummy_spectra(n=64, length=256, seed=1)
    params = []
    for fused in (False, True):
        c = dict(cfg, train=dict(cfg["train"], fused_epoch=fused))
        exp = Experiment(c, device="cuda", seed=0, datamodule=SpecDataModule(c, source=data))
        exp.fit()
        params.append({k: v.detach().cpu() for k, v in exp.module.state_dict().items()})
    assert exp.fused is not None and exp.fused.replays == 2 * 8 - 1
    for k in params[0]:
        assert torch.allclose(params[1][k], params[0][k], rtol=1e-6, atol=1e-7), k


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t, short", [(65, True), (129, True), (197, True), (600, False)])
def test_seed_vector_launch_is_r_single_launches(gen, t, short, dtype):
    """K1, K2, K4, K5, K6 over three stacked replicas with a seed each
    (bh_per_seed): every output bit for bit the replica's own launch, and
    the stacked launch within tolerance of the plain version."""
    fwd, bwd = (fa.short_fwd, fa.short_bwd) if short else (fa.flash_fwd, fa.flash_bwd)
    pfwd, pbwd = ((fa.short_fwd_plain, fa.short_bwd_plain) if short
                  else (fa.flash_fwd_plain, fa.flash_bwd_plain))
    seeds, per, d = [7, -1, 2**31 - 1], 6, 64
    sv = torch.tensor(seeds, dtype=torch.int32, device="cuda")
    q, k, v = _qkv(gen, len(seeds) * per, t, d, dtype)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    o, lse = fwd(q, k, v, d**-0.5, 0.1, sv, per)
    delta = (do.float() * o.float()).sum(-1)
    grads = bwd(q, k, v, do, lse, delta, d**-0.5, 0.1, sv, per)
    for i, s in enumerate(seeds):
        sl = slice(i * per, (i + 1) * per)
        o1, lse1 = fwd(q[sl], k[sl], v[sl], d**-0.5, 0.1, s)
        assert torch.equal(o[sl], o1) and torch.equal(lse[sl], lse1)
        for a, b in zip(grads, bwd(q[sl], k[sl], v[sl], do[sl], lse1, delta[sl], d**-0.5, 0.1,
                                   s)):
            assert torch.equal(a[sl], b)
    o_ref, _ = pfwd(q, k, v, d**-0.5, 0.1, sv, per)
    assert (o.float() - o_ref.float()).abs().max().item() <= _tol(o_ref)
    for a, b in zip(grads, pbwd(q, k, v, do, lse, delta, d**-0.5, 0.1, sv, per)):
        assert (a.float() - b.float()).abs().max().item() <= _tol(b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vmap_rules_launch_as_the_stacked_replicas(gen, dtype):
    """torch.func.vmap over three replicas: flash_attention folds them into
    one launch of K2 and K6 with their seeds, the fused MLP launches K3 and
    K7 once per replica on its own weights; outputs and gradients against
    each replica's plain version on the CPU in the same dtype (the weight
    gradients, fp32 sums over every row, to 1e-5 / 1e-3 of their largest
    value as above)."""
    from vit_tpu_torch.ops.flash_attention import flash_attention

    r, b, h, t, d, f = 3, 4, 2, 65, 64, 256
    seeds = torch.tensor([3, 4, 5], dtype=torch.int32, device="cuda")
    q, k, v = (torch.randn(r, b, h, t, d, generator=gen, device="cuda").to(dtype)
               .requires_grad_(True) for _ in range(3))
    before = {n: KERNELS[n].launches for n in KERNELS}
    o = torch.func.vmap(lambda q, k, v, s: flash_attention(q, k, v, 0.1, s))(q, k, v, seeds)
    co = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)  # dO, exact on both sides
    grads = torch.autograd.grad(o, (q, k, v), co)
    assert KERNELS["short_fwd"].launches == before["short_fwd"] + 1
    assert KERNELS["short_bwd"].launches == before["short_bwd"] + 1
    for i in range(r):
        qi, ki, vi = (x[i].detach().cpu().requires_grad_(True) for x in (q, k, v))
        oi = flash_attention(qi, ki, vi, 0.1, int(seeds[i]))
        gi = torch.autograd.grad(oi, (qi, ki, vi), co[i].cpu())
        assert (o[i].float().cpu() - oi.float()).abs().max().item() <= _tol(oi)
        for a, c in zip(grads, gi):
            assert (a[i].float().cpu() - c.float()).abs().max().item() <= _tol(c)
    x = torch.randn(r, b * t, d, generator=gen, device="cuda").to(dtype).requires_grad_(True)
    w = [torch.randn(r, *shape, generator=gen, device="cuda").mul_(0.05).requires_grad_(True)
         for shape in ((f, d), (f,), (d, f), (d,))]
    before = {n: KERNELS[n].launches for n in KERNELS}
    y = torch.func.vmap(fm.fused_mlp)(x, *w)
    cy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
    gy = torch.autograd.grad(y, (x, *w), cy)
    assert KERNELS["fused_mlp_fwd"].launches == before["fused_mlp_fwd"] + r
    assert KERNELS["fused_mlp_bwd"].launches == before["fused_mlp_bwd"] + r
    rel = 1e-5 if dtype == torch.float32 else 1e-3
    for i in range(r):
        xi = x[i].detach().cpu().requires_grad_(True)
        wi = [t_[i].detach().cpu().requires_grad_(True) for t_ in w]
        yi = fm.fused_mlp(xi, *wi)
        gi = torch.autograd.grad(yi, (xi, *wi), cy[i].cpu())
        assert (y[i].float().cpu() - yi.float()).abs().max().item() <= _tol(yi)
        assert (gy[0][i].float().cpu() - gi[0].float()).abs().max().item() <= _tol(gi[0])
        for a, c in zip(gy[1:], gi[1:]):
            assert (a[i].cpu() - c).abs().max().item() <= rel * c.abs().max().item()


# -- int8 serving and the served kernels as custom operators ------------------------
@pytest.mark.parametrize("rows", [1, 16, 17, 300])
def test_int8_dense_on_int_mm_matches_the_cpu(gen, rows):
    """torch._int_mm on the card: 16 rows and fewer are padded to 17; the
    int32 products are exact, so the card equals the CPU's int8_dense to one
    fp32 rounding of the rescale (dynamic and static activation scales)."""
    from vit_tpu_torch.ops import quant

    x = torch.randn(rows, 128, generator=gen, device="cuda")
    w = torch.randn(256, 128, generator=gen, device="cuda") * 0.05
    scale = torch.clamp_min(w.abs().amax(1), 1e-12) / 127.0
    wq = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    b = torch.randn(256, generator=gen, device="cuda") * 0.01
    xq = torch.randint(-127, 128, (rows, 128), generator=gen, device="cuda", dtype=torch.int8)
    assert torch.equal(quant.int8_matmul(xq, wq).cpu(), xq.cpu().int() @ wq.cpu().int().t())
    for sx in (None, torch.tensor(0.02, device="cuda")):
        got = quant.int8_dense(x, wq, scale, b, sx=sx)
        want = quant.int8_dense(x.cpu(), wq.cpu(), scale.cpu(), b.cpu(),
                                sx=None if sx is None else sx.cpu())
        torch.testing.assert_close(got.cpu(), want, rtol=2**-23, atol=1e-6)
    xb = x.to(torch.bfloat16)
    assert quant.int8_dense(xb, wq, scale, b).dtype == torch.bfloat16  # x's dtype back


@pytest.mark.parametrize("k, n", [(100, 256), (128, 60)])
def test_int8_matmul_refuses_what_int_mm_cannot_take(gen, k, n):
    from vit_tpu_torch.ops import quant

    xq = torch.zeros(32, k, dtype=torch.int8, device="cuda")
    wq = torch.zeros(n, k, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_matmul(xq, wq)


@pytest.mark.parametrize("short, t", [(True, 129), (False, 1100)])
def test_served_custom_ops_launch_the_kernels(gen, short, t):
    """The served forward's K1/K2 and K3 custom operators launch the kernels
    once a call (what an exported program runs) and equal the wrappers."""
    q, k, v = _qkv(gen, 4, t, 64, torch.bfloat16)
    name = "short_fwd" if short else "flash_fwd"
    op = getattr(torch.ops.vit_tpu_torch, name)
    before = KERNELS[name].launches
    o, lse = op(q, k, v, 0.125, 0.0, None)
    torch.cuda.synchronize()
    assert KERNELS[name].launches == before + 1
    o2, lse2 = (fa.short_fwd if short else fa.flash_fwd)(q, k, v, 0.125)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    x, w1, b1, w2, b2 = _mlp_operands(gen, 300, 128, 512, torch.bfloat16)
    before = KERNELS["fused_mlp_fwd"].launches
    y = torch.ops.vit_tpu_torch.fused_mlp_fwd(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert KERNELS["fused_mlp_fwd"].launches == before + 1
    assert torch.equal(y, fm.fused_mlp(x, w1, b1, w2, b2))


def test_stream_dropout_in_a_graph_equals_eager(gen):
    """fast_dropout: false's stream from a device seed: a captured CUDA graph
    replayed with new seeds in its buffer draws the eager masks bit for bit,
    and the card's masks are the CPU's (the kept values to one fp32 ulp:
    the card divides by a scalar as a product with its reciprocal)."""
    from vit_tpu_torch.ops.dropout import stream_dropout

    x = torch.randn(16, 129, 32, generator=gen, device="cuda")
    seed = torch.zeros((), dtype=torch.int32, device="cuda")
    out = torch.empty_like(x)
    stream_dropout(x, 0.1, seed)  # warm-up before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(stream_dropout(x, 0.1, seed))
    for s in (0, -1, 2**31 - 1, 12345):
        seed.fill_(s)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, stream_dropout(x, 0.1, s))
        cpu = stream_dropout(x.cpu(), 0.1, s)
        assert torch.equal(out.cpu() != 0, cpu != 0)
        torch.testing.assert_close(out.cpu(), cpu, rtol=2**-23, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_layer_on_the_card_matches_the_cpu(gen, dtype):
    """The MoE layer at ViT-S/16-MoE's widths (E 8, top-2, C 21, D 384,
    F 1536, T 65) on the card against the same layer on the CPU: the same
    routing (the router runs in fp32 on the same inputs), the output within
    _tol of the CPU's and the statistics within 1e-5; then the gradients
    of the same loss, per tensor within 1e-4 (fp32) or 2e-2 (bf16) of the
    larger of its norm and 1e-3 of the global norm."""
    from vit_tpu_torch.models.builder import get_vit_config
    from vit_tpu_torch.models.moe import MoEMLP

    precision = "bf16" if dtype == torch.bfloat16 else "float32"
    cfg = get_vit_config({"model": dict(name="vit-s16", task_type="cls", input_kind="image",
                                        image_size=32, patch_size=4, num_labels=10,
                                        moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25),
                          "train": {"precision": precision}})
    layer, g = MoEMLP(cfg), torch.Generator().manual_seed(0)
    layer.init_(g)
    layer.router.init_(g)
    x = torch.randn(4, 65, 384, generator=torch.Generator().manual_seed(1)).to(dtype)
    cpu = []
    for dev in ("cpu", "cuda"):
        layer.to(dev).zero_grad()
        xi = x.to(dev).clone().requires_grad_(True)
        y, stats = layer(xi)
        (y.float().square().mean() + stats[0]).backward()
        idx = layer.route(xi.detach())[3]
        cpu.append((y.detach().cpu(), stats.detach().cpu(), idx.cpu(),
                    [p.grad.float().cpu().clone() for p in layer.parameters()]
                    + [xi.grad.float().cpu()]))
    (y0, s0, i0, g0), (y1, s1, i1, g1) = cpu
    assert torch.equal(i0, i1)
    assert (y1.float() - y0.float()).abs().max().item() <= _tol(y0)
    assert torch.allclose(s1, s0, rtol=0, atol=1e-5)
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    total = torch.sqrt(sum(g.square().sum() for g in g0))
    for a, b in zip(g1, g0):
        assert (a - b).norm() <= tol * max(b.norm(), 1e-3 * total)


def test_moe_step_in_a_graph_equals_the_per_step_path(gen, tmp_path, monkeypatch):
    """A tiny MoE model (E 4, top-2 at cf 1.0, router jitter, dropout, the
    short kernels) trained two epochs through the CUDA graph of its step and
    per step from one seed: the parameters bit-equal; the routing's
    one-hots, cumsum and top-k hold no host read, so the step captures."""
    from vit_tpu_torch.data.datasets import SpecDataModule
    from vit_tpu_torch.data.synthetic import make_dummy_spectra
    from vit_tpu_torch.train.loop import Experiment

    monkeypatch.setenv("CKPT_DIR", str(tmp_path))
    cfg = {"model": dict(name="vit", task_type="reg", image_size=256, patch_size=16,
                         hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                         stride_size=16, attn_impl="flash", moe_experts=4, moe_top_k=2,
                         moe_capacity_factor=1.0, moe_router_jitter=0.1, moe_z_weight=1e-3),
           "train": {"batch_size": 8, "ep": 2, "save": False},
           "loss": {"name": "mae"}, "opt": {"type": "AdamW", "lr": 1e-3, "lr_sch": "none"},
           "data": {"file_path": "in-memory", "val_path": "in-memory", "param": "log_g",
                    "num_samples": 64, "label_norm": "minmax"},
           "noise": {"noise_level": 0}, "viz": {"enable": False}}
    data = make_dummy_spectra(n=64, length=256, seed=1)
    params, dropped = [], []
    for fused in (False, True):
        c = dict(cfg, train=dict(cfg["train"], fused_epoch=fused))
        exp = Experiment(c, device="cuda", seed=0, datamodule=SpecDataModule(c, source=data))
        dropped.append(exp.fit()["moe_dropped_frac"])
        params.append({k: v.detach().cpu() for k, v in exp.module.state_dict().items()})
    assert exp.fused is not None and exp.fused.replays == 2 * 8 - 1
    assert dropped[0] == dropped[1]
    for k in params[0]:
        assert torch.equal(params[1][k], params[0][k]), k


# The offline statistics (vit_tpu_torch.prepca, spectro) on the card against
# device="cpu" at a small size; chip_smoke.py's run (P) holds them at full
# size. Limits as there: float64 results 1e-5, float32 products 1e-4,
# relative to the largest value, after aligning eigenvector groups.
def _offline_data():
    from vit_tpu_torch.data.synthetic import make_dummy_spectra

    return make_dummy_spectra(n=384, length=512, seed=2)["flux"]


@pytest.mark.parametrize("step", [32, 1])
def test_compute_pca_on_the_card_matches_the_cpu(gen, step):
    import numpy as np

    from chip_smoke import P_F32, P_F64, aligned_err
    from vit_tpu_torch.prepca.pipeline import compute_pca

    flux = _offline_data()
    card = compute_pca(torch.from_numpy(flux).cuda(), patch_size=32, step=step, device="cuda")
    cpu = compute_pca(flux, patch_size=32, step=step, device="cpu")
    lam = cpu["singular_values"].astype(np.float64) ** 2
    np.testing.assert_allclose(card["singular_values"], cpu["singular_values"], rtol=P_F64)
    assert aligned_err(cpu["components"], card["components"], lam) <= P_F64
    assert aligned_err(cpu["scores"], card["scores"], lam) <= P_F32


def test_kernel_pca_on_the_card_matches_the_cpu(gen):
    import numpy as np

    from chip_smoke import P_CHUNK, P_F32, P_F64, aligned_err, rel_err
    from vit_tpu_torch.prepca.pipeline import compute_kernel_pca

    flux = _offline_data()
    card = compute_kernel_pca(torch.from_numpy(flux).cuda(), r=16, landmarks=256, device="cuda")
    cpu = compute_kernel_pca(flux, r=16, landmarks=256, device="cpu")
    assert np.array_equal(card.landmarks, cpu.landmarks) and card.gamma == cpu.gamma
    lam = 1.0 / (cpu.A.astype(np.float64) ** 2).sum(0)
    lam_card = 1.0 / (card.A.astype(np.float64) ** 2).sum(0)
    assert np.abs(lam_card - lam).max() <= P_F64 * lam.max()
    z = card.transform(flux, chunk=100)
    assert rel_err(z, card.transform(flux)) <= P_CHUNK
    assert aligned_err(cpu.transform(flux), z, lam) <= P_F32


@pytest.mark.parametrize("rank", [None, 8])
def test_zca_on_the_card_matches_the_cpu(gen, rank):
    from chip_smoke import P_F64, rel_err
    from vit_tpu_torch.prepca.pipeline import ZCAWhitening

    flux = _offline_data()[:, :128]  # more spectra than pixels: full rank
    kw = dict(gamma=0.1, eps=1e-5, rank=rank, alpha=0.1)
    card = ZCAWhitening(device="cuda", **kw).fit(torch.from_numpy(flux).cuda())
    cpu = ZCAWhitening(device="cpu", **kw).fit(flux)
    for key in ("whitening", "covariance", "eigenvalues", "mean"):
        assert rel_err(getattr(card._state, key), getattr(cpu._state, key)) <= P_F64, key
    assert rel_err(card.transform(flux[:8]), cpu.transform(flux[:8])) <= P_F64


def test_pcp_on_the_card_matches_the_cpu(gen):
    import numpy as np

    from chip_smoke import P_PCP, P_PCP_ITERS
    from vit_tpu_torch.prepca.pipeline import compute_pcp

    flux = _offline_data()[:128, :256]
    L, S, h = compute_pcp(torch.from_numpy(flux).cuda(), device="cuda")
    Lc, Sc, hc = compute_pcp(flux, device="cpu")
    norm = np.linalg.norm(flux.astype(np.float64))
    assert np.abs(L - Lc).max() <= P_PCP * norm and np.abs(S - Sc).max() <= P_PCP * norm
    assert abs(h["iters"] - hc["iters"]) <= P_PCP_ITERS and h["primal_resid"][-1] < 1e-7


def test_svd_denoiser_on_the_card_matches_the_cpu(gen):
    from chip_smoke import P_F64, aligned_err, rel_err
    from vit_tpu_torch.spectro import SVDDenoiser

    flux = _offline_data()
    card = SVDDenoiser(16, device="cuda").fit(torch.from_numpy(flux).cuda())
    cpu = SVDDenoiser(16, device="cpu").fit(flux)
    assert rel_err(card.explained_variance_ratio_, cpu.explained_variance_ratio_) <= P_F64
    assert aligned_err(cpu.V, card.V, cpu.explained_variance_ratio_) <= P_F64
    assert rel_err(card.denoise(flux[:16] + 0.01), cpu.denoise(flux[:16] + 0.01)) <= P_F64


def test_kpca_warm_attention_on_the_card_matches_the_cpu(gen):
    import numpy as np

    from chip_smoke import P_F32, rel_err
    from vit_tpu_torch.prepca.attention import KPCAWarmSelfAttention
    from vit_tpu_torch.prepca.pipeline import compute_kernel_pca

    rng = np.random.default_rng(0)
    state = compute_kernel_pca(rng.standard_normal((512, 32)).astype(np.float32), r=16,
                               landmarks=128, device="cuda")
    card = KPCAWarmSelfAttention(32, 2, state, generator=torch.Generator().manual_seed(0),
                                 device="cuda")
    cpu = KPCAWarmSelfAttention(32, 2, state, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    x = torch.from_numpy(rng.standard_normal((3, 130, 32)).astype(np.float32))
    got = []
    for m, xx in ((card, x.cuda()), (cpu, x)):
        xx = xx.clone().requires_grad_(True)
        out, probs = m(xx, need_weights=True)
        out.square().sum().backward()
        got.append([t.detach().cpu() for t in (out, probs, xx.grad)]
                   + [p.grad.cpu() for _, p in sorted(m.named_parameters())])
    for a, b in zip(*got):
        assert rel_err(a, b) <= P_F32


# -- a data-parallel rank's launches (the batch offset) ------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t, short", [(129, True), (197, True), (1000, False), (4066, False)])
def test_batch_offset_launch_is_the_full_launchs_slice(gen, t, short, dtype):
    """Rows [2, 4) of a batch of 4 (2 heads), launched alone with bh_offset
    4, give the full launch's heads 4..7 bit for bit, forward and backward,
    with dropout: K1/K2, K4+K5/K6 hash the global head. The plain versions
    with the same offset agree at the kernel limits."""
    h, lo, rate, seed, d = 2, 2, 0.1, 7, 64
    q, k, v = _qkv(gen, 4 * h, t, d, dtype)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    fwd, bwd = (fa.short_fwd, fa.short_bwd) if short else (fa.flash_fwd, fa.flash_bwd)
    scale = d ** -0.5
    part = [x[lo * h:].contiguous() for x in (q, k, v, do)]
    o, lse = fwd(q, k, v, scale, rate, seed)
    o2, lse2 = fwd(*part[:3], scale, rate, seed, bh_offset=lo * h)
    assert torch.equal(o2, o[lo * h:]) and torch.equal(lse2, lse[lo * h:])
    delta = (do.float() * o.float()).sum(-1)
    full = bwd(q, k, v, do, lse, delta, scale, rate, seed)
    mine = bwd(*part, lse[lo * h:].contiguous(), delta[lo * h:].contiguous(), scale, rate, seed,
               bh_offset=lo * h)
    for a, b in zip(mine, full):
        assert torch.equal(a, b[lo * h:])
    plain = (fa.short_fwd_plain if short else fa.flash_fwd_plain)(
        *part[:3], scale, rate, seed, bh_offset=lo * h)
    assert (plain[0].float() - o2.float()).abs().max().item() <= _tol(plain[0])


def test_two_rank_gloo_ring_on_the_card_matches_k1_k4_k5(gen):
    """Ring attention on two gloo ranks sharing the card (CUDA tensors
    staged through the host by the collective wrapper), at stride1's head
    shape, against K1 and K4+K5 on the whole sequence (fp32, no dropout)."""
    import numpy as np

    from torch_ranks import Ranks, ring

    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((2, 2, 1024, 64)).astype(np.float32) for _ in range(4))
    ranks = Ranks(2)
    try:
        res = ranks.run(ring, 2, 1, q, k, v, g, 0.0, None, None, "cuda")
    finally:
        ranks.close()
    xs = [torch.from_numpy(a).cuda().reshape(4, 1024, 64) for a in (q, k, v, g)]
    o, lse = fa.flash_fwd(*xs[:3], 64 ** -0.5)
    delta = (xs[3] * o).sum(-1)
    grads = fa.flash_bwd(*xs[:3], xs[3], lse, delta, 64 ** -0.5)
    want = [t.reshape(2, 2, 1024, 64).cpu().numpy() for t in (o, *grads)]
    for rank_out in res:
        _, *got = rank_out
        for a, b in zip(got, want):
            assert np.abs(a - b).max() <= FP32_TOL * max(1.0, np.abs(b).max())



# -- vit_tpu's envelope: library_mlp outside it --------------------------------------
@pytest.mark.parametrize("r, d, f, dtype", [(64 * 197, 768, 3072, torch.bfloat16),
                                            (1000, 384, 1536, torch.float32)])
def test_library_mlp_on_the_card_matches_the_plain_versions(gen, r, d, f, dtype):
    """library_mlp (the model's MLP outside the envelope: ViT-B/16 at (u)'s
    rows in bf16, ViT-S/16 in fp32) launches no kernel, and its forward and
    autograd gradients hold against the plain versions of K3 and K7: y and
    dx at the bf16 limit; bf16 weight gradients come out of bf16 operands,
    so four bf16 ulps of their largest value; fp32 as _check_mlp_bwd."""
    x, w1, b1, w2, b2 = _mlp_operands(gen, r, d, f, dtype)
    dy = torch.randn(r, d, generator=gen, device="cuda").to(dtype)
    leaves = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
    before = {n: k.launches for n, k in KERNELS.items()}
    y = fm.library_mlp(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert {n: k.launches for n, k in KERNELS.items()} == before
    want = [fm.fused_mlp_plain(x, w1, b1, w2, b2), *fm.fused_mlp_bwd_plain(x, dy, w1, b1, w2)]
    for name, a, b in zip(("y", "dx", "dW1", "db1", "dW2", "db2"), [y, *got], want):
        assert a.dtype == dtype and a.shape == b.shape, name
        if name in ("y", "dx"):
            tol = _tol(b)
        elif dtype == torch.bfloat16:
            tol = 4 * 2**-8 * b.abs().max().item()
        else:
            tol = 1e-5 * max(1.0, b.abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol, name


@pytest.mark.parametrize("hidden, mlp, launches", [(768, 3072, 0), (384, 1536, 1)])
def test_model_mlp_route_on_the_card_follows_the_envelope(gen, hidden, mlp, launches):
    """fused_mlp: true in bf16: outside vit_tpu's envelope (D768, F3072) a
    training step launches neither K3 nor K7; inside (D384, F1536) one
    each a layer. The card's logits and loss stand within bf16 of the CPU's."""
    from vit_tpu_torch.models.builder import get_model

    cfg = {"model": dict(task_type="reg", image_size=256, patch_size=16, hidden_size=hidden,
                         intermediate_size=mlp, num_hidden_layers=1,
                         num_attention_heads=hidden // 64, stride_size=16, attn_impl="flash",
                         fused_mlp=True),
           "train": {"precision": "bf16"}, "data": {"param": "log_g"}}
    model = get_model(cfg, generator=torch.Generator().manual_seed(1)).module.eval()
    x = torch.randn(4, 256, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(x)
    model.cuda()
    before = {n: KERNELS[n].launches for n in ("fused_mlp_fwd", "fused_mlp_bwd")}
    got = model(x.cuda())
    got.float().square().sum().backward()
    torch.cuda.synchronize()
    assert {n: KERNELS[n].launches - before[n] for n in before} == {
        "fused_mlp_fwd": launches, "fused_mlp_bwd": launches}
    assert (got.detach().cpu() - want).abs().max().item() <= 1e-2


# -- hash dropout, csrc/hash_dropout.cu -------------------------------------------------
# The kernel against the torch ops it replaces (``x * hash_keep_mask(...).to(x.dtype)``,
# run on the card), forward and backward, bit for bit: compared as integers, so the
# sign of zero and every NaN's bits count.
HASH_DTYPES = [torch.float32, torch.bfloat16, torch.float16]
HASH_SHAPES = [(3, 2, 1, 2, 3)[:rank - 1] + (last,) for rank in range(1, 7)
               for last in (1, 197, 768, 4066)] + [(8, 12, 197, 197)]


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _torch_ops(x, rate, seed, offsets=None):
    from vit_tpu_torch.ops.dropout import hash_keep_mask

    return x * hash_keep_mask(x.shape, rate, seed, offsets, device=x.device).to(x.dtype)


def _with_grad(fn, x, g):
    """(fn(x), the gradient of fn's output against ``g`` at x)."""
    x = x.detach().requires_grad_()
    y = fn(x)
    y.backward(g)
    return y.detach(), x.grad


def _hash_launches() -> int:
    return KERNELS["hash_dropout"].launches


def _check_hash_dropout(x, g, rate, seed, offsets=None, launches=2):
    from vit_tpu_torch.ops.dropout import hash_dropout

    launched = _hash_launches()
    y, dx = _with_grad(lambda t: hash_dropout(t, rate, seed, offsets), x, g)
    torch.cuda.synchronize()
    assert _hash_launches() == launched + launches
    ref_seed = seed.cpu() if isinstance(seed, torch.Tensor) else seed
    want, want_dx = _with_grad(lambda t: _torch_ops(t, rate, ref_seed, offsets), x, g)
    assert _same_bits(y, want) and _same_bits(dx, want_dx)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", HASH_DTYPES)
@pytest.mark.parametrize("shape", HASH_SHAPES, ids=str)
def test_hash_dropout_kernel_is_the_torch_ops(gen, shape, dtype, rate):
    x, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(2))
    _check_hash_dropout(x, g, rate, -123456789)


@pytest.mark.parametrize("dtype", HASH_DTYPES)
@pytest.mark.parametrize("seed", ["negative", "max", "device int32", "device int64"])
@pytest.mark.parametrize("offsets", [None, (3, -2, 2**31 - 1, 7)])
def test_hash_dropout_kernel_seeds_and_offsets(gen, dtype, seed, offsets):
    """An int seed is a kernel argument, a 0-d seed on the card is read by
    the kernel (an int64 one cast there first); offsets wrap as int32."""
    seed = {"negative": -7, "max": 2**31 - 1,
            "device int32": torch.tensor(-99, dtype=torch.int32, device="cuda"),
            "device int64": torch.tensor(2**33 + 5, device="cuda")}[seed]
    x, g = (torch.randn(5, 3, 197, 197, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    _check_hash_dropout(x, g, 0.1, seed, offsets)


@pytest.mark.parametrize("dtype", HASH_DTYPES)
def test_hash_dropout_kernel_batch_offset(gen, dtype):
    """A data-parallel rank's site (``site_dropout`` in a ``batch_offset``)
    draws its rows of the whole batch's mask."""
    from vit_tpu_torch.ops.dropout import batch_offset, hash_dropout, site_dropout

    x = torch.randn(12, 197, 768, generator=gen, device="cuda").to(dtype)
    with batch_offset(4):
        y = site_dropout(x[4:8], 0.1, 31)
    assert _same_bits(y, hash_dropout(x, 0.1, 31)[4:8])
    assert _same_bits(y, _torch_ops(x[4:8].contiguous(), 0.1, 31, (4, 0, 0)))


@pytest.mark.parametrize("dtype", HASH_DTYPES)
def test_hash_dropout_kernel_signed_zeros_infs_and_nans(gen, dtype):
    """A dropped element is x * 0: -0 from a negative x, NaN from inf or NaN;
    a kept one keeps its sign, and inf stays inf."""
    x = -torch.rand(4, 197, 768, generator=gen, device="cuda").to(dtype)
    flat = x.view(-1)
    flat[::7] = float("inf")
    flat[3::11] = float("-inf")
    flat[5::13] = float("nan")
    flat[6::17] = 0.0
    flat[8::19] = -0.0
    g = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    g.view(-1)[1::9] = float("nan")
    g.view(-1)[2::10] = -0.0
    _check_hash_dropout(x, g, 0.5, 2024)


def test_hash_dropout_kernel_takes_views_and_unaligned_inputs(gen):
    """A non-contiguous input is made contiguous, an unaligned one copied."""
    x = torch.randn(2, 197, 770, generator=gen, device="cuda").to(torch.bfloat16)
    unaligned = x.view(-1)[1:1 + 2 * 197 * 768].view(2, 197, 768)
    assert unaligned.data_ptr() % 16 != 0
    for view in (x[..., 1:769], x.transpose(1, 2), unaligned):
        g = torch.randn(view.shape, generator=gen, device="cuda").to(torch.bfloat16)
        _check_hash_dropout(view, g, 0.1, 5)


def test_hash_dropout_kernel_under_remat(gen):
    """models.vit.remat (non-reentrant checkpoint) around a site: the
    recompute launches the kernel again, the backward keeps the batch offset
    its forward read, and every gradient is the torch ops' bit for bit."""
    from vit_tpu_torch.models.vit import remat
    from vit_tpu_torch.ops import dropout as dr

    lin = torch.nn.Linear(768, 768, device="cuda", dtype=torch.bfloat16)
    x = torch.randn(4, 197, 768, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)

    def grads(drop):
        def fn(t):  # the dropout is followed by an op that saves its output
            return lin(drop(lin(t), 0.1, 77, dr.batch_offsets(t.dim()))).tanh()

        xr = x.detach().requires_grad_()
        lin.zero_grad()
        with dr.batch_offset(8):
            y = remat(lin, fn, xr)
        y.backward(g)
        return [y.detach(), xr.grad, lin.weight.grad.clone(), lin.bias.grad.clone()]

    launched = _hash_launches()
    got = grads(dr.hash_dropout)
    assert _hash_launches() == launched + 3  # forward, recompute, backward
    want = grads(lambda t, rate, seed, offsets: _torch_ops(t, rate, seed, offsets))
    assert all(_same_bits(a, b) for a, b in zip(got, want))


def test_hash_dropout_kernel_in_a_cuda_graph(gen):
    """A 0-d device seed read by the kernel: a captured graph replayed with
    new seeds in its buffer draws each seed's mask."""
    from vit_tpu_torch.ops.dropout import hash_dropout

    x = torch.randn(8, 12, 197, 197, generator=gen, device="cuda").to(torch.bfloat16)
    seed = torch.zeros((), dtype=torch.int32, device="cuda")
    out = torch.empty_like(x)
    hash_dropout(x, 0.1, seed)  # warm-up before the capture
    torch.cuda.synchronize()
    launched = KERNELS["hash_dropout"].launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(hash_dropout(x, 0.1, seed))
    assert KERNELS["hash_dropout"].launches == launched + 1
    for s in (-5, 2**31 - 1):
        seed.fill_(s)
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(out, _torch_ops(x, 0.1, s))


def test_hash_dropout_launches_of_a_vitb16_layer(gen):
    """One ViT-B/16 layer (D 768, 12 heads, T 197, xla attention, remat:
    true) in bf16, forward and backward: the embeddings' site and the
    layer's three draw in the forward (4), the recompute draws the
    probabilities' and the attention output's again (2: the checkpoint
    stops once the MLP's saved tensors are back, before the MLP output's
    site), the backward runs each (4)."""
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.models.vit import compute_loss

    cfg = {"model": dict(name="vit-b16", task_type="cls", input_kind="image", image_size=224,
                         num_labels=1000, num_hidden_layers=1, remat=True, attn_impl="auto"),
           "train": {"precision": "bf16"}}
    model = get_model(cfg, generator=torch.Generator().manual_seed(0)).module.cuda().train()
    x = torch.randn(2, 3, 224, 224, generator=gen, device="cuda")
    labels = torch.tensor([3, 7], device="cuda")
    launched = _hash_launches()
    logits = model(x, dropout_seeds=list(range(1, 1 + model.num_dropout_sites)))
    assert _hash_launches() == launched + 4
    compute_loss(logits, labels, "cls", "ce").backward()
    torch.cuda.synchronize()
    assert _hash_launches() == launched + 10


@pytest.mark.parametrize("form", ["seed vector", "vmap"])
@pytest.mark.parametrize("dtype", HASH_DTYPES)
@pytest.mark.parametrize("shape, offsets", [((3, 197), None), ((3, 5, 1), (2, -1)),
                                            ((3, 4, 12, 197, 197), (5, 0, 0, 0)),
                                            ((3, 1, 2, 1, 2, 3, 768), None)], ids=str)
def test_hash_dropout_kernel_replicas(gen, form, dtype, shape, offsets):
    """Three replicas in one launch, forward and backward: an (R,) seed
    vector, or a call under torch.func.vmap with a seed a replica. Replica
    r's output and gradient are the torch ops' of its seed alone, bit for
    bit, with 1 to 6 hashed axes and offsets of the hashed axes."""
    from vit_tpu_torch.ops.dropout import hash_dropout

    x, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(2))
    seeds = torch.tensor([7, -123456789, 2**31 - 1], dtype=torch.int32, device="cuda")

    def fn(t):
        if form == "seed vector":
            return hash_dropout(t, 0.1, seeds, offsets)
        return torch.func.vmap(lambda tr, s: hash_dropout(tr, 0.1, s, offsets))(t, seeds)

    launched = _hash_launches()
    y, dx = _with_grad(fn, x, g)
    torch.cuda.synchronize()
    assert _hash_launches() == launched + 2
    for r, seed in enumerate(seeds.tolist()):
        assert _same_bits(y[r], _torch_ops(x[r], 0.1, seed, offsets))
        assert _same_bits(dx[r], _torch_ops(g[r], 0.1, seed, offsets))


def test_hash_dropout_launches_of_a_vmapped_vitb16_step(gen, monkeypatch):
    """The stacked sweep's step (``train.fused.ReplicaEpochs``: three
    replicas' losses under torch.func.vmap, then one backward) at one
    ViT-B/16 layer: the kernel launches as often as in one model's step
    (10, as above), once a site for all replicas, remat's recompute
    included; the losses and gradients are those of the torch ops under
    vmap, bit for bit."""
    from vit_tpu_torch.func_internals import reparametrize
    from vit_tpu_torch.models.builder import get_model
    from vit_tpu_torch.models.vit import compute_loss, train_forward
    from vit_tpu_torch.ops import dropout as dr

    cfg = {"model": dict(name="vit-b16", task_type="cls", input_kind="image", image_size=224,
                         num_labels=1000, num_hidden_layers=1, remat=True, attn_impl="auto"),
           "train": {"precision": "bf16"}}
    model = get_model(cfg, generator=torch.Generator().manual_seed(0)).module.cuda().train()
    x = torch.randn(3, 2, 3, 224, 224, generator=gen, device="cuda")
    labels = torch.tensor([[3, 7], [1, 2], [0, 999]], device="cuda")
    seeds = 11 + torch.arange(3 * model.num_dropout_sites, dtype=torch.int32,
                              device="cuda").view(3, -1)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)

    def step():
        params = {n: torch.stack([p.detach() * (1 + 0.01 * r) for r in range(3)]).requires_grad_()
                  for n, p in model.named_parameters()}

        def one(p, x, y, s):
            with reparametrize(model, p):
                logits, _ = train_forward(model, x, s)
            return compute_loss(logits, y, "cls", "ce")

        losses = torch.func.vmap(one)(params, x, labels, seeds)
        out = [losses.detach(), *torch.autograd.grad(losses.sum(), list(params.values()))]
        torch.cuda.synchronize()
        return out

    launched = _hash_launches()
    got = step()
    assert _hash_launches() == launched + 10
    monkeypatch.setattr(dr, "_on_card", lambda t: False)
    want = step()
    assert _hash_launches() == launched + 10
    assert all(_same_bits(a, b) for a, b in zip(got, want))
