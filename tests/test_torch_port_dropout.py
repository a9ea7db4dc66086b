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


# -- the route: the kernel on the card, the torch ops elsewhere ---------------------
# On the CPU the kernel cannot run: ``on_card`` pretends CPU tensors lie on the
# card and puts a stand-in for the launch, the plain version, which counts
# itself; the route, the autograd and vmap rules are the real ones.
@pytest.fixture()
def on_card(monkeypatch):
    launched = []

    def launch(x, rate, seed, seed_t, offsets, rep):
        launched.append((tuple(x.shape), seed, seed_t, offsets, rep))
        if rep:  # hash_keep_mask's replicas: one seed each along shape[0]
            offsets = None if offsets is None else offsets[1:]
        return x * port.hash_keep_mask(x.shape, rate, seed if seed_t is None else seed_t,
                                       offsets).to(x.dtype)

    monkeypatch.setattr(port, "_on_card", lambda x: True)
    monkeypatch.setattr(port, "_launch", launch)
    return launched


def _plain(x, rate, seed, offsets=None):
    return x * port.hash_keep_mask(x.shape, rate, seed, offsets).to(x.dtype)


def _grad(fn, x, g):
    x = x.detach().requires_grad_()
    y = fn(x)
    y.backward(g)
    return y.detach(), x.grad


def test_cpu_tensors_take_the_torch_ops():
    """The CPU path is today's ops: the same bits, forward and backward, and
    no launch."""
    from vit_tpu_torch.ops._build import KERNELS

    launched = KERNELS["hash_dropout"].launches
    x, g = torch.randn(2, 3, 33, 17, generator=torch.Generator().manual_seed(0)).unbind(0)
    for seed in (-5, torch.tensor(-5)):
        got = _grad(lambda t: port.hash_dropout(t, 0.3, seed, (1, 2, 3)), x, g)
        want = _grad(lambda t: _plain(t, 0.3, -5, (1, 2, 3)), x, g)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert KERNELS["hash_dropout"].launches == launched


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("seed", [-7, 2**31 - 1, "tensor"])
@pytest.mark.parametrize("offsets", [None, (3, None, -2, 2**31 - 1)])
def test_card_tensors_take_the_kernel(on_card, dtype, seed, offsets):
    """Forward and backward are the kernel's, each one launch; an int seed
    reaches it as its uint32 value, a tensor seed as an int32 tensor;
    offsets as ints (None as 0). The bits are the torch ops'."""
    x, g = (torch.randn(2, 3, 5, 7, generator=torch.Generator().manual_seed(i)).to(dtype)
            for i in (1, 2))
    value = -99 if seed == "tensor" else seed
    seed = torch.tensor(value) if seed == "tensor" else seed
    got = _grad(lambda t: port.hash_dropout(t, 0.25, seed, offsets), x, g)
    want = _grad(lambda t: _plain(t, 0.25, value, offsets), x, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    offs = None if offsets is None else tuple(0 if o is None else o for o in offsets)
    assert len(on_card) == 2 and all(call[3] == offs for call in on_card)
    assert [call[1] for call in on_card] == [value & 0xFFFFFFFF] * 2
    assert all(call[2] is None for call in on_card)  # a CPU seed tensor is read on the host
    assert all(call[4] == 0 for call in on_card)


@pytest.mark.parametrize("form", ["seed vector", "vmap", "vmap, one int seed",
                                  "vmap, seeds only", "vmap, one device seed"])
def test_card_replicas_take_the_kernel_once(on_card, form):
    """An (R,) seed vector and a call under torch.func.vmap each launch the
    kernel once for all R replicas, forward and backward, with x's first
    axis the replicas' and one int32 seed a replica (one seed repeated where
    only x is mapped, x repeated where only the seeds are); offsets gain a 0
    for the replica axis. Replica r's bits are its seed's alone."""
    gen = torch.Generator().manual_seed(3)
    x, g = torch.randn(2, 3, 4, 9, generator=gen).unbind(0)
    seeds = torch.tensor([5, -6, 2**31 - 1], dtype=torch.int32)
    offsets = (2, -1)
    each = {"vmap, one int seed": [-6] * 3, "vmap, one device seed": [-6] * 3}.get(
        form, seeds.tolist())
    if form == "vmap, seeds only":
        x, g = x[0], g[0]
    vmap = torch.func.vmap

    def fn(t):
        if form == "seed vector":
            return port.hash_dropout(t, 0.5, seeds, offsets)
        if form == "vmap":
            return vmap(lambda tr, s: port.hash_dropout(tr, 0.5, s, offsets))(t, seeds)
        if form == "vmap, seeds only":
            return vmap(lambda s: port.hash_dropout(t, 0.5, s, offsets))(seeds)
        seed = -6 if form == "vmap, one int seed" else torch.tensor(-6)
        return vmap(lambda tr: port.hash_dropout(tr, 0.5, seed, offsets))(t)

    if form == "vmap, seeds only":  # x is each replica's: its gradient sums theirs
        y, dx = _grad(fn, x, g.expand(3, 4, 9))
        want = [_plain(x, 0.5, s, offsets) for s in each]
        want_dx = sum(_plain(g, 0.5, s, offsets) for s in each)
    else:
        y, dx = _grad(fn, x, g)
        want = [_plain(x[r], 0.5, s, offsets) for r, s in enumerate(each)]
        want_dx = torch.stack([_plain(g[r], 0.5, s, offsets) for r, s in enumerate(each)])
    assert torch.equal(y, torch.stack(want)) and torch.equal(dx, want_dx)
    assert [(call[0], call[3], call[4]) for call in on_card] == [((3, 4, 9), (0, 2, -1), 1)] * 2
    assert all(call[2].dtype == torch.int32 and call[2].tolist() == each for call in on_card)


def test_card_inputs_the_kernel_cannot_take_raise(on_card):
    """No CUDA call takes the torch ops: a dtype or rank the kernel lacks,
    replicas that do not match x's first axis, and (R,) seeds under vmap
    raise; offsets must cover the hashed axes."""
    x = torch.randn(3, 4, 9)
    for bad, seed in ((x.double(), 5), (x[0, 0, 0], 5), (x.view(1, 1, 1, 1, 3, 4, 9), 5),
                      (x[:, 0, 0], torch.tensor([1, 2, 3])), (x, torch.tensor([1, 2]))):
        with pytest.raises(ValueError):
            port.hash_dropout(bad, 0.5, seed)
    with pytest.raises(ValueError, match="one replica axis"):
        torch.func.vmap(lambda xr: port.hash_dropout(xr, 0.5, torch.tensor([1, 2, 3])))(
            x.unsqueeze(0).expand(2, 3, 4, 9))
    with pytest.raises(ValueError, match="offsets"):
        port.hash_dropout(x, 0.5, 5, (1, 2))
    with pytest.raises(ValueError, match="offsets"):
        port.hash_dropout(x, 0.5, torch.tensor([1, 2, 3]), (1,))
    assert on_card == []


@pytest.mark.parametrize("remat, impl, launches", [(False, "xla", (7, 14)),
                                                   ("mlp", "flash", (5, 10)),
                                                   (True, "xla", (7, 18))])
def test_a_steps_launches_and_bits(on_card, remat, impl, launches):
    """A 2-layer model's step: the forward draws each site once (the
    embeddings' and 2 or 3 a layer: flash drops the probabilities in its
    kernels), the backward once more, and remat's recompute the sites whose
    outputs its checkpoint needs again (non-reentrant checkpointing stops
    once the region's last saved tensor is back, so the MLP output's site,
    which saves nothing, is not recomputed). The loss and every gradient
    are the torch ops'."""
    from vit_tpu_torch.models.vit import compute_loss

    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 256)).astype(np.float32))
    y = torch.rand(4, 1, generator=torch.Generator().manual_seed(4))

    def step():
        m = _slow_model(remat, impl, fast=True)
        seeds = list(range(300, 300 + m.num_dropout_sites))
        loss = compute_loss(m(x, dropout_seeds=seeds), y, "reg", "mae")
        forward = len(on_card)
        loss.backward()
        return forward, loss.item(), [p.grad for p in m.parameters()]

    forward, loss, grads = step()
    assert (forward, len(on_card)) == launches
    assert all(call[4] == 0 for call in on_card)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port, "_on_card", lambda t: False)
        _, want_loss, want = step()
    assert loss == want_loss and all(torch.equal(a, b) for a, b in zip(grads, want))


@pytest.mark.parametrize("remat, impl, launches", [(False, "xla", 14), ("mlp", "flash", 10),
                                                   (True, "xla", 18)])
def test_a_vmapped_replica_step_launches_once_a_site(on_card, remat, impl, launches):
    """The stacked sweep's step (``train.fused.ReplicaEpochs``: the
    replicas' losses under torch.func.vmap, then one backward): three
    replicas launch the kernel as often as one model's step does, once a
    site for all of them, remat's recompute (``_ReplicaRemat``) included.
    The losses and every gradient are the torch ops' under vmap."""
    from vit_tpu_torch.func_internals import reparametrize
    from vit_tpu_torch.models.vit import compute_loss, train_forward

    m = _slow_model(remat, impl, fast=True)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(3, 4, 256, generator=gen)
    y = torch.rand(3, 4, 1, generator=gen)
    seeds = 300 + torch.arange(3 * m.num_dropout_sites, dtype=torch.int32).view(3, -1)

    def step():
        params = {n: torch.stack([p.detach() * (1 + 0.01 * r) for r in range(3)]).requires_grad_()
                  for n, p in m.named_parameters()}

        def one(p, x, y, s):
            with reparametrize(m, p):
                logits, _ = train_forward(m, x, s)
            return compute_loss(logits, y, "reg", "mae")

        losses = torch.func.vmap(one)(params, x, y, seeds)
        return [losses.detach(), *torch.autograd.grad(losses.sum(), list(params.values()))]

    got = step()
    assert len(on_card) == launches and all(call[4] == 1 for call in on_card)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port, "_on_card", lambda t: False)
        want = step()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", ["BASELINE_TRAIN", "baseline.yaml", "cifar_vit_s16.yaml",
                                  "cifar_vit_s16.yaml flash fused", "vit_b16_bf16.yaml",
                                  "moe"])
def test_chip_smoke_counts_a_training_steps_launches(on_card, name):
    """chip_smoke.hash_per_step, which its runs hold the kernel's launches
    to, is what one training step launches: the flash route and the plain
    one, remat: true and none, an MoE model."""
    import copy
    import os

    import chip_smoke
    from vit_tpu_torch.config import load_config
    from vit_tpu_torch.models.builder import get_model, get_vit_config
    from vit_tpu_torch.models.vit import train_forward

    cfg = {"BASELINE_TRAIN": lambda: chip_smoke.BASELINE_TRAIN,
           "baseline.yaml": lambda: load_config(os.path.join(
               os.path.dirname(chip_smoke.__file__), "configs/exp/att_clp/baseline.yaml")),
           "cifar_vit_s16.yaml": lambda: chip_smoke.image_config(name),
           "cifar_vit_s16.yaml flash fused": lambda: chip_smoke.image_config(
               "cifar_vit_s16.yaml", attn_impl="flash", fused_mlp=True),
           "vit_b16_bf16.yaml": lambda: chip_smoke.image_config(name, num_hidden_layers=2),
           "moe": lambda: chip_smoke.moe_config(num_hidden_layers=2)}[name]()
    vc = get_vit_config(copy.deepcopy(cfg))
    model = get_model(copy.deepcopy(cfg), generator=torch.Generator().manual_seed(0)).module
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(2, 3, vc.image_size, vc.image_size, generator=gen)
         if vc.input_kind == "image" else torch.randn(2, vc.image_size, generator=gen))
    logits, reg = train_forward(model.train(), x, list(range(1, 1 + model.num_dropout_sites)))
    (logits.float().sum() + (0 if reg is None else reg)).backward()
    assert len(on_card) == chip_smoke.hash_per_step(vc) > 0
