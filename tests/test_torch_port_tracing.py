"""The port's profiler spans (``vit_tpu_torch.tracing``) on the CPU: off
without a profiler, and under one the spans of a per-step epoch, of a
served call, and none in an exported artifact.
"""

import copy
import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vit_tpu_torch import tracing
from vit_tpu_torch.export import export_predictor, load_exported
from vit_tpu_torch.models.builder import get_model
from vit_tpu_torch.parallel import comm
from vit_tpu_torch.serve import Predictor
from vit_tpu_torch.train.loop import Experiment


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spans(prof, prefix="vtt."):
    """(name, start µs, end µs) of the profiler's spans named ``prefix``..."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(prefix)]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outers):
    return any(o[1] <= inner[1] and inner[2] <= o[2] for o in outers)


def _predictor(tiny_config, batch_size=8):
    """The tiny model on the kernels' route (K2 and K3, their plain versions
    here) behind a Predictor."""
    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(attn_impl="flash", fused_mlp=True)
    bundle = get_model(cfg, generator=torch.Generator().manual_seed(0))
    return Predictor(bundle.module, bundle.vit_config, batch_size=batch_size,
                     input_shape=(cfg["model"]["image_size"],))


def test_span_without_a_profiler_is_the_shared_null_context(tiny_config, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler running")

    pred = _predictor(tiny_config)
    x = np.random.default_rng(0).standard_normal((20, 512)).astype(np.float32)
    want = pred.predict(x)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("vtt.a") is tracing.span("vtt.b") is tracing._OFF
    np.testing.assert_array_equal(pred.predict(x), want)  # no span opened on the way
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler"):
            tracing.span("vtt.a")


def test_a_per_step_epoch_records_its_spans(tiny_config, tmp_path, monkeypatch):
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
    cfg = copy.deepcopy(tiny_config)
    cfg["model"].update(attn_impl="flash", fused_mlp=True)
    cfg["train"].update(ep=1, fused_epoch=False)
    exp = Experiment(cfg, seed=0, device="cpu")
    comm.reset_stats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exp.fit()
    spans = _spans(prof)
    # one rank: no gradient average, no collective, no count
    assert not [s for s in spans if s[0] in ("vtt.train.grad_sync", "vtt.train.zero1_gather")
                or s[0].startswith("vtt.comm.")]
    assert comm.STATS["calls"] == 0 and comm.STATS["ops"] == {}
    steps = _named(spans, "vtt.train.step")
    layers = cfg["model"]["num_hidden_layers"]
    n_steps = -(-cfg["data"]["num_samples"] // cfg["train"]["batch_size"])
    n_val = -(-len(exp.datamodule.val) // exp.datamodule.val_batch_size)
    assert len(steps) == n_steps == len(exp.epoch_losses)
    assert len(_named(spans, "vtt.input")) == n_steps + n_val
    assert len(_named(spans, "vtt.train.validate")) == 1
    assert len(_named(spans, "vtt.train.epoch_end")) == 2
    for child in ("vtt.train.forward_backward", "vtt.train.optimizer"):
        assert len(_named(spans, child)) == n_steps
        assert all(_inside(s, steps) for s in _named(spans, child))
    ops = [s for s in spans if s[0].startswith("vtt.op.")]
    # T 17: the short kernels; backward spans come from autograd's engine.
    for op in ("short_fwd", "short_bwd", "fused_mlp_fwd", "fused_mlp_bwd"):
        assert len(_named(ops, f"vtt.op.{op}")) == n_steps * layers, op
    assert len(_named(ops, "vtt.op.site_dropout")) == n_steps * (1 + 2 * layers)
    assert all(_inside(s, steps) for s in ops)


def test_a_predict_call_nests_its_batches(tiny_config):
    pred = _predictor(tiny_config, batch_size=8)
    x = np.random.default_rng(1).standard_normal((20, 512)).astype(np.float32)  # 3 batches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = pred.predict(x)
    assert out.shape == (20, 1)
    spans = sorted(_spans(prof, "vtt.predict."), key=lambda s: s[1])
    (call,) = _named(spans, "vtt.predict.call")
    inner = [s for s in spans if s is not call]
    assert [s[0] for s in inner] == ["vtt.predict.stage", "vtt.predict.forward",
                                     "vtt.predict.readback"] * 3
    assert all(_inside(s, [call]) for s in inner)
    assert all(a[2] <= b[1] for a, b in itertools.pairwise(inner))  # one after another


def test_an_export_made_under_a_profiler_holds_no_profiler_op(tiny_config, tmp_path):
    pred = _predictor(tiny_config)
    path = str(tmp_path / "model.vtt")
    with profile(activities=[ProfilerActivity.CPU]):
        export_predictor(pred, path)
    served = load_exported(path, device="cpu")
    targets = [str(n.target) for n in served.program.graph.nodes]
    assert targets and not [t for t in targets if "profiler" in t]
    x = np.random.default_rng(2).standard_normal((8, 512)).astype(np.float32)
    np.testing.assert_allclose(served.predict(x), pred.predict(x), rtol=1e-5, atol=1e-6)
