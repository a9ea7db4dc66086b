"""The readers of the program's spans (``benchmark/metrics/``) on hand-built
traces: known spans give known values, overlapping spans count once, and a
trace without the spans gives None.
"""

import pytest

from benchlib import spec
from benchlib.trace import Trace

SPAN_METRICS = [m["name"] for m in spec.benchmark()["per_layer"]
                if m["source"] == "program_span"]


def _read(metric, trace):
    return spec.load_module("metrics", metric).read(trace, None, {})


def _steps():
    """Two steps of 10 and 30 ms, each with op spans inside (those of the
    second overlap), an input pull between them, and a validation."""
    return [(0.000, 0.010, "vtt.train.step"), (0.001, 0.003, "vtt.op.flash_fwd"),
            (0.004, 0.005, "vtt.op.site_dropout"), (0.011, 0.013, "vtt.input"),
            (0.012, 0.014, "vtt.input"), (0.020, 0.050, "vtt.train.step"),
            (0.021, 0.031, "vtt.op.flash_bwd"), (0.026, 0.036, "vtt.op.site_dropout"),
            (0.060, 0.080, "vtt.train.validate"), (0.061, 0.062, "aten::mm")]


def test_every_span_metric_is_checked_here():
    assert sorted(SPAN_METRICS) == sorted(
        [f"{m}.train.{c}" for m in ("host_step_ms", "input_share", "validate_share")
         for c in ("spectra", "image")] + ["op_host_share.train.spectra", "stage_share.predict"])


@pytest.mark.parametrize("cell", ["spectra", "image"])
def test_training_spans_read_known_values(cell):
    trace = Trace(span_s=0.1, device=[], host=_steps())
    assert _read(f"host_step_ms.train.{cell}", trace) == pytest.approx(20.0)  # median of 10, 30
    # the two overlapping input pulls, 11-13 and 12-14 ms, cover 3 ms once
    assert _read(f"input_share.train.{cell}", trace) == pytest.approx(3.0)
    assert _read(f"validate_share.train.{cell}", trace) == pytest.approx(20.0)


def test_op_share_counts_overlaps_once_and_only_inside_steps():
    # ops cover 2 + 1 ms of the first step and 21-36 ms of the second: 18 of 40 ms
    trace = Trace(span_s=0.1, device=[], host=_steps())
    assert _read("op_host_share.train.spectra", trace) == pytest.approx(45.0)
    late = _steps() + [(0.045, 0.055, "vtt.op.fused_mlp_bwd"),  # 5 ms inside the second
                       (0.090, 0.095, "vtt.op.flash_fwd")]      # outside every step
    assert _read("op_host_share.train.spectra",
                 Trace(span_s=0.1, device=[], host=late)) == pytest.approx(57.5)
    no_ops = [e for e in _steps() if not e[2].startswith("vtt.op.")]
    assert _read("op_host_share.train.spectra", Trace(span_s=0.1, device=[], host=no_ops)) is None


def test_stage_share_reads_the_staging_spans():
    host = [(0.0, 0.05, "vtt.predict.call"), (0.0, 0.01, "vtt.predict.stage"),
            (0.01, 0.03, "vtt.predict.forward"), (0.03, 0.04, "vtt.predict.readback"),
            (0.04, 0.045, "vtt.predict.stage")]
    assert _read("stage_share.predict", Trace(span_s=0.05, device=[], host=host)) == \
        pytest.approx(30.0)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_no_spans_read_none(metric):
    bare = [(0.0, 0.01, "aten::mm"), (0.02, 0.03, "cudaLaunchKernel")]
    assert _read(metric, Trace(span_s=0.1, device=[(0.0, 0.005, "k")], host=bare)) is None
    assert _read(metric, Trace(span_s=0.1, device=[], host=[])) is None
