"""stage_share.predict: the share of the traced calls in which the host staged
served batches: the union of the program's ``vtt.predict.stage`` spans
(``Predictor._batched_logits``: a batch's padding, ``torch.from_numpy`` and
the pageable copy to the card) over the traced span. Read, like the idle
share, at the pace under the profiler. Moves predict_samples_per_s.
"""

from benchlib.trace import Trace


def read(trace, d, params):
    spans = [e for e in trace.host if e[2] == "vtt.predict.stage"]
    if not spans or trace.span_s <= 0:
        return None
    # The union of the spans' intervals, taken as the device's busy time is.
    return 100.0 * Trace(trace.span_s, sorted(spans), []).busy_s() / trace.span_s
