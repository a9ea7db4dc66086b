"""input_share.train.image: the share of the traced epoch in which the host
pulled a training or validation batch and issued its copy to the card: the
union of the program's ``vtt.input`` spans
(``data/pipeline.py::prefetch_to_device``: a ``Batcher``'s numpy gather, the
pin and the non-blocking copy; overlapping spans count once) over the traced
span. Read, like the idle share, at the pace under the profiler. Moves
train_samples_per_s.image.
"""

from benchlib.trace import Trace


def read(trace, d, params):
    spans = [e for e in trace.host if e[2] == "vtt.input"]
    if not spans or trace.span_s <= 0:
        return None
    # The union of the spans' intervals, taken as the device's busy time is.
    return 100.0 * Trace(trace.span_s, sorted(spans), []).busy_s() / trace.span_s
