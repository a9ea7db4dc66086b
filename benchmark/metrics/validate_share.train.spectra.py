"""validate_share.train.spectra: the share of the traced epoch spent on its
validation: the union of the program's ``vtt.train.validate`` spans
(``Experiment.fit``: the validation split's forward in masked batches, their
read-back and the metrics) over the traced span. Read, like the idle share,
at the pace under the profiler. Moves train_samples_per_s.spectra.
"""

from benchlib.trace import Trace


def read(trace, d, params):
    spans = [e for e in trace.host if e[2] == "vtt.train.validate"]
    if not spans or trace.span_s <= 0:
        return None
    # The union of the spans' intervals, taken as the device's busy time is.
    return 100.0 * Trace(trace.span_s, sorted(spans), []).busy_s() / trace.span_s
