"""mfu.predict: the forward FLOPs of the rows served in the traced calls
over the traced span, as a share of the card's dense peak in the
configuration's precision. Moves predict_samples_per_s.
"""

from benchlib import counts, readers


def read(trace, d, params):
    return readers.mfu(trace, d, counts.model_flops(d, trace.counts["rows"], train=False))
