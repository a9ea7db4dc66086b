"""h2d_share.predict: the share of the traced calls' span spent in
host-to-device copies (the inputs of each batch). Moves
predict_samples_per_s.
"""


def read(trace, d, params):
    seconds, found = trace.seconds_matching(("Memcpy HtoD",))
    return None if found == 0 or trace.span_s <= 0 else 100.0 * seconds / trace.span_s
