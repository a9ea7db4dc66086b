"""idle_share.predict: the share of the traced calls' span in which no
kernel, copy or fill ran on the card. Moves predict_samples_per_s.
"""

from benchlib import readers


def read(trace, d, params):
    return readers.idle_share(trace)
