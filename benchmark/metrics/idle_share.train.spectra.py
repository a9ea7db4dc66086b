"""idle_share.train.spectra: the share of the traced epoch in which no kernel, copy
or fill ran on the card. Moves train_samples_per_s.spectra.
"""

from benchlib import readers


def read(trace, d, params):
    return readers.idle_share(trace)
