"""flash_bwd_roofline.train: the streaming attention backward (K4 + K5) of
the traced epoch: the least time of the algorithm's backward from the
saved log-sum-exp (five T x T products and the exponentials, every layer
of every training step) over the summed device time of the kernels that
do it. Moves train_samples_per_s.spectra.
"""

from benchlib import readers


def read(trace, d, params):
    least = d.layers * trace.counts["train_steps"] * readers.attention_least(d, d.batch, True)
    return readers.roofline(trace, readers.FLASH_BWD, least)
