"""flash_fwd_roofline.predict: the streaming attention forward (K1) of the
traced calls: the least time of its calls (every layer of every served
batch) at the serving shape, over the summed device time of the K1
kernels. Moves predict_samples_per_s.
"""

from benchlib import readers


def read(trace, d, params):
    c = trace.counts
    least = d.layers * c["batches"] * readers.attention_least(d, c["batch_size"])
    return readers.roofline(trace, readers.FLASH_FWD, least)
