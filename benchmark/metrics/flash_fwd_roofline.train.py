"""flash_fwd_roofline.train: the streaming attention forward (K1) of the
traced epoch: the least time of its calls (every layer of every training
step, with dropout, and of every validation batch) at their shapes, over
the summed device time of the K1 kernels. Moves train_samples_per_s.spectra.
"""

from benchlib import readers


def read(trace, d, params):
    c = trace.counts
    least = d.layers * (c["train_steps"] * readers.attention_least(d, d.batch)
                        + c["val_batches"] * readers.attention_least(d, c["val_batch_rows"]))
    return readers.roofline(trace, readers.FLASH_FWD, least)
