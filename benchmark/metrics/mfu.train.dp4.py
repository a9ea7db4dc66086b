"""mfu.train.dp4: the model FLOPs of rank 0's traced epoch over its traced
span, as a share of one card's dense peak in the configuration's precision
(989 TFLOP/s in bf16): the global batch's training steps at three
forwards' worth (recompute not counted) divided over the ranks, and the
validation batches at one forward, which every rank runs whole. Moves
train_samples_per_s.spectra.
"""

from benchlib import counts, readers


def read(trace, d, params):
    c = trace.counts
    flops = (counts.model_flops(d, d.batch, train=True) / c["ranks"] * c["train_steps"]
             + counts.model_flops(d, c["val_batch_rows"], train=False) * c["val_batches"])
    return readers.mfu(trace, d, flops)
