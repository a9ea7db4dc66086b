"""mfu.train.image: the model FLOPs of the traced epoch (its training steps at
three forwards' worth, recompute not counted, and its validation batches
at one) over the traced span, as a share of the card's dense peak in the
configuration's precision (989 TFLOP/s in bf16). Moves train_samples_per_s.image.
"""

from benchlib import counts, readers


def read(trace, d, params):
    c = trace.counts
    flops = (counts.model_flops(d, d.batch, train=True) * c["train_steps"]
             + counts.model_flops(d, c["val_batch_rows"], train=False) * c["val_batches"])
    return readers.mfu(trace, d, flops)
