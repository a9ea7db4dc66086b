"""grad_allreduce_roofline.train.dp4: the gradients' average, one NCCL
all-reduce a step of 4 bytes a parameter and the loss (fp32), as a share
of its least time: those bytes out of a card at NVLink's 450 GB/s a
direction (no algorithm sends fewer, NVLink SHARP included), over the
median of the step's all-reduce kernel, taken as the traced epoch's
``train_steps`` longest NCCL all-reduce kernels on rank 0's card. A kernel
starts when it is queued, so its time holds any wait for the other ranks.
Moves train_samples_per_s.spectra.
"""

import statistics

from benchlib import collectives


def read(trace, d, params):
    times = collectives.largest_all_reduces(trace, int(trace.counts["train_steps"]))
    if not times or min(times) <= 0:
        return None
    least = collectives.grad_bytes(d) / collectives.NVLINK_BYTES_PER_S
    return 100.0 * least / statistics.median(times)
