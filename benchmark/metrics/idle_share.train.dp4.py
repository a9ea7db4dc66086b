"""idle_share.train.dp4: the share of rank 0's traced epoch in which no
kernel, copy or fill ran on its card (NCCL's kernels count as busy). Moves
train_samples_per_s.spectra.
"""

from benchlib import readers


def read(trace, d, params):
    return readers.idle_share(trace)
