"""comm_share.train.dp4: the share of rank 0's traced epoch in which an NCCL
kernel ran on its card (the union of their intervals, on any stream): the
gradients' all-reduce, ZeRO-1's all-gathers, the epoch end's flag and
moments. Moves train_samples_per_s.spectra.
"""

from benchlib import collectives
from benchlib.trace import Trace


def read(trace, d, params):
    ks = collectives.nccl_kernels(trace)
    if not ks or trace.span_s <= 0:
        return None
    # The union of their intervals, taken as the device's busy time is.
    return 100.0 * Trace(trace.span_s, sorted(ks), []).busy_s() / trace.span_s
