"""comm_exposed_share.train.dp4: the share of rank 0's traced epoch in which
an NCCL kernel ran on its card and nothing else did (no other kernel, copy
or fill, on any stream): the collectives' time that no work hides. At most
``comm_share.train.dp4``. Moves train_samples_per_s.spectra.
"""

from benchlib import collectives


def read(trace, d, params):
    ks = collectives.nccl_kernels(trace)
    if not ks or trace.span_s <= 0:
        return None
    other = [(a, b) for a, b, n in trace.device if not n.startswith(collectives.NCCL)]
    return 100.0 * collectives.minus([(a, b) for a, b, _ in ks], other) / trace.span_s
