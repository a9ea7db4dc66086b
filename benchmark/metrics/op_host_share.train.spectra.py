"""op_host_share.train.spectra: the share of the traced epoch's training
steps (the program's ``vtt.train.step`` spans) in which the host was inside
the port's custom ops (its ``vtt.op.*`` spans: the flash attention's and the
fused MLP's forward and backward wrappers, the dropout sites), counted once
where they overlap, over the steps' summed time. The backward's op spans run
on autograd's thread while the step's thread waits in it. Read, like the
idle share, at the pace under the profiler. Moves
train_samples_per_s.spectra.
"""

import bisect

from benchlib.trace import Trace


def read(trace, d, params):
    steps = sorted((a, b, n) for a, b, n in trace.host if n == "vtt.train.step")
    total = sum(b - a for a, b, _ in steps)
    if not steps or total <= 0:
        return None
    starts = [a for a, _, _ in steps]
    inside = []  # each op span cut to the step it lies in (steps never overlap)
    for a, b, n in trace.host:
        i = bisect.bisect_right(starts, a) - 1
        if n.startswith("vtt.op.") and i >= 0 and a < steps[i][1]:
            inside.append((a, min(b, steps[i][1]), n))
    if not inside:
        return None
    # The union of their intervals, taken as the device's busy time is.
    return 100.0 * Trace(trace.span_s, sorted(inside), []).busy_s() / total
