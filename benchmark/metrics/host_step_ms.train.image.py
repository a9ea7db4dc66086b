"""host_step_ms.train.image: the median host time of one training step in
the traced epoch: the duration of the program's ``vtt.train.step`` spans
(``Experiment.train_step``, from the seed draws through the optimizer's
step, every kernel enqueued). Read, like the idle share, at the pace under
the profiler. Moves train_samples_per_s.image.
"""

import statistics


def read(trace, d, params):
    steps = [b - a for a, b, n in trace.host if n == "vtt.train.step"]
    return 1e3 * statistics.median(steps) if steps else None
