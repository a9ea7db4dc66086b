"""What the data-parallel cells' readers share (``benchmark/metrics/*.dp4``):
NCCL's kernels in the device trace, the time of one union of intervals
outside another, and the gradients' all-reduce's least time.

NCCL names its kernels ``ncclDevKernel_<Collective>_...`` (``ncclKernel_``
in older releases), so a device event whose name starts with ``nccl`` is
a collective's kernel.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from benchlib.dims import Dims, param_shapes

NCCL = "nccl"
# NVLink 4 on an H100 SXM: 18 links of 25 GB/s each way, 450 GB/s out of
# (and into) a card. An all-reduce of S bytes sends at least S out of each
# card (NVLink SHARP reduces in the switch; a ring sends 2(n-1)/n S).
NVLINK_BYTES_PER_S = 450e9


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def minus(keep: List[Tuple[float, float]], cover: List[Tuple[float, float]]) -> float:
    """The length of the union of ``keep`` outside the union of ``cover``."""
    keep, cover = merged(keep), merged(cover)
    total, j = 0.0, 0
    for a, b in keep:
        inside = 0.0
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            inside += min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
        total += (b - a) - inside
    return total


def nccl_kernels(trace) -> List[Tuple[float, float, str]]:
    return [e for e in trace.device if e[2].startswith(NCCL)]


def grad_bytes(d: Dims) -> float:
    """What the gradients' average all-reduces: every parameter and the loss, fp32."""
    return 4.0 * (sum(int(np.prod(s)) for _, s in param_shapes(d)) + 1)


def largest_all_reduces(trace, count: int) -> List[float]:
    """The durations of the ``count`` longest NCCL all-reduce kernels."""
    times = sorted((b - a for a, b, n in nccl_kernels(trace) if "AllReduce" in n), reverse=True)
    return times[:count]
