"""What the per-layer metrics' readers share (``benchmark/metrics/``).

Each reader is ``read(trace, dims, params) -> value or None``: ``trace``
the traced window (:class:`benchlib.trace.Trace`, with the work inside it
in ``trace.counts``), ``dims`` the configuration's shapes, ``params`` the
cell's traffic parameters. A reader that finds nothing to read returns
None and the metric is left out of the line.
"""

from __future__ import annotations

from benchlib import counts

# The attention kernels' device functions, by name.
FLASH_FWD = ("attn_fwd_tc::flash_kernel", "flash_fwd_kernel")
FLASH_BWD = ("attn_bwd_fused_tc::bwd_kernel",)
# torch's own elementwise, reduction, softmax, normalisation, indexing and
# fused-optimizer kernels; library products (cuBLAS, cuDNN) are not in it.
TORCH_NATIVE = ("at::native::",)
COPIES = ("Memcpy", "Memset")


def kernels(trace):
    return [(a, b, n) for a, b, n in trace.device if not n.startswith(COPIES)]


def mfu(trace, d, flops: float):
    if trace.span_s <= 0 or flops <= 0:
        return None
    peak = counts.PEAK_BF16_FLOPS if d.precision == "bf16" else counts.PEAK_FP32_FLOPS
    return 100.0 * flops / trace.span_s / peak


def idle_share(trace):
    if trace.span_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.span_s)


def roofline(trace, patterns, least_s: float):
    """The least time of the calls the traced work makes (``least_s``,
    summed) over the summed device time of the kernels that do them; None
    where no such kernel ran."""
    seconds, found = trace.seconds_matching(patterns)
    if found == 0 or seconds <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / seconds


def attention_least(d, rows: int, backward: bool = False) -> float:
    """The least time of one attention call over ``rows`` batch rows."""
    fn = counts.attention_bwd if backward else counts.attention_fwd
    itemsize = 2 if d.precision == "bf16" else 4
    return counts.least_seconds(*fn(rows, d.heads, d.seq, d.head_dim, itemsize),
                                bf16=d.precision == "bf16")


def share_of_kernels(trace, patterns):
    ks = kernels(trace)
    total = sum(b - a for a, b, _ in ks)
    part = sum(b - a for a, b, n in ks if any(p in n for p in patterns))
    return None if total <= 0 else 100.0 * part / total
