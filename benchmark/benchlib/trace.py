"""The traced window: torch.profiler (CUPTI) over a steady part of a run,
reduced to device events, busy time, idle gaps and sums by kernel.

The events are read from the profiler's Chrome trace (kineto's own
records): its ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events are
the device's, everything else with a duration the host's. (The
``FunctionEvent`` list of ``profile.events()`` gives eager kernels the
wrong durations: 28.6 ms of kernels for a served batch whose CUDA events
read 61.8 ms, where the Chrome trace reads 60.5 ms.) Device-side spans of
``record_function`` scopes (``gpu_user_annotation``) cover many kernels and
the gaps between them, and are left out. Busy time is the union of the
device events' intervals inside the traced span; an idle gap is named by
the innermost host operation running when it began.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch


@dataclass
class Trace:
    span_s: float                      # host clock, sync to sync
    device: List[Tuple[float, float, str]]  # (start s, end s, name), sorted
    host: List[Tuple[float, float, str]]    # host operations, same clock
    counts: Dict[str, float] = field(default_factory=dict)  # work inside the span

    def __post_init__(self) -> None:
        self.host.sort()
        self._host_starts = [h[0] for h in self.host]

    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for start, stop, _ in self.device:
            if stop > end:
                busy += stop - max(start, end)
                end = stop
        return busy

    def gaps(self) -> List[Tuple[float, float]]:
        """(start, length) of each idle interval between device events."""
        out, end = [], None
        for start, stop, _ in self.device:
            if end is not None and start > end:
                out.append((end, start - end))
            end = stop if end is None else max(end, stop)
        return out

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for start, stop, name in self.device:
            out[name] = out.get(name, 0.0) + (stop - start)
        return out

    def seconds_matching(self, patterns) -> Tuple[float, int]:
        """(summed seconds, launches) of the device events whose name holds
        any of ``patterns``."""
        total, n = 0.0, 0
        for start, stop, name in self.device:
            if any(p in name for p in patterns):
                total += stop - start
                n += 1
        return total, n

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``: of those begun by
        then and not yet ended, the latest begun (host operations nest)."""
        i = bisect.bisect_right(self._host_starts, t)
        for start, stop, name in reversed(self.host[max(0, i - 512):i]):
            if stop >= t:
                return name
        return "no host operation"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])[:top]
        idle: Dict[str, float] = {}
        for start, length in self.gaps():
            key = self.host_at(start)
            idle[key] = idle.get(key, 0.0) + length
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
SKIP = ("gpu_user_annotation", "Trace")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Tracer:
    """``start()`` ... ``stop()`` around a steady part of the window."""

    def __init__(self) -> None:
        self.prof = None
        self.t0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        _sync()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, counts: Dict[str, float]) -> Trace:
        _sync()
        span = time.perf_counter() - self.t0
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        device, host = [], []
        for e in events:
            if e.get("ph") != "X" or not e.get("dur") or e.get("cat") in SKIP:
                continue
            start = float(e["ts"]) / 1e6
            item = (start, start + float(e["dur"]) / 1e6, str(e.get("name", "")))
            (device if e.get("cat") in DEVICE else host).append(item)
        device.sort()
        return Trace(span_s=span, device=device, host=host, counts=dict(counts))
