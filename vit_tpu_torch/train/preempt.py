"""Preemption-safe training: SIGTERM -> a clean stop at the epoch boundary
(port of ``vit_tpu/train/preempt.py``).

Spot and preemptible machines get a SIGTERM ahead of eviction. The guard
turns the FIRST signal into a flag that ``Experiment.fit`` reads once an
epoch, after the epoch's checkpoint: the run finishes the epoch, saves
``last`` through the normal path and returns, so ``--ckpt last`` resumes it.
On the first signal the previous handler is put back, so a SECOND signal
terminates the process the ordinary way.

On by default (``train.handle_preemption: false`` turns it off). Python
lets only the main thread install a handler; elsewhere the guard is inert.
"""

from __future__ import annotations

import signal
import threading
from typing import Dict, Iterable

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Latches the first signal; training loops read ``triggered``."""

    def __init__(self, enabled: bool = True,
                 signals: Iterable[int] = (signal.SIGTERM,)) -> None:
        self.enabled = enabled
        self.signals = tuple(signals)
        self.triggered = False
        self._prev: Dict[int, object] = {}

    def install(self) -> "PreemptionGuard":
        if not self.enabled or threading.current_thread() is not threading.main_thread():
            return self
        for sig in self.signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except (ValueError, OSError):  # exotic runtimes; stay inert
                pass
        return self

    def _handle(self, signum, frame) -> None:
        self.triggered = True
        # One-shot: a repeat gets the previous behaviour instead of being
        # swallowed by a hung run. The handler goes back BEFORE the line is
        # printed: a caller that sends the second signal on reading the line
        # must find the previous handler in place, not this one's slot.
        prev = self._prev.pop(signum, signal.SIG_DFL)
        try:
            signal.signal(signum, prev)
        except (ValueError, OSError):
            pass
        print(f"[preempt] signal {signum} received — stopping at the next epoch boundary "
              "(send again to terminate immediately)", flush=True)

    def uninstall(self) -> None:
        for sig, prev in list(self._prev.items()):
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
