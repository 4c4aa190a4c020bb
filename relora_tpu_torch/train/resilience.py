"""Preemption-safe shutdown: a copy of ``relora_tpu/train/resilience.py``'s
``PreemptionGuard`` for the PyTorch port.

The guard turns SIGTERM/SIGINT into a polled ``requested`` flag that the
trainer honors at the next update boundary; a second SIGINT raises
``KeyboardInterrupt`` at once.  (The JAX trainer then writes an emergency
checkpoint; checkpoints are not ported yet, so the port's trainer stops and
reports ``preempted``.)
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Context manager turning SIGTERM/SIGINT into a polled ``requested``
    flag.  Installs only in the main thread (``signal.signal`` raises
    elsewhere); previous handlers are restored on exit."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT), enabled: bool = True):
        self._signals = tuple(signals)
        self._enabled = enabled
        self._prev: dict = {}
        self.requested = False
        self.signum: Optional[int] = None

    def __enter__(self) -> "PreemptionGuard":
        if not self._enabled:
            return self
        if threading.current_thread() is not threading.main_thread():
            logger.warning("PreemptionGuard skipped: signal handlers require the main thread")
            return self
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _handle(self, signum, frame) -> None:
        if signum == signal.SIGINT and self.requested:
            raise KeyboardInterrupt
        self.requested = True
        self.signum = signum
        logger.warning(f"signal {signum} received: stopping at the next update boundary")
