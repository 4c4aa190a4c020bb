"""Preemption-safe shutdown and loss-spike detection: the port's copy of
``relora_tpu/train/resilience.py``'s ``PreemptionGuard``, ``SpikeEvent`` and
``LossSpikeDetector`` (``:94-180``).

The guard turns SIGTERM/SIGINT into a polled ``requested`` flag that the
trainer honors at the next update boundary, where it writes an emergency
checkpoint when ``save_dir`` is set; a second SIGINT raises
``KeyboardInterrupt`` at once.  The detector flags a sustained loss spike,
which the trainer answers by rolling back to the last checkpoint before it.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import signal
import threading
from collections import deque
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


@dataclasses.dataclass
class SpikeEvent:
    """A sustained loss spike: ``first_step``..``last_step`` are the logged
    update steps of the consecutive outliers that crossed ``patience``."""

    first_step: int
    last_step: int
    loss: float
    median: float
    mad: float


class LossSpikeDetector:
    """Rolling median/MAD outlier detector over per-update losses.

    ``update(step, loss)`` returns a :class:`SpikeEvent` once ``patience``
    consecutive losses exceed ``median + threshold * 1.4826 * MAD`` over the
    last ``window`` clean losses, armed after ``min_history`` of them.
    NaN/inf losses always count as outliers.  Outliers are not admitted to
    the window, so the baseline stays clean during a streak;
    ``min_deviation`` floors the margin so a near-zero MAD in a flat loss
    region cannot flag noise."""

    def __init__(
        self,
        threshold: float,
        window: int = 64,
        min_history: int = 16,
        patience: int = 3,
        min_deviation: float = 0.05,
    ):
        if threshold <= 0:
            raise ValueError("threshold must be > 0 (gate construction on it)")
        if patience < 1:
            raise ValueError("patience must be >= 1")
        if min_history < 4:
            raise ValueError("min_history must be >= 4")
        self.threshold = threshold
        self.patience = patience
        self.min_history = min_history
        self.min_deviation = min_deviation
        self._window: deque = deque(maxlen=window)
        self._streak = 0
        self._first_step: Optional[int] = None
        self.last_median = float("nan")
        self.last_mad = float("nan")

    @staticmethod
    def _median(values) -> float:
        s = sorted(values)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def update(self, step: int, loss: float) -> Optional[SpikeEvent]:
        outlier = False
        if len(self._window) >= self.min_history:
            med = self._median(self._window)
            mad = self._median(abs(v - med) for v in self._window)
            self.last_median, self.last_mad = med, mad
            margin = max(self.threshold * 1.4826 * mad, self.min_deviation)
            outlier = not math.isfinite(loss) or loss > med + margin
        if outlier:
            self._streak += 1
            if self._streak == 1:
                self._first_step = step
            if self._streak >= self.patience:
                return SpikeEvent(
                    first_step=self._first_step,
                    last_step=step,
                    loss=loss,
                    median=self.last_median,
                    mad=self.last_mad,
                )
        else:
            self._streak = 0
            self._first_step = None
            if math.isfinite(loss):
                self._window.append(loss)
        return None

    def reset_streak(self) -> None:
        """Forget the current outlier run (after a rollback, or when a spike
        fired but no rollback target exists) while keeping the clean window."""
        self._streak = 0
        self._first_step = None
