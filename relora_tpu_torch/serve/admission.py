"""Bounded admission and serving metrics of the HTTP front end.

The port's own copy of ``relora_tpu/serve/admission.py``.  The scheduler is
single-threaded (one model thread owns ``submit`` / ``step`` / ``cancel``);
this module is what crosses between the asyncio handlers and that thread:

- ``AdmissionController`` — the only waiting room between the network and
  the decode slots: a ``queue.Queue(maxsize=max_queue)`` of tickets the
  model thread has not claimed.  Full, ``try_admit`` raises ``QueueFull``
  (HTTP 429 + Retry-After); after ``begin_drain()`` it raises ``Draining``
  (HTTP 503) while accepted tickets keep flowing to the model thread.
- ``Ticket`` — one accepted request with its callbacks (which hop onto the
  event loop) and the ``cancelled`` event a disconnect sets.
- ``ServeMetrics`` — the shared registry under the ``relora_serve``
  namespace, the ``/metrics`` body.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Callable, Optional

from relora_tpu_torch.obs.metrics import MetricsRegistry
from relora_tpu_torch.serve.scheduler import Completion, Request

__all__ = ["QueueFull", "Draining", "Ticket", "AdmissionController", "ServeMetrics"]


class QueueFull(Exception):
    """Admission queue at capacity: shed load (HTTP 429)."""


class Draining(Exception):
    """The server is draining: reject new work (HTTP 503)."""


@dataclasses.dataclass
class Ticket:
    """One accepted request on its way to the model thread."""

    uid: int
    request: Request
    deadline: Optional[float]  # absolute time.monotonic(), None = no limit
    on_token: Callable[[int, int, int], None]
    on_finish: Callable[[Completion], None]
    cancelled: threading.Event = dataclasses.field(default_factory=threading.Event)
    t_enqueue: float = dataclasses.field(default_factory=time.monotonic)
    t_last_token: Optional[float] = None  # model thread only; TPOT bookkeeping
    trace_id: Optional[str] = None  # request id: X-Request-Id and span trace_id
    span: Optional[Any] = None  # root "request" span, ended at finish
    queue_span: Optional[Any] = None  # "queue_wait": admission -> model-thread claim


class AdmissionController:
    """Bounded, drain-aware handoff from request handlers to the model thread.

    ``try_admit`` (any thread) enforces the bound and enqueues; ``pop``
    (model thread) claims the next ticket.  The bound covers only requests
    waiting for a slot, so in-system work is ``max_batch`` decoding plus
    ``max_queue`` waiting, whatever the offered load.  ``uid_base`` offsets
    the uids this controller mints (fleet replicas keep disjoint uid spaces).
    """

    #: Retry-After never exceeds this
    RETRY_AFTER_CAP_S = 30.0

    def __init__(self, max_queue: int, *, retry_after_s: float = 1.0, uid_base: int = 0):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.retry_after_floor_s = retry_after_s
        self._q: "queue.Queue[Ticket]" = queue.Queue(maxsize=max_queue)
        self._uids = itertools.count(uid_base)
        self._draining = threading.Event()
        self._tpot_ewma: Optional[float] = None  # model thread writes, any reads

    @property
    def retry_after_s(self) -> float:
        """The time for the current queue to clear at the observed decode
        rate (queue depth x rolling TPOT), clamped to ``[max(1, floor),
        RETRY_AFTER_CAP_S]``; the floor before any token was observed."""
        floor = max(1.0, self.retry_after_floor_s)
        if self._tpot_ewma is None:
            return floor
        estimate = self._q.qsize() * self._tpot_ewma
        return min(max(floor, estimate), self.RETRY_AFTER_CAP_S)

    def note_tpot(self, seconds: float) -> None:
        """Fold one observed per-token latency into the rolling TPOT."""
        if seconds <= 0.0:
            return
        if self._tpot_ewma is None:
            self._tpot_ewma = seconds
        else:
            self._tpot_ewma = 0.8 * self._tpot_ewma + 0.2 * seconds

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def begin_drain(self) -> None:
        self._draining.set()

    def depth(self) -> int:
        return self._q.qsize()

    def next_uid(self) -> int:
        return next(self._uids)

    def try_admit(self, ticket: Ticket) -> Ticket:
        """Enqueue or reject: never block, never buffer beyond the bound."""
        if self._draining.is_set():
            raise Draining("server is draining; not accepting new requests")
        try:
            self._q.put_nowait(ticket)
        except queue.Full:
            raise QueueFull(
                f"admission queue full ({self.max_queue} waiting); retry after "
                f"{self.retry_after_s:.0f}s"
            ) from None
        return ticket

    def pop(self, timeout: Optional[float] = None) -> Optional[Ticket]:
        """Claim the next waiting ticket, or None (``timeout=None`` polls
        without blocking)."""
        try:
            if timeout is None:
                return self._q.get_nowait()
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None


class ServeMetrics(MetricsRegistry):
    """Serving metrics: the shared registry under ``relora_serve``."""

    def __init__(self, namespace: str = "relora_serve"):
        super().__init__(namespace=namespace)
