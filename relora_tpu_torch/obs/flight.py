"""Flight recorder: a bounded ring buffer of recent spans and events.

The port's own copy of ``relora_tpu/obs/flight.py``.  Tracers feed every
finished span into the process-wide :class:`FlightRecorder`; the serving
front end's stall watchdog calls :func:`dump_on_fault` to write the buffer
to disk as JSON, the last spans before a fault being what aggregate metrics
cannot show.

Dump location, first match wins: ``RELORA_TPU_FLIGHT_DIR``, the directory
set with :func:`configure`, the current directory.  Dumps are written
atomically (tmp + rename).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "default_recorder", "configure", "dump_on_fault"]

#: ring capacities: minutes of serving traffic at well under 1 MB resident
SPAN_CAPACITY = 2048
EVENT_CAPACITY = 512


class FlightRecorder:
    """Thread-safe ring buffer of span/event dicts with atomic JSON dumps."""

    def __init__(self, span_capacity: int = SPAN_CAPACITY, event_capacity: int = EVENT_CAPACITY):
        self._lock = threading.Lock()
        self._spans: "collections.deque[Dict[str, Any]]" = collections.deque(maxlen=span_capacity)
        self._events: "collections.deque[Dict[str, Any]]" = collections.deque(maxlen=event_capacity)
        self.dropped_spans = 0  # appends beyond capacity

    def add_span(self, span: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped_spans += 1
            self._spans.append(span)

    def add_event(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(event)

    def spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._events.clear()
            self.dropped_spans = 0

    def dump(self, path: str, reason: str = "manual") -> str:
        """Write the buffer as JSON (atomic rename).  Returns the path."""
        with self._lock:
            payload = {
                "reason": reason,
                "wall_time": time.time(),
                "pid": os.getpid(),
                "dropped_spans": self.dropped_spans,
                "spans": list(self._spans),
                "events": list(self._events),
            }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)
        return path


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()
_DUMP_DIR: Optional[str] = None


def default_recorder() -> FlightRecorder:
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder()
        return _RECORDER


def configure(dump_dir: Optional[str] = None) -> None:
    """Set the preferred dump directory."""
    global _DUMP_DIR
    _DUMP_DIR = dump_dir


def _dump_dir() -> str:
    return os.environ.get("RELORA_TPU_FLIGHT_DIR") or _DUMP_DIR or "."


def dump_on_fault(reason: str) -> Optional[str]:
    """Dump the default recorder to ``<dir>/flight_<reason>_<pid>.json``.
    Never raises (a failed dump must not mask the fault); returns None when
    the buffer is empty or the write fails."""
    rec = default_recorder()
    try:
        if not rec.spans() and not rec.events():
            return None
        path = os.path.join(_dump_dir(), f"flight_{reason}_{os.getpid()}.json")
        return rec.dump(path, reason=reason)
    except Exception:
        return None
