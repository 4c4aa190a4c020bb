"""Span tracer: attributable wall-clock timing for serving.

The port's own copy of ``relora_tpu/obs/tracer.py``.  A span is a named
wall-clock interval with a ``trace_id`` (one per HTTP request, the
``X-Request-Id``), a ``parent_id`` (phases nest into a tree) and free-form
attributes.  The server opens a request's ``request`` and ``queue_wait``
spans on the event loop; the scheduler opens ``prefill_chunk``,
``decode_step`` and ``decode`` on the model thread under the same trace id.

- ``Tracer.span`` nests per thread (a per-thread stack); spans that start on
  one thread and end on another use ``start_span()`` / ``Span.end()``.
- Finished spans land in the process's
  :class:`~relora_tpu_torch.obs.flight.FlightRecorder` and, when a path is
  given, a JSONL file.  ``chrome_trace_events`` converts both to Chrome /
  Perfetto trace-event JSON, which ``torch.profiler`` traces share.
- A span costs two clock reads, a few dict stores and one locked append.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "NoopTracer",
    "new_trace_id",
    "chrome_trace_events",
]


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id (also the HTTP X-Request-Id)."""
    return uuid.uuid4().hex[:16]


class Span:
    """One named wall-clock interval.  Mutable until :meth:`end`, which
    records it with the owning tracer exactly once."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "t_start", "t_end",
        "attrs", "thread", "_tracer",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        t_start: float,
        attrs: Dict[str, Any],
        tracer: "Tracer",
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.attrs = attrs
        self.thread = threading.current_thread().name
        self._tracer = tracer

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def duration_s(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return self.t_end - self.t_start

    def end(self) -> float:
        """Close and record the span; returns its duration in seconds.  A
        second call returns the recorded duration."""
        if self.t_end is None:
            self.t_end = self._tracer.clock()
            self._tracer._record(self)
        return self.t_end - self.t_start

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_start": self.t_start,
            "t_end": self.t_end,
            # wall-clock start: joins spans of processes with other
            # monotonic origins on one timeline
            "t_wall": self._tracer.wall_anchor + self.t_start,
            "dur_s": None if self.t_end is None else self.t_end - self.t_start,
            "thread": self.thread,
            "service": self._tracer.service,
            "attrs": self.attrs,
        }


class Tracer:
    """Factory and sink for the spans of one service ("serve", ...).

    ``span()`` is the context manager with per-thread nesting;
    ``start_span()`` / ``Span.end()`` the manual API for spans that cross
    threads; ``event()`` records an instant marker.
    """

    def __init__(
        self,
        service: str = "app",
        *,
        recorder=None,
        jsonl_path: Optional[str] = None,
        clock=time.monotonic,
    ):
        self.service = service
        self.clock = clock
        self.enabled = True
        self.wall_anchor = time.time() - clock()
        self.default_trace_id = new_trace_id()
        if recorder is None:
            from relora_tpu_torch.obs.flight import default_recorder

            recorder = default_recorder()
        self.recorder = recorder
        self._ids = itertools.count(1)  # next() is atomic in CPython
        self._local = threading.local()
        self._jsonl_lock = threading.Lock()
        self._jsonl_fh = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
            self._jsonl_fh = open(jsonl_path, "a")

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _next_id(self) -> str:
        return f"s{next(self._ids):06x}"

    def _write(self, record: Dict[str, Any]) -> None:
        fh = self._jsonl_fh
        if fh is not None:
            with self._jsonl_lock:
                fh.write(json.dumps(record) + "\n")
                fh.flush()

    def _record(self, span: Span) -> None:
        d = span.to_dict()
        self.recorder.add_span(d)
        self._write(d)

    def start_span(
        self,
        name: str,
        *,
        trace_id: Optional[str] = None,
        parent: Optional[Span] = None,
        **attrs: Any,
    ) -> Span:
        """Manual span (may end on another thread); the caller must call
        ``end()``.  It does not join the nesting stack, but with no explicit
        parent the calling thread's current span becomes its parent."""
        stack = self._stack()
        if parent is None:
            parent = stack[-1] if stack else None
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None else self.default_trace_id
        return Span(
            name,
            trace_id,
            self._next_id(),
            parent.span_id if parent is not None else None,
            self.clock(),
            attrs,
            self,
        )

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        *,
        trace_id: Optional[str] = None,
        parent: Optional[Span] = None,
        **attrs: Any,
    ):
        """Context-managed span: children opened on this thread inside the
        block parent to it."""
        sp = self.start_span(name, trace_id=trace_id, parent=parent, **attrs)
        stack = self._stack()
        stack.append(sp)
        try:
            yield sp
        finally:
            if stack and stack[-1] is sp:
                stack.pop()
            elif sp in stack:
                stack.remove(sp)
            sp.end()

    def current_span(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def event(self, name: str, *, trace_id: Optional[str] = None, **attrs: Any) -> None:
        """Instant (zero-duration) marker, recorded immediately."""
        top = self.current_span()
        if trace_id is None:
            trace_id = top.trace_id if top is not None else self.default_trace_id
        t = self.clock()
        record = {
            "name": name,
            "trace_id": trace_id,
            "parent_id": top.span_id if top is not None else None,
            "t": t,
            "t_wall": self.wall_anchor + t,
            "thread": threading.current_thread().name,
            "service": self.service,
            "attrs": attrs,
        }
        self.recorder.add_event(record)
        self._write({"_event": True, **record})

    def close(self) -> None:
        fh, self._jsonl_fh = self._jsonl_fh, None
        if fh is not None:
            with self._jsonl_lock:
                fh.close()


class _NoopSpan:
    __slots__ = ()
    name = trace_id = span_id = thread = ""
    parent_id = None
    t_start = t_end = 0.0
    duration_s = 0.0
    attrs: Dict[str, Any] = {}

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def end(self) -> float:
        return 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {}


_NOOP_SPAN = _NoopSpan()


class _NoopCtx:
    __slots__ = ()

    def __enter__(self) -> _NoopSpan:
        return _NOOP_SPAN

    def __exit__(self, *exc) -> None:
        return None


_NOOP_CTX = _NoopCtx()


class NoopTracer:
    """A tracer that records nothing: the scheduler's default, so the batch
    CLI pays nothing for spans."""

    enabled = False
    service = "noop"
    clock = staticmethod(time.monotonic)
    wall_anchor = 0.0
    default_trace_id = "0" * 16

    def span(self, name: str, **kw: Any) -> _NoopCtx:
        return _NOOP_CTX

    def start_span(self, name: str, **kw: Any) -> _NoopSpan:
        return _NOOP_SPAN

    def current_span(self) -> None:
        return None

    def event(self, name: str, **kw: Any) -> None:
        return None

    def close(self) -> None:
        return None


def chrome_trace_events(
    spans: Iterable[Dict[str, Any]],
    events: Iterable[Dict[str, Any]] = (),
    *,
    pid: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Recorded span/event dicts as Chrome trace-event objects (the
    ``traceEvents`` list); timestamps in monotonic microseconds."""
    pid = os.getpid() if pid is None else pid
    out: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}

    def tid_of(thread: str) -> int:
        if thread not in tids:
            tids[thread] = len(tids) + 1
        return tids[thread]

    for s in spans:
        if s.get("t_end") is None:
            continue
        out.append(
            {
                "name": s["name"],
                "cat": s.get("service", "obs"),
                "ph": "X",
                "ts": round(s["t_start"] * 1e6, 3),
                "dur": round((s["t_end"] - s["t_start"]) * 1e6, 3),
                "pid": pid,
                "tid": tid_of(s.get("thread", "main")),
                "args": {
                    "trace_id": s.get("trace_id"),
                    "span_id": s.get("span_id"),
                    "parent_id": s.get("parent_id"),
                    **(s.get("attrs") or {}),
                },
            }
        )
    for e in events:
        out.append(
            {
                "name": e["name"],
                "cat": e.get("service", "obs"),
                "ph": "i",
                "s": "t",
                "ts": round(e["t"] * 1e6, 3),
                "pid": pid,
                "tid": tid_of(e.get("thread", "main")),
                "args": {"trace_id": e.get("trace_id"), **(e.get("attrs") or {})},
            }
        )
    for thread, tid in tids.items():
        out.append(
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": thread}}
        )
    return out
