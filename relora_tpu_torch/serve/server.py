"""Async HTTP/1.1 serving front end: streaming generation over the scheduler.

The port's own copy of ``relora_tpu/serve/server.py``, stdlib only beside
the scheduler: one asyncio listener accepts requests while a dedicated
**model thread** drives the engine, contiguous or paged, through the
scheduler's incremental core (any ``ContinuousBatchingScheduler``).  The
decode loop never blocks the event loop, and the event loop never touches a
tensor.

Endpoints:

- ``POST /v1/generate`` — body ``{"prompt": [ids...], "max_new_tokens": N,
  "temperature": T, "top_p": P, "stream": true, "deadline_s": S, "spec":
  true, "adapter": NAME}``.  Streaming responses are Server-Sent Events:
  one ``data: {"uid", "index", "token"}`` event per sampled token, a final
  ``data: {...finish record...}`` with the tokens and latency fields, then
  ``data: [DONE]``.  ``"stream": false`` returns the finish record alone.
- ``GET /healthz`` — 200 ``ok`` while routable; 503 with ``error`` (the
  model thread died), ``stuck`` (no decode step for ``stall_timeout_s``),
  ``draining`` (SIGTERM) or ``warming`` (``warmup_fn`` still running the
  serving shapes), with the scheduler's ``paging`` block when it has a
  page pool.
- ``GET /metrics`` — Prometheus text (``serve/admission.ServeMetrics``).
- ``POST /admin/reload`` — body ``{"checkpoint": DIR}``: ``reload_prepare``
  verifies and restores the checkpoint off the model thread (422 when it
  refuses; 409 while another reload is pending), then the model thread
  swaps the weights at its next idle boundary: claiming pauses, the
  requests in flight finish on the old weights, nothing is dropped.  A
  failed swap (500) keeps the old ``weights_version``.  ``/healthz`` carries
  ``weights_version`` and ``weights_checkpoint``, every generate response
  the ``X-Relora-Weights`` header.
- ``POST /internal/migrate`` — a donor's page-run frame
  (``wire.encode_page_run``; 400 when it does not decode): the run is
  adopted into a decoding slot on the model thread and the continuation
  streams back as SSE, which the donor relays to its client.  409 when the
  scheduler refuses the run, while a reload is pending here (so the swap's
  idle boundary is reached under steady handoffs), or when the record's
  ``weights_version`` is not this replica's: K/V prefilled by other weights
  never decodes here (the reference adopts it, ROADMAP Queue 3 item 0).
- ``/internal/prefix/*`` answers 501: the fleet prefix directory waits for
  the fleet front-end slice (ROADMAP Queue 1 item 5b).
- ``POST /admin/profile`` — an operator route, unauthenticated like
  ``/admin/reload`` (bind the server where only operators reach it).  Body
  ``{"action": "start"}`` opens a device profile window
  (``utils/profiling.DeviceWindow``) that closes itself after
  ``PROFILE_MAX_S`` seconds, so a window nobody closes does not record
  without end; ``{"action": "stop"}`` closes it (or takes the
  window that closed itself, marked ``"expired": true``) and answers its
  wall and device busy seconds and idle share: a replica's own share of a
  card that several processes share.  The window's read costs ~0.1 ms a
  kernel, on a thread of its own.

Disaggregated serving (``role`` from the scheduler, ``peer_file`` the
``peers.json`` roster): a prefill replica's scheduler hands each finished
prompt's run to ``_migration_sink``, which frames it and starts the handoff
on the event loop (``_migrate_task``): per decode peer, ``relayed`` (the
peer finished the stream: the donor slot is committed away), ``rejected``
(no token reached the client: the next peer, then local decode,
token-identical) or ``aborted`` (the peer died after a token reached the
client: a typed ``migration_failed`` error finish).  Work crossing into
the model thread (handoff outcomes, adopted runs) goes through an inbox the
model loop drains every iteration, as the reload goes through its fence.

Flow control: the ``AdmissionController`` is the only waiting room (a full
queue answers 429 + Retry-After); ``deadline_s`` ends a request at a round
boundary with its partial output (``finish_reason: "timeout"``); a client
that hangs up is cancelled at the next round, freeing its slot; a drain
(``begin_drain()`` or SIGTERM) answers 503 to new requests, finishes every
accepted one, then stops the listener.

CUDA on the model thread: the thread sets the engine's device before it
runs anything, and the warmup (the first launch of every kernel, which
builds and loads it) runs there before ``/healthz`` reports ``ok``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import os
import signal
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional, Set, Tuple

import torch

from relora_tpu_torch.obs.flight import dump_on_fault
from relora_tpu_torch.obs.tracer import NoopTracer, Tracer, new_trace_id
from relora_tpu_torch.serve import disagg
from relora_tpu_torch.serve.admission import (
    AdmissionController,
    Draining,
    QueueFull,
    ServeMetrics,
    Ticket,
)
from relora_tpu_torch.serve.scheduler import (
    Completion,
    ContinuousBatchingScheduler,
    Request,
)
from relora_tpu_torch.serve.deploy import checkpoint_step
from relora_tpu_torch.serve.wire import (
    MAX_BODY_BYTES,
    decode_page_run as _decode_page_run,
    encode_page_run as _encode_page_run,
    head as _head,
    read_http_request as _read_http_request,
    respond as _respond,
    respond_json as _respond_json,
    sse as _sse,
)
from relora_tpu_torch.utils import faults
from relora_tpu_torch.utils.logging import MetricsLogger, get_logger
from relora_tpu_torch.utils.profiling import DeviceWindow

logger = get_logger(__name__)

_REQUEST_TIMEOUT_S = 30.0
_IDLE_POP_S = 0.02
#: the longest an ``/admin/profile`` window stays open
PROFILE_MAX_S = 120.0

#: the peer prefix-page route, refused until the fleet front end is ported
_PREFIX_ROUTE = "/internal/prefix/"
FLEET_FRONT_END = (
    "the fleet prefix directory (GET /internal/prefix/<digest>, --fleet-url) is not "
    "ported to relora_tpu_torch yet: it comes with the fleet front end "
    "(ROADMAP Queue 1 item 5b)"
)


def _completion_record(completion: Completion) -> Dict[str, Any]:
    record = {
        "uid": completion.uid,
        "finish_reason": completion.finish_reason,
        "tokens": completion.tokens,
        "prompt_tokens": completion.prompt_tokens,
        "output_tokens": len(completion.tokens),
        "ttft_s": round(completion.ttft_s, 6),
        "latency_s": round(completion.latency_s, 6),
    }
    if completion.error is not None:
        record["error"] = completion.error
    return record


def _failed(ticket: Ticket, detail: str) -> Completion:
    """The finish record of a request that never produced a token."""
    return Completion(
        uid=ticket.uid, tokens=[], finish_reason="error",
        prompt_tokens=len(ticket.request.prompt), ttft_s=0.0, latency_s=0.0, error=detail,
    )


class BadRequest(Exception):
    """Malformed request body: HTTP 400."""


class _ReloadRequest:
    """One pending weight swap for the model thread: ``apply`` is the
    prepared copy onto the device (the checkpoint already verified and
    restored on the host); the model thread runs it at an idle boundary and
    sets ``done`` with ``ok`` or ``error`` filled in."""

    def __init__(self, apply: Callable[[], None], version: int, checkpoint: str):
        self.apply = apply
        self.version = version
        self.checkpoint = checkpoint
        self.done = threading.Event()
        self.ok = False
        self.error: Optional[str] = None


def parse_generate_body(
    body: bytes,
    *,
    default_max_new_tokens: int,
    default_temperature: float,
    default_top_p: float,
) -> Dict[str, Any]:
    """Validate the /v1/generate JSON body into plain fields (no uid yet).
    Raises BadRequest with a reader-facing message on any violation."""
    try:
        payload = json.loads(body.decode("utf-8") or "{}")
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise BadRequest(f"body is not valid JSON: {e}") from None
    if not isinstance(payload, dict):
        raise BadRequest("body must be a JSON object")
    prompt = payload.get("prompt")
    if not isinstance(prompt, list) or not all(
        isinstance(t, int) and not isinstance(t, bool) for t in prompt
    ):
        raise BadRequest('"prompt" must be a list of token ids (ints)')
    max_new = payload.get("max_new_tokens", default_max_new_tokens)
    if not isinstance(max_new, int) or isinstance(max_new, bool) or max_new < 1:
        raise BadRequest('"max_new_tokens" must be an int >= 1')
    temperature = payload.get("temperature", default_temperature)
    top_p = payload.get("top_p", default_top_p)
    if not isinstance(temperature, (int, float)) or temperature < 0:
        raise BadRequest('"temperature" must be a number >= 0')
    if not isinstance(top_p, (int, float)) or not 0.0 < top_p <= 1.0:
        raise BadRequest('"top_p" must be in (0, 1]')
    stream = payload.get("stream", True)
    if not isinstance(stream, bool):
        raise BadRequest('"stream" must be a boolean')
    deadline_s = payload.get("deadline_s")
    if deadline_s is not None and (not isinstance(deadline_s, (int, float)) or deadline_s <= 0):
        raise BadRequest('"deadline_s" must be a number > 0')
    # "spec": false opts this request out of drafting on a --spec server
    # (its tokens follow the same distribution); a no-op elsewhere
    spec = payload.get("spec", True)
    if not isinstance(spec, bool):
        raise BadRequest('"spec" must be a boolean')
    # "adapter" names a tenant under --adapter-dir; whether it is servable
    # is the scheduler's call (validate_request)
    adapter = payload.get("adapter")
    if adapter is not None and (not isinstance(adapter, str) or not adapter.strip()):
        raise BadRequest('"adapter" must be a non-empty string')
    return {
        "prompt": prompt,
        "max_new_tokens": max_new,
        "temperature": float(temperature),
        "top_p": float(top_p),
        "stream": stream,
        "deadline_s": deadline_s,
        "spec": spec,
        "adapter": adapter.strip() if isinstance(adapter, str) else None,
    }


class GenerateServer:
    """Asyncio front end over a continuous-batching scheduler, contiguous
    (:class:`ContinuousBatchingScheduler`) or paged (its subclass).

    The constructor takes an idle scheduler (the model thread becomes its
    one driving thread).  ``serve_forever()`` binds, starts the model
    thread, and runs until a drain completes; ``begin_drain()`` (thread-safe,
    also wired to SIGTERM) starts the drain.
    """

    def __init__(
        self,
        scheduler: ContinuousBatchingScheduler,
        *,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_queue: int = 64,
        default_max_new_tokens: int = 64,
        default_temperature: float = 0.0,
        default_top_p: float = 1.0,
        retry_after_s: float = 1.0,
        stall_timeout_s: float = 0.0,
        error_linger_s: float = 1.0,
        metrics: Optional[MetricsLogger] = None,
        tracer: Optional[Tracer] = None,
        warmup_fn: Optional[Callable[[], Any]] = None,
        reload_prepare: Optional[Callable[[str], Callable[[], None]]] = None,
        weights_version: int = 0,
        weights_checkpoint: str = "",
        peer_file: Optional[str] = None,
        fleet_url: Optional[str] = None,
        migrate_timeout_s: float = 30.0,
    ):
        if fleet_url is not None:
            raise NotImplementedError(f"fleet_url: {FLEET_FRONT_END}")
        self.scheduler = scheduler
        self.host = host
        self.port = port  # the bound port after bind (port=0 = ephemeral)
        # fleet replicas mint disjoint uid spaces (a request's uid keys its
        # sampling draws, so two replicas must never mint the same one)
        self.replica_id = os.environ.get("RELORA_TPU_REPLICA_ID", f"pid{os.getpid()}")
        uid_base = (
            (zlib.crc32(self.replica_id.encode()) % 1021 + 1) << 21
            if "RELORA_TPU_REPLICA_ID" in os.environ
            else 0
        )
        self.admission = AdmissionController(
            max_queue, retry_after_s=retry_after_s, uid_base=uid_base
        )
        self.stats = ServeMetrics()
        self.metrics = metrics
        if tracer is None:
            # one JSONL sink a process: replicas of a fleet share a trace dir
            trace_dir = os.environ.get("RELORA_TPU_TRACE_DIR")
            tracer = Tracer(
                service="serve",
                jsonl_path=(
                    os.path.join(trace_dir, f"serve_spans_{os.getpid()}.jsonl")
                    if trace_dir
                    else None
                ),
            )
        self.tracer = tracer
        # the scheduler's phase spans carry the requests' trace ids and its
        # histograms land on this /metrics (unless it was given its own)
        if isinstance(scheduler.tracer, NoopTracer):
            scheduler.tracer = self.tracer
        if scheduler.obs_registry is None:
            scheduler.obs_registry = self.stats
        # every adapter's series at zero before any tenant traffic
        registry = scheduler.adapter_registry
        if registry is not None:
            if registry.metrics is None:
                registry.metrics = self.stats
            self.stats.inc("adapter_requests_total", ("adapter", "base"), 0)
            for name in registry.list_adapters():
                self.stats.inc("adapter_requests_total", ("adapter", name), 0)
            self.stats.inc("adapter_evictions_total", by=0)
            self.stats.set_gauge("adapter_slots_used", registry.slots_used())
            self.stats.materialize_histogram("adapter_load_seconds")
        self.stats.inc("requests_finished_total", ("reason", "stop"), 0)
        self.stats.inc("requests_finished_total", ("reason", "error"), 0)
        self.default_max_new_tokens = default_max_new_tokens
        self.default_temperature = default_temperature
        self.default_top_p = default_top_p
        self.started = threading.Event()  # set once the listener is bound
        self.drained = threading.Event()  # set once the model thread exits
        self._t_start = time.monotonic()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._shutdown: Optional[asyncio.Event] = None
        self._handler_tasks: Set[asyncio.Task] = set()
        self._active: Dict[int, Ticket] = {}  # model thread only
        self._worker = threading.Thread(target=self._model_loop, name="serve-model", daemon=True)
        self._worker_error: Optional[BaseException] = None
        # stall watchdog: no decode step for stall_timeout_s while the
        # scheduler had work -> /healthz 503 "stuck" and one flight dump an
        # episode (0 disables)
        self.stall_timeout_s = stall_timeout_s
        # after the model thread dies the listener stays up this long (or
        # until a drain is asked for), so probes see 503 "error" before the
        # process exits
        self.error_linger_s = error_linger_s
        self._drain_requested = threading.Event()  # ends the linger early
        # feeds faults.serve_tick; the model thread (local decode) and the
        # event loop (relayed migration streams) both count, hence the lock
        self._tokens_emitted = 0
        self._emitted_lock = threading.Lock()
        # the weight hot swap: reload_prepare(path) runs off the model
        # thread (verify, restore on the host) and returns the apply the
        # model thread runs at an idle boundary
        self.reload_prepare = reload_prepare
        self.weights_version = weights_version
        self.weights_checkpoint = weights_checkpoint
        self.stats.set_gauge("weights_version", weights_version)
        self._reload_lock = threading.Lock()
        self._pending_reload: Optional[_ReloadRequest] = None
        # the profiler's state is its starting thread's: one thread starts
        # and stops every window
        self._profile = DeviceWindow()
        self._profile_thread = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-profile"
        )
        self._profile_expiry: Optional[asyncio.TimerHandle] = None
        self._profile_expired: Optional[Dict[str, Any]] = None  # a window that closed itself
        self._last_step_t = time.monotonic()
        self._model_busy = False  # model thread writes; watchdog reads
        self._stuck = False  # watchdog writes; healthz reads
        self._watchdog: Optional[threading.Thread] = None
        # warmup runs first on the model thread: the listener binds (and
        # the port file lands) at once, but /healthz answers 503 "warming"
        # until every serving shape has run
        self.warmup_fn = warmup_fn
        self.warmup_report: Optional[Any] = None
        self._warming = warmup_fn is not None
        self.stats.set_gauge("warming", 1 if self._warming else 0)
        # the disaggregated tier: the role is the scheduler's, peer_file the
        # peers.json roster; the inbox carries work into the model thread
        self.role = getattr(scheduler, "role", "mixed")
        self.peer_file = peer_file
        self.migrate_timeout_s = migrate_timeout_s
        self._disagg_inbox: Deque[Tuple[str, Any]] = deque()
        # a frame carries up to a whole block table of pages: the migrate
        # route takes that beside the general body limit (the reference's
        # 16 MiB alone refuses a 512-token run of llama_250m's int8 pool)
        self._route_limits: Dict[str, int] = {}
        engine = scheduler.engine
        if getattr(engine, "paged", False):
            run_bytes = engine.pool_bytes() // engine.num_pages * engine.block_table_width
            self._route_limits["/internal/migrate"] = MAX_BODY_BYTES + run_bytes
        if hasattr(scheduler, "migration_sink"):
            if self.role == "prefill" and peer_file:
                scheduler.migration_sink = self._migration_sink
            for name in ("pages_migrated_total", "migration_bytes_total",
                         "migration_failures_total", "migrated_inserts_total",
                         "prefix_fetch_total", "prefix_fetch_failures_total"):
                self.stats.inc(name, by=0)

    # -- lifecycle -----------------------------------------------------------------

    def begin_drain(self) -> None:
        """Stop admitting (new requests get 503), finish in-flight and queued
        work, then shut down.  Thread-safe and idempotent; after the model
        thread died it also ends the error linger."""
        self._drain_requested.set()
        if self.admission.draining:
            return
        logger.info("drain requested: rejecting new requests, finishing in-flight")
        self.admission.begin_drain()
        self.stats.set_gauge("draining", 1)
        if self.metrics is not None:
            self.metrics.event(
                "serve_drain_begin",
                queue_depth=self.admission.depth(),
                active_slots=self.scheduler.active_slots,
            )

    async def serve_forever(self, *, install_signal_handlers: bool = True) -> None:
        self._loop = asyncio.get_running_loop()
        self._shutdown = asyncio.Event()
        server = await asyncio.start_server(self._client_connected, self.host, self.port)
        self.port = server.sockets[0].getsockname()[1]
        if install_signal_handlers:
            try:
                self._loop.add_signal_handler(signal.SIGTERM, self.begin_drain)
            except (NotImplementedError, RuntimeError):
                # not the main thread: callers drain with begin_drain()
                logger.warning("SIGTERM handler unavailable; use begin_drain()")
        self.stats.set_gauge("draining", 0)
        self._worker.start()
        if self.stall_timeout_s > 0:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="serve-watchdog", daemon=True
            )
            self._watchdog.start()
        self.started.set()
        logger.info(f"serving on http://{self.host}:{self.port}")
        async with server:
            await self._shutdown.wait()
            server.close()
            await server.wait_closed()
        if self._handler_tasks:
            # the finish events are queued on the loop: a bounded grace for
            # the handlers to flush their last bytes
            await asyncio.wait(set(self._handler_tasks), timeout=10.0)
        if self._profile_expiry is not None:
            self._profile_expiry.cancel()
        self._profile_thread.submit(self._close_profile)
        self._profile_thread.shutdown(wait=True)
        if self.metrics is not None:
            self.metrics.event("serve_drain_complete", **self.stats.snapshot())
        logger.info("drain complete; server stopped")
        if self._worker_error is not None:
            raise RuntimeError("model thread died") from self._worker_error

    def _signal_shutdown(self) -> None:
        loop, shutdown = self._loop, self._shutdown
        if loop is None or shutdown is None:
            return
        try:
            loop.call_soon_threadsafe(shutdown.set)
        except RuntimeError:
            pass  # the loop already closed

    # -- model thread ----------------------------------------------------------------

    def _model_loop(self) -> None:
        """The scheduler's one driving thread: claim tickets while slots are
        free, apply cancellations, run one round, repeat.  Exits when
        draining and nothing is left anywhere."""
        sched = self.scheduler
        try:
            device = next(sched.engine.model.parameters()).device
            if device.type == "cuda":
                # a thread's current CUDA device is its own: launch every
                # kernel on the card that holds the weights
                torch.cuda.set_device(device)
            if self.warmup_fn is not None:
                t0 = time.monotonic()
                logger.info("warmup: running every serving shape before going routable")
                self.warmup_report = self.warmup_fn()
                self._warming = False
                self.stats.set_gauge("warming", 0)
                self._last_step_t = time.monotonic()
                logger.info(f"warmup complete in {time.monotonic() - t0:.1f}s; healthz -> ok")
                if self.metrics is not None:
                    detail = self.warmup_report if isinstance(self.warmup_report, dict) else {}
                    self.metrics.event(
                        "serve_warm", duration_s=round(time.monotonic() - t0, 3), **detail
                    )
            while True:
                faults.serve_tick(self._tokens_emitted)  # serving drills only
                # a pending reload pauses claiming only: queued tickets wait
                # in admission, the requests in flight finish on the old
                # weights, and the swap runs at the idle boundary below
                reload_req = self._pending_reload
                while reload_req is None and (
                    sched.active_slots + sched.queue_depth < sched.max_batch
                ):
                    ticket = self.admission.pop(timeout=None)
                    if ticket is None:
                        break
                    self._claim(ticket)
                for uid, ticket in list(self._active.items()):
                    if ticket.cancelled.is_set():
                        sched.cancel(uid)  # fires on_finish -> _active cleanup
                self._drain_disagg_inbox()
                self.stats.set_gauge("queue_depth", self.admission.depth() + sched.queue_depth)
                self.stats.set_gauge("active_slots", sched.active_slots)
                self.stats.set_gauge("retry_after_s", round(self.admission.retry_after_s, 3))
                if sched.has_work():
                    self._model_busy = True
                    sched.step()
                    self._last_step_t = time.monotonic()
                    continue
                self._model_busy = False
                self._last_step_t = time.monotonic()  # idle is not a stall
                if reload_req is not None:
                    # the boundary: nothing active, nothing queued in the
                    # scheduler; swap now, claim again next iteration
                    self._apply_reload(reload_req)
                    continue
                if self.admission.draining and self.admission.depth() == 0:
                    break
                ticket = self.admission.pop(timeout=_IDLE_POP_S)
                if ticket is not None:
                    self._claim(ticket)
        except BaseException as e:  # recorded and re-raised by serve_forever
            self._worker_error = e
            logger.error(f"model thread died: {e!r}")
            dump_on_fault("serve_model_thread")  # the spans before the death
            self._fail_pending(e)
        finally:
            self._fail_reload("model thread exited")
            self.drained.set()
            if self._worker_error is not None and self.error_linger_s > 0:
                self._drain_requested.wait(self.error_linger_s)
            self._signal_shutdown()

    def _fail_pending(self, error: BaseException) -> None:
        """The model thread died: finish every active and queued request with
        ``finish_reason="error"`` instead of stranding its stream."""
        detail = f"model thread died: {error!r}"
        self.stats.set_gauge("model_dead", 1)
        try:
            # the scheduler's requests: fail_all fires the usual on_finish
            # wrappers, so metrics, spans and SSE finishes flow as always
            self.scheduler.fail_all(reason="error", detail=detail)
        except Exception as e:
            logger.error(f"fail_all after model-thread death failed too: {e!r}")
            for uid, ticket in list(self._active.items()):
                self._active.pop(uid, None)
                try:
                    ticket.on_finish(_failed(ticket, detail))
                except Exception:
                    logger.exception(f"request {uid}: finish callback failed")
        # tickets still waiting in admission, never claimed
        while True:
            ticket = self.admission.pop(timeout=None)
            if ticket is None:
                break
            self.stats.inc("requests_finished_total", ("reason", "error"))
            if ticket.queue_span is not None:
                ticket.queue_span.set(outcome="error").end()
            if ticket.span is not None:
                ticket.span.set(finish_reason="error", output_tokens=0).end()
            try:
                ticket.on_finish(_failed(ticket, detail))
            except Exception as e:
                logger.warning(f"request {ticket.uid}: finish callback failed: {e!r}")

    # -- the weight hot swap ---------------------------------------------------------

    def request_reload(
        self, apply: Callable[[], None], version: int, checkpoint: str
    ) -> _ReloadRequest:
        """Queue a prepared swap for the model thread's next idle boundary.
        Thread-safe; raises RuntimeError while another is pending (one swap
        at a time keeps the versions in order)."""
        req = _ReloadRequest(apply, version, checkpoint)
        with self._reload_lock:
            if self._pending_reload is not None:
                raise RuntimeError("a weight reload is already pending")
            self._pending_reload = req
        return req

    def _apply_reload(self, req: _ReloadRequest) -> None:
        """Model thread, idle boundary: run the swap.  A failure fails
        closed: the old weights keep serving and the version stays."""
        try:
            faults.maybe_fail("deploy_reload")
            req.apply()
        except Exception as e:
            req.error = f"{e!r}"
            self.stats.inc("weights_reload_failures_total")
            logger.error(
                f"weight reload to {req.checkpoint!r} failed ({e!r}); "
                f"keeping weights_version {self.weights_version}"
            )
            if self.metrics is not None:
                self.metrics.event("serve_reload_failed", checkpoint=req.checkpoint,
                                   error=f"{e!r}")
        else:
            # prefix pages hold K/V of the old weights: no later request may
            # reuse them (nothing is active at this boundary, so every
            # entry is the cache's alone)
            prefix_cache = getattr(self.scheduler, "prefix_cache", None)
            if prefix_cache is not None:
                prefix_cache.clear()
            req.ok = True
            self.weights_version = req.version
            self.weights_checkpoint = req.checkpoint
            self.stats.inc("weights_reloads_total")
            self.stats.set_gauge("weights_version", req.version)
            logger.info(f"weights hot-swapped to version {req.version} ({req.checkpoint})")
            if self.metrics is not None:
                self.metrics.event("serve_reload", weights_version=req.version,
                                   checkpoint=req.checkpoint)
        finally:
            with self._reload_lock:
                self._pending_reload = None
            req.done.set()

    def _fail_reload(self, detail: str) -> None:
        """Finish a still-pending reload with an error, so its requester never
        hangs (the model thread died or drained)."""
        with self._reload_lock:
            req, self._pending_reload = self._pending_reload, None
        if req is not None and not req.done.is_set():
            req.error = detail
            self.stats.inc("weights_reload_failures_total")
            req.done.set()

    def _watchdog_loop(self) -> None:
        """When the scheduler had work but no step completed for
        ``stall_timeout_s``, flip ``/healthz`` to 503 "stuck" and dump the
        flight recorder once an episode; un-stick when a step completes."""
        interval = max(0.02, min(self.stall_timeout_s / 4.0, 1.0))
        while not self.drained.is_set():
            time.sleep(interval)
            # _model_busy and _last_step_t freeze while the model thread is
            # wedged, which is exactly the signal
            stalled = (
                self._model_busy
                and time.monotonic() - self._last_step_t > self.stall_timeout_s
            )
            if stalled and not self._stuck:
                self._stuck = True
                self.stats.set_gauge("stuck", 1)
                logger.error(
                    f"watchdog: no decode step for {self.stall_timeout_s:.1f}s "
                    "with work queued; healthz -> 503 stuck"
                )
                dump_on_fault("serve_stall")
                if self.metrics is not None:
                    self.metrics.event(
                        "serve_stall_detected",
                        stall_timeout_s=self.stall_timeout_s,
                        active_slots=self.scheduler.active_slots,
                    )
            elif not stalled and self._stuck:
                self._stuck = False
                self.stats.set_gauge("stuck", 0)
                logger.warning("watchdog: decode progress resumed; healthz -> ok")

    def _claim(self, ticket: Ticket) -> None:
        """Hand one admitted ticket to the scheduler (model thread only)."""
        # the queue-wait span opened at admission on the event loop ends here
        if ticket.queue_span is not None:
            self.stats.observe("queue_wait_seconds", ticket.queue_span.end())
        if ticket.cancelled.is_set():
            # the client left while the request was queued: never admit it
            self.stats.inc("requests_finished_total", ("reason", "cancelled"))
            if ticket.span is not None:
                ticket.span.set(finish_reason="cancelled", output_tokens=0).end()
            ticket.on_finish(
                Completion(
                    uid=ticket.uid, tokens=[], finish_reason="cancelled",
                    prompt_tokens=len(ticket.request.prompt), ttft_s=0.0, latency_s=0.0,
                )
            )
            return
        self._active[ticket.uid] = ticket
        self.scheduler.submit(
            ticket.request,
            on_token=lambda uid, tok, idx, _t=ticket: self._token_cb(_t, uid, tok, idx),
            on_finish=lambda completion, _t=ticket: self._finish_cb(_t, completion),
            deadline=ticket.deadline,
            trace_id=ticket.trace_id,
        )

    def _token_cb(self, ticket: Ticket, uid: int, token: int, index: int) -> None:
        """Per-token bookkeeping: the latency histograms, the Retry-After
        TPOT estimate, and the client's own on_token."""
        now = time.monotonic()
        if index == 0:
            self.stats.observe("ttft_seconds", now - ticket.t_enqueue)
        elif ticket.t_last_token is not None:
            tpot = now - ticket.t_last_token
            self.stats.observe("tpot_seconds", tpot)
            self.admission.note_tpot(tpot)
        ticket.t_last_token = now
        with self._emitted_lock:
            self._tokens_emitted += 1
        self.stats.inc("tokens_generated_total")
        ticket.on_token(uid, token, index)

    def _finish_cb(self, ticket: Ticket, completion: Completion) -> None:
        """Finish bookkeeping: counters, end-to-end latency, the root span,
        the client's stream."""
        self._active.pop(completion.uid, None)
        self.stats.inc("requests_finished_total", ("reason", completion.finish_reason))
        self.stats.observe("e2e_latency_seconds", time.monotonic() - ticket.t_enqueue)
        if ticket.span is not None:
            ticket.span.set(
                finish_reason=completion.finish_reason, output_tokens=len(completion.tokens)
            ).end()
        ticket.on_finish(completion)

    # -- the disaggregated handoff ---------------------------------------------------
    #
    # The scheduler is the model thread's alone: every handoff outcome and
    # adopted run crosses from the event loop through _disagg_inbox, applied
    # by _drain_disagg_inbox inside the model loop.  _migration_sink is
    # called by the scheduler on the model thread; the relay (_migrate_task)
    # and the /internal/migrate handler run on the event loop.

    def _drain_disagg_inbox(self) -> None:
        """Model thread: apply the queued cross-thread work."""
        sched = self.scheduler
        while self._disagg_inbox:
            kind, payload = self._disagg_inbox.popleft()
            try:
                if kind == "failed":
                    sched.migration_failed(payload[0], payload[1])
                elif kind == "commit":
                    sched.migration_commit(payload[0], bytes_sent=payload[1])
                elif kind == "abort":
                    sched.migration_abort(payload[0], payload[1])
                elif kind == "insert":
                    self._apply_migrate_insert(*payload)
            except Exception as e:
                # inbox work never kills the model thread: each message has
                # its own fail-open path, and this is the last resort
                logger.warning(f"disagg inbox {kind!r} failed: {e!r}")

    def _apply_migrate_insert(
        self, record: Dict[str, Any], arrays: Any, ticket: Ticket, done: threading.Event,
        result: Dict[str, Any],
    ) -> None:
        """Model thread: adopt a migrated run into a decoding slot; a raise
        lands in ``result["error"]`` and the donor fails open."""
        try:
            if ticket.cancelled.is_set():
                raise RuntimeError("donor went away before the insert")
            # the fence and the version are read on this thread, which is the
            # one that swaps: nothing changes between this check and the insert
            if self._pending_reload is not None:
                raise RuntimeError("a weight reload is pending")
            if record.get("weights_version") != self.weights_version:
                raise RuntimeError(
                    f"run prefilled on weights_version {record.get('weights_version')}, "
                    f"serving {self.weights_version}"
                )
            self.scheduler.submit_migrated(
                record,
                arrays,
                on_token=lambda uid, tok, idx, _t=ticket: self._token_cb(_t, uid, tok, idx),
                on_finish=lambda completion, _t=ticket: self._finish_cb(_t, completion),
                deadline=ticket.deadline,
                trace_id=ticket.trace_id,
            )
            self._active[ticket.uid] = ticket
        except Exception as e:
            result["error"] = str(e)
        finally:
            done.set()

    def _migration_sink(self, record: Dict[str, Any], entries: Any) -> bool:
        """Model thread (the scheduler's ``_maybe_migrate``): pick decode
        peers, frame the run and start the handoff on the event loop.  False
        means it could not start, and the scheduler fails open at once."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return False
        ticket = self._active.get(int(record["uid"]))
        if ticket is None or ticket.cancelled.is_set():
            return False
        peers = disagg.load_peers(self.peer_file)
        candidates = disagg.pick_peers(peers, role="decode", exclude_rid=self.replica_id)
        if not candidates:
            return False
        # what only the server knows: the deadline left, the request id and
        # the weights that prefilled the run
        record["weights_version"] = self.weights_version
        if ticket.deadline is not None:
            record["deadline_s"] = max(0.1, ticket.deadline - time.monotonic())
        if ticket.trace_id:
            record["trace_id"] = ticket.trace_id
        try:
            blob = _encode_page_run(record, entries)
        except Exception as e:
            logger.warning(f"request {record['uid']}: wire encode failed: {e!r}")
            return False
        asyncio.run_coroutine_threadsafe(
            self._migrate_task(record, blob, ticket, candidates[:2]), loop
        )
        return True

    async def _migrate_task(
        self, record: Dict[str, Any], blob: bytes, ticket: Ticket, candidates: list
    ) -> None:
        """Event loop: the handoff against each candidate peer in turn.  An
        attempt is ``relayed`` (the peer finished the stream: commit the
        donor slot), ``rejected`` (no token reached the client: the next
        peer, else local decode, still token-identical) or ``aborted`` (the
        peer died after relaying a token: a replay would repeat tokens, so
        the client gets a typed error finish)."""
        uid = int(record["uid"])
        detail = "no decode peer accepted the handoff"
        for peer in candidates:
            try:
                outcome, detail = await self._migrate_attempt(blob, ticket, peer, uid)
            except Exception as e:
                outcome, detail = "rejected", f"{peer.get('rid')}: {e!r}"
            if outcome == "relayed":
                self._disagg_inbox.append(("commit", (uid, len(blob))))
                return
            if outcome == "aborted":
                self._disagg_inbox.append(("abort", (uid, detail)))
                try:
                    self._finish_cb(ticket, Completion(
                        uid=uid, tokens=[], finish_reason="error",
                        prompt_tokens=len(ticket.request.prompt), ttft_s=0.0,
                        latency_s=time.monotonic() - ticket.t_enqueue,
                        error=f"migration_failed: {detail}",
                    ))
                except Exception as e:
                    logger.warning(f"request {uid}: finish callback failed: {e!r}")
                if self.metrics is not None:
                    self.metrics.event("migration_failed", uid=uid, detail=str(detail),
                                       aborted=True)
                return
            logger.warning(f"request {uid}: handoff to {peer.get('rid')} rejected ({detail})")
        self._disagg_inbox.append(("failed", (uid, detail)))
        if self.metrics is not None:
            self.metrics.event("migration_failed", uid=uid, detail=str(detail))

    async def _migrate_attempt(
        self, blob: bytes, ticket: Ticket, peer: Dict[str, Any], uid: int
    ) -> Tuple[str, str]:
        """One ``POST /internal/migrate`` exchange: send the frame, then relay
        the peer's SSE continuation into the client ticket's callbacks.
        Returns ``("relayed" | "rejected" | "aborted", detail)``."""
        host = str(peer.get("host") or "127.0.0.1")
        port = int(peer["port"])
        relayed_any = False
        timeout = self.migrate_timeout_s
        try:
            reader, writer = await asyncio.wait_for(asyncio.open_connection(host, port), 5.0)
        except (OSError, asyncio.TimeoutError) as e:
            return "rejected", f"connect {host}:{port}: {e!r}"
        try:
            writer.write(
                (f"POST /internal/migrate HTTP/1.1\r\nHost: {host}:{port}\r\n"
                 f"Content-Type: application/octet-stream\r\nContent-Length: {len(blob)}\r\n"
                 f"Connection: close\r\n\r\n").encode()
            )
            writer.write(blob)
            await asyncio.wait_for(writer.drain(), timeout)
            status_line = await asyncio.wait_for(reader.readline(), timeout)
            parts = status_line.decode("latin-1", "replace").split()
            status = int(parts[1]) if len(parts) >= 2 and parts[1].isdigit() else 0
            while True:  # the response head; an SSE or JSON body follows
                line = await asyncio.wait_for(reader.readline(), timeout)
                if line in (b"\r\n", b"\n", b""):
                    break
            if status != 200:
                body = await reader.read(4096)
                return "rejected", f"{host}:{port} -> {status} {body[:200]!r}"
            while True:
                if ticket.cancelled.is_set():
                    # the client left: closing our end is the peer's
                    # disconnect, which frees its slot; commit the donor's
                    self._finish_cb(ticket, Completion(
                        uid=uid, tokens=[], finish_reason="cancelled",
                        prompt_tokens=len(ticket.request.prompt), ttft_s=0.0,
                        latency_s=time.monotonic() - ticket.t_enqueue,
                    ))
                    return "relayed", "client cancelled mid-relay"
                line = await asyncio.wait_for(reader.readline(), timeout)
                if not line:
                    if relayed_any:
                        return "aborted", f"{host}:{port}: peer died mid-stream"
                    return "rejected", f"{host}:{port}: peer died before first token"
                line = line.strip()
                if not line.startswith(b"data: "):
                    continue
                data = line[len(b"data: "):]
                if data == b"[DONE]":
                    continue
                try:
                    rec = json.loads(data.decode("utf-8"))
                except (UnicodeDecodeError, json.JSONDecodeError):
                    continue
                if not isinstance(rec, dict):
                    continue
                if "finish_reason" in rec:
                    if rec["finish_reason"] == "error" and not relayed_any:
                        # nothing reached the client: the next peer or local
                        # decode is still safe
                        return "rejected", f"{host}:{port}: {rec.get('error')}"
                    self._finish_cb(ticket, Completion(
                        uid=uid,
                        tokens=[int(t) for t in rec.get("tokens", [])],
                        finish_reason=str(rec["finish_reason"]),
                        prompt_tokens=int(rec.get("prompt_tokens", len(ticket.request.prompt))),
                        ttft_s=float(rec.get("ttft_s", 0.0)),
                        latency_s=time.monotonic() - ticket.t_enqueue,
                        error=rec.get("error"),
                    ))
                    return "relayed", "ok"
                if "token" in rec:
                    relayed_any = True
                    self._token_cb(ticket, uid, int(rec["token"]), int(rec["index"]))
        except (asyncio.TimeoutError, ConnectionError, OSError) as e:
            if relayed_any:
                return "aborted", f"{host}:{port}: {e!r}"
            return "rejected", f"{host}:{port}: {e!r}"
        finally:
            try:
                writer.close()
            except Exception:
                pass

    # -- asyncio handlers --------------------------------------------------------------

    async def _client_connected(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._handler_tasks.add(task)
            task.add_done_callback(self._handler_tasks.discard)
        try:
            await self._handle(reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError, TimeoutError):
            pass  # the client went away; per-request cleanup already ran
        except Exception as e:
            logger.warning(f"handler error: {e!r}")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        if faults.should("serve_accept_drop"):
            # drill: an accepted connection that dies before a byte of
            # response, what a router's pre-stream retry must absorb
            self.stats.inc("accept_drops_total")
            return
        try:
            parsed = await asyncio.wait_for(
                _read_http_request(reader, self._route_limits), _REQUEST_TIMEOUT_S
            )
        except ValueError as e:
            await _respond_json(writer, 400, {"error": str(e)})
            return
        if parsed is None:
            return
        method, path, headers, body = parsed
        route = path.split("?", 1)[0]
        if route == "/healthz" and method == "GET":
            self.stats.inc("http_requests_total", ("route", "healthz"))
            await self._handle_healthz(writer)
        elif route == "/metrics" and method == "GET":
            self.stats.inc("http_requests_total", ("route", "metrics"))
            await _respond(
                writer, 200, self.stats.render(), content_type="text/plain; version=0.0.4"
            )
        elif route == "/v1/generate":
            self.stats.inc("http_requests_total", ("route", "generate"))
            if method != "POST":
                await _respond_json(writer, 405, {"error": "use POST"})
                return
            await self._handle_generate(reader, writer, body, headers)
        elif route == "/admin/reload":
            self.stats.inc("http_requests_total", ("route", "reload"))
            if method != "POST":
                await _respond_json(writer, 405, {"error": "use POST"})
                return
            await self._handle_reload(writer, body)
        elif route == "/internal/migrate":
            self.stats.inc("http_requests_total", ("route", "migrate"))
            if method != "POST":
                await _respond_json(writer, 405, {"error": "use POST"})
                return
            await self._handle_migrate(reader, writer, body)
        elif route == "/admin/profile":
            self.stats.inc("http_requests_total", ("route", "profile"))
            if method != "POST":
                await _respond_json(writer, 405, {"error": "use POST"})
                return
            await self._handle_profile(writer, body)
        elif route.startswith(_PREFIX_ROUTE):
            self.stats.inc("http_requests_total", ("route", "prefix"))
            await _respond_json(writer, 501, {"error": FLEET_FRONT_END})
        else:
            self.stats.inc("http_requests_total", ("route", "other"))
            await _respond_json(writer, 404, {"error": f"no route {route}"})

    async def _handle_healthz(self, writer: asyncio.StreamWriter) -> None:
        # a dead worker trumps everything, a wedged one the drain, the drain
        # the warmup: a router stops routing (or never starts) on all four
        if self._worker_error is not None:
            state, status = "error", 503
        elif self._stuck:
            state, status = "stuck", 503
        elif self.admission.draining:
            state, status = "draining", 503
        elif self._warming:
            state, status = "warming", 503
        else:
            state, status = "ok", 200
        payload = {
            "status": state,
            "active_slots": self.scheduler.active_slots,
            "queue_depth": self.admission.depth() + self.scheduler.queue_depth,
            "max_batch": self.scheduler.max_batch,
            "max_queue": self.admission.max_queue,
            "retry_after_s": round(self.admission.retry_after_s, 3),
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            # numeric, so a fleet collector can ingest it; the checkpoint
            # path is what a rolling updater reads back as its rollback target
            "weights_version": self.weights_version,
            "weights_checkpoint": self.weights_checkpoint,
            "role": self.role,
        }
        prefix_cache = getattr(self.scheduler, "prefix_cache", None)
        if prefix_cache is not None:
            try:
                payload["prefix_digests"] = prefix_cache.digests()
            except RuntimeError:
                pass  # the model thread mutated the cache mid-iteration
        if self._worker_error is not None:
            payload["detail"] = f"model thread died: {self._worker_error!r}"
        elif self._stuck:
            payload["detail"] = f"no decode step completed for {self.stall_timeout_s:.1f}s"
        elif self._warming:
            payload["detail"] = "warmup in progress"
        paging_stats = getattr(self.scheduler, "paging_stats", None)
        if paging_stats is not None:
            payload["paging"] = paging_stats()
        adapter_stats = self.scheduler.adapter_stats()
        if adapter_stats is not None:
            payload["adapters"] = adapter_stats
        await _respond_json(writer, status, payload)

    async def _handle_reload(self, writer: asyncio.StreamWriter, body: bytes) -> None:
        """``POST /admin/reload {"checkpoint": DIR}``: ``reload_prepare``
        (verify, restore on the host) off the event loop and the model
        thread, then the swap at the model thread's idle boundary, whose
        verdict is the answer.  Every failure keeps the old weights serving:
        the version moves only on a full success."""
        if self.reload_prepare is None:
            await _respond_json(writer, 501, {"error": "no reload path configured"})
            return
        if self._worker_error is not None:
            await _respond_json(writer, 503, {"error": f"model thread died: {self._worker_error!r}"})
            return
        try:
            payload = json.loads(body.decode("utf-8") or "{}")
            path = payload.get("checkpoint") if isinstance(payload, dict) else None
            if not isinstance(path, str) or not path.strip():
                raise BadRequest('"checkpoint" must be a non-empty path string')
        except (UnicodeDecodeError, json.JSONDecodeError, BadRequest) as e:
            await _respond_json(writer, 400, {"error": str(e)})
            return
        path = path.strip()
        version = checkpoint_step(path)
        if version is None:
            version = self.weights_version + 1  # directories not named model_N still order
        loop = asyncio.get_running_loop()
        try:
            # decode keeps running while the host restores the checkpoint
            apply = await loop.run_in_executor(None, self.reload_prepare, path)
        except Exception as e:
            self.stats.inc("weights_reload_failures_total")
            logger.error(f"reload rejected before any device write: {e!r}")
            if self.metrics is not None:
                self.metrics.event("serve_reload_failed", checkpoint=path, error=f"{e!r}")
            await _respond_json(writer, 422, {"error": f"{e}",
                                              "weights_version": self.weights_version})
            return
        try:
            req = self.request_reload(apply, version, path)
        except RuntimeError as e:
            await _respond_json(writer, 409, {"error": str(e),
                                              "weights_version": self.weights_version})
            return
        await loop.run_in_executor(None, req.done.wait)
        await _respond_json(writer, 200 if req.ok else 500, {
            "ok": req.ok,
            "weights_version": self.weights_version,
            "weights_checkpoint": self.weights_checkpoint,
            **({"error": req.error} if req.error else {}),
        })

    async def _handle_profile(self, writer: asyncio.StreamWriter, body: bytes) -> None:
        """``POST /admin/profile {"action": "start" | "stop"}``: open the
        device profile window, closing itself after ``PROFILE_MAX_S``
        seconds, or close it (409 when it is already open, or neither open
        nor expired)."""
        try:
            payload = json.loads(body.decode("utf-8") or "{}")
            action = payload.get("action") if isinstance(payload, dict) else None
            if action not in ("start", "stop"):
                raise BadRequest('"action" must be "start" or "stop"')
        except (UnicodeDecodeError, json.JSONDecodeError, BadRequest) as e:
            await _respond_json(writer, 400, {"error": str(e)})
            return
        loop = asyncio.get_running_loop()
        try:
            if action == "start":
                await loop.run_in_executor(self._profile_thread, self._profile.start)
                window = self._profile.opened
                self._profile_expiry = loop.call_later(
                    PROFILE_MAX_S, self._profile_thread.submit, self._expire_profile, window
                )
                result = {"profiling": True, "max_s": PROFILE_MAX_S}
            else:
                if self._profile_expiry is not None:
                    self._profile_expiry.cancel()
                result = await loop.run_in_executor(self._profile_thread, self._stop_profile)
        except RuntimeError as e:
            await _respond_json(writer, 409, {"error": str(e)})
            return
        await _respond_json(writer, 200, result)

    # the profile thread's own: the profiler's state is the thread's that
    # started it

    def _expire_profile(self, window: int) -> None:
        """Close window ``window`` if it is still the open one."""
        if self._profile.open and self._profile.opened == window:
            self._profile_expired = {**self._profile.stop(), "expired": True}
            logger.warning(f"device profile window {window} closed itself after "
                           f"{PROFILE_MAX_S:g} s")

    def _stop_profile(self) -> Dict[str, Any]:
        if self._profile.open:
            self._profile_expired = None
            return self._profile.stop()
        expired, self._profile_expired = self._profile_expired, None
        if expired is None:
            raise RuntimeError("no device profile window is open")
        return expired

    def _close_profile(self) -> None:
        """At the server's exit: a window still open stops recording."""
        if self._profile.open:
            self._profile.stop()

    async def _handle_migrate(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, body: bytes
    ) -> None:
        """``POST /internal/migrate``: adopt a donor's page run into a
        decoding slot and stream the continuation back as SSE.  Every
        refusal is a non-200 the donor answers with local decode, so
        refusing is always safe; accepting makes this replica the owner of
        the request's stream."""
        if self._worker_error is not None or self._warming or self.admission.draining:
            await _respond_json(writer, 503, {"error": "replica not accepting handoffs"})
            return
        try:
            record, arrays = _decode_page_run(body)
            if not isinstance(record, dict):
                raise ValueError("page-run meta must be an object")
            req = Request(
                uid=int(record["uid"]),
                prompt=[int(t) for t in record["prompt"]],
                max_new_tokens=int(record["max_new_tokens"]),
                temperature=float(record.get("temperature", 0.0)),
                top_p=float(record.get("top_p", 1.0)),
                spec=bool(record.get("spec", True)),
                adapter=record.get("adapter"),
            )
        except (ValueError, KeyError, TypeError) as e:
            await _respond_json(writer, 400, {"error": f"bad page run: {e}"})
            return
        loop = asyncio.get_running_loop()
        events: "asyncio.Queue[Tuple[str, Any, Any]]" = asyncio.Queue()

        def post(kind: str, a: Any = None, b: Any = None) -> None:
            try:
                loop.call_soon_threadsafe(events.put_nowait, (kind, a, b))
            except RuntimeError:
                pass

        deadline_s = record.get("deadline_s")
        ticket = Ticket(
            uid=req.uid,
            request=req,
            deadline=(time.monotonic() + float(deadline_s)
                      if isinstance(deadline_s, (int, float)) and deadline_s > 0 else None),
            on_token=lambda uid, tok, idx: post("token", tok, idx),
            on_finish=lambda completion: post("finish", completion),
            trace_id=record.get("trace_id"),
        )
        done = threading.Event()
        result: Dict[str, Any] = {}
        self._disagg_inbox.append(("insert", (record, arrays, ticket, done, result)))
        ok = await loop.run_in_executor(None, done.wait, self.migrate_timeout_s)
        if not ok:
            # a late insert is refused (or, landed, freed by the cancel scan)
            ticket.cancelled.set()
            await _respond_json(writer, 503, {"error": "migrated insert timed out"})
            return
        if result.get("error"):
            await _respond_json(writer, 409, {"error": result["error"]})
            return
        await self._stream_response(reader, writer, ticket, events)

    async def _handle_generate(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        body: bytes,
        headers: Optional[Dict[str, str]] = None,
    ) -> None:
        # the request id is the span trace id and the X-Request-Id header: a
        # caller's header is honored, else one is minted here
        rid = ((headers or {}).get("x-request-id") or "").strip() or new_trace_id()
        rid_header = {"X-Request-Id": rid}
        if self._worker_error is not None:
            # a dead worker, the listener lingering for probes: fail fast
            self.stats.inc("rejected_total", ("reason", "error"))
            await _respond_json(
                writer, 500, {"error": f"model thread died: {self._worker_error!r}"},
                extra_headers=rid_header,
            )
            return
        try:
            fields = parse_generate_body(
                body,
                default_max_new_tokens=self.default_max_new_tokens,
                default_temperature=self.default_temperature,
                default_top_p=self.default_top_p,
            )
            req = Request(
                uid=self.admission.next_uid(),
                prompt=fields["prompt"],
                max_new_tokens=fields["max_new_tokens"],
                temperature=fields["temperature"],
                top_p=fields["top_p"],
                spec=fields["spec"],
                adapter=fields["adapter"],
            )
            # capacity and adapter errors answer 400 here, before admission
            self.scheduler.validate_request(req)
        except (BadRequest, ValueError) as e:
            self.stats.inc("rejected_total", ("reason", "bad_request"))
            await _respond_json(writer, 400, {"error": str(e)}, extra_headers=rid_header)
            return

        loop = asyncio.get_running_loop()
        events: "asyncio.Queue[Tuple[str, Any, Any]]" = asyncio.Queue()

        def post(kind: str, a: Any = None, b: Any = None) -> None:
            try:
                loop.call_soon_threadsafe(events.put_nowait, (kind, a, b))
            except RuntimeError:
                pass  # the loop closed mid-drain; the record is in the metrics

        deadline = (
            time.monotonic() + fields["deadline_s"] if fields["deadline_s"] is not None else None
        )
        # the root span; queue_wait opens now and the model thread ends it
        # when it claims the ticket
        root = self.tracer.start_span(
            "request", trace_id=rid, uid=req.uid, route="generate",
            prompt_tokens=len(req.prompt),
        )
        ticket = Ticket(
            uid=req.uid,
            request=req,
            deadline=deadline,
            on_token=lambda uid, tok, idx: post("token", tok, idx),
            on_finish=lambda completion: post("finish", completion),
            trace_id=rid,
            span=root,
            queue_span=self.tracer.start_span("queue_wait", trace_id=rid, parent=root, uid=req.uid),
        )
        try:
            self.admission.try_admit(ticket)
        except (QueueFull, Draining) as e:
            full = isinstance(e, QueueFull)
            reason = "queue_full" if full else "draining"
            self.stats.inc("rejected_total", ("reason", reason))
            ticket.queue_span.set(outcome=reason).end()
            root.set(finish_reason=f"rejected_{reason}").end()
            await _respond_json(
                writer,
                429 if full else 503,
                {"error": str(e)},
                extra_headers={
                    "Retry-After": f"{self.admission.retry_after_s:.0f}",
                    **rid_header,
                },
            )
            return
        if fields["stream"]:
            await self._stream_response(reader, writer, ticket, events)
        else:
            await self._unary_response(reader, writer, ticket, events)

    async def _next_event(self, reader, ticket, events, eof_watch):
        """The ticket's next (kind, a, b) event, or None when the client hung
        up first (the ticket is then cancelled)."""
        getter = asyncio.ensure_future(events.get())
        done, _ = await asyncio.wait({getter, eof_watch}, return_when=asyncio.FIRST_COMPLETED)
        if eof_watch in done and getter not in done:
            getter.cancel()
            self._client_gone(ticket)
            return None
        return getter.result()

    async def _stream_response(self, reader, writer, ticket, events) -> None:
        writer.write(
            _head(
                200, "OK", "text/event-stream",
                {
                    "Cache-Control": "no-cache",
                    "X-Request-Id": ticket.trace_id or "",
                    "X-Relora-Weights": str(self.weights_version),
                },
            )
        )
        await writer.drain()
        eof_watch = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                event = await self._next_event(reader, ticket, events, eof_watch)
                if event is None:
                    return
                kind, a, b = event
                if kind == "token":
                    # an explicit parent: handlers interleave on one thread, so
                    # the tracer's per-thread nesting would cross-wire streams
                    flush = self.tracer.start_span(
                        "sse_flush", trace_id=ticket.trace_id, parent=ticket.span, index=b
                    )
                    writer.write(_sse({"uid": ticket.uid, "index": b, "token": a}))
                    try:
                        await writer.drain()
                    except (ConnectionError, OSError):
                        flush.set(outcome="disconnect").end()
                        self._client_gone(ticket)
                        return
                    self.stats.observe("sse_flush_seconds", flush.end())
                else:  # finish
                    writer.write(_sse(_completion_record(a)))
                    writer.write(b"data: [DONE]\n\n")
                    await writer.drain()
                    return
        finally:
            if not eof_watch.done():
                eof_watch.cancel()

    async def _unary_response(self, reader, writer, ticket, events) -> None:
        eof_watch = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                event = await self._next_event(reader, ticket, events, eof_watch)
                if event is None:
                    return
                kind, a, _ = event
                if kind == "finish":
                    await _respond_json(
                        writer,
                        500 if a.finish_reason == "error" else 200,
                        _completion_record(a),
                        extra_headers={
                            "X-Request-Id": ticket.trace_id or "",
                            "X-Relora-Weights": str(self.weights_version),
                        },
                    )
                    return
        finally:
            if not eof_watch.done():
                eof_watch.cancel()

    def _client_gone(self, ticket: Ticket) -> None:
        """The client disconnected: flag the ticket so the model thread frees
        its slot at the next round."""
        ticket.cancelled.set()
        self.stats.inc("disconnects_total")


def run_server(
    scheduler: ContinuousBatchingScheduler,
    *,
    host: str = "127.0.0.1",
    port: int = 8000,
    ready_cb: Optional[Callable[["GenerateServer"], None]] = None,
    **kwargs: Any,
) -> int:
    """The CLI's blocking entry point: build a GenerateServer and run it
    until a SIGTERM drain completes.  ``ready_cb(server)`` fires once the
    listener is bound (the CLI writes the chosen port for --port 0)."""
    server = GenerateServer(scheduler, host=host, port=port, **kwargs)

    async def _main() -> None:
        serve = asyncio.ensure_future(server.serve_forever())
        while not server.started.is_set():
            await asyncio.sleep(0.01)
            if serve.done():
                break
        if ready_cb is not None and not serve.done():
            ready_cb(server)
        await serve

    asyncio.run(_main())
    return 0
