"""Health-aware HTTP router over N serving replicas.

The port's own copy of ``relora_tpu/serve/router.py``: a stdlib asyncio
proxy in front of N ``python -m relora_tpu_torch.serve_cli --port ...``
processes (usually spawned by ``serve/supervisor.py``) that makes a replica
crash or stall degrade to *slower*, never *dropped*.  It imports no torch
and runs on a host without a card.

Three mechanisms, composed:

- **Health probing.**  Every ``probe_interval_s`` the router GETs each
  replica's ``/healthz``.  A 200 marks the replica routable and records its
  queue/slot gauges; any 503 (``draining`` / ``stuck`` / ``error``) or a
  connect failure ejects it from rotation.  Recovery is automatic: the next
  200 puts it back.
- **Least-loaded routing.**  Requests go to the routable replica with the
  smallest load score — the router's own in-flight count plus the replica's
  last-reported ``queue_depth + active_slots`` (ties rotate).  The score is
  at most one probe interval stale, which is exactly the staleness the
  in-flight count compensates for.  Multi-tenant requests (an ``"adapter"``
  body field) get **tenant affinity** first: the adapter name is
  rendezvous-hashed over the routable groups so each tenant keeps hitting
  one replica (its device adapter slot stays warm instead of loading on every
  replica); the least-loaded pick is the fallback whenever the home replica
  is unroutable, already tried, or its circuit breaker is open.
- **Per-replica circuit breaker.**  ``failure_threshold`` consecutive
  connect errors or 5xx responses open the circuit; after a cooldown
  (doubling per consecutive open, capped) one half-open trial — a health
  probe or a live request — closes it again.  The breaker is what stops a
  dead-but-listed replica from eating a connect timeout per request.

**The retry-idempotency boundary.**  A failed request is retried on another
replica (bounded backoff, each replica tried at most once) *iff zero SSE
body bytes have been forwarded to the client*.  Generation is not
idempotent from the middle: replaying a started request would re-stream
tokens the client already consumed, so a stream that dies after first byte
fails fast with a typed terminal event —

    data: {"error": {"type": "stream_interrupted", "replica": "r0",
           "detail": "...", "retryable": false}}

— and no ``data: [DONE]`` sentinel.  Clients treat a missing [DONE] plus an
``error`` event as "re-issue if you want; nothing was committed".  Unary
responses are buffered router-side and are therefore always
retry-or-deliver-whole.

**Sharded replicas.**  An endpoint value may name a *shard group* (see
``EndpointSource``): the group's replicas are one tp/fsdp-sharded model
instance, routable only while every shard answers ``/healthz`` (losing one
shard loses the instance), scored by the group's summed load, and proxied
to the group's primary (lowest rid — the shard serving HTTP).  Plain
endpoints are singleton groups, so unsharded fleets are unchanged.

Endpoints: ``POST /v1/generate`` (proxied; response carries
``X-Relora-Replica``), ``GET /healthz`` (200 iff >= 1 routable group, with
per-replica and per-group state), ``GET /metrics`` (Prometheus text,
namespace ``relora_router``: request/retry/failover counters labelled by
replica, per-replica and per-group health gauges).
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Set, Tuple, Union

from relora_tpu_torch.obs.metrics import MetricsRegistry
from relora_tpu_torch.obs.tracer import Tracer, new_trace_id
from relora_tpu_torch.serve import disagg
from relora_tpu_torch.serve.wire import (
    MAX_BODY_BYTES,
    REASONS,
    head,
    read_http_request,
    respond,
    respond_json,
    sse,
)
from relora_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

#: upstream statuses worth trying another replica for (pre-stream only):
#: 5xx = replica broken, 429/503 = replica full/draining — a sibling may not be
RETRYABLE_STATUSES = (429, 500, 502, 503)

_REQUEST_TIMEOUT_S = 30.0

#: endpoints: static list/dict of (host, port), or a callable returning
#: {rid: (host, port-or-None)} — the supervisor's live view, re-read every
#: probe round so restarted replicas (new ephemeral ports) are picked up.
#: A value may carry a third element, the *shard group*: replicas sharing a
#: group are one tp/fsdp-sharded model instance (the group is routable only
#: when EVERY member answers healthz — losing one shard loses the whole
#: instance; requests go to the group's primary, the lowest rid, which is
#: the shard that serves HTTP).  A plain (host, port) value is its own
#: singleton group, so unsharded fleets behave exactly as before.
EndpointSource = Union[
    Sequence[Tuple],
    Mapping[str, Tuple],
    Callable[[], Mapping[str, Tuple]],
]


def rendezvous_home(adapter: str, groups: Sequence[str]) -> Optional[str]:
    """The shard group ``adapter``'s traffic homes to, by rendezvous
    (highest-random-weight) hashing over ``groups``.

    The property elastic scaling leans on: when a group joins or leaves,
    only the tenants whose maximal hash involved that group move — every
    other tenant keeps its home, so a fleet resize never thrashes the
    whole fleet's adapter slots, just the departed/added replica's share.
    """
    if not groups:
        return None
    return max(
        groups, key=lambda g: hashlib.sha1(f"{adapter}:{g}".encode()).digest()
    )


class _ClientGone(Exception):
    """The *downstream* client hung up mid-proxy — not the replica's fault,
    so it must not feed the replica's circuit breaker."""


async def _read_all(reader: asyncio.StreamReader, limit: int = MAX_BODY_BYTES) -> bytes:
    """Read a close-delimited body to EOF (``read(n)`` alone may return a
    partial chunk), bounded by ``limit``."""
    chunks: List[bytes] = []
    total = 0
    while total < limit:
        chunk = await reader.read(65536)
        if not chunk:
            break
        chunks.append(chunk)
        total += len(chunk)
    return b"".join(chunks)


class CircuitBreaker:
    """Consecutive-failure circuit breaker, single-threaded (event loop).

    closed --(failure_threshold consecutive failures)--> open
    open --(cooldown elapsed)--> half_open (exactly one trial allowed)
    half_open --success--> closed (cooldown resets)
    half_open --failure--> open (cooldown doubles, capped)
    """

    def __init__(
        self,
        *,
        failure_threshold: int = 3,
        cooldown_s: float = 1.0,
        cooldown_max_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.cooldown_max_s = cooldown_max_s
        self._clock = clock
        self.state = "closed"  # "closed" | "open" | "half_open"
        self.failures = 0  # consecutive
        self.opens_total = 0
        self._opened_at = 0.0
        self._cooldown = cooldown_s
        self._trial_pending = False

    def allow(self) -> bool:
        """May a request be sent?  In half-open, only the single trial."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if self._clock() - self._opened_at >= self._cooldown:
                self.state = "half_open"
                self._trial_pending = True
                return True
            return False
        # half_open: one trial in flight at a time
        if self._trial_pending:
            return False
        self._trial_pending = True
        return True

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0
        self._trial_pending = False
        self._cooldown = self.cooldown_s

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half_open":
            # failed trial: back to open, wait longer before the next one
            self._cooldown = min(self._cooldown * 2.0, self.cooldown_max_s)
            self._open()
        elif self.state == "closed" and self.failures >= self.failure_threshold:
            self._open()

    def _open(self) -> None:
        self.state = "open"
        self._opened_at = self._clock()
        self.opens_total += 1
        self._trial_pending = False


@dataclasses.dataclass
class ReplicaState:
    """The router's live view of one replica."""

    rid: str
    host: str
    port: Optional[int]  # None: no port file yet (down / restarting)
    breaker: CircuitBreaker
    group: str = ""  # shard group; "" = singleton group of just this replica
    healthy: bool = False
    status: str = "unknown"  # last healthz status string, or "unreachable"/"down"
    health: Dict[str, Any] = dataclasses.field(default_factory=dict)
    inflight: int = 0  # router-side, this instant
    probe_failures: int = 0  # consecutive

    def load(self) -> int:
        return (
            self.inflight
            + int(self.health.get("queue_depth", 0))
            + int(self.health.get("active_slots", 0))
        )


class Router:
    """Stdlib-asyncio reverse proxy with health-based failover.

    ``serve_forever()`` binds, starts the health prober, and runs until
    ``begin_shutdown()`` (thread-safe).  Mirrors GenerateServer's lifecycle
    surface (``started`` event, ``port`` rebound after bind) so the existing
    test/bench harnesses drive both the same way.
    """

    def __init__(
        self,
        endpoints: EndpointSource,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        probe_interval_s: float = 0.25,
        probe_timeout_s: float = 2.0,
        connect_timeout_s: float = 2.0,
        max_attempts: int = 3,
        retry_backoff_s: float = 0.05,
        retry_backoff_max_s: float = 0.5,
        failure_threshold: int = 3,
        cooldown_s: float = 1.0,
        cooldown_max_s: float = 30.0,
        tracer: Optional[Tracer] = None,
        extra_routes: Optional[Callable[[str], Optional[Tuple[int, str, bytes]]]] = None,
        classify_threshold: Optional[int] = None,
    ):
        self._endpoints = self._normalize_endpoints(endpoints)
        self.host = host
        self.port = port  # rebound after bind
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.max_attempts = max_attempts
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_max_s = retry_backoff_max_s
        self._breaker_opts = dict(
            failure_threshold=failure_threshold,
            cooldown_s=cooldown_s,
            cooldown_max_s=cooldown_max_s,
        )
        self.stats = MetricsRegistry(namespace="relora_router")
        if tracer is None:
            # the proxy path spans join the replica's spans under the request
            # id; a JSONL sink (one file per process, like the replicas')
            # lets the router's and the replicas' streams merge offline
            trace_dir = os.environ.get("RELORA_TPU_TRACE_DIR")
            tracer = Tracer(
                service="router",
                jsonl_path=(
                    os.path.join(trace_dir, f"router_spans_{os.getpid()}.jsonl")
                    if trace_dir
                    else None
                ),
            )
        self.tracer = tracer
        # e.g. the supervisor's FleetCollector mounting /fleet/* on this
        # front-end: path -> (status, content_type, body) or None = 404
        self._extra_routes = extra_routes
        # disaggregated fleet: classify requests by prompt length into the
        # prefill vs decode replica pools (replica roles come from healthz);
        # None = role-blind routing, the pre-disagg behaviour
        self.classify_threshold = classify_threshold
        if classify_threshold is not None:
            self.stats.inc("routed_prefill_total", by=0)
            self.stats.inc("routed_decode_total", by=0)
            self.stats.inc("route_fallback_total", by=0)
        self.replicas: Dict[str, ReplicaState] = {}
        self.started = threading.Event()
        self._t_start = time.monotonic()
        self._rr = 0  # tie-break rotation among equally loaded replicas
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._shutdown: Optional[asyncio.Event] = None
        self._handler_tasks: Set[asyncio.Task] = set()

    @staticmethod
    def _normalize_endpoints(
        endpoints: EndpointSource,
    ) -> Callable[[], Mapping[str, Tuple[str, Optional[int]]]]:
        if callable(endpoints):
            return endpoints
        if isinstance(endpoints, Mapping):
            static_map = dict(endpoints)
        else:
            static_map = {f"r{i}": hp for i, hp in enumerate(endpoints)}
        return lambda: static_map

    # -- lifecycle -----------------------------------------------------------

    def begin_shutdown(self) -> None:
        loop, shutdown = self._loop, self._shutdown
        if loop is None or shutdown is None:
            return
        try:
            loop.call_soon_threadsafe(shutdown.set)
        except RuntimeError:
            pass  # loop already closed

    async def serve_forever(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._shutdown = asyncio.Event()
        server = await asyncio.start_server(self._client_connected, self.host, self.port)
        self.port = server.sockets[0].getsockname()[1]
        prober = asyncio.ensure_future(self._prober())
        self.started.set()
        logger.info(f"router on http://{self.host}:{self.port}")
        async with server:
            await self._shutdown.wait()
            server.close()
            await server.wait_closed()
        prober.cancel()
        if self._handler_tasks:
            await asyncio.wait(set(self._handler_tasks), timeout=10.0)
        logger.info("router stopped")

    # -- health probing ------------------------------------------------------

    def _refresh_endpoints(self) -> None:
        eps = {}
        for rid, val in dict(self._endpoints()).items():
            # (host, port) = singleton group; (host, port, group) = shard
            h, p, g = val if len(val) == 3 else (val[0], val[1], rid)
            eps[rid] = (h, p, g)
        for rid, (h, p, g) in eps.items():
            st = self.replicas.get(rid)
            if st is None:
                self.replicas[rid] = ReplicaState(
                    rid=rid, host=h, port=p, group=g,
                    breaker=CircuitBreaker(**self._breaker_opts),
                )
            elif (st.host, st.port) != (h, p):
                # restarted under a new ephemeral port: fresh start — the old
                # failure streak belonged to the dead incarnation
                logger.info(f"replica {rid}: endpoint now {h}:{p}")
                st.host, st.port, st.group = h, p, g
                st.healthy, st.status, st.health = False, "restarted", {}
                st.breaker = CircuitBreaker(**self._breaker_opts)
            else:
                st.group = g
        for rid in list(self.replicas):
            if rid not in eps:
                del self.replicas[rid]

    def _groups(self) -> Dict[str, List[ReplicaState]]:
        """Replicas keyed by shard group (a plain replica is its own
        group).  One group = one servable model instance."""
        groups: Dict[str, List[ReplicaState]] = {}
        for st in self.replicas.values():
            groups.setdefault(st.group or st.rid, []).append(st)
        return groups

    async def _prober(self) -> None:
        # one span per probe *round* (not per replica probe: at 4 Hz x N
        # replicas that would drown the flight ring); per-replica health and
        # breaker *transitions* are instant events on the same trace
        prev_state: Dict[str, Tuple[bool, str]] = {}
        while True:
            try:
                self._refresh_endpoints()
                round_span = self.tracer.start_span("probe_round", trace_id="probes")
                await asyncio.gather(*(self._probe(st) for st in self.replicas.values()))
                for st in self.replicas.values():
                    prev = prev_state.get(st.rid)
                    cur = (st.healthy, st.breaker.state)
                    if prev is not None and prev != cur:
                        if prev[0] != st.healthy:
                            self.tracer.event(
                                "replica_health_flip", trace_id="probes",
                                replica=st.rid, healthy=st.healthy, status=st.status,
                            )
                        if prev[1] != st.breaker.state:
                            self.tracer.event(
                                "circuit_transition", trace_id="probes",
                                replica=st.rid, frm=prev[1], to=st.breaker.state,
                            )
                    prev_state[st.rid] = cur
                for rid in list(prev_state):
                    if rid not in self.replicas:
                        del prev_state[rid]
                healthy = sum(st.healthy for st in self.replicas.values())
                self.stats.set_gauge("healthy_replicas", healthy)
                self.stats.set_gauge("known_replicas", len(self.replicas))
                groups = self._groups()
                self.stats.set_gauge(
                    "healthy_groups",
                    sum(all(st.healthy for st in m) for m in groups.values()),
                )
                self.stats.set_gauge("known_groups", len(groups))
                for gid, members in groups.items():
                    self.stats.set_gauge(
                        f"group_{gid}_healthy",
                        int(all(st.healthy for st in members)),
                    )
                for st in self.replicas.values():
                    self.stats.set_gauge(f"replica_{st.rid}_healthy", int(st.healthy))
                    self.stats.set_gauge(
                        f"replica_{st.rid}_circuit_open",
                        int(st.breaker.state != "closed"),
                    )
                    self.stats.set_gauge(f"replica_{st.rid}_load", st.load())
                round_span.set(
                    healthy=healthy, known=len(self.replicas)
                ).end()
            except Exception as e:  # the prober must never die
                logger.warning(f"health probe round failed: {e!r}")
            await asyncio.sleep(self.probe_interval_s)

    async def _probe(self, st: ReplicaState) -> None:
        if st.port is None:
            st.healthy, st.status, st.health = False, "down", {}
            return
        writer = None
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(st.host, st.port), self.probe_timeout_s
            )
            writer.write(
                b"GET /healthz HTTP/1.1\r\nHost: router\r\nConnection: close\r\n\r\n"
            )
            await writer.drain()
            raw = await asyncio.wait_for(_read_all(reader), self.probe_timeout_s)
            code, _hdrs, body = _parse_response(raw)
            payload = json.loads(body.decode() or "{}")
            st.health = payload if isinstance(payload, dict) else {}
            st.status = str(st.health.get("status", code))
            st.healthy = code == 200
            st.probe_failures = 0
            if st.healthy and st.breaker.state != "closed":
                # the half-open probe that closes the circuit: the replica
                # answers healthz again, so let requests flow
                st.breaker.record_success()
        except (OSError, asyncio.TimeoutError, ValueError) as e:
            st.healthy, st.health = False, {}
            st.status = "unreachable"
            st.probe_failures += 1
            if st.probe_failures == 1:
                logger.warning(f"replica {st.rid} unreachable: {e!r}")
        finally:
            if writer is not None:
                writer.close()

    # -- selection -----------------------------------------------------------

    def _pick(
        self,
        exclude: Set[str],
        adapter: Optional[str] = None,
        role: Optional[str] = None,
    ) -> Optional[ReplicaState]:
        # a group is routable only when every shard is healthy; requests go
        # to its primary (lowest rid), scored by the whole group's load
        candidates: List[Tuple[ReplicaState, int]] = []
        routable_groups: List[str] = []
        for gid, members in self._groups().items():
            if not all(st.healthy and st.port is not None for st in members):
                continue
            routable_groups.append(gid)
            primary = min(members, key=lambda s: s.rid)
            if primary.rid in exclude:
                continue
            candidates.append((primary, sum(st.load() for st in members)))
        if adapter is not None and routable_groups:
            # tenant affinity: rendezvous-hash the adapter over the routable
            # groups so each tenant keeps hitting one replica (its slot pool
            # stays warm — no cross-fleet slot thrash) and keeps its home as
            # long as that group stays up.  Fall back to least-loaded when
            # the home is excluded (already tried) or its breaker won't
            # admit a request.
            home = rendezvous_home(adapter, routable_groups)
            for st, _load in candidates:
                if (st.group or st.rid) != home:
                    continue
                if st.breaker.state == "closed" or st.breaker.allow():
                    self.stats.inc("affinity_routed_total", ("replica", st.rid))
                    return st
                break
            self.stats.inc("affinity_fallback_total")
        if role is not None and candidates:
            # role routing: prefer the request's pool (replica roles come
            # from healthz), then mixed replicas, then — degraded fleet —
            # anyone routable; each widening is a counted fallback
            pool = [
                (st, load)
                for st, load in candidates
                if str(st.health.get("role", "mixed")) == role
            ]
            if not pool:
                pool = [
                    (st, load)
                    for st, load in candidates
                    if str(st.health.get("role", "mixed")) == "mixed"
                ]
                self.stats.inc("route_fallback_total")
            if pool:
                candidates = pool
        ready = [(st, load) for st, load in candidates if st.breaker.state == "closed"]
        if not ready:
            # no closed circuit: offer half-open trials (allow() mutates)
            ready = [(st, load) for st, load in candidates if st.breaker.allow()]
        if not ready:
            return None
        best = min(load for _, load in ready)
        pool = sorted((st for st, load in ready if load == best), key=lambda s: s.rid)
        self._rr += 1
        return pool[self._rr % len(pool)]

    # -- request handling ----------------------------------------------------

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
            pass
        except Exception as e:
            logger.warning(f"router handler error: {e!r}")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            parsed = await asyncio.wait_for(read_http_request(reader), _REQUEST_TIMEOUT_S)
        except ValueError as e:
            await respond_json(writer, 400, {"error": str(e)})
            return
        if parsed is None:
            return
        method, path, headers, body = parsed
        route = path.split("?", 1)[0]
        if route == "/healthz" and method == "GET":
            await self._handle_healthz(writer)
        elif route == "/metrics" and method == "GET":
            await respond(
                writer, 200, self.stats.render(), content_type="text/plain; version=0.0.4"
            )
        elif route == "/v1/generate":
            if method != "POST":
                await respond_json(writer, 405, {"error": "use POST"})
                return
            self.stats.inc("requests_total")
            await self._proxy_generate(writer, body, headers)
        elif (
            method == "GET"
            and self._extra_routes is not None
            and (mounted := self._extra_routes(path)) is not None
        ):
            status, ctype, payload = mounted
            await respond(writer, status, payload.decode(), content_type=ctype)
        else:
            await respond_json(writer, 404, {"error": f"no route {route}"})

    async def _handle_healthz(self, writer: asyncio.StreamWriter) -> None:
        replicas = {}
        queue_depth = active_slots = 0
        for st in self.replicas.values():
            replicas[st.rid] = {
                "host": st.host,
                "port": st.port,
                "group": st.group or st.rid,
                "healthy": st.healthy,
                "status": st.status,
                "circuit": st.breaker.state,
                "inflight": st.inflight,
                "load": st.load(),
            }
            if st.healthy:
                queue_depth += int(st.health.get("queue_depth", 0))
                active_slots += int(st.health.get("active_slots", 0))
        # one group = one servable (possibly tp/fsdp-sharded) model instance:
        # the router is "ok" iff at least one WHOLE group answers, a stricter
        # bar than any-replica-healthy when groups have > 1 shard
        groups = {}
        for gid, members in self._groups().items():
            groups[gid] = {
                "shards": len(members),
                "healthy": all(st.healthy for st in members),
                "members": sorted(st.rid for st in members),
                "load": sum(st.load() for st in members),
            }
        healthy = sum(st.healthy for st in self.replicas.values())
        healthy_groups = sum(g["healthy"] for g in groups.values())
        payload = {
            "status": "ok" if healthy_groups else "unavailable",
            "healthy_replicas": healthy,
            "known_replicas": len(self.replicas),
            "healthy_groups": healthy_groups,
            "known_groups": len(groups),
            "queue_depth": queue_depth,
            "active_slots": active_slots,
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "replicas": replicas,
            "groups": groups,
        }
        await respond_json(writer, 200 if healthy_groups else 503, payload)

    async def _proxy_generate(
        self,
        writer: asyncio.StreamWriter,
        body: bytes,
        headers: Dict[str, str],
    ) -> None:
        rid_hdr = (headers.get("x-request-id") or "").strip() or new_trace_id()
        # tenant affinity key + route class: a parse failure routes anywhere
        # and the replica's own body validation answers the 400
        adapter: Optional[str] = None
        role: Optional[str] = None
        try:
            payload = json.loads(body.decode("utf-8") or "{}")
            if isinstance(payload, dict):
                name = payload.get("adapter")
                if isinstance(name, str) and name.strip():
                    adapter = name.strip()
                if self.classify_threshold is not None:
                    prompt = payload.get("prompt")
                    role = disagg.classify_request(
                        len(prompt) if isinstance(prompt, list) else 0,
                        self.classify_threshold,
                    )
                    self.stats.inc(f"routed_{role}_total")
        except (UnicodeDecodeError, json.JSONDecodeError):
            pass
        # root span of this process's share of the request: trace_id is the
        # request id, the same id the replica uses for its own spans, so a
        # merged trace shows router -> replica -> model thread as one tree
        root = self.tracer.start_span(
            "route", trace_id=rid_hdr, adapter=adapter, route_class=role
        )
        try:
            outcome = await self._proxy_attempts(
                writer, body, rid_hdr, root, adapter, role
            )
        finally:
            root.set(outcome=outcome if isinstance(outcome, str) else "error").end()

    async def _proxy_attempts(
        self,
        writer: asyncio.StreamWriter,
        body: bytes,
        rid_hdr: str,
        root,
        adapter: Optional[str] = None,
        role: Optional[str] = None,
    ) -> str:
        # shared across attempts: once any SSE body byte reaches the client,
        # the request is no longer retryable (the idempotency boundary)
        sent = {"head": False, "bytes": 0}
        tried: List[str] = []
        backoff = self.retry_backoff_s
        passthrough: Optional[Tuple[int, Dict[str, str], bytes]] = None
        for attempt in range(self.max_attempts):
            st = self._pick(exclude=set(tried), adapter=adapter, role=role)
            if st is None:
                break
            tried.append(st.rid)
            if attempt > 0:
                self.stats.inc("retries_total")
            st.inflight += 1
            attempt_span = self.tracer.start_span(
                "proxy_attempt", trace_id=rid_hdr, parent=root,
                replica=st.rid, attempt=attempt,
            )
            outcome, info = "error", None
            try:
                outcome, info = await self._forward(st, writer, body, rid_hdr, sent)
            finally:
                st.inflight -= 1
                attempt_span.set(outcome=outcome).end()
            if outcome == "done":
                if attempt > 0:
                    self.stats.inc("failovers_total", ("replica", st.rid))
                    self.tracer.event(
                        "failover", trace_id=rid_hdr, replica=st.rid, attempt=attempt
                    )
                self.stats.inc("proxied_total", ("replica", st.rid))
                return "done"
            if outcome == "client_gone":
                self.stats.inc("client_disconnects_total")
                return "client_gone"
            if outcome == "midstream":
                # started stream died: typed terminal event, never a replay
                self.stats.inc("midstream_errors_total", ("replica", st.rid))
                self.tracer.event(
                    "midstream_error", trace_id=rid_hdr, replica=st.rid, detail=str(info)
                )
                logger.warning(f"stream via {st.rid} interrupted: {info}")
                event = {
                    "error": {
                        "type": "stream_interrupted",
                        "replica": st.rid,
                        "detail": str(info),
                        "retryable": False,
                    }
                }
                try:
                    writer.write(sse(event))
                    await writer.drain()
                except (ConnectionError, OSError):
                    pass
                return "midstream"
            # outcome == "retry": zero body bytes forwarded; try a sibling
            self.stats.inc("upstream_failures_total", ("replica", st.rid))
            if isinstance(info, tuple):
                passthrough = info  # a real upstream response (429/5xx body)
                logger.info(f"upstream {st.rid} answered {info[0]}; trying another replica")
            else:
                logger.warning(f"upstream {st.rid} failed pre-stream: {info}")
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2.0, self.retry_backoff_max_s)

        # every replica tried (or none routable)
        self.stats.inc("exhausted_total")
        if sent["head"]:
            event = {
                "error": {
                    "type": "no_replica_available",
                    "detail": f"tried {tried or 'no replicas'}",
                    "retryable": True,
                }
            }
            try:
                writer.write(sse(event))
                await writer.drain()
            except (ConnectionError, OSError):
                pass
            return "exhausted"
        if passthrough is not None:
            # deliver the last real upstream answer (e.g. 429 + Retry-After)
            status, up_headers, up_body = passthrough
            extra = {"X-Request-Id": rid_hdr}
            if "retry-after" in up_headers:
                extra["Retry-After"] = up_headers["retry-after"]
            ct = up_headers.get("content-type", "application/json")
            writer.write(head(status, REASONS.get(status, "?"), ct, extra, len(up_body)))
            writer.write(up_body)
            await writer.drain()
            return "passthrough"
        await respond_json(
            writer,
            503,
            {"error": "no healthy replica available"},
            extra_headers={"Retry-After": "1", "X-Request-Id": rid_hdr},
        )
        return "no_replica"

    async def _forward(
        self,
        st: ReplicaState,
        client: asyncio.StreamWriter,
        body: bytes,
        rid: str,
        sent: Dict[str, int],
    ) -> Tuple[str, Any]:
        """One proxy attempt against one replica.  Returns (outcome, info):

        - ``("done", None)``      — response fully delivered to the client
        - ``("retry", reason)``   — failed with zero body bytes forwarded;
          ``reason`` is a string, or ``(status, headers, body)`` when the
          upstream produced a real retryable response worth passing through
        - ``("midstream", why)``  — stream died after >= 1 forwarded byte
        - ``("client_gone", why)``— the *client* hung up; stop, no retry
        """

        async def to_client(data: bytes) -> None:
            try:
                client.write(data)
                await client.drain()
            except (ConnectionError, OSError) as e:
                raise _ClientGone(repr(e)) from None

        upstream: Optional[asyncio.StreamWriter] = None
        try:
            try:
                reader, upstream = await asyncio.wait_for(
                    asyncio.open_connection(st.host, st.port), self.connect_timeout_s
                )
            except (OSError, asyncio.TimeoutError) as e:
                st.breaker.record_failure()
                return "retry", f"connect failed: {e!r}"
            req = (
                f"POST /v1/generate HTTP/1.1\r\n"
                f"Host: {st.host}:{st.port}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"X-Request-Id: {rid}\r\n"
                f"Connection: close\r\n\r\n"
            ).encode() + body
            upstream.write(req)
            await upstream.drain()
            status_line = await asyncio.wait_for(reader.readline(), _REQUEST_TIMEOUT_S)
            if not status_line.strip():
                # connection accepted then dropped without a byte
                # (serve_accept_drop drill, or a process dying on accept)
                st.breaker.record_failure()
                return "retry", "connection dropped before response"
            status = int(status_line.split()[1])
            up_headers: Dict[str, str] = {}
            while True:
                raw = await asyncio.wait_for(reader.readline(), _REQUEST_TIMEOUT_S)
                if raw in (b"\r\n", b"\n", b""):
                    break
                k, _, v = raw.decode("latin-1").partition(":")
                up_headers[k.strip().lower()] = v.strip()
            if status in RETRYABLE_STATUSES:
                up_body = await _read_all(reader)
                if status >= 500:
                    st.breaker.record_failure()
                else:
                    st.breaker.record_success()  # 429 = busy, not broken
                return "retry", (status, up_headers, up_body)
            st.breaker.record_success()
            ct = up_headers.get("content-type", "application/octet-stream")
            fwd_headers = {"X-Request-Id": rid, "X-Relora-Replica": st.rid}
            if "x-relora-weights" in up_headers:
                # surface which weights version served this response so a
                # rolling update is observable from outside the fleet
                fwd_headers["X-Relora-Weights"] = up_headers["x-relora-weights"]
            if "text/event-stream" in ct:
                # SSE: forward bytes as they arrive.  The head goes out once
                # (a retry after head-only keeps streaming into the same
                # response — no events were delivered, so nothing replays).
                if not sent["head"]:
                    await to_client(
                        head(200, "OK", ct, {"Cache-Control": "no-cache", **fwd_headers})
                    )
                    sent["head"] = True
                tail = b""
                while True:
                    chunk = await reader.read(65536)
                    if not chunk:
                        break
                    sent["bytes"] += len(chunk)
                    tail = (tail + chunk)[-24:]
                    await to_client(chunk)
                if b"[DONE]" in tail:
                    return "done", None
                # EOF without the sentinel: the replica died mid-stream
                st.breaker.record_failure()
                if sent["bytes"] == 0:
                    return "retry", "upstream closed before first event"
                return "midstream", "upstream closed before [DONE]"
            # unary (or error) response: buffer whole, then deliver whole —
            # a failure while reading stays retryable
            up_body = await _read_all(reader)
            await to_client(
                head(status, REASONS.get(status, "?"), ct, fwd_headers, len(up_body))
                + up_body
            )
            return "done", None
        except _ClientGone as e:
            return "client_gone", str(e)
        except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError, ValueError) as e:
            st.breaker.record_failure()
            if sent["bytes"] > 0:
                return "midstream", f"{e!r}"
            return "retry", f"{e!r}"
        finally:
            if upstream is not None:
                upstream.close()


def _parse_response(raw: bytes) -> Tuple[int, Dict[str, str], bytes]:
    """Split a full close-delimited HTTP response into (status, headers, body)."""
    head_part, _, body = raw.partition(b"\r\n\r\n")
    lines = head_part.decode("latin-1").split("\r\n")
    parts = lines[0].split()
    if len(parts) < 2 or not parts[1].isdigit():
        raise ValueError(f"malformed status line: {lines[0]!r}")
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    return int(parts[1]), headers, body
