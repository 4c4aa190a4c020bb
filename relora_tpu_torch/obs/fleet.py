"""Fleet observability plane: scrape, keep and serve cross-replica series.

The port's own copy of ``relora_tpu/obs/fleet.py``.  What a replica
exposes is per process and per instant: its ``/metrics`` text is gone
unless something polls it, ``/healthz`` is a verdict of the moment, and the
trainer's ``metrics.jsonl`` sits in a run directory.  This module keeps
them:

- :class:`SeriesStore`: in-memory ring buffers keyed ``(source, series)``
  with bounded JSONL persistence.  The file's schema is the trainer's
  ``metrics.jsonl`` schema (flat numeric records with ``_time``, ``_event``
  for structured events) plus a ``_source`` tag, so one loader reads both.
- :class:`FleetCollector`: scrapes every replica's and the router's
  ``/metrics`` and ``/healthz`` on a cadence into the store, derives
  quantile and rate series from histogram buckets and counter deltas, tails
  ``metrics.jsonl`` files (the trainer's) into the same store, records
  health flips as events, feeds the fleet :class:`PrefixPageDirectory` from
  each replica's ``prefix_digests``, and drives the SLO engine
  (:mod:`relora_tpu_torch.obs.slo`) once a round.
- the ``/fleet/metrics``, ``/fleet/series`` and ``/fleet/prefix`` payloads,
  served by the router inside the supervisor's process and by the
  standalone CLI (``python -m relora_tpu_torch.obs.fleet``).

Stdlib only and torch-free: the collector runs in a daemon thread of the
supervisor's process and never imports the model stack.
"""

from __future__ import annotations

import argparse
import collections
import http.client
import json
import os
import threading
import time
from typing import Any, Callable, Deque, Dict, Iterable, List, Mapping, Optional, Tuple

from relora_tpu_torch.obs.metrics import MetricsRegistry
from relora_tpu_torch.serve.disagg import PrefixPageDirectory
from relora_tpu_torch.utils.logging import get_logger

__all__ = [
    "FleetCollector",
    "SeriesStore",
    "histogram_quantile",
    "load_series_jsonl",
    "parse_prometheus",
]

logger = get_logger("relora_tpu_torch.fleet")


# -- Prometheus text parsing --------------------------------------------------


def parse_prometheus(text: str) -> Tuple[Dict[str, float], Dict[str, Dict[str, Any]]]:
    """Parse Prometheus 0.0.4 text exposition into flat samples + histograms.

    Returns ``(flat, hists)``.  ``flat`` maps metric name -> value, with the
    one-level labels this codebase uses joined as ``name.labelvalue`` (the
    same convention as ``MetricsRegistry.snapshot``).  ``hists`` maps
    histogram name -> ``{"buckets": [(le, cumcount), ...], "sum": float,
    "count": int}`` with ``le`` as float (``inf`` for +Inf).  Unparseable
    lines are skipped — a scrape must survive a foreign exporter.
    """
    flat: Dict[str, float] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            name_part, value_s = line.rsplit(None, 1)
            value = float(value_s)
        except ValueError:
            continue
        label_val = None
        if "{" in name_part:
            name, _, label_s = name_part.partition("{")
            label_s = label_s.rstrip("}")
            try:
                _, _, label_val = label_s.partition("=")
                label_val = label_val.strip('"')
            except ValueError:
                continue
        else:
            name = name_part
        if name.endswith("_bucket") and label_val is not None:
            base = name[: -len("_bucket")]
            h = hists.setdefault(base, {"buckets": [], "sum": 0.0, "count": 0})
            le = float("inf") if label_val == "+Inf" else float(label_val)
            h["buckets"].append((le, value))
        elif name.endswith("_sum") and name[: -len("_sum")] in hists:
            hists[name[: -len("_sum")]]["sum"] = value
        elif name.endswith("_count") and name[: -len("_count")] in hists:
            hists[name[: -len("_count")]]["count"] = int(value)
        elif label_val is not None:
            flat[f"{name}.{label_val}"] = value
        else:
            flat[name] = value
    return flat, hists


def histogram_quantile(buckets: Iterable[Tuple[float, float]], q: float) -> float:
    """Quantile from cumulative ``(le, count)`` buckets — the same
    first-bound-reaching-q·count rule as ``Histogram.quantile`` so a scraped
    p95 matches what the replica would report about itself."""
    buckets = sorted(buckets)
    if not buckets:
        return 0.0
    total = buckets[-1][1]
    if total <= 0:
        return 0.0
    target = q * total
    for bound, cum in buckets:
        if cum >= target:
            return bound
    return buckets[-1][0]


# -- time-series store --------------------------------------------------------


class SeriesStore:
    """Ring-buffer time series keyed ``(source, series)`` + an event log.

    ``source`` is a replica id ("r0"), "router", "train", ...; ``series`` is
    a metric name.  Samples are ``(wall_time, float)``.  Persistence writes
    one flat JSONL record per ``add_samples`` call and one per event, in the
    metrics.jsonl schema (``_time``/``_event``/``_source`` plus plain numeric
    keys), rotating ``path`` -> ``path.1`` when the file exceeds
    ``persist_max_bytes`` so disk use stays bounded at ~2x that.
    """

    def __init__(
        self,
        max_points: int = 1024,
        max_events: int = 1024,
        persist_path: Optional[str] = None,
        persist_max_bytes: int = 8 * 1024 * 1024,
    ):
        self.max_points = max_points
        self._series: Dict[Tuple[str, str], Deque[Tuple[float, float]]] = {}
        self._events: Deque[Dict[str, Any]] = collections.deque(maxlen=max_events)
        self._lock = threading.Lock()
        self.persist_path = persist_path
        self.persist_max_bytes = persist_max_bytes
        self._fh = None
        if persist_path:
            d = os.path.dirname(os.path.abspath(persist_path))
            os.makedirs(d, exist_ok=True)
            self._fh = open(persist_path, "a")

    # -- ingestion ----------------------------------------------------------

    def add_sample(self, source: str, series: str, value: float, t: Optional[float] = None) -> None:
        self.add_samples(source, {series: value}, t=t)

    def add_samples(
        self, source: str, values: Mapping[str, float], t: Optional[float] = None, persist: bool = True
    ) -> None:
        t = time.time() if t is None else t
        with self._lock:
            for name, value in values.items():
                try:
                    v = float(value)
                except (TypeError, ValueError):
                    continue
                key = (source, name)
                dq = self._series.get(key)
                if dq is None:
                    dq = self._series[key] = collections.deque(maxlen=self.max_points)
                dq.append((t, v))
        if persist and values:
            self._persist({**{k: v for k, v in values.items()}, "_source": source, "_time": t})

    def add_event(
        self, kind: str, source: str, t: Optional[float] = None, persist: bool = True, **fields: Any
    ) -> Dict[str, Any]:
        t = time.time() if t is None else t
        record = {"_event": kind, "_source": source, "_time": t, **fields}
        with self._lock:
            self._events.append(record)
        if persist:
            self._persist(record)
        return record

    def ingest_record(self, record: Mapping[str, Any], source: Optional[str] = None) -> None:
        """Ingest one metrics.jsonl-schema record (the shared schema): an
        ``_event`` record lands in the event log, anything else contributes
        its numeric non-underscore keys as samples at ``_time``."""
        src = record.get("_source") or source or "unknown"
        t = record.get("_time")
        t = time.time() if not isinstance(t, (int, float)) else float(t)
        if "_event" in record:
            fields = {k: v for k, v in record.items() if k not in ("_event", "_source", "_time")}
            self.add_event(str(record["_event"]), src, t=t, persist=False, **fields)
            return
        values = {
            k: v
            for k, v in record.items()
            if not k.startswith("_") and isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        if values:
            self.add_samples(src, values, t=t, persist=False)

    # -- queries ------------------------------------------------------------

    def sources(self) -> List[str]:
        with self._lock:
            return sorted({src for (src, _) in self._series})

    def series_names(self, source: str) -> List[str]:
        with self._lock:
            return sorted(name for (src, name) in self._series if src == source)

    def samples(
        self, source: str, series: str, since: Optional[float] = None
    ) -> List[Tuple[float, float]]:
        with self._lock:
            dq = self._series.get((source, series))
            if dq is None:
                return []
            out = list(dq)
        if since is not None:
            out = [(t, v) for (t, v) in out if t >= since]
        return out

    def latest(self, source: str, series: str) -> Optional[Tuple[float, float]]:
        with self._lock:
            dq = self._series.get((source, series))
            return dq[-1] if dq else None

    def window_values(
        self, source: str, series: str, window_s: float, now: Optional[float] = None
    ) -> List[float]:
        now = time.time() if now is None else now
        return [v for (_, v) in self.samples(source, series, since=now - window_s)]

    def events(
        self, kinds: Optional[Iterable[str]] = None, since: Optional[float] = None
    ) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._events)
        if kinds is not None:
            kinds = set(kinds)
            out = [e for e in out if e.get("_event") in kinds]
        if since is not None:
            out = [e for e in out if e.get("_time", 0.0) >= since]
        return out

    # -- persistence --------------------------------------------------------

    def _persist(self, record: Mapping[str, Any]) -> None:
        fh = self._fh
        if fh is None:
            return
        with self._lock:
            try:
                fh.write(json.dumps(record) + "\n")
                fh.flush()
                if fh.tell() > self.persist_max_bytes:
                    fh.close()
                    os.replace(self.persist_path, self.persist_path + ".1")
                    self._fh = open(self.persist_path, "a")
            except (OSError, ValueError) as e:
                logger.warning(f"fleet store persistence failed: {e}")
                self._fh = None

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def load_series_jsonl(
    store: SeriesStore, path: str, source: Optional[str] = None, include_rotated: bool = True
) -> int:
    """Replay a persisted JSONL file (store persistence or a trainer
    metrics.jsonl) into ``store``.  Torn-tail tolerant: a half-written final
    line (crash mid-flush) or any corrupt line is skipped, everything parseable
    is kept.  Reads ``path.1`` first when present so rotation keeps order.
    Returns the number of records ingested."""
    n = 0
    paths = ([path + ".1"] if include_rotated and os.path.exists(path + ".1") else []) + [path]
    for p in paths:
        if not os.path.exists(p):
            continue
        with open(p, "r", errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail / corruption: skip, keep the rest
                if isinstance(record, dict):
                    store.ingest_record(record, source=source)
                    n += 1
    return n


# -- HTTP scraping ------------------------------------------------------------


def _http_get(host: str, port: int, path: str, timeout_s: float) -> Tuple[int, bytes]:
    """Minimal GET via http.client (deliberately not urllib: no proxy-env
    surprises in test environments).  Raises OSError-family on connect
    failure; returns (status, body) otherwise — 503 healthz bodies are data,
    not errors."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class FleetCollector:
    """Scrapes a fleet of HTTP endpoints into a :class:`SeriesStore`.

    ``endpoints`` is a zero-arg callable returning ``{source: (host, port)}``
    — the supervisor's ``endpoints()`` shape; ``port=None`` means the replica
    has not published its port yet and scores as down.  A "router" entry is
    just another source.  Each round:

    1. GET ``/healthz``: ``up`` (1.0 iff HTTP 200), numeric payload fields
       (queue_depth, active_slots, ...), status-flip events.
    2. GET ``/metrics``: gauges/counters via :func:`parse_prometheus`;
       histograms become ``<name>_p50``/``<name>_p95`` series from
       per-round bucket deltas (quiet rounds emit no sample); counters
       become ``<name>_per_s`` rate series from deltas; serve-style
       ``requests_finished_total`` reasons collapse into an ``error_rate``
       series.  Router group-health gauges flip into events.
    3. Tail configured metrics.jsonl files (the trainer's) into the store.
    4. Run the SLO engine, if attached.

    One flat record per (source, round) is persisted, so
    :func:`load_series_jsonl` can rebuild the store after the supervisor dies.
    """

    def __init__(
        self,
        endpoints: Callable[[], Mapping[str, Tuple[str, Optional[int]]]],
        *,
        store: Optional[SeriesStore] = None,
        slo_engine=None,
        cadence_s: float = 1.0,
        timeout_s: float = 0.5,
        persist_path: Optional[str] = None,
        jsonl_sources: Optional[Mapping[str, str]] = None,
    ):
        self.endpoints = endpoints
        self.store = store or SeriesStore(persist_path=persist_path)
        self.slo = slo_engine
        self.cadence_s = cadence_s
        self.timeout_s = timeout_s
        self.jsonl_sources = dict(jsonl_sources or {})
        self.metrics = MetricsRegistry(namespace="relora_fleet")
        # fleet-wide prefix-page directory (serve/disagg): fed from the
        # prefix_digests list each replica advertises on /healthz, served to
        # replicas via /fleet/prefix so a local PrefixCache miss becomes a
        # peer fetch instead of a recompute
        self.directory = PrefixPageDirectory()
        self._jsonl_offsets: Dict[str, int] = {}
        self._prev_counters: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self._prev_hist_buckets: Dict[Tuple[str, str], Dict[float, float]] = {}
        self._last_status: Dict[str, str] = {}
        self._last_gauges: Dict[Tuple[str, str], float] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- one scrape round ---------------------------------------------------

    def scrape_once(self, now: Optional[float] = None) -> Dict[str, float]:
        """One scrape round over all endpoints.  Returns {source: up}."""
        now = time.time() if now is None else now
        t0 = time.monotonic()
        ups: Dict[str, float] = {}
        for source, (host, port) in sorted(self.endpoints().items()):
            ups[source] = self._scrape_target(source, host, port, now)
        for source, path in self.jsonl_sources.items():
            self._tail_jsonl(source, path)
        self.metrics.inc("scrape_rounds_total")
        self.metrics.set_gauge("sources_known", len(ups))
        self.metrics.set_gauge("sources_up", sum(1 for u in ups.values() if u >= 1.0))
        self.metrics.set_gauge("last_scrape_duration_s", time.monotonic() - t0)
        if self.slo is not None:
            self.slo.evaluate(self.store, now=now)
            self.metrics.set_gauge("alerts_firing", len(self.slo.active_alerts()))
        return ups

    def _scrape_target(self, source: str, host: str, port: Optional[int], now: float) -> float:
        values: Dict[str, float] = {}
        status_str = "down"
        up = 0.0
        if port is not None:
            try:
                code, body = _http_get(host, port, "/healthz", self.timeout_s)
                up = 1.0 if code == 200 else 0.0
                try:
                    payload = json.loads(body)
                    status_str = str(payload.get("status", code))
                    for k, v in payload.items():
                        if isinstance(v, (int, float)) and not isinstance(v, bool):
                            values[f"healthz_{k}"] = float(v)
                    digests = payload.get("prefix_digests")
                    if code == 200 and isinstance(digests, list):
                        self.directory.update(
                            source, host, int(port), [str(d) for d in digests]
                        )
                except (json.JSONDecodeError, AttributeError):
                    status_str = str(code)
            except OSError:
                self.metrics.inc("scrape_errors_total", ("source", source))
            try:
                code, body = _http_get(host, port, "/metrics", self.timeout_s)
                if code == 200:
                    self._ingest_metrics(source, body.decode(errors="replace"), values, now)
            except OSError:
                self.metrics.inc("scrape_errors_total", ("source", source))
        values["up"] = up
        if up < 1.0:
            # a down replica's pages are unreachable; stale directory entries
            # would send fetchers into connect timeouts until the next scrape
            self.directory.drop_replica(source)
        prev_status = self._last_status.get(source)
        if prev_status is not None and prev_status != status_str:
            self.store.add_event(
                "health_flip", source, t=now, frm=prev_status, to=status_str
            )
            logger.info(f"fleet: {source} health {prev_status} -> {status_str}")
        self._last_status[source] = status_str
        self.metrics.inc("scrapes_total", ("source", source))
        self.store.add_samples(source, values, t=now)
        return up

    def _ingest_metrics(self, source: str, text: str, values: Dict[str, float], now: float) -> None:
        flat, hists = parse_prometheus(text)
        finished_total = 0.0
        finished_bad = 0.0
        spec_drafted = None
        spec_accepted = None
        evict_delta = None
        mig_fail_delta = None
        disp_delta = None
        round_delta = None
        disp_tokens = None
        disp_real = None
        for name, value in flat.items():
            values[name] = value
            # drafting-mode gauge (1 = model draft, 0 = ngram), aliased to
            # its bare name so the replica comparison's spec_acc mode suffix
            # reads one series whatever the registry namespace
            if name.endswith("spec_mode_model"):
                values["spec_mode_model"] = value
            if name.endswith("_total") or "_total." in name:
                prev = self._prev_counters.get((source, name))
                self._prev_counters[(source, name)] = (now, value)
                if prev is not None and now > prev[0]:
                    rate = max(0.0, value - prev[1]) / (now - prev[0])
                    values[f"{name}_per_s"] = rate
                if "requests_finished_total." in name:
                    delta = max(0.0, value - prev[1]) if prev is not None else value
                    finished_total += delta
                    if name.endswith(".error"):
                        finished_bad += delta
                # per-replica speculative accept rate from counter deltas
                # (falls back to lifetime totals on the first scrape)
                if name.endswith("spec_drafted_total"):
                    spec_drafted = max(0.0, value - prev[1]) if prev is not None else value
                elif name.endswith("spec_accepted_total"):
                    spec_accepted = max(0.0, value - prev[1]) if prev is not None else value
                # adapter churn is a delta, not a lifetime total: the first
                # scrape contributes 0 so a report rebuilt from disk does not
                # see the whole run's evictions as one giant round
                elif name.endswith("adapter_evictions_total"):
                    evict_delta = max(0.0, value - prev[1]) if prev is not None else 0.0
                # KV-migration fail-open falls are a delta for the same
                # reason: a rebuilt report must not replay lifetime failures
                # as one round's incident
                elif name.endswith("migration_failures_total"):
                    mig_fail_delta = max(0.0, value - prev[1]) if prev is not None else 0.0
                # packed-dispatch economics from counter deltas: how many
                # model dispatches a scheduler round costs, and how much of
                # each packed dispatch was real work vs bucket padding
                elif name.endswith("model_dispatches_total"):
                    disp_delta = max(0.0, value - prev[1]) if prev is not None else value
                elif name.endswith("sched_rounds_total"):
                    round_delta = max(0.0, value - prev[1]) if prev is not None else value
                elif name.endswith("dispatch_tokens_real_total"):
                    disp_real = max(0.0, value - prev[1]) if prev is not None else value
                elif name.endswith("dispatch_tokens_total"):
                    disp_tokens = max(0.0, value - prev[1]) if prev is not None else value
            if "group_" in name and name.endswith("_healthy"):
                prev_g = self._last_gauges.get((source, name))
                if prev_g is not None and prev_g != value:
                    self.store.add_event(
                        "group_health_flip", source, t=now, gauge=name, frm=prev_g, to=value
                    )
                self._last_gauges[(source, name)] = value
        if finished_total > 0:
            values["error_rate"] = finished_bad / finished_total
        elif any("requests_finished_total" in k for k in flat):
            values["error_rate"] = 0.0
        if spec_drafted is not None:
            values["spec_accept_rate"] = (
                (spec_accepted or 0.0) / spec_drafted if spec_drafted > 0 else 0.0
            )
        if disp_delta is not None and round_delta is not None and round_delta > 0:
            values["dispatches_per_round"] = disp_delta / round_delta
        if disp_tokens is not None and disp_delta is not None and disp_delta > 0:
            values["tokens_per_dispatch"] = disp_tokens / disp_delta
        if disp_real is not None and disp_tokens is not None and disp_tokens > 0:
            values["packed_token_utilization"] = disp_real / disp_tokens
        if evict_delta is not None:
            # per-replica adapter churn: evictions this round.  A round that
            # turns over the whole slot pool means tenants are thrashing each
            # other's slots (more --adapter-slots is the remedy), so surface
            # it on the fleet timeline.
            values["adapter_churn"] = evict_delta
            slots_used = next(
                (v for k, v in flat.items() if k.endswith("adapter_slots_used")), None
            )
            if evict_delta >= max(2.0, slots_used or 0.0):
                self.store.add_event(
                    "adapter_thrash", source, t=now,
                    evictions=evict_delta, slots_used=slots_used,
                )
        if mig_fail_delta:
            # every fall back to local decode is a typed event on the fleet
            # timeline: the request was served, but the disaggregated tier
            # is leaking work
            self.store.add_event(
                "migration_failed", source, t=now, failures=mig_fail_delta
            )
        for name, h in hists.items():
            # Quantiles of the *recent* distribution, from bucket deltas
            # between scrape rounds.  The exposition is cumulative over the
            # replica's lifetime; a lifetime p95 never recovers from one
            # compile storm, which would latch the autoscaler's burn signal
            # above target long after traffic has drained.  A round with no
            # new observations emits no sample at all (the series goes
            # quiet rather than repeating a stale value), so windowed
            # readers like AutoscalerPolicy see only live traffic.
            prev_b = self._prev_hist_buckets.get((source, name))
            self._prev_hist_buckets[(source, name)] = {
                le: c for le, c in h["buckets"]
            }
            if prev_b is None:
                delta = h["buckets"]  # first scrape: lifetime is the window
            else:
                delta = [
                    (le, max(0.0, c - prev_b.get(le, 0.0)))
                    for le, c in h["buckets"]
                ]
            if delta and max(c for _, c in delta) > 0:
                values[f"{name}_p50"] = histogram_quantile(delta, 0.50)
                values[f"{name}_p95"] = histogram_quantile(delta, 0.95)

    def _tail_jsonl(self, source: str, path: str) -> None:
        """Incrementally ingest new complete lines of a metrics.jsonl file.
        A torn tail (no trailing newline yet) is left for the next round; a
        truncated/rotated file resets the offset."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return
        offset = self._jsonl_offsets.get(path, 0)
        if size < offset:
            offset = 0  # rotated or truncated underneath us
        if size == offset:
            return
        try:
            with open(path, "r", errors="replace") as fh:
                fh.seek(offset)
                chunk = fh.read(size - offset)
        except OSError:
            return
        complete, _, tail = chunk.rpartition("\n")
        self._jsonl_offsets[path] = size - len(tail.encode())
        for line in complete.splitlines():
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(record, dict):
                self.store.ingest_record(record, source=source)

    # -- supervisor integration ---------------------------------------------

    def record_supervisor_event(self, event: str, replica_idx, detail: str) -> None:
        """`ReplicaSupervisor.on_event` adapter: restarts, quarantines,
        rolling-drain steps, and deployment transitions become store events
        on the fleet timeline.  ``deploy_*`` events (the rolling updater's
        lifecycle) and ``autoscale_*`` events (elastic scaling decisions)
        keep their own namespaces; everything else gets the ``supervisor_``
        prefix.  ``replica_idx`` may be an int index or an rid string
        ("r0"); None means the fleet as a whole."""
        if replica_idx is None:
            source = "supervisor"
        elif isinstance(replica_idx, int):
            source = f"r{replica_idx}"
        else:
            source = str(replica_idx)
        kind = (
            event
            if event.startswith(("deploy_", "autoscale_"))
            else f"supervisor_{event}"
        )
        self.store.add_event(kind, source, detail=detail)

    # -- background loop ----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="fleet-collector", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=max(2.0, 2 * self.cadence_s))
        self.store.close()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception as e:  # never kill the supervisor over a scrape
                self.metrics.inc("scrape_round_failures_total")
                logger.warning(f"fleet scrape round failed: {e}")
            self._stop.wait(self.cadence_s)

    # -- exposure ------------------------------------------------------------

    def render_metrics(self) -> str:
        """``/fleet/metrics`` body: the collector's own registry plus a
        per-source ``up`` gauge and firing-alert gauges."""
        for source in self.store.sources():
            latest = self.store.latest(source, "up")
            if latest is not None:
                self.metrics.set_gauge(f"source_{source}_up", latest[1])
        if self.slo is not None:
            for alert in self.slo.active_alerts():
                self.metrics.set_gauge(f"alert_{alert.key()}_firing", 1)
        return self.metrics.render()

    def series_payload(
        self,
        source: Optional[str] = None,
        series: Optional[str] = None,
        since: Optional[float] = None,
        last: int = 256,
    ) -> Dict[str, Any]:
        """``/fleet/series`` body: JSON time series + events (+ SLO status)."""
        out: Dict[str, Any] = {"sources": {}, "events": self.store.events(since=since)}
        for src in self.store.sources():
            if source is not None and src != source:
                continue
            names = self.store.series_names(src)
            if series is not None:
                names = [n for n in names if n == series]
            out["sources"][src] = {
                n: [[round(t, 3), v] for (t, v) in self.store.samples(src, n, since=since)][-last:]
                for n in names
            }
        if self.slo is not None:
            out["slo"] = self.slo.status()
        return out

    def handle_fleet_route(self, path: str) -> Optional[Tuple[int, str, bytes]]:
        """Shared HTTP routing for ``/fleet/*``: returns (status,
        content_type, body) or None when the path is not a fleet route.
        Query strings: ``/fleet/series?source=r0&series=up&last=64``."""
        from urllib.parse import parse_qs, urlsplit

        parts = urlsplit(path)
        if parts.path == "/fleet/metrics":
            return 200, "text/plain; version=0.0.4", self.render_metrics().encode()
        if parts.path == "/fleet/series":
            q = parse_qs(parts.query)

            def one(key: str) -> Optional[str]:
                vals = q.get(key)
                return vals[0] if vals else None

            last_s = one("last")
            payload = self.series_payload(
                source=one("source"),
                series=one("series"),
                last=int(last_s) if last_s and last_s.isdigit() else 256,
            )
            return 200, "application/json", json.dumps(payload).encode()
        if parts.path == "/fleet/prefix":
            q = parse_qs(parts.query)
            raw = (q.get("d") or [""])[0]
            digests = [d for d in raw.split(",") if d]
            exclude = (q.get("exclude") or [None])[0]
            hit = self.directory.lookup(digests, exclude_rid=exclude) if digests else None
            if hit is None:
                body = json.dumps({"error": "no holder known"}).encode()
                return 404, "application/json", body
            digest, rid, host, port = hit
            body = json.dumps(
                {"digest": digest, "replica": rid, "host": host, "port": port}
            ).encode()
            return 200, "application/json", body
        return None


# -- standalone CLI -----------------------------------------------------------


def _parse_target(spec: str) -> Tuple[str, Tuple[str, int]]:
    """``name=host:port`` -> (name, (host, port))."""
    name, _, addr = spec.partition("=")
    host, _, port = addr.rpartition(":")
    return name, (host or "127.0.0.1", int(port))


def main(argv: Optional[List[str]] = None) -> int:
    """Standalone collector: scrape targets on a cadence and serve
    ``/fleet/metrics`` + ``/fleet/series`` over its own tiny HTTP server —
    the same plane the supervisor hosts, runnable against any fleet."""
    ap = argparse.ArgumentParser(description="standalone fleet metrics collector")
    ap.add_argument("--target", action="append", default=[], metavar="NAME=HOST:PORT",
                    help="scrape target (repeatable), e.g. r0=127.0.0.1:8101")
    ap.add_argument("--train-jsonl", action="append", default=[], metavar="NAME=PATH",
                    help="metrics.jsonl file to tail into the store (repeatable)")
    ap.add_argument("--cadence-s", type=float, default=1.0)
    ap.add_argument("--timeout-s", type=float, default=0.5)
    ap.add_argument("--persist", default=None, help="JSONL persistence path")
    ap.add_argument("--slo-config", default=None, help="JSON SLO config (see docs)")
    ap.add_argument("--port", type=int, default=0, help="HTTP port for /fleet/* (0 = ephemeral)")
    ap.add_argument("--port-file", default=None, help="write the bound port here")
    ap.add_argument("--rounds", type=int, default=0, help="scrape N rounds then exit (0 = forever)")
    args = ap.parse_args(argv)

    from relora_tpu_torch.obs.slo import SLOEngine

    targets = dict(_parse_target(s) for s in args.target)
    jsonl_sources = dict(s.partition("=")[::2] for s in args.train_jsonl)
    engine = SLOEngine.from_config(args.slo_config)
    collector = FleetCollector(
        lambda: targets,
        slo_engine=engine,
        cadence_s=args.cadence_s,
        timeout_s=args.timeout_s,
        persist_path=args.persist,
        jsonl_sources=jsonl_sources,
    )

    if args.rounds > 0:
        for _ in range(args.rounds):
            collector.scrape_once()
            time.sleep(args.cadence_s)
        print(json.dumps(collector.series_payload(), indent=2))
        collector.store.close()
        return 0

    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 (stdlib API)
            routed = collector.handle_fleet_route(self.path)
            if routed is None:
                self.send_error(404)
                return
            status, ctype, body = routed
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt: str, *fa: Any) -> None:
            pass  # quiet: the collector logs transitions itself

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    if args.port_file:
        with open(args.port_file, "w") as fh:
            fh.write(str(httpd.server_address[1]))
    collector.start()
    logger.info(f"fleet collector on 127.0.0.1:{httpd.server_address[1]} "
                f"scraping {sorted(targets)} every {args.cadence_s}s")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        collector.stop()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
