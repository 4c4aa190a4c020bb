"""SLO-driven elastic scaling of the serving fleet.

The port's own copy of ``relora_tpu/serve/autoscale.py``.  The serving
tier runs N replica processes behind the router (``serve/supervisor.py``).
N is a cost and latency dial: too few replicas and TTFT burns through its
SLO budget under load; too many and idle cards bill for nothing.  The
fleet observability plane (``obs/fleet.py``'s SeriesStore) drives N here.

Split into a *policy* and an *executor*:

- :class:`AutoscalerPolicy` is decision logic over a SeriesStore: it reads
  the collector's derived per-replica series (TTFT p95 from the scraped
  histogram, ``healthz_queue_depth``, slot utilization from
  ``healthz_active_slots / healthz_max_batch``) and returns a
  :class:`Decision` (scale up, scale down or hold) with a named reason.
  Flap resistance is structural: a scale-up needs the *whole* burn window
  saturated on every replica, a scale-down the whole (longer) idle window
  quiet on every replica, and any action starts a cooldown in which the
  policy holds.
- :class:`Autoscaler` is the executor thread: every ``interval_s`` it asks
  the policy, then acts through the supervisor's ``scale_up`` /
  ``scale_down`` (serialized with the rolling drain behind the supervisor's
  scale lock).  It holds a scale-up while the newest replica is still
  warming (``up == 0`` in the store: a replica answers ``/healthz`` 503
  "warming" until its serving shapes have run), because capacity that
  cannot take traffic yet is not capacity.

Every decision that acts, and every hold for a *new* reason, lands in the
SeriesStore as an ``autoscale_decision`` event beside the supervisor's
``autoscale_up`` / ``autoscale_down_complete`` events.  The executor also
samples ``replicas_live`` under the ``autoscaler`` source: the replica
count over time.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from relora_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

#: the collector's derived series this policy reads (per replica source)
TTFT_P95_SERIES = "relora_serve_ttft_seconds_p95"
QUEUE_DEPTH_SERIES = "healthz_queue_depth"
ACTIVE_SLOTS_SERIES = "healthz_active_slots"
MAX_BATCH_SERIES = "healthz_max_batch"
UP_SERIES = "up"


@dataclasses.dataclass
class Decision:
    """One policy evaluation: ``action`` is ``"up"``, ``"down"``, or
    ``"hold"``; ``reason`` is a named, greppable cause; ``metrics`` carries
    the numbers the decision was made on (for the event detail)."""

    action: str
    reason: str
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)


class AutoscalerPolicy:
    """Hysteresis-banded scaling policy over the fleet SeriesStore.

    A replica is **burning** when, for at least one pressure signal, every
    sample in the last ``burn_window_s`` breaches its high-water mark
    (TTFT p95 over ``ttft_p95_target_s``, queue depth over
    ``queue_depth_high``, or slot utilization over ``slot_util_high``) —
    with at least ``min_samples`` samples, so a single hot scrape never
    scales the fleet.  The fleet scales up only when *every* live replica
    is burning: one hot tenant pinned to one replica is a routing story,
    uniform saturation is a capacity story.

    A replica is **idle** when every sample in the last ``idle_window_s``
    sits under the low-water marks (``queue_depth_low``,
    ``slot_util_low``).  The fleet scales down only when every replica is
    idle for the whole window — the idle window is deliberately longer
    than the burn window so capacity leaves slower than it arrives.

    Any action arms a ``cooldown_s`` hold, so consecutive decisions see
    the *effect* of the previous one instead of re-firing on the same
    stale pressure.
    """

    def __init__(
        self,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        ttft_p95_target_s: float = 2.0,
        queue_depth_high: float = 4.0,
        slot_util_high: float = 0.9,
        queue_depth_low: float = 0.5,
        slot_util_low: float = 0.5,
        burn_window_s: float = 5.0,
        idle_window_s: float = 15.0,
        cooldown_s: float = 10.0,
        min_samples: int = 3,
    ):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) < min_replicas ({min_replicas})"
            )
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.ttft_p95_target_s = ttft_p95_target_s
        self.queue_depth_high = queue_depth_high
        self.slot_util_high = slot_util_high
        self.queue_depth_low = queue_depth_low
        self.slot_util_low = slot_util_low
        self.burn_window_s = burn_window_s
        self.idle_window_s = idle_window_s
        self.cooldown_s = cooldown_s
        self.min_samples = min_samples
        self._last_scale_t: Optional[float] = None

    # -- cooldown ------------------------------------------------------------

    def note_scaled(self, now: Optional[float] = None) -> None:
        """The executor applied an action; start the cooldown clock."""
        self._last_scale_t = time.time() if now is None else now

    def in_cooldown(self, now: Optional[float] = None) -> bool:
        if self._last_scale_t is None:
            return False
        now = time.time() if now is None else now
        return (now - self._last_scale_t) < self.cooldown_s

    # -- signal extraction ---------------------------------------------------

    def _slot_util(self, store, source: str, window_s: float, now: float) -> List[float]:
        active = store.window_values(source, ACTIVE_SLOTS_SERIES, window_s, now=now)
        latest_mb = store.latest(source, MAX_BATCH_SERIES)
        if not active or latest_mb is None or latest_mb[1] <= 0:
            return []
        max_batch = latest_mb[1]
        return [a / max_batch for a in active]

    def _burning(self, store, source: str, now: float) -> Optional[str]:
        """The signal name sustaining a burn on ``source``, else None."""
        w = self.burn_window_s
        ttft = store.window_values(source, TTFT_P95_SERIES, w, now=now)
        if len(ttft) >= self.min_samples and all(v > self.ttft_p95_target_s for v in ttft):
            return "ttft_p95"
        queue = store.window_values(source, QUEUE_DEPTH_SERIES, w, now=now)
        if len(queue) >= self.min_samples and all(v > self.queue_depth_high for v in queue):
            return "queue_depth"
        util = self._slot_util(store, source, w, now)
        if len(util) >= self.min_samples and all(v > self.slot_util_high for v in util):
            return "slot_utilization"
        return None

    def _idle(self, store, source: str, now: float) -> bool:
        w = self.idle_window_s
        queue = store.window_values(source, QUEUE_DEPTH_SERIES, w, now=now)
        if len(queue) < self.min_samples or any(v > self.queue_depth_low for v in queue):
            return False
        util = self._slot_util(store, source, w, now)
        # no slot data yet → not provably idle; short data is fine for util
        # (queue depth already proved the window), but a breach is not
        return not any(v > self.slot_util_low for v in util)

    # -- the decision --------------------------------------------------------

    def decide(
        self,
        store,
        sources: Sequence[str],
        n_live: int,
        now: Optional[float] = None,
    ) -> Decision:
        """Evaluate the fleet: ``sources`` are the replica rids to read,
        ``n_live`` the capacity-bearing replica count (the supervisor's
        view, which includes a replica mid-backoff the store has marked
        down)."""
        now = time.time() if now is None else now
        if self.in_cooldown(now):
            return Decision("hold", "cooldown", {"n_live": n_live})
        if not sources:
            return Decision("hold", "no_replicas", {"n_live": n_live})

        burning = {s: self._burning(store, s, now) for s in sources}
        signals = {s: b for s, b in burning.items() if b is not None}
        if signals and len(signals) == len(sources):
            if n_live >= self.max_replicas:
                return Decision(
                    "hold",
                    "at_max_replicas",
                    {"n_live": n_live, "max_replicas": self.max_replicas},
                )
            return Decision(
                "up",
                f"sustained_burn ({'/'.join(sorted(set(signals.values())))})",
                {"n_live": n_live, "burning_replicas": len(signals)},
            )

        if all(self._idle(store, s, now) for s in sources):
            if n_live <= self.min_replicas:
                return Decision(
                    "hold",
                    "at_min_replicas",
                    {"n_live": n_live, "min_replicas": self.min_replicas},
                )
            return Decision("down", "sustained_idle", {"n_live": n_live})

        reason = "partial_burn" if signals else "steady"
        return Decision(
            "hold", reason, {"n_live": n_live, "burning_replicas": len(signals)}
        )


class Autoscaler:
    """Executor thread: policy decisions become supervisor scale actions.

    ``supervisor`` needs the ReplicaSupervisor surface (``endpoints``,
    ``n_live``, ``scale_up``, ``scale_down``); ``store`` is the collector's
    SeriesStore.  Tests drive :meth:`step` directly with a scripted policy
    — the thread is just ``step`` on a cadence."""

    def __init__(
        self,
        policy: AutoscalerPolicy,
        supervisor,
        store,
        *,
        interval_s: float = 1.0,
        emit: Optional[Callable[[str, Optional[int], Dict], None]] = None,
    ):
        self.policy = policy
        self.supervisor = supervisor
        self.store = store
        self.interval_s = interval_s
        self.emit = emit  # (event, replica_idx, detail) — the supervisor CLI's sink
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_hold_reason: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception as e:  # the fleet outlives a bad evaluation
                logger.warning(f"autoscaler step failed: {e}")

    # -- one evaluation ------------------------------------------------------

    def _event(self, decision: Decision) -> None:
        detail = {"action": decision.action, "reason": decision.reason}
        detail.update(decision.metrics)
        self.store.add_event("autoscale_decision", "autoscaler", **detail)
        if self.emit is not None:
            try:
                self.emit("autoscale_decision", None, detail)
            except Exception:
                pass

    def _warming_replica(self, sources: Sequence[str]) -> Optional[str]:
        """A replica the router cannot use yet (``up == 0`` in the store —
        cold warmup, rebinding after restart, or mid-backoff)."""
        for source in sources:
            latest = self.store.latest(source, UP_SERIES)
            if latest is not None and latest[1] < 1.0:
                return source
        return None

    def step(self, now: Optional[float] = None) -> Decision:
        now = time.time() if now is None else now
        sources = sorted(self.supervisor.endpoints().keys())
        n_live = self.supervisor.n_live()
        self.store.add_sample("autoscaler", "replicas_live", float(n_live), t=now)
        decision = self.policy.decide(self.store, sources, n_live, now=now)

        if decision.action == "up":
            warming = self._warming_replica(sources)
            if warming is not None:
                # the last scale-up has not finished warming: adding another
                # replica now would double-provision for one burn
                decision = Decision(
                    "hold",
                    "replica_warming",
                    {**decision.metrics, "warming": warming},
                )

        if decision.action == "hold":
            if decision.reason != self._last_hold_reason:
                self._event(decision)
            self._last_hold_reason = decision.reason
            return decision
        self._last_hold_reason = None
        self._event(decision)

        if decision.action == "up":
            rid = self.supervisor.scale_up()
            if rid is None:
                return Decision("hold", "scale_up_cancelled", decision.metrics)
            self.policy.note_scaled(now)
            logger.info(f"autoscale: {decision.reason} -> added {rid}")
        elif decision.action == "down":
            rid = self.supervisor.scale_down()
            if rid is None:
                return Decision("hold", "scale_down_refused", decision.metrics)
            self.policy.note_scaled(now)
            logger.info(f"autoscale: {decision.reason} -> drained {rid}")
        return decision
