"""Declarative SLOs with multi-window burn-rate alerts over a SeriesStore.

The port's own copy of ``relora_tpu/obs/slo.py``.  The fleet collector
(:mod:`relora_tpu_torch.obs.fleet`) keeps the signals; this module decides
when they make an incident.  Two detectors, cheap enough for every scrape
round:

- **Burn-rate alerts** (the SRE workbook's construction): an :class:`SLO`
  says which samples of a series are *bad* and what good fraction the
  objective asks; the error budget is ``1 - objective``.  An alert fires
  when the budget burns faster than a window pair allows: the *long*
  window proves the burn is sustained, the *short* one that it is still
  going on (so a stale incident cannot page again).  The default pairs
  (1h/5m at 14.4x, 6h/30m at 6x, 3d/6h at 1x) are the workbook's; drills
  and tests compress them with ``window_scale``.  An alert clears when
  every pair's short window is back under its burn factor.
- **Series anomaly detection**: the trainer's ``LossSpikeDetector``
  (median/MAD with patience, outliers kept out of the baseline) over any
  stored series: a TTFT regression or an MFU collapse is a loss spike on
  another curve, and a test holds the two detectors to the same samples.

Alert transitions are *events*: they land in the store (persisted), the
flight recorder and the log.

Stdlib only and torch-free (``train.resilience`` is host-side code, and
``relora_tpu_torch.train`` imports nothing at package import).
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import TYPE_CHECKING, Any, Deque, Dict, Iterable, List, Optional, Tuple

from relora_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:  # pragma: no cover
    from relora_tpu_torch.train.resilience import LossSpikeDetector, SpikeEvent

__all__ = [
    "SLO",
    "AnomalySpec",
    "Alert",
    "SLOEngine",
    "SeriesAnomalyDetector",
    "default_slos",
    "load_slo_config",
]

logger = get_logger("relora_tpu_torch.slo")

#: (long_window_s, short_window_s, burn_factor) — SRE-workbook defaults:
#: 14.4x burn exhausts a 30-day budget in ~2 days (page now), 6x in ~5 days,
#: 1x is the slow-burn ticket tier.
DEFAULT_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (3600.0, 300.0, 14.4),
    (21600.0, 1800.0, 6.0),
    (259200.0, 21600.0, 1.0),
)


@dataclasses.dataclass
class SLO:
    """One declarative objective over a stored series.

    A sample is *bad* when ``value <bad_when> threshold`` (``"lt"`` or
    ``"gt"``).  ``source=None`` evaluates the SLO independently against every
    source that carries the series (each replica gets its own budget);
    pinning ``source`` scopes it (e.g. the MFU floor to ``"train"``).
    """

    name: str
    series: str
    threshold: float
    bad_when: str = "gt"
    objective: float = 0.999
    source: Optional[str] = None
    windows: Tuple[Tuple[float, float, float], ...] = DEFAULT_WINDOWS
    description: str = ""

    def __post_init__(self) -> None:
        if self.bad_when not in ("lt", "gt"):
            raise ValueError(f"bad_when must be 'lt' or 'gt', got {self.bad_when!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {self.objective}")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def is_bad(self, value: float) -> bool:
        return value < self.threshold if self.bad_when == "lt" else value > self.threshold


@dataclasses.dataclass
class AnomalySpec:
    """Median/MAD anomaly detection over a stored series, parameterized the
    same way as the trainer's loss-spike config."""

    series: str
    source: Optional[str] = None
    threshold: float = 4.0
    window: int = 64
    min_history: int = 16
    patience: int = 3
    min_deviation: float = 0.05
    direction: str = "high"  # "high": spikes up are anomalous; "low": drops

    def __post_init__(self) -> None:
        if self.direction not in ("high", "low"):
            raise ValueError(f"direction must be 'high' or 'low', got {self.direction!r}")


@dataclasses.dataclass
class Alert:
    """Lifecycle record of one (SLO, source) alert."""

    slo: str
    source: str
    state: str  # "firing" | "cleared"
    fired_at: float
    window_s: float = 0.0
    burn_long: float = 0.0
    burn_short: float = 0.0
    cleared_at: Optional[float] = None

    def key(self) -> str:
        return f"{self.slo}_{self.source}".replace("-", "_").replace(".", "_")


class SeriesAnomalyDetector:
    """Per-(source, series) :class:`LossSpikeDetector` bank.

    ``observe`` feeds one sample and returns the detector's ``SpikeEvent``
    when a sustained outlier run crosses patience — byte-for-byte the
    trainer's spike semantics, so a series that would have tripped the
    trainer's detector trips this one at the same sample (pinned by test).
    ``direction="low"`` negates samples so collapses (MFU falling off a
    cliff) register as spikes.
    """

    def __init__(self, specs: Iterable[AnomalySpec] = ()):
        self.specs = list(specs)
        self._detectors: Dict[Tuple[str, str], "LossSpikeDetector"] = {}
        self._steps: Dict[Tuple[str, str], int] = {}

    def _spec_for(self, source: str, series: str) -> Optional[AnomalySpec]:
        for spec in self.specs:
            if spec.series == series and spec.source in (None, source):
                return spec
        return None

    def observe(self, source: str, series: str, value: float) -> Optional["SpikeEvent"]:
        spec = self._spec_for(source, series)
        if spec is None:
            return None
        # imported at first use, as the reference does: a front-end process
        # without anomaly specs never loads the trainer's module
        from relora_tpu_torch.train.resilience import LossSpikeDetector

        key = (source, series)
        det = self._detectors.get(key)
        if det is None:
            det = self._detectors[key] = LossSpikeDetector(
                threshold=spec.threshold,
                window=spec.window,
                min_history=spec.min_history,
                patience=spec.patience,
                min_deviation=spec.min_deviation,
            )
        step = self._steps.get(key, 0)
        self._steps[key] = step + 1
        return det.update(step, value if spec.direction == "high" else -value)


class SLOEngine:
    """Evaluates SLOs + anomaly specs against a SeriesStore and manages
    alert lifecycle.  ``evaluate`` is called by the collector once per scrape
    round; it is idempotent per timestamp and safe to call ad hoc (once
    over a store rebuilt from disk by ``fleet.load_series_jsonl``)."""

    def __init__(
        self,
        slos: Iterable[SLO] = (),
        anomalies: Iterable[AnomalySpec] = (),
        history: int = 256,
    ):
        self.slos = list(slos)
        self.anomaly = SeriesAnomalyDetector(anomalies)
        self._alerts: Dict[Tuple[str, str], Alert] = {}
        self.history: Deque[Alert] = deque(maxlen=history)
        self._anomaly_seen: Dict[Tuple[str, str], float] = {}
        self._last_status: List[Dict[str, Any]] = []

    @classmethod
    def from_config(cls, path: Optional[str]) -> "SLOEngine":
        if path is None:
            return cls(default_slos())
        slos, anomalies = load_slo_config(path)
        return cls(slos, anomalies)

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, store, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One evaluation pass.  Returns the list of transition events fired
        this pass (already recorded into store/flight/log)."""
        now = time.time() if now is None else now
        fired: List[Dict[str, Any]] = []
        status: List[Dict[str, Any]] = []
        for slo in self.slos:
            sources = [slo.source] if slo.source else [
                s for s in store.sources() if store.samples(s, slo.series)
            ]
            for source in sources:
                st = self._evaluate_one(store, slo, source, now)
                if st is None:
                    continue
                status.append(st)
                if st.pop("_transition", None) is not None:
                    fired.append(st)
        fired.extend(self._evaluate_anomalies(store, now))
        self._last_status = status
        return fired

    def _evaluate_one(
        self, store, slo: SLO, source: str, now: float
    ) -> Optional[Dict[str, Any]]:
        worst_burn = 0.0
        should_fire = False
        short_ok = True
        fire_window = 0.0
        burn_l = burn_s = 0.0
        evaluated = False
        for long_s, short_s, factor in slo.windows:
            long_vals = store.window_values(source, slo.series, long_s, now=now)
            short_vals = store.window_values(source, slo.series, short_s, now=now)
            if not long_vals:
                continue
            evaluated = True
            frac_long = sum(1 for v in long_vals if slo.is_bad(v)) / len(long_vals)
            frac_short = (
                sum(1 for v in short_vals if slo.is_bad(v)) / len(short_vals)
                if short_vals
                else 0.0
            )
            bl = frac_long / slo.budget
            bs = frac_short / slo.budget
            worst_burn = max(worst_burn, bl)
            if bs >= factor:
                short_ok = False
            if bl >= factor and bs >= factor:
                should_fire = True
                if bl > burn_l:
                    burn_l, burn_s, fire_window = bl, bs, long_s
        if not evaluated:
            return None
        key = (slo.name, source)
        active = self._alerts.get(key)
        transition = None
        if should_fire and (active is None or active.state != "firing"):
            active = Alert(
                slo=slo.name, source=source, state="firing", fired_at=now,
                window_s=fire_window, burn_long=burn_l, burn_short=burn_s,
            )
            self._alerts[key] = active
            self.history.append(active)
            transition = "fire"
            self._emit(store, "fire", slo, active, now)
        elif active is not None and active.state == "firing":
            active.burn_long, active.burn_short = max(burn_l, worst_burn), burn_s
            if short_ok and not should_fire:
                active.state = "cleared"
                active.cleared_at = now
                transition = "clear"
                self._emit(store, "clear", slo, active, now)
        return {
            "slo": slo.name,
            "source": source,
            "series": slo.series,
            "objective": slo.objective,
            "budget": slo.budget,
            "max_burn": round(worst_burn, 3),
            "state": "firing" if (active is not None and active.state == "firing") else "ok",
            "_transition": transition,
        }

    def _evaluate_anomalies(self, store, now: float) -> List[Dict[str, Any]]:
        fired: List[Dict[str, Any]] = []
        for spec in self.anomaly.specs:
            sources = [spec.source] if spec.source else store.sources()
            for source in sources:
                key = (source, spec.series)
                seen = self._anomaly_seen.get(key, 0.0)
                for t, v in store.samples(source, spec.series):
                    if t <= seen:
                        continue
                    self._anomaly_seen[key] = t
                    spike = self.anomaly.observe(source, spec.series, v)
                    if spike is not None:
                        detail = {
                            "series": spec.series,
                            "value": spike.loss,
                            "median": spike.median,
                            "mad": spike.mad,
                        }
                        store.add_event("series_anomaly", source, t=now, **detail)
                        self._flight_event("series_anomaly", source, detail)
                        logger.warning(f"series anomaly: {source}/{spec.series} {detail}")
                        fired.append({"anomaly": True, "source": source, **detail})
        return fired

    def _emit(self, store, kind: str, slo: SLO, alert: Alert, now: float) -> None:
        detail = {
            "slo": alert.slo,
            "series": slo.series,
            "state": kind,
            "window_s": alert.window_s,
            "burn_long": round(alert.burn_long, 3),
            "burn_short": round(alert.burn_short, 3),
            "objective": slo.objective,
        }
        store.add_event("slo_burn_alert", alert.source, t=now, **detail)
        self._flight_event("slo_burn_alert", alert.source, detail)
        log = logger.warning if kind == "fire" else logger.info
        log(
            f"SLO burn alert {kind}: {alert.slo} on {alert.source} "
            f"(burn {alert.burn_long:.1f}x long / {alert.burn_short:.1f}x short, "
            f"window {alert.window_s:g}s, objective {slo.objective})"
        )

    @staticmethod
    def _flight_event(name: str, source: str, detail: Dict[str, Any]) -> None:
        try:
            from relora_tpu_torch.obs.flight import default_recorder

            default_recorder().add_event(
                {
                    "name": name,
                    "trace_id": "fleet",
                    "parent_id": None,
                    "t": time.monotonic(),
                    "thread": "fleet-collector",
                    "service": "fleet",
                    "attrs": {"source": source, **detail},
                }
            )
        except Exception:
            pass  # forensics must never break the control loop

    # -- queries -------------------------------------------------------------

    def active_alerts(self) -> List[Alert]:
        return [a for a in self._alerts.values() if a.state == "firing"]

    def status(self) -> Dict[str, Any]:
        """JSON-able SLO and error-budget status for ``/fleet/series``."""
        return {
            "objectives": [dict(s) for s in self._last_status],
            "active": [dataclasses.asdict(a) for a in self.active_alerts()],
            "history": [dataclasses.asdict(a) for a in self.history],
        }


def default_slos(window_scale: float = 1.0) -> List[SLO]:
    """The fleet's standing objectives.  ``window_scale`` compresses the
    burn windows (drills, tests); thresholds are deliberately loose — they
    are floors for "clearly broken", tuned per deployment via JSON config."""
    w = tuple(
        (long_s * window_scale, short_s * window_scale, factor)
        for long_s, short_s, factor in DEFAULT_WINDOWS
    )
    return [
        SLO(
            name="availability", series="up", threshold=1.0, bad_when="lt",
            objective=0.999, windows=w,
            description="replica answers /healthz 200",
        ),
        SLO(
            name="ttft_p95", series="relora_serve_ttft_seconds_p95", threshold=2.0,
            bad_when="gt", objective=0.95, windows=w,
            description="scraped p95 time-to-first-token under 2s",
        ),
        SLO(
            name="tpot_p95", series="relora_serve_tpot_seconds_p95", threshold=0.5,
            bad_when="gt", objective=0.95, windows=w,
            description="scraped p95 per-token latency under 500ms",
        ),
        SLO(
            name="error_rate", series="error_rate", threshold=0.05, bad_when="gt",
            objective=0.99, windows=w,
            description="under 5% of finished requests errored per scrape interval",
        ),
        SLO(
            name="mfu_floor", series="mfu", threshold=0.05, bad_when="lt",
            objective=0.90, source="train", windows=w,
            description="training MFU above 5% (collapse detector, not a target)",
        ),
    ]


def load_slo_config(path: str) -> Tuple[List[SLO], List[AnomalySpec]]:
    """Load a JSON SLO config::

        {
          "window_scale": 1.0,             # optional, scales default windows
          "slos": [ {"name": ..., "series": ..., "threshold": ...,
                     "bad_when": "gt", "objective": 0.99,
                     "source": null, "windows": [[60, 5, 10.0]] } ],
          "anomalies": [ {"series": "loss", "threshold": 4.0,
                          "patience": 3, "direction": "high"} ]
        }

    Omitting ``slos`` keeps the defaults (scaled); per-SLO ``windows``
    override the scaled defaults for that SLO.
    """
    with open(path) as fh:
        cfg = json.load(fh)
    scale = float(cfg.get("window_scale", 1.0))
    scaled = tuple(
        (long_s * scale, short_s * scale, factor)
        for long_s, short_s, factor in DEFAULT_WINDOWS
    )
    slos: List[SLO] = []
    if "slos" in cfg:
        for raw in cfg["slos"]:
            raw = dict(raw)
            windows = raw.pop("windows", None)
            slo = SLO(**raw)
            slo.windows = (
                tuple(tuple(wp) for wp in windows) if windows is not None else scaled
            )
            slos.append(slo)
    else:
        slos = default_slos(window_scale=scale)
    anomalies = [AnomalySpec(**raw) for raw in cfg.get("anomalies", [])]
    return slos, anomalies
