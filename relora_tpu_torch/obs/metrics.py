"""Counters, gauges and fixed-bucket histograms with Prometheus text output.

The port's own copy of ``relora_tpu/obs/metrics.py`` (the PyTorch port
imports nothing of the JAX package).  ``ServeMetrics``
(``serve/admission.py``) is this registry under the ``relora_serve``
namespace; its ``render()`` is the ``/metrics`` body and must stay
byte-identical to the reference's for the same observations.

Stdlib only: every operation takes one lock and does O(1) work (an observe
is a bisect over the bucket bounds), so per-token call sites can afford it.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["LATENCY_BUCKETS", "Histogram", "MetricsRegistry"]

#: latency histogram buckets (seconds), log-spaced over the TTFT/TPOT range
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics): counts per
    upper bound, plus sum and count."""

    def __init__(self, buckets: Tuple[float, ...] = LATENCY_BUCKETS):
        self.bounds = tuple(sorted(buckets))
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.total += value
        self.count += 1

    def quantile(self, q: float) -> float:
        """The upper bound of the first bucket whose cumulative count reaches
        ``q * count`` (0.0 when empty)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cumulative = 0
        for bound, count in zip(self.bounds, self.counts):
            cumulative += count
            if cumulative >= target:
                return bound
        return float("inf")


class MetricsRegistry:
    """Thread-safe metrics with Prometheus text exposition.

    Counters take an optional label pair; gauges are set-to-latest;
    histograms observe seconds.  ``render()`` gives the ``/metrics`` body,
    ``snapshot()`` a flat dict for JSONL records and tests.
    """

    def __init__(self, namespace: str = "relora"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Optional[Tuple[str, str]]], int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    def inc(self, name: str, label: Optional[Tuple[str, str]] = None, by: int = 1) -> None:
        with self._lock:
            key = (name, label)
            self._counters[key] = self._counters.get(key, 0) + by

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = Histogram()
            hist.observe(value)

    def materialize_histogram(self, name: str) -> None:
        """Create ``name`` with zero observations, so it renders before the
        first sample."""
        with self._lock:
            self._hists.setdefault(name, Histogram())

    def counter_value(self, name: str, label: Optional[Tuple[str, str]] = None) -> int:
        with self._lock:
            return self._counters.get((name, label), 0)

    def gauge_value(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def snapshot(self) -> Dict[str, float]:
        """Flat dict view: counters (labels joined with '.'), gauges, and
        histogram count/sum."""
        with self._lock:
            out: Dict[str, float] = {}
            for (name, label), value in sorted(self._counters.items()):
                key = name if label is None else f"{name}.{label[1]}"
                out[key] = value
            out.update(self._gauges)
            for name, hist in self._hists.items():
                out[f"{name}_count"] = hist.count
                out[f"{name}_sum"] = round(hist.total, 6)
            return out

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        with self._lock:
            lines: List[str] = []
            seen_types = set()
            for (name, label), value in sorted(self._counters.items()):
                full = f"{self.namespace}_{name}"
                if full not in seen_types:
                    lines.append(f"# TYPE {full} counter")
                    seen_types.add(full)
                if label is None:
                    lines.append(f"{full} {value}")
                else:
                    lines.append(f'{full}{{{label[0]}="{label[1]}"}} {value}')
            for name, value in sorted(self._gauges.items()):
                full = f"{self.namespace}_{name}"
                lines.append(f"# TYPE {full} gauge")
                lines.append(f"{full} {value:g}")
            for name, hist in sorted(self._hists.items()):
                full = f"{self.namespace}_{name}"
                lines.append(f"# TYPE {full} histogram")
                cumulative = 0
                for bound, count in zip(hist.bounds, hist.counts):
                    cumulative += count
                    lines.append(f'{full}_bucket{{le="{bound:g}"}} {cumulative}')
                cumulative += hist.counts[-1]
                lines.append(f'{full}_bucket{{le="+Inf"}} {cumulative}')
                lines.append(f"{full}_sum {hist.total:.6f}")
                lines.append(f"{full}_count {hist.count}")
            return "\n".join(lines) + "\n"
