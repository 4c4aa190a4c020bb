"""Render fleet health, SLO/error-budget status, and the incident timeline.

Reads the ``fleet_series.jsonl`` the FleetCollector persists (supervisor
``--fleet-persist``, or ``python -m relora_tpu_torch.obs.fleet --persist``) and
rebuilds the in-memory SeriesStore from it, so the report works on a live
fleet's file as well as post-mortem on a copied one.  Optionally joins
additional metrics.jsonl streams (e.g. a trainer run dir) with ``--join``.

Sections:

1. fleet health — per source: last ``up`` sample, staleness, queue depth;
2. replica comparison — p95 TTFT/TPOT, error rate, token throughput,
   tokens per model dispatch, and prefill stall share per source over the
   comparison window (spot the slow, erroring, or under-packed replica);
3. SLO / error budget — burn status per objective from a fresh SLOEngine
   pass over the rebuilt store (``--slo-config`` mirrors the collector's);
4. autoscale — live replica count (current and min/max over the window)
   plus every autoscaler decision: scale-ups with the burn signals that
   drove them, scale-downs, and holds (cooldown, warming, partial burn);
5. timeline — health flips, supervisor lifecycle, autoscale actions, SLO
   burn alerts and anomalies, merged and time-ordered.

    python -m relora_tpu_torch.tools.fleet_report /tmp/fleet/fleet_series.jsonl
    python -m relora_tpu_torch.tools.fleet_report fleet.jsonl --join train=ckpts/run/metrics.jsonl
    python -m relora_tpu_torch.tools.fleet_report fleet.jsonl --slo-config slo.json --window-s 300

The port's copy of ``tools/fleet_report.py``, over the port's
``obs/fleet.py`` and ``obs/slo.py``; the persisted file is the one the
port's supervisor writes (``<workdir>/fleet_series.jsonl`` by default).
It leaves out the reference's ``--bench-dir`` banner, which checks the JAX
package's ``BENCH_r*.json`` rounds; with that check off (``--bench-dir ''``)
the two print the same report.  Imports no torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from relora_tpu_torch.obs.fleet import SeriesStore, load_series_jsonl
from relora_tpu_torch.obs.slo import SLOEngine

# replica-comparison columns: (header, series name, unit scale, format)
_COMPARE_COLUMNS = (
    ("ttft_p95_ms", "relora_serve_ttft_seconds_p95", 1e3, "{:.1f}"),
    ("tpot_p95_ms", "relora_serve_tpot_seconds_p95", 1e3, "{:.2f}"),
    ("err_rate", "error_rate", 1.0, "{:.3f}"),
    ("tok_per_s", "relora_serve_tokens_generated_total_per_s", 1.0, "{:.1f}"),
    ("spec_acc", "spec_accept_rate", 1.0, "{:.3f}"),
    ("adpt_churn", "adapter_churn", 1.0, "{:.2f}"),
    ("adpt_hit", "relora_serve_adapter_hit_rate", 1.0, "{:.3f}"),
    ("tok_disp", "tokens_per_dispatch", 1.0, "{:.1f}"),
    ("stall", "relora_serve_prefill_stall_share", 1.0, "{:.3f}"),
)

_TIMELINE_KINDS = (
    "health_flip",
    "group_health_flip",
    "slo_burn_alert",
    "series_anomaly",
    "adapter_thrash",
    "migration_failed",
)


def _mean(vals: List[float]) -> Optional[float]:
    return sum(vals) / len(vals) if vals else None


def fleet_health(store: SeriesStore, now: float, out=sys.stdout) -> None:
    out.write("== fleet health ==\n")
    sources = store.sources()
    if not sources:
        out.write("no sources in store\n")
        return
    out.write(f"{'source':<12} {'up':>4} {'age_s':>7} {'queue':>6} {'slots':>6}\n")
    for src in sources:
        up = store.latest(src, "up")
        if up is None:
            # jsonl-joined sources (trainer) have no scraped up gauge; show
            # them by their freshest sample instead of skipping the row
            newest = max(
                (store.latest(src, name) for name in store.series_names(src)),
                key=lambda s: s[0] if s else 0.0,
                default=None,
            )
            age = f"{now - newest[0]:.1f}" if newest else "?"
            out.write(f"{src:<12} {'-':>4} {age:>7} {'-':>6} {'-':>6}\n")
            continue
        t, v = up
        queue = store.latest(src, "healthz_queue_depth")
        slots = store.latest(src, "healthz_active_slots")
        out.write(
            f"{src:<12} {v:>4.0f} {now - t:>7.1f} "
            f"{'-' if queue is None else f'{queue[1]:.0f}':>6} "
            f"{'-' if slots is None else f'{slots[1]:.0f}':>6}\n"
        )


def replica_comparison(
    store: SeriesStore, now: float, window_s: float, out=sys.stdout
) -> None:
    out.write(f"\n== replica comparison (last {window_s:.0f}s, mean) ==\n")
    rows = []
    for src in store.sources():
        cells = {}
        for header, series, scale, fmt in _COMPARE_COLUMNS:
            m = _mean(store.window_values(src, series, window_s, now=now))
            cells[header] = "-" if m is None else fmt.format(m * scale)
            if header == "spec_acc" and m is not None:
                # an 0.2 accept rate is healthy for ngram and a collapse for
                # a model draft — the mode suffix keeps the column comparable
                mode = _mean(
                    store.window_values(src, "spec_mode_model", window_s, now=now)
                )
                if mode is None:
                    mode = _mean(
                        store.window_values(
                            src, "relora_serve_spec_mode_model", window_s, now=now
                        )
                    )
                if mode is not None:
                    cells[header] += ":mdl" if mode >= 0.5 else ":ngm"
        if any(v != "-" for v in cells.values()):
            rows.append((src, cells))
    if not rows:
        out.write("no serving series in window\n")
        return
    headers = [h for h, _, _, _ in _COMPARE_COLUMNS]
    out.write(f"{'source':<12} " + " ".join(f"{h:>12}" for h in headers) + "\n")
    for src, cells in rows:
        out.write(f"{src:<12} " + " ".join(f"{cells[h]:>12}" for h in headers) + "\n")


def slo_status(
    store: SeriesStore, engine: SLOEngine, now: float, out=sys.stdout
) -> None:
    out.write("\n== SLO / error budget ==\n")
    # snapshot the collector's persisted transitions BEFORE evaluating: the
    # fresh pass below records its own events into the (sink-less, in-memory)
    # store, which must not masquerade as run history
    alerts = store.events(kinds=("slo_burn_alert",))
    engine.evaluate(store, now=now)
    status = engine.status()
    if not status["objectives"]:
        out.write("no objectives evaluated (series missing from store)\n")
    else:
        out.write(
            f"{'slo':<14} {'source':<12} {'objective':>9} {'max_burn':>9} {'state':>7}\n"
        )
        for st in status["objectives"]:
            out.write(
                f"{st['slo']:<14} {st['source']:<12} {st['objective']:>9} "
                f"{st['max_burn']:>9} {st['state']:>7}\n"
            )
    # alert history as persisted by the collector — the authoritative record
    # of what actually fired during the run (the pass above only sees burn
    # still visible inside the rebuilt store's windows)
    if alerts:
        out.write(f"\nalert history ({len(alerts)} transitions):\n")
        for a in alerts:
            out.write(
                f"  {a.get('_time', 0):.2f} {a.get('state'):>5} "
                f"{a.get('slo')} source={a.get('_source')} "
                f"burn_long={a.get('burn_long')} burn_short={a.get('burn_short')}\n"
            )


def autoscale_section(
    store: SeriesStore, now: float, window_s: float, out=sys.stdout
) -> None:
    """Replica count plus the autoscaler's decision record.  Quiet (prints
    nothing) on fleets that never ran an autoscaler — the section only
    exists when there is an ``autoscaler`` source or ``autoscale_*`` events
    to show."""
    live = store.latest("autoscaler", "replicas_live")
    counts = store.window_values("autoscaler", "replicas_live", window_s, now=now)
    decisions = [
        e for e in store.events() if str(e.get("_event", "")).startswith("autoscale_")
    ]
    if live is None and not decisions:
        return
    out.write("\n== autoscale ==\n")
    if live is not None:
        lo = min(counts) if counts else live[1]
        hi = max(counts) if counts else live[1]
        out.write(
            f"replicas: {live[1]:.0f} live (age {now - live[0]:.1f}s; "
            f"window min {lo:.0f} / max {hi:.0f})\n"
        )
    ups = sum(1 for e in decisions if e.get("action") == "up")
    downs = sum(1 for e in decisions if e.get("action") == "down")
    out.write(f"decisions: {len(decisions)} recorded ({ups} up, {downs} down)\n")
    for e in decisions:
        detail = {
            k: v
            for k, v in e.items()
            if k not in ("_event", "_source", "_time", "action", "reason")
        }
        out.write(
            f"  {e.get('_time', 0):.2f} {str(e.get('_event')):<24} "
            f"{str(e.get('action', '-')):<5} {str(e.get('reason', '-')):<28}"
            + " ".join(f"{k}={v}" for k, v in sorted(detail.items()))
            + "\n"
        )


def timeline(store: SeriesStore, last: int, out=sys.stdout) -> None:
    events = [
        e
        for e in store.events()
        if e.get("_event", "").startswith(("supervisor_", "deploy_", "autoscale_"))
        or e.get("_event") in _TIMELINE_KINDS
    ]
    events.sort(key=lambda e: e.get("_time", 0.0))
    out.write(f"\n== timeline (last {last} of {len(events)} events) ==\n")
    for e in events[-last:]:
        detail = {
            k: v for k, v in e.items() if k not in ("_event", "_source", "_time")
        }
        out.write(
            f"  {e.get('_time', 0):.2f} {e.get('_event'):<22} "
            f"{str(e.get('_source')):<12} "
            + " ".join(f"{k}={v}" for k, v in detail.items())
            + "\n"
        )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="fleet_series.jsonl written by the FleetCollector")
    ap.add_argument(
        "--join", action="append", default=[], metavar="NAME=PATH",
        help="also ingest a metrics.jsonl under source NAME (e.g. train=...)",
    )
    ap.add_argument("--slo-config", help="JSON SLO config (default: standing objectives)")
    ap.add_argument(
        "--window-s", type=float, default=300.0,
        help="comparison window in seconds (default 300)",
    )
    ap.add_argument(
        "--events", type=int, default=40,
        help="how many trailing timeline events to print (default 40)",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="emit machine-readable JSON instead of the text report",
    )
    args = ap.parse_args(argv)

    store = SeriesStore(max_points=100_000, max_events=100_000)
    n = load_series_jsonl(store, args.path)
    for spec in args.join:
        name, _, path = spec.partition("=")
        if not path:
            ap.error(f"--join expects NAME=PATH, got {spec!r}")
        n += load_series_jsonl(store, path, source=name)
    if n == 0:
        print(f"no records loaded from {args.path}")
        return 1

    # "now" is the newest stamp in the file, not wall clock: the report must
    # give identical answers on a file copied off a dead fleet hours ago
    stamps = [e.get("_time", 0.0) for e in store.events()]
    for src in store.sources():
        for name in store.series_names(src):
            latest = store.latest(src, name)
            if latest is not None:
                stamps.append(latest[0])
    now = max(stamps) if stamps else time.time()

    engine = SLOEngine.from_config(args.slo_config)
    if args.json:
        history = store.events(kinds=("slo_burn_alert",))
        engine.evaluate(store, now=now)
        payload = {
            "loaded_records": n,
            "now": now,
            "sources": store.sources(),
            "slo": engine.status(),
            "alert_history": history,
        }
        json.dump(payload, sys.stdout, indent=2)
        sys.stdout.write("\n")
        return 0

    print(f"fleet report: {args.path}  ({n} records, now={now:.2f})\n")
    fleet_health(store, now)
    replica_comparison(store, now, args.window_s)
    slo_status(store, engine, now)
    autoscale_section(store, now, args.window_s)
    timeline(store, args.events)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
