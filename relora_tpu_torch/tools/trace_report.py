"""Render span traces: tree view, per-phase percentages, p50/p95 tables.

Reads either a flight-recorder dump (``flight_<reason>_<pid>.json``, written
by ``relora_tpu_torch.obs.flight.dump_on_fault``) or a JSONL span stream (one span
dict per line — the trainer's ``RELORA_TPU_TRACE_DIR`` sink).  Prints:

1. a span tree per trace (``--trace`` selects one; default: the few most
   recent), children indented under parents, with duration and the share of
   the root span's wall time;
2. a phase summary across ALL loaded spans: count, total seconds, p50/p95,
   and percentage of the total traced time per span name.

``--chrome OUT.json`` additionally exports everything as Chrome trace-event
JSON — open in chrome://tracing or https://ui.perfetto.dev, where it overlays
with the torch.profiler traces StepProfiler writes.

    python -m relora_tpu_torch.tools.trace_report ckpts/flight_sigterm_1234.json
    python -m relora_tpu_torch.tools.trace_report traces/train_spans.jsonl --trace a1b2c3
    python -m relora_tpu_torch.tools.trace_report router_spans_1.jsonl serve_spans_2.jsonl
    python -m relora_tpu_torch.tools.trace_report dump.json --chrome /tmp/trace.json

The port's copy of ``tools/trace_report.py``, over the port's
``obs/tracer.py``: it reads the port's span streams (the router's
``router_spans_<pid>.jsonl``, a server's or the trainer's under
``RELORA_TPU_TRACE_DIR``) and the port's flight dumps.  Imports no torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from relora_tpu_torch.obs.tracer import chrome_trace_events


def load(path: str) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]], Dict[str, Any]]:
    """Return (spans, events, header) from a flight dump or a JSONL stream."""
    if path.endswith(".jsonl"):
        spans: List[Dict[str, Any]] = []
        events: List[Dict[str, Any]] = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail line from a killed writer
                # instant events share the stream, flagged with _event
                if record.pop("_event", None):
                    events.append(record)
                else:
                    spans.append(record)
        return spans, events, {"source": "jsonl"}
    with open(path) as fh:
        payload = json.load(fh)
    header = {k: v for k, v in payload.items() if k not in ("spans", "events")}
    return payload.get("spans", []), payload.get("events", []), header


def merge_streams(
    streams: List[Tuple[str, List[Dict[str, Any]], List[Dict[str, Any]]]],
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """Join span streams from different processes into one timeline.

    Each process numbers its spans independently ("s000001" collides across
    files), so span/parent ids get a per-stream prefix — parent links stay
    intra-process, while the shared ``trace_id`` (the router's X-Request-Id)
    joins the trees.  Timestamps are per-process *monotonic* clocks with
    unrelated origins; spans recorded since ``t_wall`` exists are shifted
    onto the wall clock so router and replica phases interleave correctly.
    Every span/event is tagged with ``_pid`` (stream index + 1) and
    ``_stream`` (stream name) for the Chrome export's per-process grouping.
    """
    merged_spans: List[Dict[str, Any]] = []
    merged_events: List[Dict[str, Any]] = []
    for i, (name, spans, events) in enumerate(streams):
        prefix = f"p{i}:"
        for s in spans:
            s = dict(s)
            if s.get("span_id"):
                s["span_id"] = prefix + str(s["span_id"])
            if s.get("parent_id"):
                s["parent_id"] = prefix + str(s["parent_id"])
            t_wall = s.get("t_wall")
            if isinstance(t_wall, (int, float)) and s.get("t_start") is not None:
                shift = t_wall - s["t_start"]
                s["t_start"] = t_wall
                if s.get("t_end") is not None:
                    s["t_end"] = s["t_end"] + shift
            s["_pid"], s["_stream"] = i + 1, name
            merged_spans.append(s)
        for e in events:
            e = dict(e)
            if e.get("parent_id"):
                e["parent_id"] = prefix + str(e["parent_id"])
            if isinstance(e.get("t_wall"), (int, float)):
                e["t"] = e["t_wall"]
            e["_pid"], e["_stream"] = i + 1, name
            merged_events.append(e)
    # re-zero at the earliest stamp: wall-epoch microseconds confuse trace
    # viewers and make the tree's ms column unreadable
    t0 = min(
        [s["t_start"] for s in merged_spans if s.get("t_start") is not None]
        + [e["t"] for e in merged_events if e.get("t") is not None]
        or [0.0]
    )
    for s in merged_spans:
        if s.get("t_start") is not None:
            s["t_start"] -= t0
        if s.get("t_end") is not None:
            s["t_end"] -= t0
    for e in merged_events:
        if e.get("t") is not None:
            e["t"] -= t0
    merged_spans.sort(key=lambda s: s.get("t_start") or 0.0)
    merged_events.sort(key=lambda e: e.get("t") or 0.0)
    return merged_spans, merged_events


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over raw durations (exact, not bucketed)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _fmt_attrs(attrs: Dict[str, Any], limit: int = 4) -> str:
    if not attrs:
        return ""
    items = list(attrs.items())[:limit]
    body = " ".join(f"{k}={v}" for k, v in items)
    more = "" if len(attrs) <= limit else " …"
    return f"  [{body}{more}]"


def print_tree(spans: List[Dict[str, Any]], trace_id: str, out=sys.stdout) -> None:
    trace = [s for s in spans if s.get("trace_id") == trace_id]
    by_id = {s["span_id"]: s for s in trace}
    children: Dict[Optional[str], List[Dict[str, Any]]] = {}
    for s in trace:
        parent = s.get("parent_id")
        # a parent evicted from the ring buffer orphans its children: show
        # them at the root rather than dropping them
        if parent not in by_id:
            parent = None
        children.setdefault(parent, []).append(s)
    for group in children.values():
        group.sort(key=lambda s: s.get("t_start") or 0.0)
    roots = children.get(None, [])
    total = sum(s.get("dur_s") or 0.0 for s in roots) or None
    # a cross-process trace (router + replica joined on one request id)
    # qualifies span names with their service so the tree reads as a hop
    # sequence; single-service traces render exactly as before
    services = {s.get("service") for s in trace if s.get("service")}
    qualify = len(services) > 1
    out.write(f"trace {trace_id}  ({len(trace)} spans)\n")

    def walk(span: Dict[str, Any], depth: int) -> None:
        dur = span.get("dur_s")
        dur_txt = "open" if dur is None else f"{dur * 1e3:.2f} ms"
        pct = ""
        if total and dur is not None:
            pct = f"  {100.0 * dur / total:5.1f}%"
        name = span.get("name", "?")
        if qualify:
            name = f"{span.get('service', '?')}/{name}"
        out.write(
            f"  {'  ' * depth}{name}  {dur_txt}{pct}"
            f"{_fmt_attrs(span.get('attrs') or {})}\n"
        )
        for child in children.get(span["span_id"], []):
            walk(child, depth + 1)

    for root in roots:
        walk(root, 0)


def phase_summary(spans: List[Dict[str, Any]], out=sys.stdout) -> None:
    by_name: Dict[str, List[float]] = {}
    for s in spans:
        dur = s.get("dur_s")
        if dur is not None:
            by_name.setdefault(s.get("name", "?"), []).append(dur)
    if not by_name:
        out.write("no finished spans\n")
        return
    # % is of the summed time across all phases — sibling phases of one step
    # roughly partition it, so the column reads as "where did the time go"
    grand_total = sum(sum(v) for v in by_name.values())
    out.write(
        f"\n{'phase':<20} {'count':>6} {'total_s':>9} {'p50_ms':>9} "
        f"{'p95_ms':>9} {'share':>7}\n"
    )
    for name, vals in sorted(by_name.items(), key=lambda kv: -sum(kv[1])):
        vals.sort()
        total = sum(vals)
        out.write(
            f"{name:<20} {len(vals):>6} {total:>9.3f} "
            f"{percentile(vals, 0.50) * 1e3:>9.2f} "
            f"{percentile(vals, 0.95) * 1e3:>9.2f} "
            f"{100.0 * total / grand_total:>6.1f}%\n"
        )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "paths", nargs="+", metavar="path",
        help="flight_*.json dumps and/or *.jsonl span streams; several paths "
        "are merged into one timeline joined on shared trace ids "
        "(e.g. router_spans_*.jsonl + serve_spans_*.jsonl)",
    )
    ap.add_argument("--trace", help="render only this trace id")
    ap.add_argument(
        "--max-traces", type=int, default=3,
        help="without --trace: how many of the most recent traces to render",
    )
    ap.add_argument("--chrome", help="also export Chrome trace-event JSON here")
    args = ap.parse_args(argv)

    if len(args.paths) == 1:
        spans, events, header = load(args.paths[0])
        if header.get("reason"):
            sys.stdout.write(
                f"flight dump: reason={header['reason']} pid={header.get('pid')} "
                f"dropped_spans={header.get('dropped_spans', 0)}\n\n"
            )
    else:
        streams = []
        for path in args.paths:
            s, e, _ = load(path)
            streams.append((Path(path).name, s, e))
        spans, events = merge_streams(streams)
        sys.stdout.write(
            f"merged {len(args.paths)} streams: "
            + " ".join(name for name, _, _ in streams) + "\n\n"
        )
    if not spans and not events:
        print("empty trace")
        return 1

    if args.trace:
        trace_ids = [args.trace]
    else:
        seen: List[str] = []  # insertion order == recording order
        for s in spans:
            tid = s.get("trace_id")
            if tid and tid not in seen:
                seen.append(tid)
        trace_ids = seen[-args.max_traces:]
    for tid in trace_ids:
        print_tree(spans, tid)
    phase_summary(spans)

    if args.chrome:
        if len(args.paths) == 1:
            trace_events = chrome_trace_events(spans, events)
        else:
            # one Chrome process per source stream, labelled with the file
            # it came from, so Perfetto shows router and replicas as
            # separate swim lanes on the shared wall-clock axis
            trace_events = []
            for i, (name, _, _) in enumerate(streams):
                pid = i + 1
                trace_events.extend(
                    chrome_trace_events(
                        [s for s in spans if s.get("_pid") == pid],
                        [e for e in events if e.get("_pid") == pid],
                        pid=pid,
                    )
                )
                trace_events.append(
                    {"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": name}}
                )
        with open(args.chrome, "w") as fh:
            json.dump({"traceEvents": trace_events}, fh)
        print(f"\nchrome trace written to {args.chrome}")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # downstream closed early (e.g. `| head`, `| grep -q`): not an error.
        # Point stdout at devnull so the interpreter's exit-time flush of the
        # dead pipe can't raise a second time.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
