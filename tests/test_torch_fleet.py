"""The fleet observability plane in the port, held to the JAX package.

The collector, its store, the SLO engine and the prefix directory are
stdlib code in both packages, so each case feeds the port's and the
reference's the same inputs:

- ``parse_prometheus`` of the port server's own ``/metrics`` text (a real
  server on loopback after a few requests) equals the reference's parse,
  and ``histogram_quantile`` equals the reference's and the in-process
  histogram's;
- ``SeriesStore`` retention, queries, persistence with rotation and the
  torn-tail reader, record for record;
- ``FleetCollector`` over scriptable ``/healthz`` + ``/metrics`` stubs
  (``tests/test_fleet.py``'s ``_ScrapeTarget``): the derived series,
  health-flip events, the trainer JSONL tail, the ``/fleet/*`` payloads and
  the prefix directory fed from ``prefix_digests``, equal to the
  reference collector's over the same stubs;
- SLO burn alerts fire and clear at the same samples as the reference's,
  and the anomaly path fires where the port's ``LossSpikeDetector`` fires;
- ``PrefixPageDirectory`` answers as the reference's to one script of
  updates, drops and lookups; the standalone CLI scrapes and prints.
"""

import json
import os
import subprocess
import sys

import pytest

from relora_tpu.obs import fleet as jax_fleet, slo as jax_slo
from relora_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from relora_tpu.serve import disagg as jax_disagg
from relora_tpu_torch.obs import fleet, slo
from relora_tpu_torch.obs.metrics import MetricsRegistry
from relora_tpu_torch.serve import disagg
from tests.test_fleet import _ScrapeTarget
from tests.test_torch_server import Served, generate, metrics_text, pair, scheduler  # noqa: F401

pytestmark = [pytest.mark.torch_port, pytest.mark.fleet]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = {"port": (fleet, slo), "jax": (jax_fleet, jax_slo)}


# -- exposition parsing ------------------------------------------------------------------------


def test_parse_prometheus_of_the_port_servers_metrics(pair):  # noqa: F811
    """A real port server's ``/metrics`` after three requests: both parsers
    read the same flat samples and histograms, the TTFT histogram counts the
    three first tokens, and its p50/p95 equal the server's own histogram's."""
    with Served(scheduler(pair[1])) as server:
        for n in (3, 5, 4):
            generate(server.port, {"prompt": [5, 6, 7], "max_new_tokens": n})
        text = metrics_text(server.port)
        own = server.stats.histogram("ttft_seconds")
    flat, hists = fleet.parse_prometheus(text)
    assert (flat, hists) == jax_fleet.parse_prometheus(text)
    assert flat["relora_serve_requests_finished_total.length"] == 3.0
    assert flat["relora_serve_tokens_generated_total"] == 12.0
    ttft = hists["relora_serve_ttft_seconds"]
    assert ttft["count"] == 3 and ttft["buckets"][-1] == (float("inf"), 3.0)
    for q in (0.5, 0.95):
        assert fleet.histogram_quantile(ttft["buckets"], q) == own.quantile(q)


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.95, 0.99, 1.0])
def test_histogram_quantile_equals_jax(q):
    regs = [MetricsRegistry(namespace="x"), JaxRegistry(namespace="x")]
    for reg in regs:
        for v in (0.001, 0.004, 0.004, 0.02, 0.09, 0.3, 1.7, 12.0, 80.0):
            reg.observe("lat", v)
    texts = [reg.render() for reg in regs]
    assert texts[0] == texts[1]
    buckets = fleet.parse_prometheus(texts[0])[1]["x_lat"]["buckets"]
    got = fleet.histogram_quantile(buckets, q)
    assert got == jax_fleet.histogram_quantile(buckets, q) == regs[0].histogram("lat").quantile(q)
    assert fleet.histogram_quantile([], q) == 0.0


# -- the series store -----------------------------------------------------------------------


def test_series_store_retention_and_queries_equal_jax():
    stores = [mod.SeriesStore(max_points=4) for mod, _ in BOTH.values()]
    for store in stores:
        for i in range(10):
            store.add_samples("r0", {"up": float(i), "q": 2.0 * i}, t=100.0 + i, persist=False)
        store.add_samples("r1", {"up": 1.0, "bad": "x"}, t=105.0, persist=False)
        store.add_event("health_flip", "r1", t=106.0, persist=False, frm="ok", to="stuck")
    views = [(s.samples("r0", "up"), s.latest("r0", "q"), s.window_values("r0", "up", 2.5, now=109.0),
              s.sources(), s.series_names("r1"), s.events(kinds=("health_flip",)),
              s.samples("r0", "q", since=108.0)) for s in stores]
    assert views[0] == views[1]
    assert [v for _, v in views[0][0]] == [6.0, 7.0, 8.0, 9.0]
    assert views[0][2] == [7.0, 8.0, 9.0] and views[0][4] == ["up"]


def test_series_store_rotation_and_torn_tail_equal_jax(tmp_path):
    """Each package persists the same records (the trainer's schema plus
    ``_source``), rotates at the byte cap, and reads back everything but a
    torn last line, the rotated file first."""
    loaded = {}
    for name, (mod, _) in BOTH.items():
        path = str(tmp_path / f"{name}.jsonl")
        store = mod.SeriesStore(persist_path=path, persist_max_bytes=400)
        for i in range(12):
            store.add_samples("r0", {"up": 1.0, "queue": float(i)}, t=1000.0 + i)
        store.add_event("health_flip", "r0", t=1012.0, frm="ok", to="stuck")
        store.close()
        assert os.path.exists(path + ".1")
        with open(path, "a") as fh:
            fh.write('{"up": 1.0, "_source": "r0", "_ti')
        fresh = mod.SeriesStore()
        n = mod.load_series_jsonl(fresh, path)
        with open(path + ".1") as a, open(path) as b:
            lines = a.read() + b.read()
        loaded[name] = (n, fresh.samples("r0", "queue"), fresh.events(), lines)
    assert loaded["port"] == loaded["jax"]
    assert loaded["port"][0] == 13 and len(loaded["port"][1]) == 12


# -- the collector over stubs -----------------------------------------------------------------


def serve_text(registry_cls, finished_length=0, finished_error=0, ttfts=(), migration_fail=0):
    reg = registry_cls(namespace="relora_serve")
    if finished_length:
        reg.inc("requests_finished_total", ("reason", "length"), by=finished_length)
    if finished_error:
        reg.inc("requests_finished_total", ("reason", "error"), by=finished_error)
    reg.inc("migration_failures_total", by=migration_fail)
    for v in ttfts:
        reg.observe("ttft_seconds", v)
    return reg.render()


def store_view(store):
    return ({src: {n: store.samples(src, n) for n in store.series_names(src)}
             for src in store.sources()}, store.events())


def test_collector_derives_series_and_flips_as_jax(tmp_path):
    """Two scripted replicas and an unbound one over three rounds: gauges,
    ``_per_s`` rates, ``error_rate``, recent-window p50/p95, ``up``, a
    health flip, a ``migration_failed`` event: the port's store equals the
    reference collector's over the same stubs and clocks, and so do the
    ``/fleet/series`` and ``/fleet/metrics`` payloads."""
    a, b = _ScrapeTarget(), _ScrapeTarget()
    try:
        eps = {"r0": ("127.0.0.1", a.port), "r1": ("127.0.0.1", b.port), "r2": ("127.0.0.1", None)}
        colls = {name: mod.FleetCollector(lambda: eps, persist_path=str(tmp_path / f"{name}.jsonl"))
                 for name, (mod, _) in BOTH.items()}
        rounds = [
            (dict(finished_length=10, ttfts=(0.004,) * 5), True),
            (dict(finished_length=20, finished_error=2, ttfts=(0.004,) * 5 + (0.3,) * 3,
                  migration_fail=1), False),
            (dict(finished_length=20, finished_error=2, ttfts=(0.004,) * 5 + (0.3,) * 3,
                  migration_fail=1), True),
        ]
        ups = {name: [] for name in colls}
        for i, (kw, b_healthy) in enumerate(rounds):
            a.metrics_text = serve_text(MetricsRegistry, **kw)
            b.metrics_text = serve_text(MetricsRegistry, finished_length=5)
            b.healthy = b_healthy
            for name, coll in colls.items():
                ups[name].append(coll.scrape_once(now=1000.0 + 2 * i))
        views = {name: store_view(c.store) for name, c in colls.items()}
        assert views["port"] == views["jax"] and ups["port"] == ups["jax"]
        series, events = views["port"]
        assert series["r0"]["relora_serve_requests_finished_total.length_per_s"][0][1] == 5.0
        assert series["r0"]["error_rate"][1][1] == pytest.approx(2.0 / 12.0)
        assert [v for _, v in series["r0"]["relora_serve_ttft_seconds_p95"]] == [0.005, 0.5]
        assert [v for _, v in series["r2"]["up"]] == [0.0, 0.0, 0.0]
        assert [(e["_event"], e["_source"]) for e in events] == [
            ("migration_failed", "r0"), ("health_flip", "r1"), ("health_flip", "r1")]
        for path in ("/fleet/series?source=r0&last=2", "/fleet/metrics"):
            got = [c.handle_fleet_route(path) for c in colls.values()]
            assert got[0][:2] == got[1][:2] == ((200, "application/json") if "series" in path
                                                 else (200, "text/plain; version=0.0.4"))
            if "series" in path:
                assert json.loads(got[0][2]) == json.loads(got[1][2])
        assert colls["port"].handle_fleet_route("/nope") is None
        for c in colls.values():
            c.stop()
    finally:
        a.close()
        b.close()


def test_collector_tails_trainer_jsonl_and_records_supervisor_events(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    with open(path, "w") as fh:
        fh.write(json.dumps({"loss": 2.5, "mfu": 0.31, "_step": 1, "_time": 50.0}) + "\n")
        fh.write('{"loss": 2.4, "_step": 2')
    colls = {name: mod.FleetCollector(lambda: {}, jsonl_sources={"train": path})
             for name, (mod, _) in BOTH.items()}
    for c in colls.values():
        c.scrape_once(now=1000.0)
    with open(path, "a") as fh:
        fh.write(', "_time": 51.0}\n')
    for c in colls.values():
        c.scrape_once(now=1001.0)
        c.record_supervisor_event("respawn", 1, "{'pid': 7}")
        c.record_supervisor_event("deploy_begin", None, "{}")
        c.record_supervisor_event("autoscale_up", "r3", "{}")
    views = {name: (c.store.samples("train", "loss"), c.store.latest("train", "mfu"),
                    [(e["_event"], e["_source"], e["detail"]) for e in c.store.events()])
             for name, c in colls.items()}
    assert views["port"] == views["jax"]
    assert views["port"][0] == [(50.0, 2.5), (51.0, 2.4)]
    assert [e[:2] for e in views["port"][2]] == [("supervisor_respawn", "r1"),
                                                  ("deploy_begin", "supervisor"),
                                                  ("autoscale_up", "r3")]


def test_collector_feeds_the_prefix_directory_from_prefix_digests():
    """A replica's advertised ``prefix_digests`` land in the directory; a
    lookup through ``/fleet/prefix`` names its holder (never the asker,
    ``exclude``); a replica that goes down leaves the directory; both
    packages answer alike."""
    a, b = _ScrapeTarget(), _ScrapeTarget()
    try:
        a.health_payload = {"status": "ok", "queue_depth": 0, "active_slots": 0,
                            "prefix_digests": ["aa11", "bb22"]}
        b.health_payload = {"status": "ok", "queue_depth": 0, "active_slots": 0,
                            "prefix_digests": ["cc33"]}
        eps = {"r0": ("127.0.0.1", a.port), "r1": ("127.0.0.1", b.port)}
        colls = {name: mod.FleetCollector(lambda: eps) for name, (mod, _) in BOTH.items()}
        answers = {name: [] for name in colls}
        for step in range(3):
            if step == 1:
                a.health_payload = dict(a.health_payload, prefix_digests=["bb22", "dd44"])
            if step == 2:
                b.healthy = False
            for name, c in colls.items():
                c.scrape_once(now=1000.0 + step)
                for query in ("d=zz,aa11,bb22", "d=cc33", "d=bb22&exclude=r0", "d=dd44,cc33",
                              "d="):
                    status, _, body = c.handle_fleet_route(f"/fleet/prefix?{query}")
                    answers[name].append((status, json.loads(body)))
                answers[name].append(c.directory.stats())
        assert answers["port"] == answers["jax"]
        port_answers = answers["port"]
        assert port_answers[0] == (200, {"digest": "aa11", "replica": "r0", "host": "127.0.0.1",
                                         "port": a.port})
        assert port_answers[2][0] == 404  # only r0 holds bb22, and r0 asked
        # (six answers a round) r0 stopped advertising aa11: the lookup walks on to bb22
        assert port_answers[6][1]["digest"] == "bb22"
        assert port_answers[7][1]["replica"] == "r1" and port_answers[13][0] == 404  # r1 down
        assert port_answers[15][1]["digest"] == "dd44"
    finally:
        a.close()
        b.close()


def test_prefix_page_directory_equals_jax():
    dirs = [disagg.PrefixPageDirectory(max_entries=4), jax_disagg.PrefixPageDirectory(max_entries=4)]
    trace = [[], []]
    script = [
        ("update", "r0", ["a", "b", "c"]), ("lookup", ["x", "b", "a"], None),
        ("update", "r1", ["c", "d"]), ("lookup", ["c"], "r1"), ("lookup", ["c"], None),
        ("update", "r0", ["a", "e"]), ("lookup", ["b", "e"], None), ("update", "r2", ["f"]),
        ("lookup", ["a", "c", "d", "f"], "r2"), ("drop", "r1"), ("lookup", ["d", "c"], None),
        ("update", "r1", []), ("lookup", ["f"], "r0"),
    ]
    for d, out in zip(dirs, trace):
        for op in script:
            if op[0] == "update":
                d.update(op[1], "127.0.0.1", 9000 + int(op[1][1]), op[2])
            elif op[0] == "drop":
                d.drop_replica(op[1])
            else:
                out.append(d.lookup(op[1], exclude_rid=op[2]))
            out.append((len(d), d.stats()))
    assert trace[0] == trace[1]
    assert trace[0][1] == ("b", "r0", "127.0.0.1", 9000)
    with pytest.raises(ValueError):
        disagg.PrefixPageDirectory(max_entries=0)


# -- the SLO engine ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["outage", "flap", "two_sources"])
def test_slo_burn_alerts_fire_and_clear_as_jax(shape):
    """One availability series per shape through both engines: the same
    transitions at the same samples, the same stored events and status."""
    out = {}
    for name, (fmod, smod) in BOTH.items():
        store = fmod.SeriesStore()
        engine = smod.SLOEngine([smod.SLO(name="availability", series="up", threshold=1.0,
                                          bad_when="lt", objective=0.9,
                                          windows=((30.0, 5.0, 2.0), (60.0, 10.0, 1.0)))])
        transitions = []
        for i in range(90):
            t = 1000.0 + i
            if shape == "outage":
                ups = {"r0": 0.0 if 20 <= i < 35 else 1.0}
            elif shape == "flap":
                ups = {"r0": float(i % 3 != 0 or i > 60)}
            else:
                ups = {"r0": 0.0 if 10 <= i < 30 else 1.0, "r1": 0.0 if i >= 50 else 1.0}
            for src, up in ups.items():
                store.add_samples(src, {"up": up}, t=t, persist=False)
            for tr in engine.evaluate(store, now=t):
                transitions.append((i, tr["source"], tr["state"], tr["max_burn"]))
        status = engine.status()
        out[name] = (transitions, store.events(), status["objectives"], status["history"],
                     [a.key() for a in engine.active_alerts()])
    assert out["port"] == out["jax"]
    assert out["port"][0], "no alert fired"


def test_slo_anomaly_fires_where_the_ports_loss_spike_detector_fires():
    from relora_tpu_torch.train.resilience import LossSpikeDetector

    series = [2.0 + 0.01 * (i % 5) for i in range(40)] + [9.0] * 4
    det = LossSpikeDetector(threshold=4.0, window=16, min_history=8, patience=3)
    direct = next(i for i, v in enumerate(series) if det.update(i, v) is not None)
    fired_at = {}
    for name, (fmod, smod) in BOTH.items():
        store = fmod.SeriesStore()
        engine = smod.SLOEngine([], anomalies=[smod.AnomalySpec(
            series="loss", source="train", threshold=4.0, window=16, min_history=8, patience=3)])
        for i, v in enumerate(series):
            store.add_samples("train", {"loss": v}, t=1000.0 + i, persist=False)
            if engine.evaluate(store, now=1000.0 + i) and name not in fired_at:
                fired_at[name] = (i, store.events(kinds=("series_anomaly",)))
    assert fired_at["port"] == fired_at["jax"]
    assert fired_at["port"][0] == direct


def test_default_slos_and_config_equal_jax(tmp_path):
    cfg = tmp_path / "slo.json"
    cfg.write_text(json.dumps({
        "window_scale": 0.01,
        "slos": [{"name": "ttft", "series": "relora_serve_ttft_seconds_p95", "threshold": 1.5},
                 {"name": "up", "series": "up", "threshold": 1.0, "bad_when": "lt",
                  "windows": [[60, 5, 10.0]]}],
        "anomalies": [{"series": "loss", "threshold": 4.0, "direction": "high"}],
    }))
    for got, want in ((slo.default_slos(0.5), jax_slo.default_slos(0.5)),
                      (slo.load_slo_config(str(cfg))[0], jax_slo.load_slo_config(str(cfg))[0]),
                      (slo.load_slo_config(str(cfg))[1], jax_slo.load_slo_config(str(cfg))[1])):
        assert [vars(x) for x in got] == [vars(x) for x in want]
    assert [s.name for s in slo.SLOEngine.from_config(None).slos] == [
        "availability", "ttft_p95", "tpot_p95", "error_rate", "mfu_floor"]
    with pytest.raises(ValueError):
        slo.SLO(name="x", series="up", threshold=1.0, bad_when="eq")


def test_standalone_collector_cli_scrapes_and_prints(tmp_path):
    """``python -m relora_tpu_torch.obs.fleet --target r0=HOST:PORT --rounds
    2`` scrapes a stub twice, persists the rounds and prints the
    ``/fleet/series`` payload with the SLO status."""
    a = _ScrapeTarget()
    try:
        a.metrics_text = serve_text(MetricsRegistry, finished_length=3)
        persist = tmp_path / "series.jsonl"
        out = subprocess.run(
            [sys.executable, "-m", "relora_tpu_torch.obs.fleet", "--target",
             f"r0=127.0.0.1:{a.port}", "--rounds", "2", "--cadence-s", "0.05",
             "--persist", str(persist)],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        payload = json.loads(out.stdout)
        assert [v for _, v in payload["sources"]["r0"]["up"]] == [1.0, 1.0]
        assert "objectives" in payload["slo"]
        assert len(persist.read_text().splitlines()) == 2
    finally:
        a.close()
