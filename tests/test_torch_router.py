"""The fleet front end's router and supervisor in the port, held to the JAX
package.

Both packages' front-end modules are stdlib only, so each case drives the
port's class and the reference's on the same inputs:

- ``CircuitBreaker`` on a fake clock, ``backoff_delay`` and
  ``rendezvous_home`` equal to the reference's;
- ``Router._pick`` of both packages over the same replica states makes the
  same picks: least-loaded with rotation, tenant home, role pool with the
  mixed fallback, shard groups, half-open trials;
- over in-process stub replicas (``tests/test_router.py``'s switchable
  ``_FakeReplica``): streams proxied whole with ``X-Relora-Replica`` and
  ``X-Relora-Weights``, a pre-stream failure retried on a sibling, a
  mid-stream death as a typed ``stream_interrupted`` event with no
  ``[DONE]``, the breaker opening on 5xx and closing by probe, 503 with
  ``Retry-After`` when nothing is routable, role counters, ``/fleet/*``
  mounted through ``extra_routes`` — each outcome equal to the reference
  router's over the same stubs;
- ``ReplicaSupervisor`` over stub child processes: crash-loop backoff then
  quarantine, a sequential rolling drain, and a ``peers.json`` equal to the
  reference's for the same roles;
- importing the front-end modules loads neither torch nor jax.

Waits are on state with deadlines, never fixed sleeps.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from relora_tpu.serve import router as jax_router, supervisor as jax_supervisor
from relora_tpu_torch.serve import router, supervisor
from tests.test_router import (
    _DRAINABLE_CHILD,
    _FakeReplica,
    _http,
    _sse_events,
)

pytestmark = [pytest.mark.torch_port, pytest.mark.serve]

WAIT = 30.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (router, supervisor), "jax": (jax_router, jax_supervisor)}


def wait_for(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = cond()
        if value:
            return value
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# -- pure functions ------------------------------------------------------------------------


def test_circuit_breaker_matches_jax_on_a_fake_clock():
    """One script of failures, successes and clock moves: every state,
    failure count, open count and allow() answer equal the reference's."""
    trace = {}
    for name, (rmod, _) in PACKAGES.items():
        now = [0.0]
        br = rmod.CircuitBreaker(failure_threshold=2, cooldown_s=1.0, cooldown_max_s=3.0,
                                 clock=lambda: now[0])
        out = []
        for op in ["f", "f", "allow", "t0.5", "allow", "t1.0", "allow", "allow", "f",
                   "t2.0", "allow", "f", "t4.0", "allow", "s", "allow", "f", "f", "t1.0",
                   "allow", "s"]:
            if op == "f":
                br.record_failure()
            elif op == "s":
                br.record_success()
            elif op == "allow":
                out.append(br.allow())
            else:
                now[0] += float(op[1:])
            out.append((br.state, br.failures, br.opens_total))
        trace[name] = out
    assert trace["port"] == trace["jax"]
    assert ("open", 2, 1) in trace["port"] and ("half_open", 2, 1) in trace["port"]


def test_backoff_delay_and_rendezvous_home_equal_jax():
    for n in range(1, 9):
        for base, cap, jitter, r in ((0.5, 30.0, 0.1, 0.3), (0.02, 0.1, 0.0, 0.9)):
            kw = dict(base_s=base, cap_s=cap, jitter=jitter, rand=lambda: r)
            assert supervisor.backoff_delay(n, **kw) == jax_supervisor.backoff_delay(n, **kw)
    groups = [f"r{i}" for i in range(5)]
    for k in range(40):
        tenant = f"tenant{k}"
        assert router.rendezvous_home(tenant, groups) == jax_router.rendezvous_home(tenant, groups)
        # a departed group moves only its own tenants
        home = router.rendezvous_home(tenant, groups)
        rest = [g for g in groups if g != "r2"]
        if home != "r2":
            assert router.rendezvous_home(tenant, rest) == home
    assert router.rendezvous_home("t", []) is None


# -- the pick, state for state ----------------------------------------------------------------


def _routers(endpoints, states):
    """Both packages' Routers over ``endpoints``, each replica's health set
    from ``states`` {rid: dict(healthy, load, role, breaker)}."""
    out = {}
    for name, (rmod, _) in PACKAGES.items():
        r = rmod.Router(endpoints, classify_threshold=128)
        r._refresh_endpoints()
        for rid, s in states.items():
            st = r.replicas[rid]
            st.healthy = s.get("healthy", True)
            st.health = {"queue_depth": s.get("load", 0), "active_slots": 0,
                         **({"role": s["role"]} if "role" in s else {})}
            for _ in range(s.get("failures", 0)):
                st.breaker.record_failure()
        out[name] = r
    return out


PICKS = {
    "least_loaded": (
        {f"r{i}": ("h", 1000 + i) for i in range(3)},
        {"r0": dict(load=3), "r1": dict(load=1), "r2": dict(load=1)},
        [dict(exclude=set())] * 4 + [dict(exclude={"r1"})] * 2,
    ),
    "tenant_home": (
        {f"r{i}": ("h", 1000 + i) for i in range(4)},
        {f"r{i}": dict(load=i) for i in range(4)},
        [dict(exclude=set(), adapter=f"t{k}") for k in range(8)]
        + [dict(exclude={router.rendezvous_home("t0", [f"r{i}" for i in range(4)])},
                adapter="t0")],
    ),
    "role_pool": (
        {"r0": ("h", 1), "r1": ("h", 2), "r2": ("h", 3), "r3": ("h", 4)},
        {"r0": dict(role="prefill"), "r1": dict(role="decode", load=2),
         "r2": dict(role="mixed"), "r3": dict(role="decode")},
        [dict(exclude=set(), role="prefill"), dict(exclude=set(), role="decode"),
         dict(exclude={"r0"}, role="prefill"), dict(exclude={"r1", "r3"}, role="decode"),
         dict(exclude=set(), role=None)],
    ),
    "mixed_fallback": (
        {"r0": ("h", 1), "r1": ("h", 2), "r2": ("h", 3)},
        {"r0": dict(role="prefill", healthy=False), "r1": dict(role="decode"),
         "r2": dict(role="mixed", load=4)},
        [dict(exclude=set(), role="prefill"), dict(exclude={"r2"}, role="prefill"),
         dict(exclude=set(), role="decode")],
    ),
    "shard_groups": (
        {"r0": ("h", 1, "g0"), "r1": ("h", 2, "g0"), "r2": ("h", 3, "g1"),
         "r3": ("h", 4, "g1"), "r4": ("h", 5)},
        {"r0": dict(load=1), "r1": dict(load=1), "r2": dict(load=0), "r3": dict(healthy=False),
         "r4": dict(load=3)},
        [dict(exclude=set()), dict(exclude={"r0"}), dict(exclude=set(), adapter="tX"),
         dict(exclude={"r0", "r4"})],
    ),
    "half_open": (
        {"r0": ("h", 1), "r1": ("h", 2)},
        {"r0": dict(failures=3), "r1": dict(failures=3, load=1)},
        [dict(exclude=set()), dict(exclude=set())],
    ),
}


@pytest.mark.parametrize("case", sorted(PICKS))
def test_pick_matches_jax(case):
    """The same replica states, the same sequence of picks: least-loaded
    with rotation among ties, tenant affinity by rendezvous over routable
    groups, role pools widening to mixed then anyone, shard groups (routable
    only whole, proxied to the lowest rid, scored by the group's load), and
    the half-open trial when every circuit is open."""
    endpoints, states, calls = PICKS[case]
    routers = _routers(endpoints, states)
    picks = {}
    for name, r in routers.items():
        if case == "half_open":
            for st in r.replicas.values():
                st.breaker._opened_at -= 60.0  # the cooldown has run out
        got = []
        for kw in calls:
            st = r._pick(**kw)
            got.append(None if st is None else st.rid)
        picks[name] = (got, r.stats.snapshot())
    assert picks["port"] == picks["jax"]
    assert any(p is not None for p in picks["port"][0])


# -- live routing over stub replicas ---------------------------------------------------------


class _RoleReplica(_FakeReplica):
    """The reference test's stub replica, with a ``role`` on ``/healthz`` and
    the ``X-Relora-Weights`` header on its streams."""

    def __init__(self, role=None, weights=None, **kw):
        self.role, self.weights = role, weights
        super().__init__(**kw)

    async def _respond_healthz(self, writer):
        if not self.alive or self.role is None:
            return await super()._respond_healthz(writer)
        body = json.dumps({"status": "ok", "queue_depth": self.queue_depth, "active_slots": 0,
                           "role": self.role}).encode()
        writer.write(f"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                     f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode() + body)
        await writer.drain()

    async def _respond_generate(self, writer):
        if self.weights is None or self.mode != "ok":
            return await super()._respond_generate(writer)
        self.gen_hits += 1
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                     + f"X-Relora-Weights: {self.weights}\r\n\r\n".encode())
        final = {"uid": 0, "finish_reason": "length", "tokens": [1]}
        writer.write(f"data: {json.dumps({'uid': 0, 'index': 0, 'token': 1})}\n\n"
                     f"data: {json.dumps(final)}\n\ndata: [DONE]\n\n".encode())
        await writer.drain()


class Harness:
    """A Router of one package over ``endpoints`` on a background thread."""

    def __init__(self, rmod, endpoints, **kw):
        import asyncio
        import threading

        self.router = rmod.Router(endpoints, port=0, **kw)
        self.thread = threading.Thread(target=lambda: asyncio.run(self.router.serve_forever()),
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        assert self.router.started.wait(WAIT), "router failed to start"
        return self.router

    def __exit__(self, *exc):
        self.router.begin_shutdown()
        self.thread.join(WAIT)
        assert not self.thread.is_alive(), "router did not shut down"

    def healthy(self, n):
        wait_for(lambda: sum(st.healthy for st in self.router.replicas.values()) >= n,
                 f"{n} healthy replicas")


def _stubs(n, **kw):
    return [_RoleReplica(**kw) for _ in range(n)]


def _close(stubs):
    for s in stubs:
        s.close()


def run_both(scenario):
    """``scenario(rmod)`` for each package; the outcomes must be equal."""
    out = {name: scenario(rmod) for name, (rmod, _) in PACKAGES.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


def test_streams_proxy_whole_with_replica_and_weights_headers():
    def scenario(rmod):
        a, b = stubs = _stubs(2, weights=7)
        b.queue_depth = 50
        h = Harness(rmod, {"a": ("127.0.0.1", a.port), "b": ("127.0.0.1", b.port)},
                    probe_interval_s=0.05)
        try:
            with h as r:
                h.healthy(2)
                wait_for(lambda: r.replicas["b"].load() >= 50, "b's load")
                status, headers, body = _http(r.port, "POST", "/v1/generate", {"prompt": [1]})
                events = _sse_events(body)
                health = json.loads(_http(r.port, "GET", "/healthz")[2])
                text = _http(r.port, "GET", "/metrics")[2].decode()
                return (status, headers["x-relora-replica"], headers.get("x-relora-weights"),
                        events, health["status"], health["healthy_replicas"],
                        sorted(health["replicas"]), 'relora_router_proxied_total{replica="a"} 1'
                        in text, "relora_router_healthy_replicas 2" in text)
        finally:
            _close(stubs)

    got = run_both(scenario)
    assert got[:3] == (200, "a", "7") and got[3][-1] == "[DONE]"


def test_pre_stream_failure_retries_on_sibling():
    def scenario(rmod):
        a, b = stubs = _stubs(2)
        a.mode, b.queue_depth = "drop", 1
        h = Harness(rmod, {"a": ("127.0.0.1", a.port), "b": ("127.0.0.1", b.port)},
                    probe_interval_s=0.05, retry_backoff_s=0.01)
        try:
            with h as r:
                h.healthy(2)
                wait_for(lambda: r.replicas["b"].load() >= 1, "b's load")
                status, headers, body = _http(r.port, "POST", "/v1/generate", {"prompt": [1]})
                snap = r.stats.snapshot()
                return (status, headers["x-relora-replica"], _sse_events(body)[-1], a.gen_hits,
                        snap.get("retries_total"), snap.get("upstream_failures_total.a"),
                        snap.get("failovers_total.b"))
        finally:
            _close(stubs)

    assert run_both(scenario) == (200, "b", "[DONE]", 1, 1, 1, 1)


def test_midstream_death_is_typed_stream_interrupted_without_done():
    def scenario(rmod):
        a, b = stubs = _stubs(2)
        a.mode, b.queue_depth = "die_midstream", 1
        h = Harness(rmod, {"a": ("127.0.0.1", a.port), "b": ("127.0.0.1", b.port)},
                    probe_interval_s=0.05)
        try:
            with h as r:
                h.healthy(2)
                wait_for(lambda: r.replicas["b"].load() >= 1, "b's load")
                status, headers, body = _http(r.port, "POST", "/v1/generate", {"prompt": [1]})
                events = _sse_events(body)
                return (status, headers["x-relora-replica"], events, b.gen_hits,
                        r.stats.snapshot().get("midstream_errors_total.a"))
        finally:
            _close(stubs)

    status, replica, events, b_hits, errors = run_both(scenario)
    assert "[DONE]" not in events and [e["token"] for e in events[:-1]] == [1, 2]
    assert events[-1]["error"] == {"type": "stream_interrupted", "replica": "a",
                                   "detail": "upstream closed before [DONE]", "retryable": False}
    assert (status, replica, b_hits, errors) == (200, "a", 0, 1)


def test_breaker_opens_on_5xx_and_closes_by_probe():
    def scenario(rmod):
        (a,) = stubs = _stubs(1)
        h = Harness(rmod, {"a": ("127.0.0.1", a.port)}, probe_interval_s=2.0,
                    failure_threshold=2, cooldown_s=30.0, retry_backoff_s=0.01, max_attempts=2)
        try:
            with h as r:
                h.healthy(1)
                a.mode, a.alive = "http500", False
                failed = [_http(r.port, "POST", "/v1/generate", {"prompt": [1]})[0]
                          for _ in range(2)]
                breaker = (r.replicas["a"].breaker.state, r.replicas["a"].breaker.opens_total)
                refused = _http(r.port, "POST", "/v1/generate", {"prompt": [1]})
                a.mode, a.alive = "ok", True
                wait_for(lambda: r.replicas["a"].healthy
                         and r.replicas["a"].breaker.state == "closed", "the probe's close")
                status, headers, body = _http(r.port, "POST", "/v1/generate", {"prompt": [1]})
                return (failed, breaker, refused[0], json.loads(refused[2]), status,
                        headers["x-relora-replica"], _sse_events(body)[-1])
        finally:
            _close(stubs)

    assert run_both(scenario) == ([500, 500], ("open", 1), 503,
                                  {"error": "no healthy replica available"}, 200, "a", "[DONE]")


def test_nothing_routable_answers_503_with_retry_after():
    def scenario(rmod):
        with Harness(rmod, {}, probe_interval_s=0.05) as r:
            status, headers, body = _http(r.port, "POST", "/v1/generate", {"prompt": [1]})
            hz = _http(r.port, "GET", "/healthz")
            return (status, headers.get("retry-after"), json.loads(body), hz[0],
                    json.loads(hz[2])["status"])

    assert run_both(scenario) == (503, "1", {"error": "no healthy replica available"}, 503,
                                  "unavailable")


def test_role_routing_counters_and_mounted_fleet_routes():
    """Requests classified by prompt length land in their role's pool and
    count as ``routed_prefill_total`` / ``routed_decode_total``; paths the
    router does not own go to ``extra_routes`` (the supervisor mounts the
    collector's ``/fleet/*`` there), and 404 when it declines."""
    def mounted(path):
        if path.startswith("/fleet/series"):
            return 200, "application/json", json.dumps({"path": path}).encode()
        return None

    def scenario(rmod):
        p, d = stubs = [_RoleReplica(role="prefill"), _RoleReplica(role="decode")]
        h = Harness(rmod, {"p": ("127.0.0.1", p.port), "d": ("127.0.0.1", d.port)},
                    probe_interval_s=0.05, classify_threshold=8, extra_routes=mounted)
        try:
            with h as r:
                h.healthy(2)
                wait_for(lambda: all(st.health.get("role") for st in r.replicas.values()),
                         "the replicas' roles")
                routed = [_http(r.port, "POST", "/v1/generate", {"prompt": [1] * n})[1][
                    "x-relora-replica"] for n in (3, 8, 20, 7)]
                snap = r.stats.snapshot()
                fleet = _http(r.port, "GET", "/fleet/series?source=r0")
                missing = _http(r.port, "GET", "/fleet/nothing")[0]
                return (routed, snap["routed_prefill_total"], snap["routed_decode_total"],
                        snap["route_fallback_total"], fleet[0], json.loads(fleet[2]), missing)
        finally:
            _close(stubs)

    assert run_both(scenario) == (["d", "p", "p", "d"], 2, 2, 0, 200,
                                  {"path": "/fleet/series?source=r0"}, 404)


# -- the supervisor over stub children ---------------------------------------------------------


def test_supervisor_crash_loop_backoff_then_quarantine(tmp_path):
    """A child that always exits 3 is respawned twice with backoff, then
    quarantined and never respawned; the events equal the reference's."""
    names = {}
    for name, (_, smod) in PACKAGES.items():
        events = []
        sup = smod.ReplicaSupervisor(
            lambda idx, port_file: [sys.executable, "-c", "import sys; sys.exit(3)"], 1,
            str(tmp_path / name), backoff_base_s=0.02, backoff_cap_s=0.1, backoff_jitter=0.0,
            quarantine_after=3, crash_window_s=60.0, poll_interval_s=0.01,
            on_event=lambda e, i, d, _ev=events: _ev.append(e))
        sup.start()
        try:
            wait_for(lambda: sup.status()["r0"]["quarantined"], "quarantine")
            st = sup.status()["r0"]
            assert st["last_exit_code"] == 3 and not st["running"]
            assert sup.endpoints()["r0"] == ("127.0.0.1", None)
        finally:
            sup.stop()
        names[name] = events
    assert names["port"] == names["jax"]
    assert names["port"] == ["spawn", "crash", "respawn", "crash", "respawn", "crash",
                             "quarantine"]


def test_supervisor_rolling_drain_is_sequential(tmp_path):
    """SIGTERM one child at a time, each drained before the next; a clean
    drain exit is no crash."""
    events = []
    stamps = [str(tmp_path / f"term_{i}.ts") for i in range(2)]
    sup = supervisor.ReplicaSupervisor(
        lambda idx, port_file: [sys.executable, "-c", _DRAINABLE_CHILD, stamps[idx], port_file],
        2, str(tmp_path), poll_interval_s=0.02, drain_timeout_s=10.0,
        on_event=lambda e, i, d: events.append((e, i, dict(d))))
    sup.start()
    try:
        wait_for(lambda: all(p is not None for _, p in sup.endpoints().values()), "bound children")
        sup.begin_rolling_drain()
        t0, t1 = (float(open(s).read()) for s in stamps)
        assert t1 - t0 >= 0.25, "the drains overlapped"
        names = [e for e, _, _ in events]
        assert names.count("drain_begin") == 2 and names.count("drain_complete") == 2
        assert "crash" not in names
        assert all(d["exit_code"] == 0 for e, _, d in events if e == "drain_complete")
        assert not any(s["running"] for s in sup.status().values())
    finally:
        sup.stop()


def test_peers_roster_equals_jax_for_the_same_roles(tmp_path):
    """Three bound stub children under roles prefill, decode, mixed: the
    ``peers.json`` each package's supervisor writes is the same document
    (ports aside, which each child binds for itself), and a child that
    dies leaves it until the respawn binds again."""
    rosters = {}
    for name, (_, smod) in PACKAGES.items():
        work = tmp_path / name
        sup = smod.ReplicaSupervisor(
            lambda idx, port_file: [sys.executable, "-c", _DRAINABLE_CHILD,
                                    os.devnull, port_file], 3, str(work),
            poll_interval_s=0.02, roles={0: "prefill", 1: "decode"},
            peer_file=str(work / "peers.json"), backoff_base_s=0.02, backoff_jitter=0.0)
        sup.start()
        try:
            doc = wait_for(lambda: os.path.exists(work / "peers.json") and len(
                json.load(open(work / "peers.json"))["replicas"]) == 3
                and json.load(open(work / "peers.json")), "a full roster")
            assert sup.role_of(2) == "mixed"
            rosters[name] = doc
        finally:
            sup.stop()
    assert rosters["port"] == rosters["jax"]
    assert [(p["rid"], p["role"], p["port"]) for p in rosters["port"]["replicas"]] == [
        ("r0", "prefill", 1), ("r1", "decode", 1), ("r2", "mixed", 1)]


def test_front_end_modules_import_without_torch_or_jax():
    """The supervisor's process stays torch-free (and jax-free): importing
    every front-end module, the package included, loads neither, and both
    CLIs answer ``--help``."""
    code = ("import sys\n"
            "import relora_tpu_torch.serve.supervisor, relora_tpu_torch.serve.router\n"
            "import relora_tpu_torch.serve.autoscale, relora_tpu_torch.obs.fleet\n"
            "import relora_tpu_torch.obs.slo, relora_tpu_torch.serve.deploy\n"
            "bad = [m for m in ('torch', 'jax', 'numpy') if m in sys.modules]\n"
            "bad += [m for m in sys.modules if m.startswith('relora_tpu.')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)
    for module in ("relora_tpu_torch.serve.supervisor", "relora_tpu_torch.obs.fleet"):
        out = subprocess.run([sys.executable, "-m", module, "--help"], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and "usage:" in out.stdout, out.stderr
