"""SLO-driven elastic scaling in the port, held to the JAX package.

- ``AutoscalerPolicy`` of both packages over the same SeriesStore feeds
  makes the same decisions, reasons and metrics: a sustained burn (queue
  depth, TTFT p95, slot utilization), one hot replica, a brief spike, the
  replica ceiling, idle scale-down and its floor, the cooldown;
- the executor (``Autoscaler``) acts on scripted decisions as the
  reference's does, records the same ``autoscale_decision`` events and
  ``replicas_live`` samples, and holds a scale-up while a replica is
  warming (``up == 0``), whether the store says so or a real port server
  answering ``/healthz`` 503 "warming" does, through the collector;
- the port's supervisor scales up and down over stub children (indices
  never reused, the last replica never drained, a clean drain no crash),
  and a rolling drain cancels a scale-up asked for while it runs.

Stub children bind a port file once their SIGTERM handler is installed;
waits are on that state, never fixed sleeps.
"""

import sys
import threading
import time

import pytest

from relora_tpu.obs.fleet import SeriesStore as JaxStore
from relora_tpu.serve import autoscale as jax_autoscale
from relora_tpu_torch.obs.fleet import FleetCollector, SeriesStore
from relora_tpu_torch.serve import autoscale
from relora_tpu_torch.serve.autoscale import (
    ACTIVE_SLOTS_SERIES,
    MAX_BATCH_SERIES,
    QUEUE_DEPTH_SERIES,
    TTFT_P95_SERIES,
    UP_SERIES,
    Autoscaler,
    Decision,
)
from relora_tpu_torch.serve.supervisor import ReplicaSupervisor
from tests.test_torch_server import Served, pair, scheduler  # noqa: F401

pytestmark = [pytest.mark.torch_port, pytest.mark.autoscale]

T0 = 1_000_000.0
WAIT = 30.0

#: a replica stand-in: installs its SIGTERM handler, then writes the port
#: file the supervisor appended (``--port 0 --port-file F``), and sleeps
CHILD = [sys.executable, "-c",
         "import signal, sys, time\n"
         "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
         "open(sys.argv[sys.argv.index('--port-file') + 1], 'w').write('1')\n"
         "time.sleep(600)\n"]


def wait_for(cond, what):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        value = cond()
        if value:
            return value
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def feed(store, source, series, values, t0=T0, dt=1.0):
    for i, v in enumerate(values):
        store.add_sample(source, series, float(v), t=t0 + i * dt)


BURN = [8, 9, 8, 10, 8]
IDLE = [0] * 10

#: scenario -> (feeds [(source, series, values, t0)], policy kwargs,
#:              decide calls [(sources, n_live, now)], note_scaled times)
SCENARIOS = {
    "sustained_queue_burn": (
        [(r, QUEUE_DEPTH_SERIES, BURN, T0) for r in ("r0", "r1")], {},
        [(["r0", "r1"], 2, T0 + 4)], []),
    "one_hot_replica": (
        [("r0", QUEUE_DEPTH_SERIES, BURN, T0), ("r1", QUEUE_DEPTH_SERIES, [0] * 5, T0)], {},
        [(["r0", "r1"], 2, T0 + 4)], []),
    "brief_spike": (
        [("r0", QUEUE_DEPTH_SERIES, [0, 0, 0, 9, 9], T0), ("r1", QUEUE_DEPTH_SERIES, [9, 9],
                                                            T0 + 3)], {},
        [(["r0"], 1, T0 + 4), (["r1"], 1, T0 + 4)], []),
    "ttft_and_slot_util": (
        [("r0", TTFT_P95_SERIES, [3.0, 2.5, 4.0, 3.2, 2.9], T0),
         ("r1", ACTIVE_SLOTS_SERIES, [4] * 5, T0), ("r1", MAX_BATCH_SERIES, [4] * 5, T0)],
        dict(ttft_p95_target_s=2.0, slot_util_high=0.9),
        [(["r0"], 1, T0 + 4), (["r1"], 1, T0 + 4), (["r0", "r1"], 2, T0 + 4)], []),
    "max_replicas": (
        [(r, QUEUE_DEPTH_SERIES, BURN, T0) for r in ("r0", "r1")], dict(max_replicas=2),
        [(["r0", "r1"], 2, T0 + 4), (["r0", "r1"], 1, T0 + 4)], []),
    "idle_scale_down": (
        [(r, s, v, T0) for r in ("r0", "r1") for s, v in
         ((QUEUE_DEPTH_SERIES, IDLE), (ACTIVE_SLOTS_SERIES, IDLE), (MAX_BATCH_SERIES, [4] * 10))]
        + [("r2", QUEUE_DEPTH_SERIES, IDLE[:5] + [2] + IDLE[:4], T0)], {},
        [(["r0", "r1"], 2, T0 + 9), (["r0", "r1"], 1, T0 + 9), (["r0", "r1", "r2"], 3, T0 + 9)],
        []),
    "cooldown": (
        [("r0", QUEUE_DEPTH_SERIES, BURN, T0), ("r0", QUEUE_DEPTH_SERIES, BURN, T0 + 11)],
        dict(cooldown_s=10.0),
        [(["r0"], 1, T0 + 4), (["r0"], 2, T0 + 9), (["r0"], 2, T0 + 15)], [T0 + 4]),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_policy_decisions_equal_jax(case):
    feeds, kw, calls, scaled = SCENARIOS[case]
    got = {}
    for name, (mod, store) in {"port": (autoscale, SeriesStore()),
                               "jax": (jax_autoscale, JaxStore())}.items():
        for source, series, values, t0 in feeds:
            feed(store, source, series, values, t0=t0)
        policy = mod.AutoscalerPolicy(**{**dict(min_replicas=1, max_replicas=4, burn_window_s=5.0,
                                                idle_window_s=10.0, cooldown_s=10.0,
                                                min_samples=3), **kw})
        for t in scaled:
            policy.note_scaled(t)
        got[name] = [vars(policy.decide(store, sources, n, now=now)) for sources, n, now in calls]
    assert got["port"] == got["jax"]
    actions = [d["action"] for d in got["port"]]
    assert {"sustained_queue_burn": ["up"], "one_hot_replica": ["hold"],
            "brief_spike": ["hold", "hold"], "ttft_and_slot_util": ["up", "up", "up"],
            "max_replicas": ["hold", "up"], "idle_scale_down": ["down", "hold", "hold"],
            "cooldown": ["hold", "hold", "up"]}[case] == actions


class FakeSupervisor:
    def __init__(self, n=1):
        self.n, self.calls = n, []

    def endpoints(self):
        return {f"r{i}": ("127.0.0.1", 8000 + i) for i in range(self.n)}

    def n_live(self):
        return self.n

    def scale_up(self):
        self.calls.append("up")
        self.n += 1
        return f"r{self.n - 1}"

    def scale_down(self, idx=None):
        if self.n <= 1:
            return None
        self.calls.append("down")
        self.n -= 1
        return f"r{self.n}"


class ScriptedPolicy:
    def __init__(self, decisions, mod):
        self.decisions, self.mod, self.scaled_at = list(decisions), mod, []

    def decide(self, store, sources, n_live, now=None):
        if self.decisions:
            return self.mod.Decision(*self.decisions.pop(0))
        return self.mod.Decision("hold", "steady", {"n_live": n_live})

    def note_scaled(self, now=None):
        self.scaled_at.append(now)


def test_executor_acts_and_records_as_jax():
    """Scripted decisions (up, a repeated hold, down, a refused down): the
    same supervisor calls, cooldown notes, ``autoscale_decision`` events
    (a repeated hold recorded once) and ``replicas_live`` samples as the
    reference's executor."""
    out = {}
    script = [("up", "sustained_burn (queue_depth)"), ("hold", "cooldown"), ("hold", "cooldown"),
              ("down", "sustained_idle"), ("down", "sustained_idle")]
    for name, (mod, store) in {"port": (autoscale, SeriesStore()),
                               "jax": (jax_autoscale, JaxStore())}.items():
        sup = FakeSupervisor(n=1)
        feed(store, "r0", UP_SERIES, [1.0])
        feed(store, "r1", UP_SERIES, [1.0])
        policy = ScriptedPolicy(script, mod)
        emitted = []
        asc = mod.Autoscaler(policy, sup, store, emit=lambda e, i, d: emitted.append((e, i, d)))
        decisions = [vars(asc.step(now=T0 + i)) for i in range(len(script))]
        events = [{k: v for k, v in e.items() if k != "_time"} for e in store.events()]
        out[name] = (decisions, sup.calls, policy.scaled_at, events, emitted,
                     store.samples("autoscaler", "replicas_live"))
    assert out["port"] == out["jax"]
    assert out["port"][1] == ["up", "down"]
    assert [e["action"] for e in out["port"][3]] == ["up", "hold", "down", "down"]
    assert out["port"][0][-1]["reason"] == "scale_down_refused"


def test_executor_holds_while_a_replica_is_warming_by_store():
    store = SeriesStore()
    sup = FakeSupervisor(n=2)
    feed(store, "r0", UP_SERIES, [1.0])
    feed(store, "r1", UP_SERIES, [0.0])
    policy = ScriptedPolicy([("up", "sustained_burn (queue_depth)")], autoscale)
    d = Autoscaler(policy, sup, store).step(now=T0 + 1)
    assert (d.action, d.reason, d.metrics["warming"]) == ("hold", "replica_warming", "r1")
    assert sup.calls == [] and policy.scaled_at == []


def test_executor_holds_while_a_port_server_warms(pair):  # noqa: F811
    """The collector scrapes a real port server held in its warmup (its
    ``/healthz`` answers 503 "warming", so ``up`` is 0): an ``up`` decision
    holds as ``replica_warming``; once the warmup ends and a scrape sees
    ``up`` 1, the same decision acts."""
    gate = threading.Event()
    with Served(scheduler(pair[1]), gate=gate) as server:
        sup = FakeSupervisor(n=1)
        sup.endpoints = lambda: {"r0": ("127.0.0.1", server.port)}
        collector = FleetCollector(sup.endpoints)
        collector.scrape_once()
        assert collector.store.latest("r0", UP_SERIES)[1] == 0.0
        assert collector.store.latest("r0", "healthz_warming") is None  # status, not a number
        policy = ScriptedPolicy([("up", "sustained_burn (queue_depth)")] * 2, autoscale)
        asc = Autoscaler(policy, sup, collector.store)
        held = asc.step()
        gate.set()
        wait_for(lambda: collector.scrape_once()["r0"] == 1.0, "the warmup's end")
        acted = asc.step()
    assert (held.action, held.reason) == ("hold", "replica_warming")
    assert acted.action == "up" and sup.calls == ["up"]


def test_supervisor_scale_up_and_down_lifecycle(tmp_path):
    events = []
    sup = ReplicaSupervisor(CHILD, 1, str(tmp_path), drain_timeout_s=10.0, poll_interval_s=0.02,
                            on_event=lambda e, i, d: events.append((e, i, dict(d))))
    sup.start()
    try:
        assert sup.n_live() == 1
        assert sup.scale_up() == "r1"
        assert set(sup.endpoints()) == {"r0", "r1"} and sup.n_live() == 2
        wait_for(lambda: sup.endpoints()["r1"][1] is not None, "r1's port file")
        assert sup.scale_down() == "r1"  # the newest drains first
        assert set(sup.endpoints()) == {"r0"} and sup.n_live() == 1
        assert sup.scale_down() is None  # never the last replica
        assert sup.scale_down(idx=7) is None
        kinds = [e for e, _, _ in events]
        assert kinds[:4] == ["spawn", "spawn", "autoscale_up", "autoscale_down"]
        done = next(d for e, _, d in events if e == "autoscale_down_complete")
        assert done["exit_code"] == 0 and "crash" not in kinds
        assert sup.scale_up() == "r2"  # indices are never reused
    finally:
        sup.stop()


def test_rolling_drain_cancels_a_pending_scale_up(tmp_path):
    """A scale-up (or an executor's ``up``) asked for while the rolling
    drain runs waits for the scale lock and is cancelled: nothing spawns
    after the drain began, and no cooldown is burned."""
    events = []
    sup = ReplicaSupervisor(CHILD, 2, str(tmp_path), drain_timeout_s=10.0, poll_interval_s=0.02,
                            on_event=lambda e, i, d: events.append(e))
    sup.start()
    try:
        wait_for(lambda: all(p is not None for _, p in sup.endpoints().values()), "bound children")
        store = SeriesStore()
        for rid in ("r0", "r1"):
            feed(store, rid, UP_SERIES, [1.0], t0=time.time())
        policy = ScriptedPolicy([("up", "sustained_burn (queue_depth)")], autoscale)
        drainer = threading.Thread(target=sup.begin_rolling_drain, daemon=True)
        drainer.start()
        wait_for(lambda: sup._draining, "the drain flag")
        assert sup.scale_up() is None and sup.scale_down() is None
        d = Autoscaler(policy, sup, store).step()
        drainer.join(WAIT)
        assert not drainer.is_alive()
        assert (d.action, d.reason) == ("hold", "scale_up_cancelled") and policy.scaled_at == []
        assert events.count("autoscale_up_cancelled") == 2 and "autoscale_up" not in events
        assert events.count("drain_complete") == 2
        assert not any(s["running"] for s in sup.status().values())
    finally:
        sup.stop()


def test_decision_carries_a_named_reason():
    d = Decision("hold", "steady")
    assert d.metrics == {} and vars(d) == vars(jax_autoscale.Decision("hold", "steady"))
    with pytest.raises(ValueError):
        autoscale.AutoscalerPolicy(min_replicas=0)
    with pytest.raises(ValueError):
        autoscale.AutoscalerPolicy(min_replicas=3, max_replicas=2)
