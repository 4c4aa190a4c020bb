"""Process supervisor of the multi-replica serving tier.

The port's own copy of ``relora_tpu/serve/supervisor.py``.  It spawns N
replica processes (normally ``python -m relora_tpu_torch.serve_cli --port 0
--port-file ...``), restarts the ones that crash, and turns SIGTERM into a
rolling drain.  Stdlib only (subprocess, threading) and torch-free: this
process must stay responsive while its children hold the card, and it
never touches ``torch.cuda``.  A replica that cannot build or launch its
kernels exits, and the restarts and quarantine below make that loud.

Restart policy:

- **Crash-loop backoff.**  A replica that exits uncleanly is respawned
  after ``min(backoff_base_s * 2^(consecutive-1), backoff_cap_s)`` plus up
  to ``backoff_jitter`` relative jitter (so N replicas felled by one cause
  do not respawn in lockstep).  A clean exit during a drain is not a crash.
- **Quarantine.**  A replica that crashes ``quarantine_after`` times within
  ``crash_window_s`` is quarantined: no further restarts, a loud log line,
  and a ``quarantined`` flag in :meth:`status`.
- **Rolling drain.**  ``begin_rolling_drain()`` (wired to SIGTERM by the
  CLI) SIGTERMs replicas one at a time, waiting for each to finish its
  graceful drain before touching the next; the router keeps serving from
  the others throughout, so a fleet SIGTERM loses no request.
- **Elastic scaling.**  ``scale_up()`` / ``scale_down()`` add or drain one
  replica at a time (``serve/autoscale.py`` decides when, ``--autoscale``
  arms it).  Scale actions and the rolling drain serialize behind one scale
  lock; a drain cancels every scale action asked for after it began, so a
  SIGTERM never races an autoscaler decision.

Port discovery is file-based and restart-safe: each replica gets
``--port 0 --port-file <workdir>/replica_<i>.port``; the supervisor deletes
the port file before every (re)spawn and :meth:`endpoints` reports ``None``
until the new incarnation has bound.  The router re-reads ``endpoints``
every probe round, so a restarted replica's new port is picked up.  A
``replica_<i>.pid`` file is kept current for drills
(``kill -9 $(cat <workdir>/replica_0.pid)``).

CLI, supervisor and router in one front-end process::

    python -m relora_tpu_torch.serve.supervisor --replicas 2 \\
        --router-port 8000 --workdir /tmp/fleet -- \\
        python -m relora_tpu_torch.serve_cli --checkpoint ckpts/model_20000 \\
            --model_config llama_250m --paged --max-batch 8
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple, Union

from relora_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

#: command: a base argv (the supervisor appends ``--port 0 --port-file ...``),
#: or a callable ``(replica_idx, port_file) -> argv`` for full control
ReplicaCommand = Union[Sequence[str], Callable[[int, str], Sequence[str]]]


def backoff_delay(
    consecutive: int,
    *,
    base_s: float = 0.5,
    cap_s: float = 30.0,
    jitter: float = 0.1,
    rand: Callable[[], float] = random.random,
) -> float:
    """Exponential crash-loop backoff: ``min(base * 2^(n-1), cap)`` plus up
    to ``jitter`` relative jitter.  ``consecutive`` is the crash streak
    (>= 1)."""
    delay = min(base_s * (2.0 ** max(consecutive - 1, 0)), cap_s)
    return delay * (1.0 + jitter * rand())


@dataclasses.dataclass
class _Replica:
    idx: int
    port_file: str
    pid_file: str
    log_path: str
    proc: Optional[subprocess.Popen] = None
    log_fh: Optional[object] = None
    restarts: int = 0
    consecutive_crashes: int = 0
    crash_times: Deque[float] = dataclasses.field(default_factory=deque)
    restart_at: Optional[float] = None  # backoff deadline; None = not pending
    quarantined: bool = False
    draining: bool = False  # SIGTERM sent by a rolling drain; exit expected
    last_exit_code: Optional[int] = None

    @property
    def rid(self) -> str:
        return f"r{self.idx}"


class ReplicaSupervisor:
    """Spawn, watch, restart, quarantine, and drain N replica processes."""

    def __init__(
        self,
        command: ReplicaCommand,
        n_replicas: int,
        workdir: str,
        *,
        backoff_base_s: float = 0.5,
        backoff_cap_s: float = 30.0,
        backoff_jitter: float = 0.1,
        quarantine_after: int = 5,
        crash_window_s: float = 120.0,
        drain_timeout_s: float = 60.0,
        poll_interval_s: float = 0.1,
        env_overrides: Optional[Dict[int, Dict[str, str]]] = None,
        env_overrides_respawn: bool = True,
        on_event: Optional[Callable[[str, int, Dict], None]] = None,
        roles: Optional[Dict[int, str]] = None,
        peer_file: Optional[str] = None,
    ):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.command = command
        self.workdir = workdir
        # disaggregated fleet: replica index -> role (absent = "mixed"); the
        # supervisor maintains peer_file (peers.json) so prefill replicas can
        # find decode peers without a discovery service
        self.roles = dict(roles or {})
        self.peer_file = peer_file
        self._last_peers: Optional[str] = None
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.backoff_jitter = backoff_jitter
        self.quarantine_after = quarantine_after
        self.crash_window_s = crash_window_s
        self.drain_timeout_s = drain_timeout_s
        self.poll_interval_s = poll_interval_s
        # per-replica-index env on top of os.environ: how a drill arms a
        # fault on one replica.  env_overrides_respawn=False applies them to
        # the first incarnation only — crash once, come back clean, which is
        # the "kill one replica under load" drill shape.
        self.env_overrides = env_overrides or {}
        self.env_overrides_respawn = env_overrides_respawn
        self.on_event = on_event  # (event, replica_idx, detail) — tests hook this
        os.makedirs(workdir, exist_ok=True)
        self._replicas = [
            _Replica(
                idx=i,
                port_file=os.path.join(workdir, f"replica_{i}.port"),
                pid_file=os.path.join(workdir, f"replica_{i}.pid"),
                log_path=os.path.join(workdir, f"replica_{i}.log"),
            )
            for i in range(n_replicas)
        ]
        self._lock = threading.RLock()
        # serializes scale actions against each other AND against the rolling
        # drain: begin_rolling_drain holds it for its whole duration, so a
        # concurrent autoscaler decision either completes first or is
        # cancelled — never interleaves with the drain (the SIGTERM race)
        self._scale_lock = threading.RLock()
        self._next_idx = n_replicas  # monotonic: freed indices are never reused
        self._stop = threading.Event()
        self._draining = False
        self._monitor: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for rep in self._replicas:
            self._spawn(rep, first=True)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="supervisor", daemon=True
        )
        self._monitor.start()

    def stop(self) -> None:
        """Immediate teardown (test/bench cleanup): SIGKILL everything."""
        self._stop.set()
        with self._lock:
            reps = list(self._replicas)
            for rep in reps:
                if rep.proc is not None and rep.proc.poll() is None:
                    rep.proc.kill()
        for rep in reps:
            if rep.proc is not None:
                try:
                    rep.proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    pass
            if rep.log_fh is not None:
                rep.log_fh.close()
                rep.log_fh = None
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)

    def begin_rolling_drain(self) -> None:
        """SIGTERM replicas one at a time, each graceful drain completing
        before the next starts — the rest of the fleet keeps serving.
        Blocks until every replica has exited (or drain_timeout_s forces a
        kill); idempotent-ish: a second call finds nothing left to drain.

        Holds the scale lock for its whole duration: an in-flight scale
        action finishes first, and every scale action requested after the
        drain began is cancelled (``_draining`` is set before the lock is
        released to a waiting ``scale_up``/``scale_down``)."""
        with self._lock:
            self._draining = True
        with self._scale_lock:
            logger.info("rolling drain: one replica at a time")
            with self._lock:
                reps = list(self._replicas)
            for rep in reps:
                with self._lock:
                    proc = rep.proc
                    if proc is None or proc.poll() is not None:
                        continue
                    rep.draining = True
                self._event("drain_begin", rep)
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=self.drain_timeout_s)
                except subprocess.TimeoutExpired:
                    logger.error(
                        f"replica {rep.rid}: drain exceeded {self.drain_timeout_s}s; killing"
                    )
                    proc.kill()
                    proc.wait(timeout=10.0)
                self._remove_stale(rep)
                self._event("drain_complete", rep, exit_code=proc.returncode)
                logger.info(f"replica {rep.rid} drained (exit {proc.returncode})")
            self._stop.set()

    # -- elastic scaling (the autoscaler's levers) ---------------------------

    def scale_up(self) -> Optional[str]:
        """Add one replica: spawn a new process with the next (never-reused)
        index and report it via ``endpoints`` — the router picks it up on
        its next probe round.  Returns the new rid, or ``None`` when the
        action was cancelled because the fleet is draining or stopping
        (a decision made *before* a SIGTERM landed must not spawn a process
        the drain will never visit)."""
        with self._scale_lock:
            with self._lock:
                if self._draining or self._stop.is_set():
                    self._event("autoscale_up_cancelled", None, reason="draining")
                    logger.info("autoscale: scale-up cancelled — fleet is draining")
                    return None
                idx = self._next_idx
                self._next_idx += 1
                rep = _Replica(
                    idx=idx,
                    port_file=os.path.join(self.workdir, f"replica_{idx}.port"),
                    pid_file=os.path.join(self.workdir, f"replica_{idx}.pid"),
                    log_path=os.path.join(self.workdir, f"replica_{idx}.log"),
                )
                self._replicas.append(rep)
                self._spawn(rep, first=True)
                pid = rep.proc.pid if rep.proc is not None else None
            self._event("autoscale_up", rep, pid=pid)
            logger.info(f"autoscale: added replica {rep.rid} (pid {pid})")
            return rep.rid

    def scale_down(self, idx: Optional[int] = None) -> Optional[str]:
        """Drain and remove one replica (default: the newest non-draining
        one).  Blocks through the graceful drain, then drops the replica
        from the fleet entirely — ``endpoints``/``status`` stop reporting
        it.  Refuses (returns ``None``) when the fleet is draining/stopping,
        when it would leave fewer than one live replica, or when ``idx``
        names a replica that is gone or already draining."""
        with self._scale_lock:
            with self._lock:
                if self._draining or self._stop.is_set():
                    return None
                candidates = [
                    r for r in self._replicas if not r.draining and not r.quarantined
                ]
                if len(candidates) <= 1:
                    return None
                if idx is None:
                    rep = candidates[-1]
                else:
                    matches = [r for r in candidates if r.idx == idx]
                    if not matches:
                        return None
                    rep = matches[0]
                rep.draining = True
                proc = rep.proc
            self._event("autoscale_down", rep)
            exit_code: Optional[int] = None
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=self.drain_timeout_s)
                except subprocess.TimeoutExpired:
                    logger.error(
                        f"replica {rep.rid}: scale-down drain exceeded "
                        f"{self.drain_timeout_s}s; killing"
                    )
                    proc.kill()
                    proc.wait(timeout=10.0)
                exit_code = proc.returncode
            self._remove_stale(rep)
            with self._lock:
                self._replicas = [r for r in self._replicas if r is not rep]
            if rep.log_fh is not None:
                rep.log_fh.close()
                rep.log_fh = None
            self._event("autoscale_down_complete", rep, exit_code=exit_code)
            logger.info(f"autoscale: removed replica {rep.rid} (exit {exit_code})")
            return rep.rid

    def n_live(self) -> int:
        """Replicas that count toward capacity: not draining, not
        quarantined (a crash-looping replica in backoff still counts — it
        is coming back; the autoscaler must not double-provision it)."""
        with self._lock:
            return sum(
                1 for r in self._replicas if not r.draining and not r.quarantined
            )

    # -- the router's view ---------------------------------------------------

    def endpoints(self) -> Dict[str, Tuple[str, Optional[int]]]:
        """Live {rid: (host, port-or-None)} — port None while a replica is
        down, restarting, or quarantined.  The router polls this every probe
        round, so restarts (new ephemeral ports) propagate automatically."""
        out: Dict[str, Tuple[str, Optional[int]]] = {}
        with self._lock:
            reps = list(self._replicas)
        for rep in reps:
            port: Optional[int] = None
            if rep.proc is not None and rep.proc.poll() is None:
                try:
                    with open(rep.port_file) as f:
                        port = int(f.read().strip())
                except (OSError, ValueError):
                    port = None  # not bound yet
            out[rep.rid] = ("127.0.0.1", port)
        return out

    def status(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                rep.rid: {
                    "pid": rep.proc.pid if rep.proc is not None else None,
                    "running": rep.proc is not None and rep.proc.poll() is None,
                    "restarts": rep.restarts,
                    "consecutive_crashes": rep.consecutive_crashes,
                    "quarantined": rep.quarantined,
                    "draining": rep.draining,
                    "last_exit_code": rep.last_exit_code,
                }
                for rep in self._replicas
            }

    def pid(self, idx: int) -> Optional[int]:
        rep = self._rep_by_idx(idx)
        return rep.proc.pid if rep is not None and rep.proc is not None else None

    def send_signal(self, idx: int, sig: int) -> None:
        """Deliver a signal to one replica (drills: SIGKILL under load)."""
        rep = self._rep_by_idx(idx)
        if rep is not None and rep.proc is not None and rep.proc.poll() is None:
            rep.proc.send_signal(sig)

    # -- internals -----------------------------------------------------------

    def _rep_by_idx(self, idx: int) -> Optional[_Replica]:
        # replica index != list position once the fleet has scaled
        with self._lock:
            for rep in self._replicas:
                if rep.idx == idx:
                    return rep
        return None

    def _event(self, event: str, rep: Optional[_Replica], **detail) -> None:
        if self.on_event is not None:
            try:
                self.on_event(event, rep.idx if rep is not None else None, detail)
            except Exception:
                pass

    def _argv(self, rep: _Replica) -> List[str]:
        if callable(self.command):
            return list(self.command(rep.idx, rep.port_file))
        return list(self.command) + ["--port", "0", "--port-file", rep.port_file]

    def _remove_stale(self, rep: _Replica) -> None:
        for path in (rep.port_file, rep.pid_file):
            try:
                os.remove(path)
            except OSError:
                pass

    def _spawn(self, rep: _Replica, *, first: bool) -> None:
        self._remove_stale(rep)  # never route to a dead incarnation's port
        env = dict(os.environ)
        # replica identity for the shared metrics schema: serve_cli stamps
        # every metrics.jsonl record with _source=<rid>, so fleet tooling can
        # join a replica's log against the collector's store by source
        env["RELORA_TPU_REPLICA_ID"] = rep.rid
        if first or self.env_overrides_respawn:
            env.update(self.env_overrides.get(rep.idx, {}))
        if rep.log_fh is None:
            rep.log_fh = open(rep.log_path, "ab")
        argv = self._argv(rep)
        rep.proc = subprocess.Popen(
            argv,
            stdout=rep.log_fh,
            stderr=subprocess.STDOUT,
            env=env,
            start_new_session=True,  # a fleet SIGTERM is ours to orchestrate
        )
        with open(rep.pid_file, "w") as f:
            f.write(str(rep.proc.pid))
        rep.restart_at = None
        self._event("spawn" if first else "respawn", rep, pid=rep.proc.pid)
        logger.info(f"replica {rep.rid}: pid {rep.proc.pid} ({' '.join(argv[:3])} ...)")

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.poll_interval_s)
            with self._lock:
                if self._draining:
                    continue  # begin_rolling_drain owns the processes now
                for rep in self._replicas:
                    self._check(rep)
            self._update_peers()

    def role_of(self, idx: int) -> str:
        return self.roles.get(idx, "mixed")

    def _update_peers(self) -> None:
        """Keep peers.json current with the bound fleet: {rid, host, port,
        role} per live replica.  Written atomically and only on change (the
        replicas mtime-cache it via disagg.load_peers)."""
        if self.peer_file is None:
            return
        import json as _json

        replicas = [
            {"rid": rid, "host": host, "port": port,
             "role": self.role_of(int(rid[1:]))}  # noqa: RTL202 - rid string parse
            for rid, (host, port) in sorted(self.endpoints().items())
            if port is not None
        ]
        doc = _json.dumps({"replicas": replicas}, sort_keys=True)
        if doc == self._last_peers:
            return
        tmp = self.peer_file + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(doc)
            os.replace(tmp, self.peer_file)
            self._last_peers = doc
        except OSError as e:
            logger.warning(f"peers.json update failed: {e!r}")

    def _check(self, rep: _Replica) -> None:
        now = time.monotonic()
        if rep.quarantined or rep.draining:
            # a draining replica's exit is expected, not a crash; scale_down
            # owns it until it is removed from the fleet
            return
        if rep.restart_at is not None:
            if now >= rep.restart_at:
                rep.restarts += 1
                self._spawn(rep, first=False)
            return
        proc = rep.proc
        if proc is None or proc.poll() is None:
            return
        # the replica exited outside a drain: a crash
        code = proc.returncode
        rep.last_exit_code = code
        self._remove_stale(rep)
        rep.consecutive_crashes += 1
        rep.crash_times.append(now)
        while rep.crash_times and now - rep.crash_times[0] > self.crash_window_s:
            rep.crash_times.popleft()
        self._event("crash", rep, exit_code=code)
        if len(rep.crash_times) >= self.quarantine_after:
            rep.quarantined = True
            rep.proc = None
            self._event("quarantine", rep, crashes=len(rep.crash_times))
            logger.error(
                f"replica {rep.rid} QUARANTINED: {len(rep.crash_times)} crashes "
                f"within {self.crash_window_s:.0f}s (last exit {code}) — "
                "not restarting: a crash loop is a fault to diagnose, not to hide"
            )
            return
        delay = backoff_delay(
            rep.consecutive_crashes,
            base_s=self.backoff_base_s,
            cap_s=self.backoff_cap_s,
            jitter=self.backoff_jitter,
        )
        rep.restart_at = now + delay
        rep.proc = None
        logger.warning(
            f"replica {rep.rid} exited {code}; restart #{rep.restarts + 1} "
            f"in {delay:.2f}s (crash streak {rep.consecutive_crashes})"
        )

    def note_healthy(self, idx: int) -> None:
        """Optional: callers that know a replica is serving again (e.g. the
        CLI watching router health) can clear its crash streak so an
        occasional crash every few hours never accumulates to quarantine."""
        rep = self._rep_by_idx(idx)
        if rep is not None:
            with self._lock:
                rep.consecutive_crashes = 0


# -- CLI: supervisor + router in one front-end process -----------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Run N serve_cli replicas behind the health-aware router.",
        epilog="Everything after '--' is the replica command; the supervisor "
        "appends --port 0 --port-file <workdir>/replica_<i>.port to it.",
    )
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument(
        "--prefill-replicas",
        type=int,
        default=0,
        help="disaggregated fleet: the first N replicas run --role prefill "
        "(long prompts; finished page runs migrate to decode peers)",
    )
    p.add_argument(
        "--decode-replicas",
        type=int,
        default=0,
        help="disaggregated fleet: the next N replicas run --role decode "
        "(short prompts + migrated runs); the rest stay mixed/fallback",
    )
    p.add_argument(
        "--classify-threshold",
        type=int,
        default=None,
        help="prompt-length (tokens) routing threshold between the decode "
        "and prefill pools (default 128 when roles are in play)",
    )
    p.add_argument("--workdir", required=True, help="port/pid/log files live here")
    p.add_argument("--router-host", default="127.0.0.1")
    p.add_argument("--router-port", type=int, default=8000, help="0 = ephemeral")
    p.add_argument("--router-port-file", default=None)
    p.add_argument("--backoff-base-s", type=float, default=0.5)
    p.add_argument("--backoff-cap-s", type=float, default=30.0)
    p.add_argument("--quarantine-after", type=int, default=5)
    p.add_argument("--crash-window-s", type=float, default=120.0)
    p.add_argument("--drain-timeout-s", type=float, default=60.0)
    p.add_argument("--probe-interval-s", type=float, default=0.25)
    p.add_argument(
        "--replica-env",
        action="append",
        default=[],
        metavar="IDX:KEY=VALUE",
        help="env override for one replica's FIRST incarnation only (drills: "
        "arm a utils/faults.py site on r0; the respawn comes back clean)",
    )
    p.add_argument(
        "--autoscale",
        action="store_true",
        help="SLO-driven elastic scaling: grow the fleet on sustained TTFT/"
        "queue/slot burn, drain it back on sustained idle.  Requires the fleet "
        "collector (--fleet-cadence-s > 0); "
        "--replicas is the starting size.",
    )
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=4)
    p.add_argument(
        "--ttft-p95-target-s", type=float, default=2.0,
        help="scale-up high-water mark for per-replica TTFT p95",
    )
    p.add_argument("--queue-depth-high", type=float, default=4.0)
    p.add_argument("--slot-util-high", type=float, default=0.9)
    p.add_argument(
        "--burn-window-s", type=float, default=5.0,
        help="pressure must be sustained this long on every replica to add one",
    )
    p.add_argument(
        "--idle-window-s", type=float, default=15.0,
        help="quiet must be sustained this long on every replica to drain one",
    )
    p.add_argument("--cooldown-s", type=float, default=10.0)
    p.add_argument("--autoscale-interval-s", type=float, default=1.0)
    p.add_argument(
        "--fleet-cadence-s",
        type=float,
        default=1.0,
        help="FleetCollector scrape cadence; <= 0 disables the collector",
    )
    p.add_argument(
        "--fleet-persist",
        default=None,
        help="fleet series JSONL path (default <workdir>/fleet_series.jsonl)",
    )
    p.add_argument("--slo-config", default=None, help="JSON SLO config (obs/slo.load_slo_config)")
    p.add_argument(
        "--watch-checkpoints",
        default=None,
        metavar="DIR",
        help="continuous deployment: poll DIR/latest (published by the "
        "trainer at every manifest commit) and roll verified new checkpoints "
        "across the fleet one replica at a time — canary-gated, automatic "
        "fleet-wide rollback on any failure",
    )
    p.add_argument(
        "--watch-interval-s", type=float, default=2.0, help="checkpoint watcher poll interval"
    )
    p.add_argument(
        "--canary-prompts",
        default=None,
        metavar="FILE",
        help="canary prompt-set for rolling updates: one token-id prompt per "
        "line (comma/space-separated ints); default: a built-in tiny set. "
        "Ignored when the checkpoint ships its own canary.json baseline.",
    )
    p.add_argument(
        "--canary-max-new-tokens",
        type=int,
        default=8,
        help="greedy tokens per canary prompt (token-identical gate)",
    )
    p.add_argument(
        "command", nargs=argparse.REMAINDER, help="replica command (after --)"
    )
    args = p.parse_args(argv)
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        raise SystemExit("pass the replica command after '--'")

    env_overrides: Dict[int, Dict[str, str]] = {}
    for spec in args.replica_env:
        idx_s, _, kv = spec.partition(":")
        key, _, value = kv.partition("=")
        env_overrides.setdefault(int(idx_s), {})[key] = value

    from relora_tpu_torch.obs.fleet import FleetCollector  # torch-free, like this module
    from relora_tpu_torch.obs.slo import SLOEngine
    from relora_tpu_torch.serve import disagg as _disagg
    from relora_tpu_torch.serve.router import Router

    # disaggregated fleet: the first --prefill-replicas indices are prefill,
    # the next --decode-replicas are decode, the rest mixed (the fallback
    # pool).  Each replica learns its role + the peer roster via flags the
    # supervisor appends to the base command; the fleet-url file lets them
    # reach the collector's prefix directory once the router has bound.
    if args.prefill_replicas + args.decode_replicas > args.replicas:
        raise SystemExit("--prefill-replicas + --decode-replicas exceeds --replicas")
    disagg_on = args.prefill_replicas + args.decode_replicas > 0
    roles: Dict[int, str] = {}
    for i in range(args.prefill_replicas):
        roles[i] = "prefill"
    for i in range(args.prefill_replicas, args.prefill_replicas + args.decode_replicas):
        roles[i] = "decode"
    peer_file = os.path.join(args.workdir, "peers.json") if disagg_on else None
    router_port_path = os.path.join(args.workdir, "router.port")
    replica_command: ReplicaCommand = command
    if disagg_on:

        def replica_command(idx: int, port_file: str) -> List[str]:
            return list(command) + [
                "--port", "0",
                "--port-file", port_file,
                "--role", roles.get(idx, "mixed"),
                "--peer-file", peer_file,
                "--fleet-url", router_port_path,
            ]

    sup = ReplicaSupervisor(
        replica_command,
        args.replicas,
        args.workdir,
        backoff_base_s=args.backoff_base_s,
        backoff_cap_s=args.backoff_cap_s,
        quarantine_after=args.quarantine_after,
        crash_window_s=args.crash_window_s,
        drain_timeout_s=args.drain_timeout_s,
        env_overrides=env_overrides,
        env_overrides_respawn=False,
        roles=roles,
        peer_file=peer_file,
    )

    # fleet observability plane: the collector scrapes every replica plus the
    # router itself into a SeriesStore, runs the SLO engine each round, and
    # mounts /fleet/metrics + /fleet/series on the router front-end
    collector: Optional[FleetCollector] = None
    router_holder: Dict[str, Router] = {}

    def fleet_endpoints() -> Dict[str, Tuple[str, Optional[int]]]:
        eps: Dict[str, Tuple[str, Optional[int]]] = dict(sup.endpoints())
        r = router_holder.get("router")
        if r is not None and r.started.is_set():
            eps["router"] = (args.router_host, r.port)
        return eps

    if args.fleet_cadence_s > 0:
        collector = FleetCollector(
            fleet_endpoints,
            slo_engine=SLOEngine.from_config(args.slo_config),
            cadence_s=args.fleet_cadence_s,
            persist_path=args.fleet_persist
            or os.path.join(args.workdir, "fleet_series.jsonl"),
        )
        sup.on_event = lambda event, idx, detail: collector.record_supervisor_event(
            event, idx, str(detail)
        )

    router = Router(
        sup.endpoints,
        host=args.router_host,
        port=args.router_port,
        probe_interval_s=args.probe_interval_s,
        extra_routes=collector.handle_fleet_route if collector is not None else None,
        classify_threshold=(
            (
                args.classify_threshold
                if args.classify_threshold is not None
                else _disagg.DEFAULT_CLASSIFY_THRESHOLD
            )
            if disagg_on
            else args.classify_threshold
        ),
    )
    router_holder["router"] = router
    sup.start()
    if collector is not None:
        collector.start()

    # elastic scaling: the collector's store drives replica count through
    # the supervisor's scale levers (decisions land as autoscale_* events)
    autoscaler = None
    if args.autoscale:
        if collector is None:
            raise SystemExit("--autoscale requires the collector (--fleet-cadence-s > 0)")
        from relora_tpu_torch.serve.autoscale import Autoscaler, AutoscalerPolicy

        policy = AutoscalerPolicy(
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            ttft_p95_target_s=args.ttft_p95_target_s,
            queue_depth_high=args.queue_depth_high,
            slot_util_high=args.slot_util_high,
            burn_window_s=args.burn_window_s,
            idle_window_s=args.idle_window_s,
            cooldown_s=args.cooldown_s,
        )
        autoscaler = Autoscaler(
            policy, sup, collector.store, interval_s=args.autoscale_interval_s
        ).start()
        logger.info(
            f"autoscaler armed: {args.min_replicas}..{args.max_replicas} replicas, "
            f"burn window {args.burn_window_s:g}s / idle window {args.idle_window_s:g}s"
        )

    # continuous deployment: watcher verifies each published checkpoint, the
    # rolling updater hot-swaps it across the fleet behind the canary gate
    watcher = None
    if args.watch_checkpoints:
        from relora_tpu_torch.serve.deploy import CheckpointWatcher, RollingUpdater

        canary_prompts = None
        if args.canary_prompts:
            with open(args.canary_prompts) as f:
                canary_prompts = [
                    [int(t) for t in line.replace(",", " ").split()]
                    for line in f
                    if line.strip()
                ]

        def deploy_emit(event: str, idx, detail: Dict) -> None:
            if collector is not None:
                collector.record_supervisor_event(event, idx, str(detail))

        updater = RollingUpdater(
            sup.endpoints,
            canary_prompts=canary_prompts,
            canary_max_new_tokens=args.canary_max_new_tokens,
            expect_replicas=args.replicas,
            emit=deploy_emit,
        )
        watcher = CheckpointWatcher(
            args.watch_checkpoints,
            updater.run,
            interval_s=args.watch_interval_s,
            on_reject=lambda path, reason: deploy_emit(
                "deploy_reject", None, {"checkpoint": path, "reason": reason}
            ),
        ).start()
        logger.info(
            f"continuous deployment armed: watching {args.watch_checkpoints}/latest "
            f"every {args.watch_interval_s:g}s, canary gate "
            f"{args.canary_max_new_tokens} greedy tokens"
        )

    def on_sigterm(signum, frame):
        logger.info("SIGTERM: rolling drain, then router shutdown")

        def _drain():
            sup.begin_rolling_drain()
            router.begin_shutdown()

        threading.Thread(target=_drain, name="rolling-drain", daemon=True).start()

    signal.signal(signal.SIGTERM, on_sigterm)
    signal.signal(signal.SIGINT, on_sigterm)

    import asyncio

    async def _main() -> None:
        serve = asyncio.ensure_future(router.serve_forever())
        while not router.started.is_set():
            await asyncio.sleep(0.01)
            if serve.done():
                break
        if not serve.done():
            # workdir copy feeds the replicas' --fleet-url (the collector's
            # /fleet/prefix directory mounts on the router front-end)
            with open(router_port_path, "w") as f:
                f.write(str(router.port))
            if args.router_port_file:
                with open(args.router_port_file, "w") as f:
                    f.write(str(router.port))
        await serve

    try:
        asyncio.run(_main())
    finally:
        if autoscaler is not None:
            autoscaler.stop()
        if watcher is not None:
            watcher.stop()
        if collector is not None:
            collector.stop()
        sup.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
