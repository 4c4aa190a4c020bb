"""Acceptance: the port's fleet front end over real replica processes.

``python -m relora_tpu_torch.serve.supervisor`` runs three ``python -m
relora_tpu_torch.serve_cli`` replicas of llama_9m on the CPU (``r0``
prefill, ``r1`` decode, ``r2`` mixed), serving a port checkpoint this test
writes, behind its router and collector, watching a save directory:

- every request routed through the router streams token-identical to the
  in-process drain of the same checkpoint; long prompts land on ``r0`` and
  migrate to ``r1``, short ones on ``r1``, as the router's counters say;
- a checkpoint published into ``--watch-checkpoints`` rolls all three
  replicas to its ``weights_version`` (``RollingUpdater`` over the
  supervisor's endpoints);
- ``kill -9`` of ``r1`` while streams run leaves no client hanging: each
  stream ends with its ``[DONE]`` or a typed ``stream_interrupted`` event,
  the supervisor restarts ``r1`` and the router routes to it again;
- SIGTERM to the supervisor with requests in flight loses none and exits 0.

Waits are on state (port files, ``/healthz``, counters) with deadlines.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from relora_tpu_torch import serve_cli
from relora_tpu_torch.config.model import load_model_config
from relora_tpu_torch.models.params_util import init_params
from relora_tpu_torch.serve import deploy
from relora_tpu_torch.serve.engine import build_decode_model
from relora_tpu_torch.train.checkpoint import save_checkpoint
from tests.test_router import _http, _sse_events

pytestmark = [pytest.mark.torch_port, pytest.mark.serve]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120.0
THRESHOLD = 16  # prompt tokens at and above this route to the prefill pool
NEW = 8
REPLICA = ["--model_config", "llama_9m", "--paged", "--device", "cpu", "--cache-size", "64",
           "--page-size", "8", "--chunk-size", "16", "--max-batch", "4", "--max-new-tokens",
           str(NEW)]


def wait_for(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            value = cond()
        except (OSError, ValueError):
            value = None
        if value:
            return value
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def health(port):
    status, _, body = _http(port, "GET", "/healthz", timeout=10.0)
    return status, json.loads(body)


def stream(port, payload, out, i, head):
    """One client: (status, X-Relora-Replica, events) or the exception;
    ``head`` is set once the response's status line and headers arrived
    (the router has placed the stream on a replica)."""
    try:
        body = json.dumps(payload).encode()
        req = (f"POST /v1/generate HTTP/1.1\r\nHost: t\r\nContent-Length: {len(body)}\r\n\r\n"
               .encode() + body)
        with socket.create_connection(("127.0.0.1", port), timeout=WAIT) as sock:
            sock.sendall(req)
            data = b""
            while True:
                chunk = sock.recv(65536)
                if not chunk:
                    break
                data += chunk
                if b"\r\n\r\n" in data:
                    head.set()
        lines = data.partition(b"\r\n\r\n")[0].split(b"\r\n")
        headers = dict(line.decode("latin-1").lower().split(":", 1) for line in lines[1:])
        out[i] = (int(lines[0].split(b" ", 2)[1]), headers.get("x-relora-replica", "").strip() or None,
                  _sse_events(data.partition(b"\r\n\r\n")[2]))
    except Exception as e:  # recorded, never raised: the drill counts them
        out[i] = ("raised", None, repr(e))
    finally:
        head.set()


def run_clients(port, payloads):
    """Start one client thread a payload; returns (threads, outcomes, the
    events set as each client's response head arrives)."""
    out = [None] * len(payloads)
    heads = [threading.Event() for _ in payloads]
    threads = [threading.Thread(target=stream, args=(port, p, out, i, heads[i]), daemon=True)
               for i, p in enumerate(payloads)]
    for t in threads:
        t.start()
    return threads, out, heads


def join(threads):
    for t in threads:
        t.join(WAIT)
    return [t.is_alive() for t in threads]


def tokens(events):
    return [e["token"] for e in events if isinstance(e, dict) and "token" in e]


def test_supervised_fleet_routes_rolls_survives_a_crash_and_drains(tmp_path):
    save_dir = tmp_path / "ckpts"
    model = build_decode_model(load_model_config("llama_9m"), device="cpu")
    paths = {}
    for step in (1, 2):
        init_params(model, torch.Generator().manual_seed(step))
        paths[step] = save_checkpoint(str(save_dir), step, model.state_dict(),
                                      {"update_step": step})
    del model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(10, 32000, n).tolist() for n in (24, 5, 31, 9, 18, 3)]
    prompt_file = tmp_path / "prompts.txt"
    prompt_file.write_text("".join(" ".join(map(str, p)) + "\n" for p in prompts))
    want = serve_cli.run(REPLICA + ["--checkpoint", paths[1], "--input-file", str(prompt_file)])[0]

    work, router_port = tmp_path / "fleet", tmp_path / "router.port"
    env = {k: v for k, v in os.environ.items() if k != "RELORA_TPU_FAULTS"}
    env["PYTHONPATH"] = REPO
    log = open(tmp_path / "supervisor.log", "w")
    sup = subprocess.Popen(
        [sys.executable, "-m", "relora_tpu_torch.serve.supervisor", "--replicas", "3",
         "--prefill-replicas", "1", "--decode-replicas", "1", "--classify-threshold",
         str(THRESHOLD), "--workdir", str(work), "--router-port", "0", "--router-port-file",
         str(router_port), "--probe-interval-s", "0.1", "--fleet-cadence-s", "0.25",
         "--backoff-base-s", "0.1", "--watch-checkpoints", str(save_dir),
         "--watch-interval-s", "0.2", "--",
         sys.executable, "-m", "relora_tpu_torch.serve_cli", *REPLICA, "--checkpoint", paths[1]],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=log)
    try:
        port = int(wait_for(lambda: router_port.read_text().strip(), "the router's port file"))
        wait_for(lambda: health(port)[1]["healthy_replicas"] == 3, "three routable replicas")

        # the routed drain: each request alone, so batching matches nothing
        routed = []
        for p in prompts:
            status, headers, body = _http(port, "POST", "/v1/generate", {"prompt": p})
            assert status == 200, body
            routed.append((headers["x-relora-replica"], tokens(_sse_events(body))))
        assert [t for _, t in routed] == [want[i].tokens for i in range(len(prompts))]
        assert [r for r, _ in routed] == ["r0" if len(p) >= THRESHOLD else "r1" for p in prompts]
        text = _http(port, "GET", "/metrics")[2].decode()
        assert "relora_router_routed_prefill_total 3" in text
        assert "relora_router_routed_decode_total 3" in text
        replica_ports = {i: int((work / f"replica_{i}.port").read_text()) for i in range(3)}
        inserts = health(replica_ports[1])[1]["paging"]["disagg"]["migrated_inserts"]
        assert inserts == 3

        # a published checkpoint rolls the whole fleet through the updater
        assert deploy.main(["publish", paths[2]]) == 0
        for i in range(3):
            wait_for(lambda i=i: health(replica_ports[i])[1]["weights_version"] == 2,
                     f"r{i} on weights_version 2")
        wait_for(lambda: "deploy_complete" in {e["_event"] for e in json.loads(
            _http(port, "GET", "/fleet/series")[2])["events"]}, "the update's deploy_complete")

        # kill -9 of the decode replica under load
        old_pid = int((work / "replica_1.pid").read_text())
        threads, out, heads = run_clients(port, [{"prompt": p, "max_new_tokens": 48}
                                                 for p in [prompts[1], prompts[3], prompts[5]] * 3])
        # every stream admitted (its head through the router) before the
        # kill: a request reaching the router after it would find no decode
        # replica and rightly get 503 + Retry-After
        wait_for(lambda: all(h.is_set() for h in heads), "nine streams admitted")
        os.kill(old_pid, signal.SIGKILL)
        t_kill = time.monotonic()
        assert not any(join(threads)), "a client hung"
        for status, _, events in out:
            assert status == 200, (status, events)
            last = events[-1]
            assert last == "[DONE]" or last["error"]["type"] == "stream_interrupted", events
        wait_for(lambda: int((work / "replica_1.pid").read_text()) != old_pid, "r1's respawn")
        wait_for(lambda: health(port)[1]["replicas"]["r1"]["healthy"], "r1 routable again")
        assert time.monotonic() - t_kill < WAIT
        status, headers, body = _http(port, "POST", "/v1/generate", {"prompt": prompts[1]})
        assert status == 200 and _sse_events(body)[-1] == "[DONE]"
        series = json.loads(_http(port, "GET", "/fleet/series?source=r1")[2])
        assert any(e["_event"] == "supervisor_respawn" for e in series["events"])

        # SIGTERM with requests in flight: a rolling drain loses none
        threads, out, _ = run_clients(port, [{"prompt": p, "max_new_tokens": 32} for p in prompts])
        wait_for(lambda: sum(r["inflight"] for r in health(port)[1]["replicas"].values()) > 0
                 or not any(t.is_alive() for t in threads), "requests in flight")
        sup.send_signal(signal.SIGTERM)
        assert not any(join(threads)), "a client hung through the drain"
        assert all(s == 200 and e[-1] == "[DONE]" for s, _, e in out), out
        assert sup.wait(WAIT) == 0
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait(30)
        log.close()
        for pid_file in work.glob("replica_*.pid"):
            try:
                os.kill(int(pid_file.read_text()), signal.SIGKILL)
            except (OSError, ValueError):
                pass
