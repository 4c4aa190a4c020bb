"""The port's HTTP front end (``relora_tpu_torch/serve/server.py``) against
the JAX package's, on the CPU.

- ``parse_generate_body``, the dynamic Retry-After and ``ServeMetrics``'
  Prometheus text equal the reference's for the same inputs;
- greedy SSE and unary output is token-identical to the JAX
  ``PagedContinuousBatchingScheduler.run()`` (sequential and packed), sampled
  output to the port's own ``scheduler.run`` with the same uids;
- overload (429 + Retry-After), deadlines, disconnects, the drain, the
  warmup and error states of ``/healthz``, the stall watchdog and the
  accept-drop drill behave as the reference's;
- one request's spans have the reference's names, parents and attribute
  keys, and the scheduler's ``metrics.jsonl`` records and ``/metrics``
  series have its keys and, outside the timings, its values;
- tenant requests (``"adapter"``) run the grouped kernel's CPU twin;
  ``/admin/reload`` refuses a missing checkpoint with 422 and
  ``/internal/migrate`` a malformed frame with 400, while the peer prefix
  route answers 501; ``serve_cli --port`` serves and drains on SIGTERM.

Steady by construction: every server binds loopback port 0 on a thread of
its own and is drained and joined in a ``finally``; waits are on events or
on the server's state with timeouts of 60 s, never fixed sleeps.  Where a
check needs a request to stay in flight, an armed fault (``serve_stall``)
holds the model thread, and where arrival order matters, a warmup gate
holds it until every request is queued.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.obs.flight import FlightRecorder as JaxRecorder
from relora_tpu.obs.tracer import Tracer as JaxTracer
from relora_tpu.serve.admission import (
    AdmissionController as JaxAdmission,
    ServeMetrics as JaxServeMetrics,
    Ticket as JaxTicket,
)
from relora_tpu.serve.engine import InferenceEngine as JaxEngine
from relora_tpu.serve.scheduler import (
    PagedContinuousBatchingScheduler as JaxScheduler,
    Request as JaxRequest,
)
from relora_tpu.serve.server import (
    BadRequest as JaxBadRequest,
    GenerateServer as JaxServer,
    parse_generate_body as jax_parse_generate_body,
)
from relora_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from relora_tpu_torch import serve_cli
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.obs.flight import FlightRecorder
from relora_tpu_torch.obs.tracer import Tracer
from relora_tpu_torch.serve.admission import AdmissionController, ServeMetrics, Ticket
from relora_tpu_torch.serve.engine import InferenceEngine
from relora_tpu_torch.serve.scheduler import PagedContinuousBatchingScheduler, Request
from relora_tpu_torch.serve.server import BadRequest, GenerateServer, parse_generate_body
from relora_tpu_torch.utils import faults
from relora_tpu_torch.utils.logging import MetricsLogger
from tests.test_torch_adapters import registries, tenant_pair, write_config  # noqa: F401
from tests.test_torch_llama import CACHE, CHUNK, PAGE, TINY, jax_params

pytestmark = [pytest.mark.torch_port, pytest.mark.serve]

WAIT = 60.0  # every wait of this file: an event or a state, never a fixed sleep
K = 2  # the spec drains' --spec-k
MAX_BATCH = 2
EOS = 9
SEED = 42
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    params = jax_params()
    kw = dict(
        cache_size=CACHE, page_size=PAGE, num_pages=3 * (CACHE // PAGE) + 1,
        chunk_size=CHUNK, token_budget=MAX_BATCH * (K + 1) + CHUNK, spec_k=K,
    )
    jx = JaxEngine(JaxModelConfig(**TINY), params, **kw)
    pt = InferenceEngine(ModelConfig(**TINY), params_from_jax(params), device="cpu", **kw)
    return jx, pt


@pytest.fixture
def armed(monkeypatch):
    """Faults disarmed before and after; no replica id (uids start at 0)."""
    monkeypatch.delenv("RELORA_TPU_REPLICA_ID", raising=False)
    faults.reset()
    yield faults
    faults.reset()


def scheduler(engine, **kw):
    """A port scheduler; no EOS unless asked (a flow check's request then
    runs to its budget)."""
    kw = {"max_batch": MAX_BATCH, "seed": SEED, **kw}
    return PagedContinuousBatchingScheduler(engine, **kw)


def wait_for(cond, what):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        value = cond()
        if value:
            return value
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


class Served:
    """A server on a background thread (signal handlers off: they need the
    main thread's loop).  ``gate`` holds the model thread in its warmup until
    set.  Leaving drains, releases the gate and joins, whatever happened."""

    def __init__(self, sched, *, cls=GenerateServer, gate=None, expect_error=False, **kw):
        self.gate = gate
        if gate is not None:
            kw["warmup_fn"] = lambda: gate.wait(WAIT)
        self.server = cls(sched, port=0, **kw)
        self.expect_error = expect_error
        self.raised = None  # what serve_forever raised (a worker death)
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        try:
            asyncio.run(self.server.serve_forever(install_signal_handlers=False))
        except RuntimeError as e:
            self.raised = e

    def __enter__(self):
        self.thread.start()
        if not self.server.started.wait(WAIT):
            self.__exit__()
            raise AssertionError("server failed to start")
        return self.server

    def __exit__(self, *exc):
        if self.gate is not None:
            self.gate.set()
        self.server.begin_drain()
        self.thread.join(WAIT)
        assert not self.thread.is_alive(), "server did not stop"
        if not self.expect_error:
            assert self.raised is None and self.server._worker_error is None, self.raised


# -- raw HTTP/1.1 clients ------------------------------------------------------------


def request_bytes(method, path, body=b"", headers=None):
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    return (
        f"{method} {path} HTTP/1.1\r\nHost: test\r\n{extra}Content-Length: {len(body)}\r\n\r\n"
    ).encode() + body


def parse_response(data):
    head, _, rest = data.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    status = int(lines[0].split(b" ", 2)[1])
    headers = {}
    for line in lines[1:]:
        key, _, value = line.decode("latin-1").partition(":")
        headers[key.strip().lower()] = value.strip()
    return status, headers, rest


def http(port, method, path, body=None, headers=None):
    """One request read to EOF (the server closes every connection)."""
    payload = b"" if body is None else body if isinstance(body, bytes) else json.dumps(body).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=WAIT) as sock:
        sock.sendall(request_bytes(method, path, payload, headers))
        data = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            data += chunk
    return parse_response(data)


def sse_events(body):
    events = []
    for block in body.decode().split("\n\n"):
        block = block.strip()
        if block.startswith("data: "):
            payload = block[len("data: "):]
            events.append("[DONE]" if payload == "[DONE]" else json.loads(payload))
    return events


def generate(port, payload, headers=None):
    """POST /v1/generate; returns (tokens, finish record, headers), the
    stream checked against its finish record."""
    status, hdrs, body = http(port, "POST", "/v1/generate", payload, headers)
    assert status == 200, body
    if not payload.get("stream", True):
        return json.loads(body)["tokens"], json.loads(body), hdrs
    events = sse_events(body)
    assert events[-1] == "[DONE]"
    final, token_events = events[-2], events[:-2]
    assert [e["index"] for e in token_events] == list(range(len(token_events)))
    tokens = [e["token"] for e in token_events]
    assert final["tokens"] == tokens, "stream diverged from the finish record"
    return tokens, final, hdrs


class Stream:
    """An open streaming request: read events one at a time, or hang up."""

    def __init__(self, port, payload):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=WAIT)
        self.sock.sendall(request_bytes("POST", "/v1/generate", json.dumps(payload).encode()))
        self.buf = b""
        head = self._read_until(b"\r\n\r\n")
        assert head is not None, "no response head"
        self.status = int(head.split(b" ", 2)[1])

    def _read_until(self, marker):
        while marker not in self.buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                return None
            self.buf += chunk
        idx = self.buf.index(marker) + len(marker)
        out, self.buf = self.buf[:idx], self.buf[idx:]
        return out

    def next_event(self):
        block = self._read_until(b"\n\n")
        assert block is not None, "stream ended early"
        payload = block.decode().strip()[len("data: "):]
        return "[DONE]" if payload == "[DONE]" else json.loads(payload)

    def read_to_done(self):
        events = []
        while (event := self.next_event()) != "[DONE]":
            events.append(event)
        return events

    def close(self):
        self.sock.close()


def metrics_text(port):
    return http(port, "GET", "/metrics")[2].decode()


def health(port):
    status, _, body = http(port, "GET", "/healthz")
    return status, json.loads(body)


def post_all(port, payloads):
    """Send every payload from its own client thread; returns the clients'
    (tokens, final) in payload order once all have finished."""
    results = [None] * len(payloads)

    def post(i):
        results[i] = generate(port, payloads[i])[:2]

    threads = [threading.Thread(target=post, args=(i,), daemon=True) for i in range(len(payloads))]
    for t in threads:
        t.start()
    return threads, results


def join_all(threads):
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive(), "a client did not finish"


# -- request validation and the admission arithmetic -------------------------------


BODIES = [
    {"prompt": [1, 2, 3]},
    {"prompt": [1], "max_new_tokens": 5, "temperature": 0.7, "top_p": 0.5, "stream": False},
    {"prompt": [1], "deadline_s": 1.5, "spec": False, "adapter": " tA "},
    {"prompt": [1], "temperature": 1},
    b"not json",
    b"[1, 2]",
    {},
    {"prompt": "text"},
    {"prompt": [1, True]},
    {"prompt": [1], "max_new_tokens": 0},
    {"prompt": [1], "max_new_tokens": True},
    {"prompt": [1], "temperature": -0.1},
    {"prompt": [1], "top_p": 0.0},
    {"prompt": [1], "top_p": 1.5},
    {"prompt": [1], "stream": "yes"},
    {"prompt": [1], "deadline_s": -1},
    {"prompt": [1], "spec": "on"},
    {"prompt": [1], "adapter": "  "},
    {"prompt": [1], "adapter": 3},
]


@pytest.mark.parametrize("body", BODIES, ids=[str(i) for i in range(len(BODIES))])
def test_parse_generate_body_matches_jax(body):
    raw = body if isinstance(body, bytes) else json.dumps(body).encode()
    kw = dict(default_max_new_tokens=8, default_temperature=0.5, default_top_p=0.9)

    def outcome(parse, bad):
        try:
            return parse(raw, **kw)
        except bad as e:
            return ("BadRequest", str(e))

    assert outcome(parse_generate_body, BadRequest) == outcome(jax_parse_generate_body, JaxBadRequest)


def test_retry_after_equals_jax_over_one_event_sequence():
    """The dynamic Retry-After (queue depth x rolling TPOT, clamped) and the
    admission outcomes of both controllers agree event by event."""
    ours, ref = AdmissionController(4, retry_after_s=2.0), JaxAdmission(4, retry_after_s=2.0)

    def admit(ctl, ticket_cls, request_cls, uid):
        req = request_cls(uid=uid, prompt=[1], max_new_tokens=1)
        try:
            ctl.try_admit(ticket_cls(uid=uid, request=req, deadline=None,
                                     on_token=lambda *_: None, on_finish=lambda *_: None))
            return "admitted"
        except Exception as e:
            return type(e).__name__, str(e)

    events = [("tpot", 0.5), ("admit",), ("admit",), ("tpot", 10.0), ("admit",), ("admit",),
              ("admit",), ("pop",), ("tpot", 100.0), ("tpot", -1.0), ("admit",), ("drain",),
              ("admit",), ("pop",), ("pop",)]
    uid = 0
    for event in events:
        if event[0] == "tpot":
            ours.note_tpot(event[1])
            ref.note_tpot(event[1])
        elif event[0] == "admit":
            assert admit(ours, Ticket, Request, uid) == admit(ref, JaxTicket, JaxRequest, uid)
            uid += 1
        elif event[0] == "pop":
            assert (ours.pop() is None) == (ref.pop() is None)
        else:
            ours.begin_drain()
            ref.begin_drain()
        assert ours.retry_after_s == ref.retry_after_s
        assert ours.depth() == ref.depth()
    assert AdmissionController(8, retry_after_s=0.2).retry_after_s == 1.0


def test_serve_metrics_render_equals_jax():
    """The same observations give the reference's /metrics text and
    snapshot, byte for byte."""
    ours, ref = ServeMetrics(), JaxServeMetrics()
    for reg in (ours, ref):
        reg.inc("requests_finished_total", ("reason", "length"))
        reg.inc("requests_finished_total", ("reason", "stop"), 0)
        reg.inc("tokens_generated_total", by=7)
        reg.inc("http_requests_total", ("route", "generate"), 3)
        reg.set_gauge("active_slots", 2)
        reg.set_gauge("batch_fill", 0.625)
        reg.set_gauge("kv_bytes_per_token", 4096.0)
        reg.materialize_histogram("adapter_load_seconds")
        for v in (0.0004, 0.003, 0.2, 7.5, 42.0):
            reg.observe("ttft_seconds", v)
    assert ours.render() == ref.render()
    assert ours.snapshot() == ref.snapshot()
    assert ours.histogram("ttft_seconds").quantile(0.5) == ref.histogram("ttft_seconds").quantile(0.5)


# -- token identity over HTTP ----------------------------------------------------------


def greedy_mix():
    rng = np.random.default_rng(11)
    return [(rng.integers(1, 256, L).tolist(), new) for L, new in ((13, 6), (5, 9), (21, 4), (3, 7))]


@pytest.fixture(scope="module")
def jax_greedy(pair):
    """The JAX paged scheduler's greedy drain of :func:`greedy_mix` (uids in
    mix order), sequential and packed."""
    jx = pair[0]
    out = {}
    for packed in (False, True):
        sched = JaxScheduler(jx, max_batch=MAX_BATCH, eos_id=EOS, key=jax.random.PRNGKey(SEED),
                             packed=packed)
        done = sched.run([JaxRequest(uid=u, prompt=p, max_new_tokens=n)
                          for u, (p, n) in enumerate(greedy_mix())])
        out[packed] = {uid: c.tokens for uid, c in done.items()}
    return out


def serve_in_order(port, server, gate, payloads):
    """Queue every payload (uids minted in payload order: each is admitted
    before the next is sent), release the gated model thread, and return the
    clients' (tokens, final) in payload order."""
    threads, results = [], []
    for i, payload in enumerate(payloads):
        t, r = post_all(port, [payload])
        threads += t
        results.append(r)
        wait_for(lambda: server.admission.depth() == i + 1, f"request {i} queued")
    gate.set()
    join_all(threads)
    return [r[0] for r in results]


@pytest.mark.parametrize("stream", [True, False], ids=["sse", "unary"])
@pytest.mark.parametrize("packed", [False, True], ids=["sequential", "packed"])
def test_greedy_output_token_identical_to_jax(pair, jax_greedy, armed, packed, stream):
    payloads = [{"prompt": p, "max_new_tokens": n, "stream": stream} for p, n in greedy_mix()]
    gate = threading.Event()
    with Served(scheduler(pair[1], packed=packed, eos_id=EOS), gate=gate, max_queue=8) as server:
        results = serve_in_order(server.port, server, gate, payloads)
    got = {final["uid"]: tokens for tokens, final in results}
    assert got == jax_greedy[packed]
    assert all(final["finish_reason"] in ("length", "eos") for _, final in results)


def test_sampled_streams_equal_the_ports_scheduler_run(pair, armed):
    """Sampling is keyed by (seed, uid, token index): concurrent sampled
    streams give what ``scheduler.run`` gives for the same uids."""
    rng = np.random.default_rng(5)
    payloads = [{"prompt": rng.integers(1, 256, L).tolist(), "max_new_tokens": 8,
                 "temperature": t, "top_p": p} for L, t, p in ((7, 0.9, 0.95), (12, 1.2, 1.0),
                                                               (4, 0.7, 0.8))]
    with Served(scheduler(pair[1]), max_queue=8) as server:
        threads, results = post_all(server.port, payloads)
        join_all(threads)
    want = scheduler(pair[1]).run([
        Request(uid=final["uid"], prompt=payloads[i]["prompt"], max_new_tokens=8,
                temperature=payloads[i]["temperature"], top_p=payloads[i]["top_p"])
        for i, (_, final) in enumerate(results)
    ])
    assert {final["uid"]: tokens for tokens, final in results} == {
        uid: c.tokens for uid, c in want.items()
    }


# -- flow control ----------------------------------------------------------------------


def test_overload_sheds_load_with_429(pair, armed):
    """One request decoding, one waiting: the third gets 429 + Retry-After
    while the first keeps streaming (the model thread is held by an armed
    stall so that the queue stays full)."""
    armed.configure("serve_stall", sleep_s=3.0, at_token=1)
    with Served(scheduler(pair[1], max_batch=1), max_queue=1, retry_after_s=2.0) as server:
        port = server.port
        a = Stream(port, {"prompt": [1, 2], "max_new_tokens": 20})
        assert a.status == 200 and a.next_event()["index"] == 0
        b = Stream(port, {"prompt": [3, 4], "max_new_tokens": 4})
        assert b.status == 200
        wait_for(lambda: server.admission.depth() == 1, "B queued")
        status, headers, body = http(port, "POST", "/v1/generate",
                                     {"prompt": [5, 6], "max_new_tokens": 4})
        assert status == 429, body
        assert headers.get("retry-after") == "2"
        assert b"admission queue full" in body
        assert a.read_to_done()[-1]["finish_reason"] == "length"
        assert b.read_to_done()[-1]["finish_reason"] == "length"
        text = metrics_text(port)
        assert 'relora_serve_rejected_total{reason="queue_full"} 1' in text
        assert 'relora_serve_requests_finished_total{reason="length"} 2' in text
        a.close()
        b.close()


def test_deadline_ends_with_timeout_and_partial_output(pair, armed):
    armed.configure("serve_stall", sleep_s=3.0, at_token=1)
    with Served(scheduler(pair[1], max_batch=1)) as server:
        tokens, final, _ = generate(
            server.port, {"prompt": [1, 2, 3], "max_new_tokens": 20, "deadline_s": 2.0}
        )
    assert final["finish_reason"] == "timeout"
    assert 0 < len(tokens) < 20


def test_disconnect_frees_the_slot(pair, armed):
    """Hanging up mid-stream cancels the request at the next round: the
    slot frees and the next request is served."""
    armed.configure("serve_stall", sleep_s=2.0, at_token=1)
    with Served(scheduler(pair[1], max_batch=1)) as server:
        port = server.port
        a = Stream(port, {"prompt": [1, 2], "max_new_tokens": 20})
        assert a.next_event()["index"] == 0
        a.close()
        wait_for(lambda: 'relora_serve_requests_finished_total{reason="cancelled"} 1'
                 in (text := metrics_text(port)) and "relora_serve_active_slots 0" in text,
                 "the cancelled slot freed")
        assert "relora_serve_disconnects_total 1" in metrics_text(port)
        tokens, final, _ = generate(port, {"prompt": [7, 8], "max_new_tokens": 4})
        assert final["finish_reason"] == "length" and len(tokens) == 4


def test_drain_finishes_queued_work_and_rejects_new(pair, armed):
    """begin_drain (SIGTERM's handler): /healthz says draining, new requests
    get 503 + Retry-After, the decoding and the queued request both finish,
    and serve_forever returns."""
    armed.configure("serve_stall", sleep_s=2.0, at_token=1)
    holder = Served(scheduler(pair[1], max_batch=1))
    with holder as server:
        port = server.port
        a = Stream(port, {"prompt": [1, 2], "max_new_tokens": 12})
        assert a.next_event()["index"] == 0
        b = Stream(port, {"prompt": [4, 5, 6], "max_new_tokens": 5})
        wait_for(lambda: server.admission.depth() == 1, "B queued")
        server.begin_drain()
        status, body = health(port)
        assert status == 503 and body["status"] == "draining"
        status, headers, _ = http(port, "POST", "/v1/generate", {"prompt": [9], "max_new_tokens": 2})
        assert status == 503 and "retry-after" in headers
        assert len(a.read_to_done()[-1]["tokens"]) == 12
        assert len(b.read_to_done()[-1]["tokens"]) == 5
        a.close()
        b.close()
        assert server.drained.wait(WAIT), "model thread did not exit after the drain"
        holder.thread.join(WAIT)
        assert not holder.thread.is_alive(), "serve_forever did not return"


# -- self-diagnosis ------------------------------------------------------------------


def test_healthz_warming_then_ok(pair, armed):
    """/healthz answers 503 "warming" until the warmup returns, then ok; the
    engine's warmup runs every sequential shape once."""
    gate = threading.Event()
    pt = pair[1]

    def warmup():
        gate.wait(WAIT)
        return pt.warmup(MAX_BATCH)

    holder = Served(scheduler(pt), warmup_fn=warmup)
    with holder as server:
        status, body = health(server.port)
        assert status == 503 and body["status"] == "warming"
        assert body["detail"] == "warmup in progress" and "paging" in body
        gate.set()
        wait_for(lambda: health(server.port)[0] == 200, "healthz ok")
        report = server.warmup_report
        assert report["n_compiles"] == 3  # prefill chunk, decode, verify (spec_k set)
        assert report["shapes"] == {"prefill_chunk": [1, CHUNK], "decode_paged": [MAX_BATCH, 1],
                                    "verify_paged": [MAX_BATCH, K + 1]}
        assert "relora_serve_warming 0" in metrics_text(server.port)


def test_packed_warmup_runs_every_bucket(pair):
    report = pair[1].warmup(MAX_BATCH, packed=True)
    buckets = list(pair[1].packed_buckets())
    assert report["packed_buckets"] == buckets and report["n_compiles"] == len(buckets)
    assert report["shapes"] == {"step_paged": [[1, b] for b in buckets]}
    assert set(report) >= {"batch", "prompt_buckets", "kv_dtype", "spec_k", "compiles"}


def test_model_thread_fault_fails_every_pending_request(pair, armed, tmp_path, monkeypatch):
    """An exception on the model thread (``serve_decode``) finishes every
    decoding and queued request with ``finish_reason="error"``, flips
    /healthz to 503 "error" while the listener lingers, new work fails
    fast, and the flight recorder is dumped."""
    monkeypatch.setenv("RELORA_TPU_FLIGHT_DIR", str(tmp_path))
    armed.configure("serve_decode", exc=RuntimeError, at_token=2)
    gate = threading.Event()
    with Served(scheduler(pair[1], max_batch=1), gate=gate, max_queue=4, error_linger_s=WAIT,
                expect_error=True) as server:
        port = server.port
        a = Stream(port, {"prompt": [1, 2], "max_new_tokens": 20})
        b = Stream(port, {"prompt": [3, 4], "max_new_tokens": 20})
        gate.set()  # both queued: A decodes, B waits, the fault fires
        for stream in (a, b):
            final = stream.read_to_done()[-1]
            assert final["finish_reason"] == "error"
            assert "injected fault at 'serve_decode'" in final["error"]
            stream.close()
        status, body = health(port)
        assert status == 503 and body["status"] == "error"
        status, _, body = http(port, "POST", "/v1/generate", {"prompt": [5], "max_new_tokens": 2})
        assert status == 500 and b"model thread died" in body
        text = metrics_text(port)
        assert "relora_serve_model_dead 1" in text
        assert 'relora_serve_requests_finished_total{reason="error"} 2' in text
    assert isinstance(server._worker_error, RuntimeError)
    dump = json.loads(next(tmp_path.glob("flight_serve_model_thread_*.json")).read_text())
    assert any(s["name"] == "queue_wait" for s in dump["spans"])


def test_stall_watchdog_flips_stuck_and_recovers(pair, armed, tmp_path, monkeypatch):
    monkeypatch.setenv("RELORA_TPU_FLIGHT_DIR", str(tmp_path))
    armed.configure("serve_stall", sleep_s=3.0, at_token=2)
    with Served(scheduler(pair[1], max_batch=1), stall_timeout_s=0.3) as server:
        port = server.port
        a = Stream(port, {"prompt": [1, 2], "max_new_tokens": 12})
        stuck = wait_for(lambda: (h := health(port))[1]["status"] == "stuck" and h, "stuck")
        assert stuck[0] == 503 and "no decode step" in stuck[1]["detail"]
        assert len(a.read_to_done()[-1]["tokens"]) == 12
        a.close()
        wait_for(lambda: health(port)[0] == 200, "healthz ok again")
        assert "relora_serve_stuck 0" in metrics_text(port)
    dump = json.loads(next(tmp_path.glob("flight_serve_stall_*.json")).read_text())
    assert dump["reason"] == "serve_stall"


def test_accept_drop_closes_then_recovers(pair, armed):
    armed.configure("serve_accept_drop", times=1)
    with Served(scheduler(pair[1])) as server:
        with socket.create_connection(("127.0.0.1", server.port), timeout=WAIT) as sock:
            sock.sendall(request_bytes("GET", "/healthz"))
            try:
                assert sock.recv(4096) == b"", "a dropped connection sent data"
            except ConnectionResetError:
                pass
        assert health(server.port)[0] == 200
        assert "relora_serve_accept_drops_total 1" in metrics_text(server.port)
    assert armed.fire_count("serve_accept_drop") == 1


@pytest.mark.parametrize("method,route", [("POST", "/admin/reload"), ("POST", "/internal/migrate"),
                                          ("GET", "/internal/prefix/00ff")])
def test_fleet_routes_answer_501(pair, armed, method, route, tmp_path):
    """The fleet routes' refusals: a reload of a missing checkpoint answers
    422 (``reload_prepare`` refuses it before any device write, as the
    reference answers) and keeps the version; a frame that does not decode
    answers 400; the peer prefix route, whose directory is not ported,
    answers 501 naming the ROADMAP item that holds it."""
    from relora_tpu_torch.train.checkpoint import restore_serving_params

    def reload_prepare(path):
        params = restore_serving_params(path)
        return lambda: pair[1].reload_params(params)

    with Served(scheduler(pair[1]), reload_prepare=reload_prepare) as server:
        body = {"checkpoint": str(tmp_path / "model_3")} if route == "/admin/reload" else b"RPR1junk"
        status, _, reply = http(server.port, method, route, body)
        version = health(server.port)[1]["weights_version"]
    if route == "/admin/reload":
        assert status == 422 and b"no params.pt" in reply and version == 0
    elif route == "/internal/migrate":
        assert status == 400 and b"bad page run" in reply
    else:
        assert status == 501 and b"ROADMAP Queue 1 item 5b" in reply


def test_error_paths_and_endpoints(pair, armed):
    with Served(scheduler(pair[1]), max_queue=4) as server:
        port = server.port
        assert http(port, "POST", "/v1/generate", b"not json")[0] == 400
        status, _, body = http(port, "POST", "/v1/generate",
                               {"prompt": [1] * 16, "max_new_tokens": CACHE})
        assert status == 400 and b"cache entries" in body
        status, _, body = http(port, "POST", "/v1/generate",
                               {"prompt": [1], "max_new_tokens": 4, "adapter": "tA"})
        assert status == 400 and b"adapter registry" in body
        assert http(port, "GET", "/v1/generate")[0] == 405
        assert http(port, "GET", "/no/such/route")[0] == 404
        with socket.create_connection(("127.0.0.1", port), timeout=WAIT) as sock:
            sock.sendall(b"garbage\r\n\r\n")
            assert b"400" in sock.recv(4096).split(b"\r\n", 1)[0]
        status, body = health(port)
        assert status == 200 and body["status"] == "ok"
        assert body["max_batch"] == MAX_BATCH and body["max_queue"] == 4
        assert set(body["paging"]) >= {"kv_pages_used", "kv_dtype", "prefix_cache", "dispatch"}
        text = metrics_text(port)
        assert 'relora_serve_http_requests_total{route="healthz"} 1' in text
        assert 'relora_serve_rejected_total{reason="bad_request"} 3' in text


def test_server_refuses_fleet_arguments(pair):
    """``fleet_url`` (the fleet prefix directory) is refused, naming the
    ROADMAP item that holds it; a reload path and a peer roster are taken."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5b"):
        GenerateServer(scheduler(pair[1]), fleet_url="u")
    server = GenerateServer(scheduler(pair[1], role="prefill"), reload_prepare=lambda path: None,
                            peer_file="p", weights_version=3)
    assert server.weights_version == 3 and server.role == "prefill"
    assert server.scheduler.migration_sink == server._migration_sink


# -- tracing and telemetry against the reference -----------------------------------------


def span_shapes(spans, rid):
    """(name, parent's name, attribute keys) of every span of ``rid``, and of
    the batch-level ``decode_step`` spans."""
    by_id = {s["span_id"]: s for s in spans}
    return sorted({
        (s["name"], by_id[s["parent_id"]]["name"] if s["parent_id"] in by_id else None,
         tuple(sorted(s["attrs"])))
        for s in spans if s["trace_id"] == rid or s["name"] == "decode_step"
    })


def test_request_id_spans_match_jax(pair, armed):
    """One X-Request-Id request through both servers: the id is echoed, and
    its spans (request, queue_wait, prefill_chunk, decode, sse_flush, and
    the round's decode_step) have the reference's names, parents and
    attribute keys."""
    rid = "feedfacecafebeef"
    payload = {"prompt": [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], "max_new_tokens": 4}
    shapes = []
    for cls, sched, tracer, recorder in (
        (GenerateServer, scheduler(pair[1], max_batch=1), Tracer, FlightRecorder()),
        (JaxServer, JaxScheduler(pair[0], max_batch=1, eos_id=EOS), JaxTracer, JaxRecorder()),
    ):
        with Served(sched, cls=cls, tracer=tracer(service="serve", recorder=recorder)) as server:
            _, final, headers = generate(server.port, payload, {"X-Request-Id": rid})
            assert headers["x-request-id"] == rid and final["finish_reason"] == "length"
            wait_for(lambda: any(s["name"] == "request" and s["trace_id"] == rid
                                 for s in recorder.spans()), "the root span")
            minted = generate(server.port, {"prompt": [5], "max_new_tokens": 2})[2]["x-request-id"]
            assert minted != rid and len(minted) == 16
        shapes.append(span_shapes(recorder.spans(), rid))
    assert shapes[0] == shapes[1]
    assert {name for name, _, _ in shapes[0]} == {
        "request", "queue_wait", "prefill_chunk", "decode", "decode_step", "sse_flush"
    }


TIMING_KEYS = ("serve/prefill_stall_s", "serve/prefill_stall_share", "serve/ttft_s",
               "serve/latency_s", "serve/decode_tokens_per_s", "_time",
               "compile/steady_state_retraces")


@pytest.mark.parametrize("mode", ["sequential", "packed", "ngram"])
def test_round_records_and_series_match_jax(pair, tmp_path, mode):
    """The scheduler's metrics.jsonl records (each round's and each
    request's) have the reference's keys and, outside the timings, its
    values; its /metrics series have the reference's names and counts."""
    jx, pt = pair
    kw = {"packed": mode == "packed", "spec": "ngram" if mode == "ngram" else "off"}
    rng = np.random.default_rng(2)
    phrase = rng.integers(1, 256, 4).tolist()
    mix = [(phrase * 4, 8), (rng.integers(1, 256, 11).tolist(), 6), (phrase * 2 + [7], 9)]
    records, series = [], []
    for name, logger_cls, registry_cls, make in (
        ("port", MetricsLogger, ServeMetrics, lambda m, r: scheduler(
            pt, eos_id=EOS, metrics=m, obs_registry=r, **kw).run(
            [Request(uid=u, prompt=p, max_new_tokens=n) for u, (p, n) in enumerate(mix)])),
        ("jax", JaxMetricsLogger, JaxServeMetrics, lambda m, r: JaxScheduler(
            jx, max_batch=MAX_BATCH, eos_id=EOS, key=jax.random.PRNGKey(SEED), metrics=m,
            obs_registry=r, **kw).run(
            [JaxRequest(uid=u, prompt=p, max_new_tokens=n) for u, (p, n) in enumerate(mix)])),
    ):
        logger, registry = logger_cls(run_dir=str(tmp_path / name)), registry_cls()
        make(logger, registry)
        logger.finish()
        with open(tmp_path / name / "metrics.jsonl") as f:
            records.append([json.loads(line) for line in f])
        series.append({k: v for k, v in registry.snapshot().items()
                       if not k.endswith("_sum") and "stall" not in k})
    ours, ref = records
    assert len(ours) == len(ref) > 3
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        assert {k: v for k, v in a.items() if k not in TIMING_KEYS} == {
            k: v for k, v in b.items() if k not in TIMING_KEYS
        }
    assert series[0] == series[1]
    if mode == "ngram":
        assert ours[-1]["serve/spec_drafted_total"] > 0


def test_adapter_requests_through_the_grouped_twin(tenant_pair, armed):
    """Requests naming tenants decode through their slots (kernel 5's CPU
    twin): each tenant's stream equals ``scheduler.run`` for the same uid
    and adapter, and an unknown adapter answers 400."""
    pt = tenant_pair[1]
    _, registry = registries(tenant_pair)
    rng = np.random.default_rng(8)
    payloads = [{"prompt": rng.integers(1, 256, 6 + 3 * i).tolist(), "max_new_tokens": 5,
                 "adapter": adapter} for i, adapter in enumerate(("tA", None, "tB", "tA"))]
    sched = PagedContinuousBatchingScheduler(pt, max_batch=3, eos_id=EOS, adapter_registry=registry)
    gate = threading.Event()
    with Served(sched, gate=gate, max_queue=8) as server:
        results = serve_in_order(server.port, server, gate, payloads)
        status, _, body = http(server.port, "POST", "/v1/generate",
                               {"prompt": [1, 2], "max_new_tokens": 4, "adapter": "nope"})
        assert status == 400 and b"unknown adapter" in body
        text = metrics_text(server.port)
    assert 'relora_serve_adapter_requests_total{adapter="tA"} 2' in text
    assert 'relora_serve_adapter_requests_total{adapter="base"} 1' in text
    _, fresh = registries(tenant_pair)
    want = PagedContinuousBatchingScheduler(pt, max_batch=3, eos_id=EOS, adapter_registry=fresh).run([
        Request(uid=uid, prompt=p["prompt"], max_new_tokens=5, adapter=p["adapter"])
        for uid, p in enumerate(payloads)
    ])
    assert {final["uid"]: tokens for tokens, final in results} == {
        uid: c.tokens for uid, c in want.items()
    }


# -- serve_cli ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra,message", [
    (["--port", "0", "--prompt", "1 2"], "drop --prompt/--input-file"),
    (["--peer-file", "p"], "pass --port"),
    (["--watch-checkpoints", "d"], "requires --port"),
    (["--port", "0", "--watch-checkpoints", "d"], "not --random-init"),
    (["--port", "0", "--role", "prefill"], "--role prefill requires --paged"),
    (["--port", "0", "--fleet-url", "u"], "ROADMAP Queue 1 item 5b"),
    (["--port", "0", "--max-queue", "0"], "--max-queue must be >= 1"),
])
def test_cli_server_flags_refused(extra, message):
    argv = ["--model_config", "llama_9m", "--random-init", "--paged", "--device", "cpu"]
    if "--role" in extra:
        argv.remove("--paged")  # a role needs the paged pool
    if "--prompt" not in extra and "--port" not in extra:
        argv += ["--prompt", "1 2"]
    with pytest.raises(SystemExit, match=message):
        serve_cli.main(argv + extra)


def test_cli_serves_and_drains_on_sigterm(tmp_path):
    """The real entry point: ``serve_cli --port 0 --port-file F --run-dir R``
    in a process of its own warms up, serves SSE and unary requests, answers
    /healthz and /metrics, and exits 0 on SIGTERM, with metrics.jsonl holding
    the warmup event and the rounds' records."""
    port_file, run_dir = tmp_path / "port", tmp_path / "run"
    argv = ["--model_config", write_config(tmp_path), "--random-init", "--paged", "--device", "cpu",
            "--cache-size", str(CACHE), "--page-size", str(PAGE), "--chunk-size", str(CHUNK),
            "--max-batch", "2", "--max-new-tokens", "5", "--port", "0",
            "--port-file", str(port_file), "--run-dir", str(run_dir)]
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("RELORA_TPU_FAULTS", None)
    env.pop("RELORA_TPU_REPLICA_ID", None)
    log = open(tmp_path / "stderr.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "relora_tpu_torch.serve_cli", *argv], cwd=REPO,
                            env=env, stdout=subprocess.DEVNULL, stderr=log)
    try:
        wait_for(lambda: port_file.exists() and port_file.read_text().strip(), "the port file")
        port = int(port_file.read_text())
        wait_for(lambda: health(port)[1]["status"] == "ok", "healthz ok")
        tokens, final, _ = generate(port, {"prompt": [1, 2, 3]})
        assert 1 <= len(tokens) <= 5 and final["finish_reason"] in ("length", "eos")
        unary, _, _ = generate(port, {"prompt": [1, 2, 3], "stream": False})
        assert unary == tokens
        assert "relora_serve_kv_pages_free" in metrics_text(port)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(WAIT) == 0, (tmp_path / "stderr.log").read_text()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(WAIT)
        log.close()
    with open(run_dir / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    events = [r["_event"] for r in records if "_event" in r]
    assert events[:2] == ["warmup", "serve_warm"] and "serve_drain_complete" in events
    assert any("serve/decode_step" in r for r in records)
    assert all(r.get("_source") == "serve" for r in records)


def test_cli_request_loop_writes_run_dir(tmp_path):
    argv = ["--model_config", write_config(tmp_path), "--random-init", "--paged", "--device", "cpu",
            "--cache-size", str(CACHE), "--page-size", str(PAGE), "--chunk-size", str(CHUNK),
            "--max-new-tokens", "4", "--prompt", "1 2 3", "--prompt", "4 5",
            "--run-dir", str(tmp_path / "run")]
    completions, _ = serve_cli.run(argv)
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert sorted(r["serve_request"] for r in records if "serve_request" in r) == sorted(completions)
    assert sum("serve/decode_step" in r for r in records) > 0
