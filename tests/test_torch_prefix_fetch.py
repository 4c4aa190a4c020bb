"""Prefix fetch across replicas in the port, held to the JAX package.

A replica whose prefix cache misses asks the fleet prefix directory (the
collector's ``/fleet/prefix``, mounted on the port's router) for a peer
that holds the prompt's longest page-aligned prefix, pulls the run from
the peer's ``GET /internal/prefix/<digest>``, imports its pages and
prefills only the tail:

- two port servers on loopback, the directory between them: the fetched
  prefix gives a stream token-identical to the JAX scheduler serving the
  same prompt after a local prefix hit, on bf16 and int8 pools; the
  receiver prefills only the tail, counts one fetch, its bytes (the frame,
  as reckoned) and its seconds; the frame is not held to the request body
  limit;
- an int8 run imported into recycled pages (stale codes, large stale
  scales) decodes as into a fresh pool;
- each failure falls open to local prefill, token-identical, and is
  counted: a stale directory entry (the donor answers 404: the directory's
  hit and the donor's route counter, not a fetch failure, as in the
  reference), a corrupt frame, an armed ``serve_prefix_fetch`` fault, a run
  of another ``weights_version``, a pending reload on the receiver, and
  another tenant's salted digest (the base request's digests miss it; a
  directory answering it anyway is refused).  The last three are guards
  beyond the reference (ROADMAP Queue 3).

Waits are on events or state with deadlines, never fixed sleeps.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from relora_tpu.serve.scheduler import Request as JaxRequest
from relora_tpu_torch.obs.fleet import FleetCollector, parse_prometheus
from relora_tpu_torch.serve import server as server_mod, wire
from relora_tpu_torch.serve.paging import PrefixCache
from relora_tpu_torch.serve.router import Router
from relora_tpu_torch.serve.scheduler import Request
from relora_tpu_torch.serve.server import GenerateServer
from tests.test_torch_adapters import registries, tenant_pair  # noqa: F401
from tests.test_torch_disagg import armed, jax_sched, pairs, port_sched  # noqa: F401
from tests.test_torch_llama import PAGE, TINY
from tests.test_torch_server import Served, generate, health, http, metrics_text, wait_for

pytestmark = [pytest.mark.torch_port, pytest.mark.serve]

PREFIX_PAGES = 2  # the fetched run: the donor's prompt's first two pages


def prompts():
    """The donor's prompt P (two full pages and a tail) and the receiver's
    Q: P's first two pages, then tokens of its own."""
    rng = np.random.default_rng(11)
    p = rng.integers(10, 256, 2 * PAGE + 4).tolist()
    q = p[: PREFIX_PAGES * PAGE] + rng.integers(10, 256, 5).tolist()
    return p, q


def jax_tokens(jx, p, q):
    """Q's tokens from the JAX scheduler after P left its pages in the
    prefix cache (a local hit)."""
    sched = jax_sched(jx)
    sched.run([JaxRequest(uid=1, prompt=p, max_new_tokens=4)])
    return sched.run([JaxRequest(uid=2, prompt=q, max_new_tokens=6)])[2].tokens


class Directory:
    """The collector's ``/fleet/*`` mounted on a port Router (as the
    supervisor mounts it), over ``endpoints``; ``scrape()`` runs one
    collector round."""

    def __init__(self, endpoints):
        import asyncio

        self.collector = FleetCollector(lambda: endpoints)
        self.router = Router({}, port=0, extra_routes=self.collector.handle_fleet_route)
        self.thread = threading.Thread(target=lambda: asyncio.run(self.router.serve_forever()),
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        assert self.router.started.wait(30), "router failed to start"
        return self

    def __exit__(self, *exc):
        self.router.begin_shutdown()
        self.thread.join(30)

    @property
    def url(self):
        return f"127.0.0.1:{self.router.port}"

    def scrape(self):
        self.collector.scrape_once()
        return self.collector.directory


def replica(monkeypatch, rid, sched, **kw):
    """A served port replica named ``rid`` (its uid space and its
    ``exclude`` in directory lookups)."""
    monkeypatch.setenv("RELORA_TPU_REPLICA_ID", rid)
    served = Served(sched, **kw)
    monkeypatch.delenv("RELORA_TPU_REPLICA_ID")
    return served


def frame_bytes(engine, digest, n_pages, weights_version=0):
    """The export frame's length, reckoned from the engine's pool leaves."""
    meta = {"digest": digest, "n_tokens": n_pages * PAGE, "n_pages": n_pages,
            "weights_version": weights_version}
    pool = engine.init_pool()
    entries = []
    for i, layer in enumerate(pool):
        for name, t in layer.items():
            shape = (n_pages, *t.shape[1:])
            entries.append((f"layers.{i}.{name}", engine._dtype_name(t.dtype), shape,
                            bytes(int(np.prod(shape)) * t.element_size())))
    return len(wire.encode_page_run(meta, entries))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_fetched_prefix_equals_jax_local_hit(pairs, armed, kv, monkeypatch):  # noqa: F811
    """P through the donor, one collector round, then Q through the
    receiver: Q's stream equals the JAX scheduler's after a local hit; the
    receiver fetched once, prefilled Q's tail alone, and counted the
    frame's bytes and the fetch's seconds; the frame went out whole although
    the general body limit is cut below its size."""
    jx, pt = pairs[kv]
    p, q = prompts()
    want = jax_tokens(jx, p, q)
    monkeypatch.setattr(wire, "MAX_BODY_BYTES", 4096)
    with replica(monkeypatch, "r0", port_sched(pt)) as donor:
        generate(donor.port, {"prompt": p, "max_new_tokens": 4})
        with Directory({"r0": ("127.0.0.1", donor.port)}) as directory:
            assert len(directory.scrape()) == len(p) // PAGE
            recv_sched = port_sched(pt)
            with replica(monkeypatch, "r1", recv_sched, fleet_url=directory.url) as receiver:
                got = generate(receiver.port, {"prompt": q, "max_new_tokens": 6})[0]
                stats = health(receiver.port)[1]["paging"]["disagg"]
                _, hists = parse_prometheus(metrics_text(receiver.port))
                donor_text = metrics_text(donor.port)
            lookups = directory.collector.directory.stats()
    digest = PrefixCache._digest(q[: PREFIX_PAGES * PAGE]).hex()
    nbytes = frame_bytes(pt, digest, PREFIX_PAGES)
    assert got == want
    assert stats["prefix_fetches"] == 1 and stats["prefix_fetch_failures"] == 0
    assert stats["migration_bytes"] == nbytes > 4096
    assert recv_sched._prefill_tokens == len(q) - PREFIX_PAGES * PAGE
    assert recv_sched.prefix_cache.hits == 1
    assert hists["relora_serve_prefix_fetch_seconds"]["count"] == 1
    assert 'relora_serve_http_requests_total{route="prefix"} 1' in donor_text
    assert lookups["lookups"] == lookups["hits"] == 1


def test_int8_run_into_recycled_pages_decodes_as_fresh(pairs, armed, monkeypatch):  # noqa: F811
    """The receiver's pool holds stale codes and large stale scales before
    the fetch: the imported run writes its own scales with its codes, so Q
    decodes as after a local hit into fresh pages."""
    jx, pt = pairs["int8"]
    p, q = prompts()
    want = jax_tokens(jx, p, q)
    with replica(monkeypatch, "r0", port_sched(pt)) as donor:
        generate(donor.port, {"prompt": p, "max_new_tokens": 4})
        with Directory({"r0": ("127.0.0.1", donor.port)}) as directory:
            directory.scrape()
            recv = port_sched(pt)
            gen = np.random.default_rng(1)
            import torch

            for layer in recv._ensure_pool():
                for name, t in layer.items():
                    if name.endswith("scale"):
                        t.fill_(50.0)
                    else:
                        t.copy_(torch.as_tensor(gen.integers(-127, 128, tuple(t.shape))).to(t.dtype))
            server = GenerateServer(recv, port=0, fleet_url=directory.url)
            server.replica_id = "r1"
            got = recv.run([Request(uid=2, prompt=q, max_new_tokens=6)])[2].tokens
    assert got == want
    assert recv.disagg_stats()["prefix_fetches"] == 1 and recv.prefix_cache.hits == 1


class _GarbageDonor:
    """A peer answering every ``/internal/prefix/`` with 200 and junk."""

    def __init__(self):
        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                body = b"RPR1" + b"\x00" * 64
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class _LyingDirectory(_GarbageDonor):
    """A directory answering every lookup with one fixed holder and digest."""

    def __init__(self, answer):
        super().__init__()
        body = json.dumps(answer).encode()

        def do_GET(handler):
            handler.send_response(200)
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)

        self.httpd.RequestHandlerClass.do_GET = do_GET


def local_receiver(engine, url, **kw):
    """A receiver scheduler driven on this thread, its fetch through an
    unstarted server's ``_prefix_fetch`` (the model thread's code path)."""
    sched = port_sched(engine)
    server = GenerateServer(sched, port=0, fleet_url=url, **kw)
    server.replica_id = "r1"
    return sched, server


@pytest.mark.parametrize("case", ["stale", "corrupt", "fault", "weights_version",
                                  "reload_pending"])
def test_failures_fall_open_to_local_prefill(pairs, armed, case, monkeypatch):  # noqa: F811
    jx, pt = pairs["int8"]
    p, q = prompts()
    want = jax_tokens(jx, p, q)
    digest = PrefixCache._digest(q[: PREFIX_PAGES * PAGE]).hex()
    garbage = _GarbageDonor() if case == "corrupt" else None
    donor_kw = {"weights_version": 1} if case == "weights_version" else {}
    try:
        with replica(monkeypatch, "r0", port_sched(pt), **donor_kw) as donor:
            if case != "stale":
                generate(donor.port, {"prompt": p, "max_new_tokens": 4})
            with Directory({"r0": ("127.0.0.1", donor.port)}) as directory:
                holder = garbage.port if garbage else donor.port
                if case in ("stale", "corrupt"):
                    directory.collector.directory.update("r0", "127.0.0.1", holder, [digest])
                else:
                    directory.scrape()
                recv, server = local_receiver(pt, directory.url)
                if case == "fault":
                    armed.configure("serve_prefix_fetch", exc=RuntimeError, times=1)
                if case == "reload_pending":
                    server.request_reload(lambda: None, 1, "/ckpt/model_1")
                got = recv.run([Request(uid=2, prompt=q, max_new_tokens=6)])[2].tokens
                lookups = directory.collector.directory.stats()
                exports = 'relora_serve_http_requests_total{route="prefix"} 1' in metrics_text(
                    donor.port)
    finally:
        if garbage:
            garbage.close()
    stats = recv.disagg_stats()
    assert got == want
    assert recv.prefix_cache.hits == 0 and recv._prefill_tokens == len(q)
    assert stats["prefix_fetches"] == 0 and recv.allocator.used_pages == len(q) // PAGE
    failures, hits, exported = {"stale": (0, 1, True), "corrupt": (1, 1, False),
                                "fault": (1, 0, False), "weights_version": (1, 1, True),
                                "reload_pending": (1, 0, False)}[case]
    assert (stats["prefix_fetch_failures"], lookups["hits"], exports) == (failures, hits, exported)
    if case == "fault":
        assert armed.fire_count("serve_prefix_fetch") == 1


def test_another_tenants_prefix_is_never_fetched(tenant_pair, armed, monkeypatch):  # noqa: F811
    """Tenant tA's prompt cached on the donor under tA's salt: the base
    request for the same prefix asks for unsalted digests, which the
    directory does not hold (a lookup, no hit, no fetch); a directory that
    answers tA's digest anyway is refused and counted; both prefill
    locally, token-identical to a replica that never fetches.  A tA request
    on another replica does fetch tA's pages, token-identical to its local
    decode."""
    pt = tenant_pair[1]
    _, registry = registries(tenant_pair)
    p, q = prompts()
    want = port_sched(pt).run([Request(uid=2, prompt=q, max_new_tokens=6)])[2].tokens
    want_ta = port_sched(pt, adapter_registry=registries(tenant_pair)[1]).run(
        [Request(uid=4, prompt=q, max_new_tokens=6, adapter="tA")])[4].tokens
    salted = PrefixCache._digest(q[: PREFIX_PAGES * PAGE], "tA").hex()
    with replica(monkeypatch, "r0", port_sched(pt, adapter_registry=registry)) as donor:
        generate(donor.port, {"prompt": p, "max_new_tokens": 4, "adapter": "tA"})
        with Directory({"r0": ("127.0.0.1", donor.port)}) as directory:
            held = directory.scrape()
            assert salted in health(donor.port)[1]["prefix_digests"]
            recv, _ = local_receiver(pt, directory.url)
            got = recv.run([Request(uid=2, prompt=q, max_new_tokens=6)])[2].tokens
            stats, lookups = recv.disagg_stats(), held.stats()
            liar = _LyingDirectory({"digest": salted, "replica": "r0", "host": "127.0.0.1",
                                    "port": donor.port})
            try:
                lied_to, _ = local_receiver(pt, f"127.0.0.1:{liar.port}")
                lied = lied_to.run([Request(uid=3, prompt=q, max_new_tokens=6)])[3].tokens
            finally:
                liar.close()
            exports = metrics_text(donor.port)
            tenant = port_sched(pt, adapter_registry=registries(tenant_pair)[1])
            server = GenerateServer(tenant, port=0, fleet_url=directory.url)
            server.replica_id = "r1"
            got_ta = tenant.run([Request(uid=4, prompt=q, max_new_tokens=6, adapter="tA")])[4].tokens
    assert got == lied == want
    assert got_ta == want_ta and tenant.disagg_stats()["prefix_fetches"] == 1
    assert tenant.prefix_cache.hits == 1
    assert (stats["prefix_fetches"], stats["prefix_fetch_failures"]) == (0, 0)
    assert (lookups["lookups"], lookups["hits"]) == (1, 0)
    assert lied_to.disagg_stats()["prefix_fetch_failures"] == 1
    assert 'route="prefix"' not in exports  # the donor never exported


def test_prefix_route_exports_and_refuses(pairs, armed, monkeypatch):  # noqa: F811
    """``GET /internal/prefix/<digest>`` answers the run's frame (its meta
    the digest, tokens, pages and the donor's weights_version), 404 for a
    digest not cached (or not hex), 405 for another method."""
    _, pt = pairs["bf16"]
    p, _ = prompts()
    with replica(monkeypatch, "r0", port_sched(pt), weights_version=3) as donor:
        generate(donor.port, {"prompt": p, "max_new_tokens": 4})
        digest = PrefixCache._digest(p[:PAGE]).hex()
        status, headers, blob = http(donor.port, "GET", f"/internal/prefix/{digest}")
        missing = http(donor.port, "GET", "/internal/prefix/" + "00" * 20)
        not_hex = http(donor.port, "GET", "/internal/prefix/zz")
        posted = http(donor.port, "POST", f"/internal/prefix/{digest}", b"")
    meta, arrays = wire.decode_page_run(blob)
    assert status == 200 and headers["content-type"] == "application/octet-stream"
    assert meta == {"digest": digest, "n_tokens": PAGE, "n_pages": 1, "weights_version": 3}
    assert len(arrays) == 2 * TINY["num_hidden_layers"] and len(blob) == frame_bytes(
        pt, digest, 1, 3)
    assert (missing[0], not_hex[0], posted[0]) == (404, 404, 405)
    assert server_mod._PREFIX_ROUTE == "/internal/prefix/"
