"""Disaggregated prefill/decode serving in the port, held to the JAX package.

The same numpy-seeded inputs and weights (tiny Llama: 2 layers, hidden 64)
go through both packages on the CPU:

- the page-run frame (``wire.encode_page_run``) and the migration record are
  the JAX package's byte for byte, and torn or corrupt frames are refused
  with its ``ValueError``s;
- ``classify_request``, ``load_peers`` (mtime cache, fail-open) and
  ``pick_peers`` answer as JAX's;
- a prefill-role scheduler handing its runs to a decode-role one through the
  real frame is token-identical to the JAX package's disaggregated drain and
  to the port's own mixed drain, on bf16 and int8 pools, with a packed
  donor (to both packages' packed counterparts) and for a tenant request
  through the adapter slots (sampled requests to the mixed drain: the two
  packages draw from different generators);
- a refusing sink, a corrupt frame and the ``serve_migrate`` fault fail open
  token-identical, counted; ``submit_migrated`` refuses inconsistent runs;
  an int8 run imported into recycled pages decodes as into fresh ones;
- two servers on loopback, a ``--role prefill`` one with a ``peers.json``
  naming a ``--role decode`` one, stream each request token-identical to the
  mixed drain, with the donor's and the receiver's counters as reckoned;
  once one side swaps its weights, runs stop crossing (each decodes on the
  weights that prefilled it) until the other side swaps too, and a
  receiver with a reload pending refuses every run;
- ``/admin/profile`` opens, closes and bounds a device window.

Waits are on events or state with 60 s timeouts, never fixed sleeps.
"""

import json
import os

import jax
import numpy as np
import pytest

from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.serve import disagg as jax_disagg, wire as jax_wire
from relora_tpu.serve.engine import InferenceEngine as JaxEngine
from relora_tpu.serve.scheduler import (
    PagedContinuousBatchingScheduler as JaxScheduler,
    Request as JaxRequest,
)
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.serve import disagg, wire
from relora_tpu_torch.serve.engine import InferenceEngine
from relora_tpu_torch.serve.paging import pages_needed
from relora_tpu_torch.serve.scheduler import PagedContinuousBatchingScheduler, Request
from tests.test_torch_adapters import registries, tenant_pair  # noqa: F401
from tests.test_torch_llama import CACHE, CHUNK, PAGE, TINY, jax_params
from tests.test_torch_server import Served, generate, health, http, metrics_text, wait_for

pytestmark = [pytest.mark.torch_port, pytest.mark.serve]

MAX_BATCH = 2
EOS = 9
SEED = 42
THRESHOLD = 12  # prompt tokens at and above this go to the prefill pool


@pytest.fixture(scope="module")
def pairs():
    """kv dtype -> (JAX engine, port engine) over the same weights."""
    params = jax_params()
    kw = dict(cache_size=CACHE, page_size=PAGE, num_pages=3 * (CACHE // PAGE) + 1,
              chunk_size=CHUNK, token_budget=MAX_BATCH + CHUNK)
    out = {}
    for kv in ("bf16", "int8"):
        out[kv] = (JaxEngine(JaxModelConfig(**TINY), params, kv_dtype=kv, **kw),
                   InferenceEngine(ModelConfig(**TINY), params_from_jax(params), kv_dtype=kv,
                                   device="cpu", **kw))
    return out


@pytest.fixture
def armed(monkeypatch):
    from relora_tpu_torch.utils import faults

    monkeypatch.delenv("RELORA_TPU_REPLICA_ID", raising=False)
    faults.reset()
    yield faults
    faults.reset()


def greedy_mix():
    """Long (prefill-pool) and short (decode-pool) prompts, uid 4 likely to
    hit EOS: (uid, prompt, new tokens)."""
    rng = np.random.default_rng(7)
    return [(uid, rng.integers(1, 256, L).tolist(), new)
            for uid, L, new in ((1, 13, 6), (2, 5, 8), (3, 21, 5), (4, 3, 6), (5, 16, 7))]


def sampled_mix():
    rng = np.random.default_rng(5)
    return [
        Request(uid=1, prompt=rng.integers(1, 256, 14).tolist(), max_new_tokens=6,
                temperature=0.8, top_p=0.9),
        Request(uid=2, prompt=rng.integers(1, 256, 4).tolist(), max_new_tokens=7),
        Request(uid=3, prompt=rng.integers(1, 256, 22).tolist(), max_new_tokens=5,
                temperature=1.1),
    ]


def port_sched(engine, role="mixed", **kw):
    return PagedContinuousBatchingScheduler(engine, max_batch=MAX_BATCH, eos_id=EOS, seed=SEED,
                                            role=role, **kw)


def jax_sched(engine, role="mixed", **kw):
    return JaxScheduler(engine, max_batch=MAX_BATCH, eos_id=EOS, key=jax.random.PRNGKey(SEED),
                        role=role, **kw)


def drain_pair(donor, recv, reqs, codec, *, wire_hook=None, sink=None):
    """Drive a prefill-role donor and a decode-role receiver to the end,
    every handoff through ``codec``'s frame (the drain loop of
    ``tests/test_disagg.py:107``, for either package).  A handoff that cannot land yet (no free
    receiver slot) waits, as an in-flight transfer would; any other insert
    error fails open to the donor.  Returns uid -> Completion."""
    completions = {}

    def finish(c):
        assert completions.setdefault(c.uid, c) is c, f"uid {c.uid} finished twice"

    handoffs = []

    def framing_sink(record, entries):
        blob = codec.encode_page_run(record, entries)
        handoffs.append((int(record["uid"]), wire_hook(blob) if wire_hook else blob))
        return True

    donor.migration_sink = sink or framing_sink
    for req in reqs:
        long = disagg.classify_request(len(req.prompt), THRESHOLD) == "prefill"
        (donor if long else recv).submit(req, on_finish=finish)
    for _ in range(400):
        if not (donor.has_work() or recv.has_work() or handoffs):
            break
        if donor.has_work():
            donor.step()
        waiting = []
        for uid, blob in handoffs:
            try:
                record, arrays = codec.decode_page_run(blob)
                recv.submit_migrated(record, arrays, on_finish=finish)
                donor.migration_commit(uid, len(blob))
            except RuntimeError:
                waiting.append((uid, blob))
            except Exception as e:
                donor.migration_failed(uid, str(e))
        handoffs[:] = waiting
        if recv.has_work():
            recv.step()
    else:
        raise AssertionError("the disaggregated drain did not converge")
    return completions


def tokens(completions):
    return {uid: c.tokens for uid, c in completions.items()}


def port_disagg(engine, reqs, **kw):
    donor, recv = port_sched(engine, "prefill"), port_sched(engine, "decode")
    return drain_pair(donor, recv, reqs, wire, **kw), donor, recv


def mixed_tokens(engine, reqs):
    sched = port_sched(engine)
    return tokens(sched.run(reqs))


def assert_pools_freed(*scheds):
    for s in scheds:
        if s.prefix_cache is not None:
            s.prefix_cache.clear()
        assert s.allocator.used_pages == 0


# -- the frame and the record ----------------------------------------------------------


def seeded_entries():
    rng = np.random.default_rng(3)
    out = []
    for i, (dtype, shape) in enumerate([("int8", (2, 8, 4, 16)), ("float32", (2, 4)),
                                        ("bfloat16", (1, 4))]):
        n = int(np.prod(shape)) * (1 if dtype == "int8" else 2 if dtype == "bfloat16" else 4)
        out.append((f"layers.{i}.k", dtype, shape, rng.integers(0, 256, n, dtype=np.uint8).tobytes()))
    return out


def test_frames_and_records_equal_jax_byte_for_byte():
    fields = dict(uid=(3 << 21) + 7, prompt=np.arange(1, 14), max_new_tokens=np.int64(6),
                  temperature=np.float32(0.5), top_p=1, spec=True, adapter="tA",
                  first_token=np.int32(17), position=13, token_index=1, n_pages=2)
    record = wire.build_migration_record(**fields)
    assert record == jax_wire.build_migration_record(**fields)
    assert json.dumps(record) == json.dumps(jax_wire.build_migration_record(**fields))
    entries = seeded_entries()
    blob = wire.encode_page_run(record, entries)
    assert blob == jax_wire.encode_page_run(record, entries)
    assert blob[:4] == wire.PAGE_RUN_MAGIC == jax_wire.PAGE_RUN_MAGIC
    meta, arrays = wire.decode_page_run(blob)
    assert (meta, arrays) == jax_wire.decode_page_run(blob)
    assert [(n, d, tuple(s), r) for n, d, s, r in entries] == arrays
    assert wire.parse_migration_record(meta) == jax_wire.parse_migration_record(meta)
    sparse = {k: record[k] for k in ("uid", "prompt", "max_new_tokens", "first_token",
                                     "position", "n_pages")}
    assert wire.parse_migration_record(sparse) == jax_wire.parse_migration_record(sparse)


def _bad_frames():
    blob = wire.encode_page_run({"uid": 1}, [("k", "int8", (2, 2), bytes(range(4)))])
    return {
        "empty": b"",
        "short": blob[:7],
        "cut_crc": blob[:-3],
        "torn_payload": blob[: len(blob) // 2],
        "bad_magic": b"XXXX" + blob[4:],
        "crc_mismatch": blob[:-4] + b"\x00\x00\x00\x00",
        "trailing": blob + b"trailing",
        "flipped_byte": blob[:10] + bytes([blob[10] ^ 0xFF]) + blob[11:],
    }


@pytest.mark.parametrize("case", sorted(_bad_frames()))
def test_torn_and_corrupt_frames_are_refused_as_jax(case):
    bad = _bad_frames()[case]
    with pytest.raises(ValueError) as ours:
        wire.decode_page_run(bad)
    with pytest.raises(ValueError) as theirs:
        jax_wire.decode_page_run(bad)
    assert str(ours.value) == str(theirs.value)


def test_malformed_records_are_refused():
    good = wire.build_migration_record(uid=1, prompt=[1], max_new_tokens=2, temperature=0,
                                       top_p=1, spec=True, adapter=None, first_token=3,
                                       position=1, token_index=1, n_pages=1)
    for bad in ({k: v for k, v in good.items() if k != "n_pages"}, {**good, "prompt": ["x"]},
                {**good, "uid": None}):
        for codec in (wire, jax_wire):
            with pytest.raises((KeyError, ValueError, TypeError)):
                codec.parse_migration_record(bad)


# -- roles, classification, peers --------------------------------------------------------


def test_classify_and_pick_peers_match_jax():
    assert disagg.ROLES == jax_disagg.ROLES
    assert disagg.DEFAULT_CLASSIFY_THRESHOLD == jax_disagg.DEFAULT_CLASSIFY_THRESHOLD
    for n in (0, 1, 127, 128, 129, 4096):
        assert disagg.classify_request(n, 128) == jax_disagg.classify_request(n, 128)
    peers = [
        {"rid": "r0", "host": "h", "port": 1, "role": "prefill"},
        {"rid": "r1", "host": "h", "port": 2, "role": "decode"},
        {"rid": "r2", "host": "h", "port": 3, "role": "mixed"},
        {"rid": "r3", "host": "h", "port": 4, "role": "decode"},
    ]
    for roster, role, rid in ((peers, "decode", "r1"), (peers, "prefill", None),
                              ([p for p in peers if p["role"] != "decode"], "decode", "r0"),
                              ([], "decode", None)):
        got = disagg.pick_peers(roster, role=role, exclude_rid=rid)
        assert got == jax_disagg.pick_peers(roster, role=role, exclude_rid=rid)
    assert [p["rid"] for p in disagg.pick_peers(peers, role="decode", exclude_rid="r1")] == [
        "r3", "r2"]


def test_load_peers_caches_by_mtime_and_fails_open_as_jax(tmp_path):
    path = str(tmp_path / "peers.json")
    assert disagg.load_peers(None) == jax_disagg.load_peers(None) == []
    assert disagg.load_peers(path) == jax_disagg.load_peers(path) == []  # no file yet
    roster = {"replicas": [{"rid": "a", "host": "127.0.0.1", "port": 5, "role": "decode"},
                           {"rid": "b", "host": "127.0.0.1", "port": None, "role": "decode"},
                           "junk"]}
    with open(path, "w") as f:
        json.dump(roster, f)
    first = disagg.load_peers(path)
    assert first == jax_disagg.load_peers(path) == [roster["replicas"][0]]
    assert disagg.load_peers(path) is first  # unchanged mtime: the cached list
    with open(path, "w") as f:
        f.write('{"replicas": [')  # a torn rewrite
    os.utime(path, ns=(1, 1))
    assert disagg.load_peers(path) == jax_disagg.load_peers(path) == first  # last good roster
    os.remove(path)
    assert disagg.load_peers(path) == jax_disagg.load_peers(path) == first


# -- the engine's page runs ---------------------------------------------------------------


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_export_import_round_trip_and_refusals(pairs, kv):
    pt = pairs[kv][1]
    src, dst = pt.init_pool(), pt.init_pool()
    gen = np.random.default_rng(4)
    for layer in src:
        for name, t in layer.items():
            if t.dtype.is_floating_point:
                t.copy_(torch_tensor(gen.standard_normal(tuple(t.shape)), t.dtype))
            else:
                t.copy_(torch_tensor(gen.integers(-127, 128, tuple(t.shape)), t.dtype))
    entries = pt.export_page_run(src, [3, 5, 6])
    names = {e[0] for e in entries}
    want = {f"layers.{i}.{leaf}" for i in range(TINY["num_hidden_layers"])
            for leaf in (("k", "v", "k_scale", "v_scale") if kv == "int8" else ("k", "v"))}
    assert names == want
    assert all(e[2][0] == 3 for e in entries)
    frame = wire.encode_page_run({"n_pages": 3}, entries)
    pt.import_page_run(dst, [9, 1, 2], wire.decode_page_run(frame)[1])
    for a, b in zip(src, dst):
        for name in a:
            assert a[name][[3, 5, 6]].equal(b[name][[9, 1, 2]])
    before = [{k: t.clone() for k, t in layer.items()} for layer in dst]
    other = "int8" if kv == "bf16" else "bf16"
    for bad, match in ((entries[:1], "leaves mismatch"),
                       (pairs[other][1].export_page_run(pairs[other][1].init_pool(), [1, 2, 3]),
                        "leaves mismatch|got"),
                       ([(n, d, (2, *s[1:]), r) for n, d, s, r in entries], "got"),
                       ([(n, d, s, r[:-1]) for n, d, s, r in entries], "payload size")):
        with pytest.raises(ValueError, match=match):
            pt.import_page_run(dst, [9, 1, 2], bad)
    for layer, saved in zip(dst, before):
        assert all(layer[k].equal(saved[k]) for k in layer)  # nothing landed
    assert pt.page_run_buckets() == (1, 2, 4)


def torch_tensor(array, dtype):
    import torch

    return torch.as_tensor(np.asarray(array, np.float32)).to(dtype)


# -- the disaggregated drain ---------------------------------------------------------------


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_disagg_drain_token_identical_to_jax_and_mixed(pairs, kv):
    jx, pt = pairs[kv]
    mix = greedy_mix()
    reqs = [Request(uid=u, prompt=p, max_new_tokens=n) for u, p, n in mix]
    got, donor, recv = port_disagg(pt, reqs)
    jd, jr = jax_sched(jx, "prefill"), jax_sched(jx, "decode")
    want = drain_pair(jd, jr, [JaxRequest(uid=u, prompt=p, max_new_tokens=n) for u, p, n in mix],
                      jax_wire)
    assert tokens(got) == tokens(want) == mixed_tokens(pt, reqs)
    assert {u: c.finish_reason for u, c in got.items()} == {
        u: c.finish_reason for u, c in want.items()}
    long = [r for r in reqs if len(r.prompt) >= THRESHOLD]
    assert recv._migrated_inserts == jr._migrated_inserts == len(long) == 3
    assert donor._pages_migrated == jd._pages_migrated == sum(
        pages_needed(len(r.prompt), PAGE) for r in long)
    assert donor._migration_failures == 0 and donor._migration_bytes > 0
    stats = donor.paging_stats()["disagg"]
    assert stats == {**jd.disagg_stats(), "migration_bytes": donor._migration_bytes}
    assert set(stats) == set(jd.disagg_stats())
    assert_pools_freed(donor, recv)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_packed_donor_drain_token_identical_to_jax_and_mixed_packed(pairs, kv):
    """A ``packed=True`` prefill-role donor (a ``--role prefill --packed``
    replica) hands its runs, prefilled in packed rounds, to a sequential
    decode-role receiver: token-identical to the JAX package's drain with
    the same roles and to the port's mixed packed drain."""
    jx, pt = pairs[kv]
    mix = greedy_mix()
    reqs = [Request(uid=u, prompt=p, max_new_tokens=n) for u, p, n in mix]
    donor, recv = port_sched(pt, "prefill", packed=True), port_sched(pt, "decode")
    got = drain_pair(donor, recv, reqs, wire)
    want = drain_pair(jax_sched(jx, "prefill", packed=True), jax_sched(jx, "decode"),
                      [JaxRequest(uid=u, prompt=p, max_new_tokens=n) for u, p, n in mix], jax_wire)
    packed = tokens(port_sched(pt, packed=True).run(reqs))
    assert tokens(got) == tokens(want) == packed == mixed_tokens(pt, reqs)
    assert recv._migrated_inserts == 3 and donor._migration_failures == 0
    assert_pools_freed(donor, recv)


def test_sampled_requests_keep_their_streams(pairs):
    pt = pairs["int8"][1]
    got, donor, recv = port_disagg(pt, sampled_mix())
    assert tokens(got) == mixed_tokens(pt, sampled_mix())
    assert recv._migrated_inserts == 2


def test_tenant_request_through_the_slots_matches_jax(tenant_pair):  # noqa: F811
    """One tenant and one base request migrate: the receiver pins the
    tenant's slot and decodes through kernel 5's twin, token-identical to
    the JAX package's disaggregated drain and to the port's mixed one."""
    jx, pt = tenant_pair[:2]
    rng = np.random.default_rng(9)
    mix = [(1, rng.integers(1, 256, 15).tolist(), 6, "tA"),
           (2, rng.integers(1, 256, 4).tolist(), 5, "tB"),
           (3, rng.integers(1, 256, 13).tolist(), 5, None)]
    rj, rp = registries(tenant_pair)
    reqs = [Request(uid=u, prompt=p, max_new_tokens=n, adapter=a) for u, p, n, a in mix]
    kw = dict(max_batch=3, eos_id=EOS)
    donor = PagedContinuousBatchingScheduler(pt, seed=SEED, role="prefill", adapter_registry=rp,
                                             **kw)
    recv = PagedContinuousBatchingScheduler(pt, seed=SEED, role="decode", adapter_registry=rp, **kw)
    got = drain_pair(donor, recv, reqs, wire)
    jd = JaxScheduler(jx, key=jax.random.PRNGKey(SEED), role="prefill", adapter_registry=rj, **kw)
    jr = JaxScheduler(jx, key=jax.random.PRNGKey(SEED), role="decode", adapter_registry=rj, **kw)
    want = drain_pair(jd, jr, [JaxRequest(uid=u, prompt=p, max_new_tokens=n, adapter=a)
                               for u, p, n, a in mix], jax_wire)
    _, fresh = registries(tenant_pair)
    mixed = PagedContinuousBatchingScheduler(pt, seed=SEED, adapter_registry=fresh, **kw).run(reqs)
    assert tokens(got) == tokens(want) == tokens(mixed)
    assert recv._migrated_inserts == 2
    assert all(v["refs"] == 0 for v in rp.stats()["resident"].values())
    assert_pools_freed(donor, recv)


def test_refusing_sink_and_corrupt_frame_fail_open(pairs):
    pt = pairs["int8"][1]
    reqs = [Request(uid=u, prompt=p, max_new_tokens=n) for u, p, n in greedy_mix()]
    want = mixed_tokens(pt, reqs)
    refused, donor, recv = port_disagg(pt, reqs, sink=lambda record, entries: False)
    assert tokens(refused) == want
    assert donor._migration_failures == 3 and recv._migrated_inserts == 0
    torn, donor, recv = port_disagg(pt, reqs, wire_hook=lambda blob: blob[:-9])
    assert tokens(torn) == want and len(torn) == 5
    assert donor._migration_failures == 3 and recv._migrated_inserts == 0
    assert donor._pages_migrated == 0
    assert_pools_freed(donor, recv)


def test_serve_migrate_fault_fails_open(pairs, armed):
    pt = pairs["int8"][1]
    reqs = [Request(uid=u, prompt=p, max_new_tokens=n) for u, p, n in greedy_mix()]
    armed.configure("serve_migrate", exc=RuntimeError, times=1)
    got, donor, recv = port_disagg(pt, reqs)
    assert tokens(got) == mixed_tokens(pt, reqs)
    assert armed.fire_count("serve_migrate") == 1
    assert donor._migration_failures == 1 and recv._migrated_inserts == 2


def test_submit_migrated_refuses_inconsistent_runs(pairs):
    pt = pairs["int8"][1]
    donor, recv = port_sched(pt, "prefill"), port_sched(pt, "decode")
    grabbed = {}
    donor.migration_sink = lambda record, entries: grabbed.update(
        record=dict(record), entries=entries) or True
    uid, prompt, new = greedy_mix()[0]
    donor.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
    for _ in range(20):
        if grabbed:
            break
        donor.step()
    record, entries = grabbed["record"], grabbed["entries"]
    for bad in (dict(record, position=record["position"] + 1),
                dict(record, n_pages=record["n_pages"] + 1)):
        with pytest.raises(ValueError, match="inconsistent"):
            recv.submit_migrated(bad, entries)
    with pytest.raises(ValueError):
        recv.submit_migrated(record, entries[:1])  # a wrong leaf set
    with pytest.raises(KeyError):
        recv.submit_migrated({k: v for k, v in record.items() if k != "first_token"}, entries)
    assert recv.allocator.used_pages == 0  # every refusal rolled back
    recv.submit_migrated(record, entries)
    with pytest.raises(ValueError, match="already in flight"):
        recv.submit_migrated(record, entries)
    blocker = port_sched(pt, "decode", prefix_cache=False)
    blocker.submit_migrated(record, entries)
    blocker.submit_migrated(dict(record, uid=uid + 1), entries)
    with pytest.raises(RuntimeError, match="no free slot"):
        blocker.submit_migrated(dict(record, uid=uid + 2), entries)
    donor.migration_commit(uid, 0)
    recv.cancel(uid)
    for s in (blocker,):
        s.cancel(uid)
        s.cancel(uid + 1)
    assert_pools_freed(donor, recv, blocker)


def test_int8_run_into_recycled_pages_decodes_as_fresh(pairs):
    """Pages a receiver recycles hold stale codes and large stale scales; an
    imported run writes its own scales with its codes, so the decode after
    the import equals the one into a fresh pool."""
    pt = pairs["int8"][1]
    reqs = [Request(uid=u, prompt=p, max_new_tokens=n) for u, p, n in greedy_mix()]
    fresh, _, _ = port_disagg(pt, reqs)
    donor, recv = port_sched(pt, "prefill"), port_sched(pt, "decode")
    gen = np.random.default_rng(1)
    for layer in recv._ensure_pool():
        for name, t in layer.items():
            if name.endswith("scale"):
                t.fill_(50.0)
            else:
                t.copy_(torch_tensor(gen.integers(-127, 128, tuple(t.shape)), t.dtype))
    recycled = drain_pair(donor, recv, reqs, wire)
    assert tokens(recycled) == tokens(fresh)
    assert recv._migrated_inserts == 3


# -- two servers on loopback ---------------------------------------------------------------


def test_prefill_and_decode_servers_stream_token_identical(pairs, armed, tmp_path, monkeypatch):
    """A prefill-role server hands every request it prefills to the
    decode-role server its peers.json names and relays the continuation
    (classifying by length is the router's work).  Every stream equals the
    mixed drain's; the donor counts the pages and frame bytes, the receiver
    its inserts; with ``serve_migrate`` armed once, that request decodes at
    home, still token-identical.  The general body limit is cut below the
    frames' size here: the migrate route's own limit (a whole block table of
    pages) must let every run through."""
    from relora_tpu_torch.serve import server as server_mod

    for module in (wire, server_mod):
        monkeypatch.setattr(module, "MAX_BODY_BYTES", 2048)
    pt = pairs["int8"][1]
    mix = greedy_mix()
    want = mixed_tokens(pt, [Request(uid=u, prompt=p, max_new_tokens=n) for u, p, n in mix])
    peers = str(tmp_path / "peers.json")
    recv = port_sched(pt, "decode")
    with Served(recv) as decode_server:
        with open(peers, "w") as f:
            json.dump({"replicas": [{"rid": "d0", "host": "127.0.0.1",
                                     "port": decode_server.port, "role": "decode"}]}, f)
        donor = port_sched(pt, "prefill")
        with Served(donor, peer_file=peers) as prefill_server:
            port = prefill_server.port
            for round_ in ("clean", "fault"):
                if round_ == "fault":
                    armed.configure("serve_migrate", exc=RuntimeError, times=1)
                got = {}
                for uid, prompt, new in mix:
                    got[uid] = generate(port, {"prompt": prompt, "max_new_tokens": new})[0]
                assert [got[u] for u, _, _ in mix] == [want[u] for u, _, _ in mix]
            h = health(port)[1]
            assert h["role"] == "prefill" and health(decode_server.port)[1]["role"] == "decode"
            prompts = [p for _, p, _ in mix]
            pages = sum(pages_needed(len(p), PAGE) for p in prompts) + sum(
                pages_needed(len(p), PAGE) for p in prompts[1:])
            # the donor counts a run at its commit, after the client's finish
            stats = wait_for(lambda: (d := health(port)[1]["paging"]["disagg"])[
                "pages_migrated"] == pages and d, "the donor's last commit")
            assert stats["migration_failures"] == 1  # the fault round's first request
            assert stats["migration_bytes"] > 2048 * (2 * len(prompts) - 1)  # frames over 2 KiB
            text = metrics_text(port)
            assert f"relora_serve_migration_bytes_total {stats['migration_bytes']}" in text
            assert "relora_serve_migration_failures_total 1" in text
            wait_for(lambda: health(decode_server.port)[1]["paging"]["disagg"][
                "migrated_inserts"] == 2 * len(prompts) - 1, "the receiver's inserts")
            assert wait_for(lambda: donor.active_slots == 0 and recv.active_slots == 0, "idle")


def test_admin_profile_window(pairs, armed):
    """``POST /admin/profile`` opens and closes a device window (on the CPU it
    counts no kernel: idle share 1); a second start or a stop without a
    window answers 409, a bad action 400."""
    with Served(port_sched(pairs["bf16"][1])) as server:
        port = server.port
        assert http(port, "POST", "/admin/profile", {"action": "stop"})[0] == 409
        assert http(port, "POST", "/admin/profile", {"action": "start"})[0] == 200
        assert http(port, "POST", "/admin/profile", {"action": "start"})[0] == 409
        generate(port, {"prompt": [1, 2, 3], "max_new_tokens": 2})
        status, _, body = http(port, "POST", "/admin/profile", {"action": "stop"})
        assert http(port, "POST", "/admin/profile", {"action": "sideways"})[0] == 400
        assert http(port, "GET", "/admin/profile")[0] == 405
    window = json.loads(body)
    assert status == 200 and set(window) == {"wall_s", "device_busy_s", "device_idle_share", "kernels",
                                             "read_s"}
    assert window["wall_s"] > 0 and window["kernels"] == 0 and window["device_idle_share"] == 1.0


def int8_engine():
    """A port engine of its own (the weights swap on one side only)."""
    return InferenceEngine(ModelConfig(**TINY), params_from_jax(jax_params()), kv_dtype="int8",
                           device="cpu", cache_size=CACHE, page_size=PAGE,
                           num_pages=3 * (CACHE // PAGE) + 1, chunk_size=CHUNK)


def swappable(engine, role, other, **kw):
    """A served ``role`` scheduler on weights_version 1 whose
    ``/admin/reload`` of ``/ckpt/model_2`` loads ``other``."""
    def reload_prepare(path):
        if path != "/ckpt/model_2":
            raise ValueError(f"refusing to serve corrupt checkpoint {path}")
        return lambda: engine.reload_params(other)

    return Served(port_sched(engine, role), reload_prepare=reload_prepare, weights_version=1,
                  weights_checkpoint="/ckpt/model_1", **kw)


def test_runs_never_cross_weights_versions(armed, tmp_path):
    """Swap one side mid-drain: while the receiver serves other weights
    than the donor, every handoff is refused (409) and the donor decodes at
    home on the weights that prefilled the run, token-identical to a mixed
    drain of those weights, each refusal counted; once the donor swaps too,
    runs cross again, token-identical to a mixed drain of the new
    weights."""
    from tests.test_torch_deploy import host_tree, perturb

    donor_engine, recv_engine = int8_engine(), int8_engine()
    other = perturb(host_tree(donor_engine), 3)
    mix = greedy_mix()
    reqs = [Request(uid=u, prompt=p, max_new_tokens=n) for u, p, n in mix]
    old = mixed_tokens(donor_engine, reqs)
    fresh = int8_engine()
    fresh.reload_params(other)
    new = mixed_tokens(fresh, reqs)
    assert new != old
    peers = str(tmp_path / "peers.json")
    with swappable(recv_engine, "decode", other) as receiver:
        with open(peers, "w") as f:
            json.dump({"replicas": [{"rid": "d0", "host": "127.0.0.1", "port": receiver.port,
                                     "role": "decode"}]}, f)
        with swappable(donor_engine, "prefill", other, peer_file=peers) as donor:

            def drain(first):
                got = [generate(donor.port, {"prompt": p, "max_new_tokens": n})[0]
                       for _, p, n in mix[:first]]
                return got, wait_for(lambda: donor.scheduler.active_slots == 0
                                     and health(donor.port)[1]["paging"]["disagg"], "idle donor")

            got, stats = drain(2)  # the drain's first requests cross
            assert got == [old[u] for u, _, _ in mix[:2]] and stats["migration_failures"] == 0
            assert http(receiver.port, "POST", "/admin/reload",
                        {"checkpoint": "/ckpt/model_2"})[0] == 200
            got, stats = drain(len(mix))  # the rest, receiver on version 2
            assert got == [old[u] for u, _, _ in mix]
            assert stats["migration_failures"] == len(mix)
            assert receiver.scheduler._migrated_inserts == 2
            assert http(donor.port, "POST", "/admin/reload",
                        {"checkpoint": "/ckpt/model_2"})[0] == 200
            got, stats = drain(len(mix))
            assert got == [new[u] for u, _, _ in mix]
            assert stats["migration_failures"] == len(mix)  # no new refusal
            assert receiver.scheduler._migrated_inserts == 2 + len(mix)


def test_pending_reload_and_other_weights_refuse_the_insert(pairs, armed):
    """The receiver's model thread refuses a migrated run while a reload is
    pending (so the swap's idle boundary is reached under steady handoffs)
    and a run whose record names other weights than its own, with nothing
    allocated; a run of its own weights lands."""
    import threading

    from relora_tpu_torch.serve.admission import Ticket
    from relora_tpu_torch.serve.server import GenerateServer

    pt = pairs["int8"][1]
    donor, recv = port_sched(pt, "prefill"), port_sched(pt, "decode")
    grabbed = {}
    donor.migration_sink = lambda record, entries: grabbed.update(
        record=dict(record), entries=entries) or True
    uid, prompt, new = greedy_mix()[0]
    donor.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
    for _ in range(20):
        if grabbed:
            break
        donor.step()
    server = GenerateServer(recv, port=0, weights_version=1)

    def insert(version):
        ticket = Ticket(uid=uid, request=Request(uid=uid, prompt=prompt, max_new_tokens=new),
                        deadline=None, on_token=lambda *a: None, on_finish=lambda c: None)
        done, result = threading.Event(), {}
        server._apply_migrate_insert(dict(grabbed["record"], weights_version=version),
                                     grabbed["entries"], ticket, done, result)
        assert done.is_set()
        return result.get("error")

    req = server.request_reload(lambda: None, 2, "/ckpt/model_2")
    assert insert(1) == "a weight reload is pending"
    server._apply_reload(req)
    assert req.ok and server.weights_version == 2
    assert "weights_version 1" in insert(1) and insert(None) is not None
    assert recv.allocator.used_pages == 0 and recv._migrated_inserts == 0
    assert insert(2) is None and recv._migrated_inserts == 1
    donor.migration_commit(uid, 0)
    recv.cancel(uid)
    assert_pools_freed(donor, recv)


def test_admin_profile_window_closes_itself(pairs, armed, monkeypatch):
    """A window nobody stops closes itself after ``PROFILE_MAX_S``; the
    next stop answers its numbers marked expired, the one after 409; a
    window stopped in time is not closed again; the server's exit closes a
    window left open."""
    from relora_tpu_torch.serve import server as server_mod

    with Served(port_sched(pairs["bf16"][1])) as server:
        port = server.port
        monkeypatch.setattr(server_mod, "PROFILE_MAX_S", 0.05)
        assert http(port, "POST", "/admin/profile", {"action": "start"})[0] == 200
        wait_for(lambda: server._profile_expired is not None, "the window's own close")
        assert not server._profile.open
        status, _, body = http(port, "POST", "/admin/profile", {"action": "stop"})
        assert status == 200 and json.loads(body)["expired"] is True
        assert http(port, "POST", "/admin/profile", {"action": "stop"})[0] == 409
        monkeypatch.setattr(server_mod, "PROFILE_MAX_S", 60.0)
        assert http(port, "POST", "/admin/profile", {"action": "start"})[0] == 200
        status, _, body = http(port, "POST", "/admin/profile", {"action": "stop"})
        assert status == 200 and "expired" not in json.loads(body)
        assert http(port, "POST", "/admin/profile", {"action": "start"})[0] == 200
    assert not server._profile.open  # the server's exit closed the window left open
