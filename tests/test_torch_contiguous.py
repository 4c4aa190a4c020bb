"""The port's contiguous serving mode against the JAX package's, on the CPU.

The contiguous engine (``InferenceEngine`` without ``page_size``: ``prefill``,
``decode``, ``insert``, ``generate``), ``ContinuousBatchingScheduler``'s
prefill-on-admission rounds, ``serve_cli`` without ``--paged`` and the HTTP
server over that scheduler, each held to ``relora_tpu`` on the same
numpy-seeded weights (``params_from_jax``), at a tiny Llama and a tiny NeoX
with ``cache_size`` 64:

- prefill logits and caches, then six decode steps, of right-padded prompts
  of 5, 11 and 17 tokens within 1e-4 of JAX's; a write at and past the last
  cache entry clamps as JAX's ``dynamic_update_slice`` does; prefill plus
  decode reproduce the port's own full forward;
- greedy drains (8 requests through 3 slots, an EOS that fires), tenant
  drains under slot contention, ``generate`` (EOS, budget, the capacity
  guard) token-identical to JAX's; ``metrics.jsonl`` records and the
  ``/metrics`` series with JAX's keys; the incremental API, cancel, a
  queued deadline, validation and duplicate uids;
- a sampled stream independent of its batch, the contiguous drain equal to
  the paged drain, unmerged (``--no-merge``) logits equal to merged ones;
- the CLI's one-shot ``--prompt`` mode through ``generate``, its drain, its
  ``--paged``-only refusals, and the server's greedy SSE and unary output,
  ``/healthz`` and warmup report against JAX's server.

Torch and JAX draw different random bits, so only greedy output is compared
across the packages; servers bind loopback port 0 and every wait is on state
(the helpers of ``tests/test_torch_server.py``).
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.core.relora import LoraSpec as JaxLoraSpec, merged_params as jax_merged_params
from relora_tpu.models.params_util import init_params as jax_init_params
from relora_tpu.serve.adapters import AdapterRegistry as JaxRegistry, extract_lora_factors as jax_extract
from relora_tpu.serve.admission import ServeMetrics as JaxServeMetrics
from relora_tpu.serve.engine import InferenceEngine as JaxEngine, build_decode_model as jax_build
from relora_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
    Request as JaxRequest,
)
from relora_tpu.obs.flight import FlightRecorder as JaxRecorder
from relora_tpu.obs.tracer import Tracer as JaxTracer
from relora_tpu.serve.server import GenerateServer as JaxServer
from relora_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from relora_tpu_torch import serve_cli
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.core.relora import LoraSpec
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.obs.flight import FlightRecorder
from relora_tpu_torch.obs.tracer import Tracer
from relora_tpu_torch.serve.adapters import RELORA_CONFIG_FILE, AdapterRegistry, extract_lora_factors
from relora_tpu_torch.serve.admission import ServeMetrics
from relora_tpu_torch.serve.engine import InferenceEngine
from relora_tpu_torch.serve.sampling import SamplingParams
from relora_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    PagedContinuousBatchingScheduler,
    Request,
)
from relora_tpu_torch.serve.server import GenerateServer
from relora_tpu_torch.train import checkpoint as ckpt
from relora_tpu_torch.utils.logging import MetricsLogger
from tests.test_torch_adapters import lora_model, write_config
from tests.test_torch_llama import TINY, jax_params
from tests.test_torch_pythia import TINY_NEOX, jax_serving_params
from tests.test_torch_server import (
    TIMING_KEYS,
    Served,
    generate as http_generate,
    health,
    metrics_text,
    serve_in_order,
    span_shapes,
    wait_for,
)

pytestmark = [pytest.mark.torch_port, pytest.mark.serve]

CACHE = 64
TOL = 1e-4  # f32 logits after 2 layers, two frameworks summing in other orders
MAX_BATCH = 3
SEED = 42
FAMILIES = {"llama": TINY, "neox": TINY_NEOX}


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=TOL * max(1.0, float(np.abs(want).max())), rtol=0)


@pytest.fixture(scope="module")
def pairs():
    """family -> (JAX engine, port engine, JAX params), contiguous, over the
    same weights (the NeoX biases and norms drawn off their init)."""
    out = {}
    for family, cfg in FAMILIES.items():
        params = jax_params() if family == "llama" else jax_serving_params()
        jx = JaxEngine(JaxModelConfig(**cfg), params, cache_size=CACHE)
        pt = InferenceEngine(ModelConfig(**cfg), params_from_jax(params), cache_size=CACHE,
                             device="cpu")
        out[family] = jx, pt, params
    return out


def jax_layers(cache):
    """A JAX contiguous cache as the port's per-layer ``{"k", "v"}`` list."""
    (attn,) = cache["layers"].values()
    return [{n: np.asarray(attn[n][i]) for n in ("k", "v")} for i in range(attn["k"].shape[0])]


def padded_prompts(vocab, lengths=(5, 11, 17), seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, L).astype(np.int32) for L in lengths]
    ids = np.zeros((len(lengths), 32), np.int32)  # bucket_length(17)
    for i, p in enumerate(prompts):
        ids[i, : len(p)] = p
    return ids, np.array(lengths, np.int32)


# -- the engine ------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_and_decode_match_jax(pairs, family):
    """Right-padded prefill (logits and every layer's cache), then six
    greedy decode steps, each row at its own position."""
    jx, pt, _ = pairs[family]
    ids, lengths = padded_prompts(FAMILIES[family]["vocab_size"])
    jl, jcache = jx.prefill(jnp.asarray(ids))
    pl, pcache = pt.prefill(ids)
    assert pl.shape == (3, 32, FAMILIES[family]["vocab_size"])
    _close(pl, jl)
    for got, want in zip(pcache, jax_layers(jcache)):
        assert got["k"].shape == (3, CACHE) + want["k"].shape[2:]
        _close(got["k"], want["k"])
        _close(got["v"], want["v"])
    token = np.asarray(jnp.argmax(jl[np.arange(3), lengths - 1], axis=-1), np.int32)[:, None]
    pos = lengths[:, None].copy()
    for _ in range(6):
        jl, jcache = jx.decode(jcache, jnp.asarray(token), jnp.asarray(pos))
        pl, pcache = pt.decode(pcache, token, pos)
        assert pl.shape == (3, FAMILIES[family]["vocab_size"])
        _close(pl, jl)
        token = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        pos += 1
    for got, want in zip(pcache, jax_layers(jcache)):
        _close(got["k"], want["k"])
        _close(got["v"], want["v"])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_writes_at_and_past_the_last_entry_clamp_like_jax(pairs, family):
    """A row decoding at ``cache_size - 1`` writes the last entry; a free
    row at a stale position past the end writes where JAX's clamped
    ``dynamic_update_slice`` writes, and never out of bounds."""
    jx, pt, _ = pairs[family]
    ids, _ = padded_prompts(FAMILIES[family]["vocab_size"], (5, 9))
    jl, jcache = jx.prefill(jnp.asarray(ids))
    pl, pcache = pt.prefill(ids)
    token = np.array([[7], [3]], np.int32)
    pos = np.array([[CACHE - 1], [CACHE + 5]], np.int32)
    jl, jcache = jx.decode(jcache, jnp.asarray(token), jnp.asarray(pos))
    pl, pcache = pt.decode(pcache, token, pos)
    _close(pl, jl)
    for got, want in zip(pcache, jax_layers(jcache)):
        _close(got["k"], want["k"])
        assert got["k"][:, CACHE - 1].abs().sum() > 0  # both rows wrote the last entry


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_then_decode_reproduce_the_full_forward(pairs, family):
    """Prefill of 5 tokens, then one decode a token, give the teacher-forced
    logits of the port's own cache-free forward at every position."""
    _, pt, _ = pairs[family]
    rng = np.random.default_rng(1)
    ids = rng.integers(0, FAMILIES[family]["vocab_size"], (2, 12)).astype(np.int32)
    with torch.inference_mode():
        full = pt.model(torch.from_numpy(ids).long())
    logits, cache = pt.prefill(ids[:, :5])
    np.testing.assert_allclose(logits.numpy(), full[:, :5].numpy(), atol=1e-5)
    pos = np.full((2, 1), 5, np.int32)
    for t in range(5, 12):
        step, cache = pt.decode(cache, ids[:, t : t + 1], pos)
        np.testing.assert_allclose(step.numpy(), full[:, t].numpy(), atol=1e-5)
        pos += 1


def test_engine_shapes_insert_warmup_and_refusals(pairs):
    jx, pt, params = pairs["llama"]
    shapes = pt.cache_shapes(4)
    assert len(shapes) == TINY["num_hidden_layers"] and shapes[0]["k"].is_meta
    assert tuple(shapes[0]["v"].shape) == (4, CACHE, 4, 16)
    assert pt.default_prompt_buckets() == jx.default_prompt_buckets() == (16, 32, 64)
    dcache = pt.init_cache(3)
    _, pcache = pt.prefill(np.arange(1, 17, dtype=np.int32)[None])
    pt.insert(dcache, pcache, 1)
    assert torch.equal(dcache[0]["k"][1], pcache[0]["k"][0]) and not dcache[0]["k"][0].any()
    report, want = pt.warmup(MAX_BATCH), jx.warmup(MAX_BATCH)
    assert set(report) == set(want) and report["shapes"] == want["shapes"]
    assert report["prompt_buckets"] == want["prompt_buckets"] == [16, 32, 64]
    assert report["n_compiles"] == 5 and {c["fn"] for c in report["compiles"]} == {
        "prefill", "insert", "decode"}
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        pt.prefill(np.zeros((1, CACHE + 1), np.int32))
    cfg, sd = ModelConfig(**TINY), params_from_jax(params)
    for kwargs, message in ((dict(token_budget=8), "token_budget requires the paged"),
                            (dict(kv_dtype="int8"), "kv_dtype='int8' requires the paged"),
                            (dict(spec_k=2), "spec_k > 0 requires the paged")):
        with pytest.raises(ValueError, match=message):
            InferenceEngine(cfg, sd, cache_size=CACHE, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="without page_size"):
        pt.init_pool()


# -- generate --------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_generate_greedy_matches_jax(pairs, family):
    """One bucket for every prompt, EOS in one row, the budget in the
    others, and the capacity guard with the reference's condition."""
    jx, pt, _ = pairs[family]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, FAMILIES[family]["vocab_size"], L).tolist() for L in (3, 9, 14)]
    plain = jx.generate(prompts, max_new_tokens=8)
    assert pt.generate(prompts, max_new_tokens=8) == plain
    eos = plain[1][2]
    want = jx.generate(prompts, max_new_tokens=8, eos_id=eos)
    got = pt.generate(prompts, max_new_tokens=8, eos_id=eos)
    assert got == want and len(got[1]) <= 3 and got[1][-1] == eos
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        pt.generate([[1] * 14], max_new_tokens=CACHE - 13)
    assert pt.generate([[1] * 14], max_new_tokens=CACHE - 14)  # fits exactly
    assert pt.generate([], max_new_tokens=4) == []


def test_generate_samples_per_step_and_runs_on_a_paged_engine(pairs):
    """Sampled draws are keyed by (seed, step): the same seed repeats, and
    a paged engine generates through its contiguous cache."""
    _, pt, params = pairs["llama"]
    prompts = [[5, 9, 3], [7, 1, 2, 8, 4]]
    sampling = SamplingParams(temperature=1.0, top_p=0.9)
    a = pt.generate(prompts, max_new_tokens=6, sampling=sampling, seed=3)
    assert a == pt.generate(prompts, max_new_tokens=6, sampling=sampling, seed=3)
    assert a != pt.generate(prompts, max_new_tokens=6, sampling=sampling, seed=4)
    paged = InferenceEngine(ModelConfig(**TINY), params_from_jax(params), cache_size=CACHE,
                            page_size=8, num_pages=2 * (CACHE // 8) + 1, chunk_size=8, device="cpu")
    assert paged.generate(prompts, max_new_tokens=6) == pt.generate(prompts, max_new_tokens=6)


# -- the scheduler ---------------------------------------------------------------------


def mixed_requests(vocab, seed=3):
    """8 requests of mixed lengths (prompts 2-30 tokens, 3-9 new)."""
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(1, vocab, L).tolist(), n)
            for uid, (L, n) in enumerate(((5, 6), (11, 9), (17, 4), (3, 7), (30, 8), (2, 5),
                                          (23, 3), (9, 8)))]


def jax_drain(engine, mix, eos, **kwargs):
    sched = JaxScheduler(engine, max_batch=MAX_BATCH, eos_id=eos, key=jax.random.PRNGKey(SEED),
                         **kwargs)
    done = sched.run([JaxRequest(uid=u, prompt=p, max_new_tokens=n, **a) for u, p, n, a in mix])
    return {uid: c.tokens for uid, c in done.items()}, sched


def port_drain(engine, mix, eos, cls=ContinuousBatchingScheduler, **kwargs):
    sched = cls(engine, max_batch=MAX_BATCH, eos_id=eos, seed=SEED, **kwargs)
    done = sched.run([Request(uid=u, prompt=p, max_new_tokens=n, **a) for u, p, n, a in mix])
    return {uid: c.tokens for uid, c in done.items()}, sched


@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_drain_token_identical_to_jax(pairs, family):
    """8 requests through 3 slots (staggered admissions, slot reuse) with an
    EOS that ends some early: token-identical to JAX's scheduler."""
    jx, pt, _ = pairs[family]
    mix = [(u, p, n, {}) for u, p, n in mixed_requests(FAMILIES[family]["vocab_size"])]
    plain, _ = jax_drain(jx, mix, None)
    eos = plain[1][2]
    want, _ = jax_drain(jx, mix, eos)
    got, sched = port_drain(pt, mix, eos)
    assert got == want and sorted(got) == list(range(8))
    assert any(t[-1] == eos and len(t) < n for (_, _, n, _), t in zip(mix, got.values()))
    assert sched.active_slots == 0 and not sched.has_work()


def test_contiguous_drain_equals_the_paged_drain(pairs):
    """The same requests, greedy and sampled, give the same tokens through
    the contiguous and the paged scheduler (draws keyed by seed, uid and
    token index in both)."""
    _, pt, params = pairs["llama"]
    mix = [(u, p, n, {"temperature": 0.8, "top_p": 0.9} if u % 3 == 1 else {})
           for u, p, n in mixed_requests(256, seed=4)]
    paged = InferenceEngine(ModelConfig(**TINY), params_from_jax(params), cache_size=CACHE,
                            page_size=8, num_pages=MAX_BATCH * (CACHE // 8) + 1, chunk_size=8,
                            device="cpu")
    got, _ = port_drain(pt, mix, 9)
    want, _ = port_drain(paged, mix, 9, cls=PagedContinuousBatchingScheduler)
    assert got == want


def test_sampled_stream_is_batch_independent(pairs):
    """A sampled request draws the same tokens alone and among others."""
    _, pt, _ = pairs["llama"]
    probe = Request(uid=7, prompt=[7, 3, 11, 5, 2, 13, 1], max_new_tokens=8, temperature=1.0,
                    top_p=0.95)
    solo = ContinuousBatchingScheduler(pt, max_batch=1, seed=SEED).run([probe])[7].tokens
    rng = np.random.default_rng(5)
    crowd = [Request(uid=2, prompt=rng.integers(1, 256, 4).tolist(), max_new_tokens=9,
                     temperature=0.9),
             probe,
             Request(uid=3, prompt=rng.integers(1, 256, 19).tolist(), max_new_tokens=5)]
    assert ContinuousBatchingScheduler(pt, max_batch=3, seed=SEED).run(crowd)[7].tokens == solo


def test_incremental_api_cancel_deadline_and_validation(pairs):
    """submit + step replays ``run`` with every token streamed in order; a
    cancel mid-decode returns the partial output and frees the slot (as
    JAX's); a deadline passed while queued times out without a prefill; bad
    and duplicate requests raise as JAX's."""
    jx, pt, _ = pairs["llama"]
    reqs = [Request(uid=i, prompt=[1 + i, 2, 3], max_new_tokens=5, temperature=0.5)
            for i in range(3)]
    ref = ContinuousBatchingScheduler(pt, max_batch=2, seed=3).run(reqs)
    sched = ContinuousBatchingScheduler(pt, max_batch=2, seed=3)
    streamed, completions = {}, {}
    for r in reqs:
        sched.submit(r, on_token=lambda uid, tok, idx: streamed.setdefault(uid, []).append((idx, tok)),
                     on_finish=lambda c: completions.__setitem__(c.uid, c))
    while sched.has_work():
        sched.step()
    assert {u: c.tokens for u, c in completions.items()} == {u: c.tokens for u, c in ref.items()}
    for uid, c in ref.items():
        assert streamed[uid] == list(enumerate(c.tokens))

    outcomes = []
    for sched, req_cls in ((ContinuousBatchingScheduler(pt, max_batch=2), Request),
                           (JaxScheduler(jx, max_batch=2), JaxRequest)):
        sched.submit(req_cls(uid=0, prompt=[4, 5, 6], max_new_tokens=9))
        sched.submit(req_cls(uid=1, prompt=[8, 9], max_new_tokens=9), deadline=0.0)
        sched.submit(req_cls(uid=2, prompt=[3, 1], max_new_tokens=9))
        first = sched.step()  # uid 1 expired in the queue; 0 and 2 admitted
        sched.step()
        cancelled = sched.cancel(0)
        assert sched.active_slots == 1 and sched.cancel(0) is None
        with pytest.raises(ValueError, match="already in flight"):
            sched.submit(req_cls(uid=2, prompt=[1], max_new_tokens=2))
        for bad, message in (([], "empty prompt"), ([1] * 60, "cache entries")):
            with pytest.raises(ValueError, match=message):
                sched.submit(req_cls(uid=5, prompt=bad, max_new_tokens=5))
        with pytest.raises(ValueError, match="max_new_tokens"):
            sched.validate_request(req_cls(uid=5, prompt=[1], max_new_tokens=0))
        outcomes.append(([(c.uid, c.finish_reason, c.tokens) for c in first],
                         (cancelled.finish_reason, cancelled.tokens)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == [(1, "timeout", [])] and len(outcomes[0][1][1]) == 3


@pytest.mark.parametrize("family", list(FAMILIES))
def test_metrics_records_and_series_match_jax(pairs, tmp_path, family):
    """The rounds' and requests' ``metrics.jsonl`` records carry JAX's keys
    and, outside the timings, its values; the ``/metrics`` series (the
    prefill, insert and decode histograms, batch_fill) its names and counts."""
    jx, pt, _ = pairs[family]
    mix = mixed_requests(FAMILIES[family]["vocab_size"], seed=6)[:5]
    records, series = [], []
    for name, logger_cls, registry_cls, make in (
        ("port", MetricsLogger, ServeMetrics, lambda m, r: ContinuousBatchingScheduler(
            pt, max_batch=2, seed=SEED, metrics=m, obs_registry=r).run(
            [Request(uid=u, prompt=p, max_new_tokens=n) for u, p, n in mix])),
        ("jax", JaxMetricsLogger, JaxServeMetrics, lambda m, r: JaxScheduler(
            jx, max_batch=2, key=jax.random.PRNGKey(SEED), metrics=m, obs_registry=r).run(
            [JaxRequest(uid=u, prompt=p, max_new_tokens=n) for u, p, n in mix])),
    ):
        logger, registry = logger_cls(run_dir=str(tmp_path / name)), registry_cls()
        make(logger, registry)
        logger.finish()
        with open(tmp_path / name / "metrics.jsonl") as f:
            records.append([json.loads(line) for line in f])
        series.append({k: v for k, v in registry.snapshot().items()
                       if not k.endswith("_sum") and "stall" not in k})
    ours, ref = records
    assert len(ours) == len(ref) > 5
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        assert {k: v for k, v in a.items() if k not in TIMING_KEYS} == {
            k: v for k, v in b.items() if k not in TIMING_KEYS}
    assert series[0] == series[1]
    assert {"prefill_seconds_count", "insert_seconds_count", "decode_step_seconds_count",
            "batch_fill"} <= set(series[0])


# -- tenants and unmerged serving ---------------------------------------------------------

SPEC_KW = dict(r=4, alpha=8.0)


@pytest.fixture(scope="module")
def tenants():
    """A JAX and a port engine with 3 adapter slots over one base (slot 0
    and two tenant slots), and three tenants' factors in both forms."""
    spec = JaxLoraSpec(**SPEC_KW)
    model = jax_build(JaxModelConfig(**TINY), cache_size=CACHE, lora=spec)
    raw = jax.tree_util.tree_map(np.asarray, jax_init_params(
        model, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    jx = JaxEngine(JaxModelConfig(**TINY), raw, lora=spec, adapter_slots=3, cache_size=CACHE)
    pt = InferenceEngine(ModelConfig(**TINY), params_from_jax(raw), lora=LoraSpec(**SPEC_KW),
                         adapter_slots=3, cache_size=CACHE, device="cpu")
    factors = {}
    for name, seed in (("tA", 11), ("tB", 22), ("tC", 33)):
        rng = np.random.default_rng(seed)

        def walk(node):
            return {k: walk(v) if isinstance(v, dict)
                    else (rng.standard_normal(np.shape(v)) * 0.1).astype(np.float32)
                    if k in ("lora_a", "lora_b") else v for k, v in node.items()}

        tree = walk(raw)
        factors[name] = jax_extract(tree), extract_lora_factors(params_from_jax(tree))
    return jx, pt, factors, raw


def test_tenant_drain_under_slot_contention_matches_jax(tenants, tmp_path):
    """Base rows and three tenants through two tenant slots: adapters load,
    wait while every slot is pinned, evict and reload mid-drain, and the
    tokens, loads and evictions equal JAX's scheduler's."""
    jx, pt, factors, _ = tenants
    root = tmp_path / "adapters"
    for name in factors:
        (root / name).mkdir(parents=True)
        (root / name / RELORA_CONFIG_FILE).write_text(json.dumps(SPEC_KW))
    scale = LoraSpec(**SPEC_KW).scale
    rj = JaxRegistry(str(root), 3, writer=jx.adapter_writer(),
                     loader=lambda path, r: (factors[os.path.basename(path)][0], scale))
    rp = AdapterRegistry(str(root), 3, writer=pt.adapter_writer(),
                         loader=lambda path, r: (factors[os.path.basename(path)][1], scale))
    rng = np.random.default_rng(8)
    names = [None, "tA", "tB", "tC"]
    mix = [(u, rng.integers(1, 256, L).tolist(), n, {"adapter": names[u % 4]})
           for u, (L, n) in enumerate(((13, 6), (21, 5), (9, 8), (5, 7), (11, 4), (17, 6),
                                       (4, 5), (8, 3)))]
    want, _ = jax_drain(jx, mix, 9, adapter_registry=rj)
    got, sched = port_drain(pt, mix, 9, adapter_registry=rp)
    assert got == want and sorted(got) == list(range(8))
    assert (rp.loads_total, rp.evictions_total) == (rj.stats()["loads_total"],
                                                    rj.stats()["evictions_total"])
    assert rp.evictions_total > 0 and sched._adapter_row.tolist() == [0, 0, 0]


def test_unmerged_logits_and_tokens_equal_merged(tenants):
    """An engine serving the LoRA factors unmerged (``--no-merge``) gives the
    merged engine's logits within 1e-4 and its greedy tokens."""
    *_, raw = tenants
    rng = np.random.default_rng(9)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else (rng.standard_normal(np.shape(v)) * 0.1).astype(np.float32)
                if k == "lora_b" else v for k, v in node.items()}

    raw = walk(raw)
    merged = jax.tree_util.tree_map(np.asarray, jax_merged_params(
        jax.tree_util.tree_map(jnp.asarray, raw), JaxLoraSpec(**SPEC_KW)))
    unmerged = InferenceEngine(ModelConfig(**TINY), params_from_jax(raw), lora=LoraSpec(**SPEC_KW),
                               cache_size=CACHE, device="cpu")
    plain = InferenceEngine(ModelConfig(**TINY), params_from_jax(merged), cache_size=CACHE,
                            device="cpu")
    ids, _ = padded_prompts(256)
    _close(unmerged.prefill(ids)[0], plain.prefill(ids)[0].numpy())
    prompts = [[1, 2, 3], [4, 5, 6, 7]]
    assert unmerged.generate(prompts, max_new_tokens=6) == plain.generate(prompts, max_new_tokens=6)


# -- serve_cli without --paged --------------------------------------------------------------


def test_cli_one_shot_drain_and_refusals(tmp_path, capsys):
    """``--prompt`` is the one-shot mode (``engine.generate``), ``--input-file``
    drains through the contiguous scheduler, equal to the paged drain, and
    the paged-only flags are refused with the reference's messages."""
    common = ["--model_config", write_config(tmp_path), "--random-init", "--device", "cpu",
              "--cache-size", str(CACHE), "--max-new-tokens", "6", "--max-batch", "2",
              "--eos-id", "9"]
    prompts = ["3 1 4 1 5 9 2 6", "2 7 1 8", "5 5 5"]
    argv = common + [a for p in prompts for a in ("--prompt", p)]
    outs, seconds, engine = serve_cli.one_shot(argv)
    assert not engine.paged and seconds > 0
    want = engine.generate([[int(t) for t in p.split()] for p in prompts], max_new_tokens=6,
                           eos_id=9)
    assert outs == want
    assert serve_cli.main(argv) == 0
    assert capsys.readouterr().out.split("\n")[:3] == [" ".join(map(str, t)) for t in want]

    path = tmp_path / "prompts.txt"
    path.write_text("\n".join(prompts) + "\n")
    done, _, sched = serve_cli.drain(common + ["--input-file", str(path)])
    assert type(sched) is ContinuousBatchingScheduler and not sched.engine.paged
    paged, _, psched = serve_cli.drain(common + ["--input-file", str(path), "--paged",
                                                 "--page-size", "8", "--chunk-size", "8"])
    assert isinstance(psched, PagedContinuousBatchingScheduler)
    assert {u: c.tokens for u, c in done.items()} == {u: c.tokens for u, c in paged.items()}
    for extra, message in ((["--packed"], "--packed requires --paged"),
                           (["--kv-dtype", "int8"], "--kv-dtype int8 requires --paged"),
                           (["--spec", "ngram"], "--spec requires --paged")):
        with pytest.raises(SystemExit, match=message):
            serve_cli.main(common + ["--prompt", "1 2"] + extra)


def test_cli_serves_unmerged_checkpoints_and_adapters_without_paged(tmp_path):
    """``--checkpoint --no-merge`` and ``--adapter-dir`` build the contiguous
    engine: the unmerged drain equals the paged one, and tenants load into
    slots and decode through them."""
    base = lora_model(1, b_std=0.1)
    path = ckpt.save_checkpoint(str(tmp_path / "base"), 0, base.state_dict(), {},
                                lora_spec=LoraSpec(**SPEC_KW))
    common = ["--model_config", write_config(tmp_path), "--checkpoint", path, "--no-merge",
              "--device", "cpu", "--cache-size", "32", "--max-new-tokens", "5", "--max-batch", "2",
              "--prompt", "3 1 4 1 5 9 2 6", "--prompt", "2 7 1 8"]
    done, _, sched = serve_cli.drain(common)
    assert sched.engine.model.layers[0].mlp.down_proj.lora is not None
    paged = serve_cli.run(common + ["--paged", "--page-size", "8", "--chunk-size", "8"])[0]
    assert {u: c.tokens for u, c in done.items()} == {u: c.tokens for u, c in paged.items()}
    adapters = tmp_path / "adapters"
    tenant = lora_model(2, b_std=0.1)
    ckpt.save_checkpoint(str(adapters), 0, extract_lora_factors(tenant.state_dict()), {},
                         lora_spec=LoraSpec(**SPEC_KW))
    os.rename(adapters / "model_0", adapters / "tA")
    sched = serve_cli.build(serve_cli.parse_args(common + ["--adapter-dir", str(adapters),
                                                           "--adapters", "tA"]))
    assert type(sched) is ContinuousBatchingScheduler and list(sched.adapter_stats()["resident"]) == ["tA"]
    out = sched.run([Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4),
                     Request(uid=1, prompt=[1, 2, 3], max_new_tokens=4, adapter="tA")])
    assert out[0].tokens != out[1].tokens  # the tenant steers


# -- the server over the contiguous scheduler -------------------------------------------------


@pytest.mark.parametrize("stream", [True, False], ids=["sse", "unary"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_server_greedy_output_matches_jax_server(pairs, family, stream, monkeypatch):
    """The same requests, admitted in the same order, through the port's and
    JAX's servers over their contiguous schedulers: identical tokens, no
    ``paging`` block on ``/healthz``, no paged dispatch series on
    ``/metrics``, the same series names and ``/healthz`` keys."""
    monkeypatch.delenv("RELORA_TPU_REPLICA_ID", raising=False)
    jx, pt, _ = pairs[family]
    mix = mixed_requests(FAMILIES[family]["vocab_size"], seed=7)[:5]
    payloads = [{"prompt": p, "max_new_tokens": n, "stream": stream} for _, p, n in mix]
    results, bodies, names = [], [], []
    for cls, sched in ((GenerateServer, ContinuousBatchingScheduler(pt, max_batch=2, eos_id=9,
                                                                    seed=SEED)),
                       (JaxServer, JaxScheduler(jx, max_batch=2, eos_id=9))):
        gate = threading.Event()
        with Served(sched, cls=cls, gate=gate, max_queue=8) as server:
            results.append(serve_in_order(server.port, server, gate, payloads))
            status, body = health(server.port)
            assert status == 200
            bodies.append(body)
            text = metrics_text(server.port)
            names.append({line.split()[2] for line in text.splitlines()
                          if line.startswith("# TYPE ")})
            http_generate(server.port, {"prompt": [1, 2, 3], "max_new_tokens": 2})
    ours, ref = ({final["uid"]: tokens for tokens, final in r} for r in results)
    assert ours == ref and len(ours) == 5
    assert "paging" not in bodies[0] and set(bodies[0]) == set(bodies[1])
    # the hot-swap gauge (weights_version) included: the port reloads too
    assert names[0] == names[1]
    assert not any("dispatch" in n or "kv_pages" in n for n in names[0])


def test_request_spans_match_jax(pairs, monkeypatch):
    """One request through both servers over their contiguous schedulers:
    its spans (request, queue_wait, prefill, insert, decode, sse_flush, and
    the rounds' decode_step) have the reference's names, parents and
    attribute keys."""
    monkeypatch.delenv("RELORA_TPU_REPLICA_ID", raising=False)
    jx, pt, _ = pairs["llama"]
    rid = "feedfacecafebeef"
    shapes = []
    for cls, sched, tracer, recorder in (
        (GenerateServer, ContinuousBatchingScheduler(pt, max_batch=1), Tracer, FlightRecorder()),
        (JaxServer, JaxScheduler(jx, max_batch=1), JaxTracer, JaxRecorder()),
    ):
        with Served(sched, cls=cls, tracer=tracer(service="serve", recorder=recorder)) as server:
            _, final, headers = http_generate(server.port, {"prompt": list(range(1, 12)),
                                                            "max_new_tokens": 4},
                                              {"X-Request-Id": rid})
            assert headers["x-request-id"] == rid and final["finish_reason"] == "length"
            wait_for(lambda: any(s["name"] == "request" and s["trace_id"] == rid
                                 for s in recorder.spans()), "the root span")
        shapes.append(span_shapes(recorder.spans(), rid))
    assert shapes[0] == shapes[1]
    assert {name for name, _, _ in shapes[0]} == {
        "request", "queue_wait", "prefill", "insert", "decode", "decode_step", "sse_flush"}


def test_server_warms_the_contiguous_shapes_through_the_cli(tmp_path, monkeypatch):
    """``build_server`` without ``--paged`` warms every prompt bucket, the
    insert and the decode on the model thread before ``/healthz`` says ok."""
    monkeypatch.delenv("RELORA_TPU_REPLICA_ID", raising=False)
    args = serve_cli.parse_args(["--model_config", write_config(tmp_path), "--random-init",
                                 "--device", "cpu", "--cache-size", str(CACHE), "--max-batch", "2",
                                 "--max-new-tokens", "4", "--port", "0"])
    sched, kw = serve_cli.build_server(args)
    assert type(sched) is ContinuousBatchingScheduler
    kw.pop("port")  # Served binds port 0 itself
    with Served(sched, **kw) as server:
        wait_for(lambda: health(server.port)[0] == 200, "healthz ok")
        assert server.warmup_report == {"batch": 2, "n_compiles": 5}
        tokens, final, _ = http_generate(server.port, {"prompt": [1, 2, 3]})
        assert 1 <= len(tokens) <= 4 and final["finish_reason"] in ("length", "eos")
