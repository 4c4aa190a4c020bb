"""Speculative decoding in the PyTorch port, held to the JAX package.

A tiny Llama (2 layers, hidden 64, cache 32, page 8, chunk 8, K = 4, f32
compute) with the same numpy-seeded weights in both packages
(``models/convert.py::params_from_jax``), on the CPU, where the paged
kernels' wrappers run their plain twins:

- the prompt-lookup drafter equals the JAX scheduler's;
- ``spec_verify_draws``: greedy rows give JAX's ``accept``/``alt`` exactly;
  sampled rows commit the filtered target distribution (total variation
  <= 0.02 over 20,000 keyed draws at V = 8, acceptance rate p(draft) within
  0.02); a row that drafted nothing draws ``sample``'s token bit for bit;
- ``verify_paged`` logits with ``W+1`` tables and a pad row within 1e-4 of
  JAX's, bf16 (here f32) and int8 pools;
- greedy ``spec="ngram"`` drains token-identical to the port's plain drain
  and to JAX's spec drain, sequential and packed, both pools; the
  ``spec=False`` opt-out; ``spec="model"`` with the base as its own draft
  (every draft accepted) and with a perturbed draft, token-identical to the
  plain drain and to JAX with the same draft (drafted and accepted counts
  too); a tenant drain with ``spec="ngram"``; sampled rows that draft
  nothing keep the plain drain's tokens;
- the engine's, the scheduler's and the CLI's guards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.models.params_util import init_params as jax_init_params
from relora_tpu.serve.adapters import (
    AdapterRegistry as JaxRegistry,
    extract_lora_factors as jax_extract,
)
from relora_tpu.serve.engine import InferenceEngine as JaxEngine, build_decode_model as jax_build
from relora_tpu.serve.sampling import spec_verify_draws as jax_spec_verify_draws
from relora_tpu.serve.scheduler import (
    PagedContinuousBatchingScheduler as JaxScheduler,
    Request as JaxRequest,
)
from relora_tpu_torch import serve_cli
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.serve.adapters import AdapterRegistry, extract_lora_factors
from relora_tpu_torch.serve.engine import InferenceEngine
from relora_tpu_torch.serve.sampling import (
    filtered_probs,
    request_generator,
    sample,
    spec_verify_draws,
)
from relora_tpu_torch.serve.scheduler import PagedContinuousBatchingScheduler, Request
from relora_tpu_torch.train import checkpoint as ckpt
from tests.test_torch_adapters import JAX_SPEC, SPEC, perturbed_factors, write_config
from tests.test_torch_llama import CACHE, CHUNK, PAGE, TINY, jax_params

pytestmark = pytest.mark.torch_port

K = 4
MAX_BATCH = 2
TOL = 1e-4  # engine logits after 2 layers, as tests/test_torch_llama.py


def engine_kwargs(kv_dtype="bf16", slot_pages=3):
    return dict(cache_size=CACHE, page_size=PAGE, num_pages=slot_pages * (CACHE // PAGE) + 1,
                chunk_size=CHUNK, kv_dtype=kv_dtype, token_budget=MAX_BATCH * (K + 1) + CHUNK)


@pytest.fixture(scope="module")
def raw():
    return jax_params()


@pytest.fixture(scope="module")
def engines(raw):
    """Per pool: (JAX spec engine, port plain engine, port spec engine)."""
    out = {}
    for kv in ("bf16", "int8"):
        kw = engine_kwargs(kv)
        out[kv] = (
            JaxEngine(JaxModelConfig(**TINY), raw, spec_k=K, **kw),
            InferenceEngine(ModelConfig(**TINY), params_from_jax(raw), device="cpu", **kw),
            InferenceEngine(ModelConfig(**TINY), params_from_jax(raw), device="cpu", spec_k=K, **kw),
        )
    return out


def spec_requests(vocab=256):
    """``tests/test_spec.py``'s mix: self-repeating greedy prompts, a greedy
    random prompt, a sampled row, staggered through two slots (uid, prompt,
    new tokens, temperature, top_p)."""
    rng = np.random.default_rng(7)
    return [
        (1, [3, 5, 7] * 4, 8, 0.0, 1.0),
        (2, rng.integers(1, vocab, 13).tolist(), 6, 0.0, 1.0),
        (3, [2, 4] * 6, 7, 0.8, 0.9),
        (4, rng.integers(1, vocab, 5).tolist(), 5, 0.0, 1.0),
    ]


GREEDY = (1, 2, 4)


def jax_drain(engine, mix, **kwargs):
    sched = JaxScheduler(engine, max_batch=MAX_BATCH, eos_id=9, key=jax.random.PRNGKey(42),
                         **kwargs)
    done = sched.run([JaxRequest(uid=u, prompt=p, max_new_tokens=n, temperature=t, top_p=tp)
                      for u, p, n, t, tp in mix])
    return sched, {uid: c.tokens for uid, c in done.items()}


def torch_drain(engine, mix, spec_flags=None, **kwargs):
    sched = PagedContinuousBatchingScheduler(engine, max_batch=MAX_BATCH, eos_id=9, seed=42,
                                             **kwargs)
    flags = spec_flags or {}
    done = sched.run([Request(uid=u, prompt=p, max_new_tokens=n, temperature=t, top_p=tp,
                              spec=flags.get(u, True)) for u, p, n, t, tp in mix])
    if sched.prefix_cache is not None:
        sched.prefix_cache.clear()
    assert sched.allocator.used_pages == 0  # base and draft runs all came back
    return sched, {uid: c.tokens for uid, c in done.items()}


# -- the drafter ----------------------------------------------------------------


def test_ngram_draft_equals_jax(engines):
    jx, _, pt = engines["bf16"]
    js = JaxScheduler(jx, max_batch=2, spec="ngram", key=jax.random.PRNGKey(0))
    ps = PagedContinuousBatchingScheduler(pt, max_batch=2, spec="ngram")
    rng = np.random.default_rng(3)
    cases = [([1, 2, 3, 4, 2, 3], 3), ([7, 9, 1, 7, 9, 2, 7, 9], 2), ([5, 6, 5, 6], 8),
             ([1, 2, 3, 4, 5], 4), ([1, 2, 3], 0), ([1], 4)]
    cases += [(rng.integers(0, 6, n).tolist(), k) for n, k in ((12, 4), (30, 2), (7, 5), (50, 4))]
    for ctx, k in cases:
        assert ps._ngram_draft(ctx, k) == js._ngram_draft(ctx, k), (ctx, k)
    assert ps._ngram_draft([1, 2, 3, 4, 2, 3], 3) == [4, 2, 3]


# -- the verify sampler -----------------------------------------------------------


def test_spec_verify_draws_greedy_equals_jax():
    rng = np.random.default_rng(5)
    B, S, V = 4, K + 1, 16
    logits = rng.standard_normal((B, S, V)).astype(np.float32)
    am = logits.argmax(-1)
    draft = rng.integers(0, V, (B, K)).astype(np.int32)
    draft[0] = am[0, :K]  # every draft a hit
    draft[1, :2] = am[1, :2]  # two hits, then misses
    k_eff = np.array([4, 3, 0, 2], np.int32)
    uids, starts = np.array([1, 2, 3, 4], np.int32), np.array([0, 5, 2, 9], np.int32)
    ja, jalt = jax_spec_verify_draws(
        jnp.asarray(logits), jnp.asarray(draft), jax.random.PRNGKey(42), jnp.asarray(uids),
        jnp.asarray(starts), jnp.asarray(k_eff), temperature=jnp.zeros(B))
    pa, palt = spec_verify_draws(torch.from_numpy(logits), draft, 42, uids, starts, k_eff,
                                 temperature=np.zeros(B, np.float32))
    np.testing.assert_array_equal(pa, np.asarray(ja))
    np.testing.assert_array_equal(palt, np.asarray(jalt))
    assert pa[0].all() and pa[1, :2].all()


def test_spec_verify_draws_sampled_marginal_is_the_target():
    """Deterministic-proposal rejection sampling: the committed token (the
    draft if accepted, else the residual draw) over 20,000 keyed streams
    follows the filtered target within total variation 0.02, and accepts
    with rate p(draft)."""
    V, N = 8, 20000
    row = np.random.default_rng(9).standard_normal(V).astype(np.float32) * 2.0
    temp, top_k, top_p = 0.7, 5, 0.9
    target = filtered_probs(torch.from_numpy(row)[None], temperature=temp, top_k=top_k,
                            top_p=top_p)[0].numpy()
    d = int(np.argsort(target)[-2])  # a mid-probability draft inside the support
    logits = torch.from_numpy(np.broadcast_to(row, (N, 2, V)).copy())
    accept, alt = spec_verify_draws(
        logits, np.full((N, 1), d), 0, np.arange(N), np.zeros(N, np.int64), np.ones(N, np.int64),
        temperature=np.full(N, temp, np.float32), top_k=top_k, top_p=np.full(N, top_p, np.float32))
    committed = np.where(accept[:, 0], d, alt[:, 0])
    emp = np.bincount(committed, minlength=V) / N
    assert 0.5 * np.abs(emp - target).sum() <= 0.02
    assert abs(accept[:, 0].mean() - target[d]) <= 0.02
    assert emp[target < 1e-12].sum() == 0.0  # filtered-out tokens never appear
    # the bonus slot is a plain target draw too
    assert 0.5 * np.abs(np.bincount(alt[:, 1], minlength=V) / N - target).sum() <= 0.02


def test_row_without_drafts_draws_sample_bit_for_bit():
    """A sampled row with k_eff = 0 commits slot 0's draw from the plain
    (seed, uid, token_index) generator: sample()'s token on the same
    logits.  Greedy rows construct no generator."""
    rng = np.random.default_rng(1)
    B, S, V = 3, K + 1, 64
    logits = torch.from_numpy(rng.standard_normal((B, S, V)).astype(np.float32) * 3)
    temps, top_ps = np.array([0.9, 0.0, 1.3], np.float32), np.array([0.95, 1.0, 1.0], np.float32)
    uids, starts = np.array([11, 12, 13]), np.array([4, 0, 17])
    for seed in range(20):
        _, alt = spec_verify_draws(logits, np.zeros((B, K), np.int64), seed, uids, starts,
                                   np.zeros(B, np.int64), temperature=temps, top_k=20, top_p=top_ps)
        gens = [request_generator(seed, int(u), int(s)) if t > 0 else None
                for u, s, t in zip(uids, starts, temps)]
        want = sample(logits[:, 0], gens, temperature=temps, top_k=20, top_p=top_ps)
        np.testing.assert_array_equal(alt[:, 0], want.numpy())


# -- the verify forward ----------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_verify_paged_logits_match_jax(engines, kv_dtype):
    """Two rows prefilled, then one (2+1, K+1) verify window: row 0's window
    straddles a page edge, row 1 sits mid-page, row 2 is a pad row (all-null
    table at pos = cache_size)."""
    jx, _, pt = engines[kv_dtype]
    rng = np.random.default_rng(0)
    W = CACHE // PAGE
    lengths = (6, 11)
    tables = np.zeros((3, W), np.int32)
    tables[:2] = (np.arange(2 * W).reshape(2, W) + 1)
    jpool, ppool = jx.init_pool(), pt.init_pool()
    for row, L in enumerate(lengths):
        prompt = rng.integers(1, 256, L).astype(np.int32)
        for start in range(0, L, CHUNK):
            ids = np.zeros((1, CHUNK), np.int32)
            part = prompt[start : start + CHUNK]
            ids[0, : len(part)] = part
            _, jpool = jx.prefill_chunk(jnp.asarray(ids), start, jpool, tables[row : row + 1])
            _, ppool = pt.prefill_chunk(ids, start, ppool, tables[row : row + 1])
    tokens = rng.integers(1, 256, (3, K + 1)).astype(np.int32)
    pos = np.full((3, K + 1), CACHE, np.int32)
    pos[:2] = np.array(lengths)[:, None] + np.arange(K + 1)
    vtables = np.zeros((3, W + 1), np.int32)
    vtables[:, :W] = tables
    jl, _ = jx.verify_paged(jpool, jnp.asarray(tokens), pos, vtables)
    pl, _ = pt.verify_paged(ppool, tokens, pos, vtables)
    assert pl.shape == (3, K + 1, 256)
    np.testing.assert_allclose(pl[:2].numpy(), np.asarray(jl)[:2], atol=TOL, rtol=0)
    assert torch.isfinite(pl).all()


# -- drains -------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("packed", [False, True], ids=["paged", "packed"])
def test_greedy_ngram_drain_token_identical(engines, kv_dtype, packed):
    jx, plain, pt = engines[kv_dtype]
    mix = spec_requests()
    _, want = torch_drain(plain, mix, packed=packed)
    js, jax_got = jax_drain(jx, mix, spec="ngram", packed=packed)
    sched, got = torch_drain(pt, mix, spec="ngram", packed=packed)
    for uid in GREEDY:
        assert got[uid] == want[uid] == jax_got[uid], f"uid {uid}"
    assert got[3] and all(0 <= t < 256 for t in got[3])
    stats = sched.spec_stats()
    assert stats["mode"] == "ngram" and stats["k"] == K
    assert stats["drafted"] > 0 and stats["verify_rounds"] > 0
    assert 0 <= stats["accepted"] <= stats["drafted"]
    assert stats["accept_rate"] == pytest.approx(stats["accepted"] / stats["drafted"], abs=1e-3)


def test_greedy_only_ngram_counters_equal_jax(engines):
    """With every row greedy, both packages draft and accept the same tokens."""
    jx, _, pt = engines["bf16"]
    mix = [m for m in spec_requests() if m[3] == 0.0] + [(5, [2, 4] * 6, 9, 0.0, 1.0)]
    js, want = jax_drain(jx, mix, spec="ngram")
    sched, got = torch_drain(pt, mix, spec="ngram")
    assert got == want
    j, p = js.spec_stats(), sched.spec_stats()
    assert (p["drafted"], p["accepted"]) == (j["drafted"], j["accepted"]) and p["drafted"] > 0


def test_spec_false_opts_out(engines):
    _, plain, pt = engines["bf16"]
    mix = [(1, [3, 5, 7] * 4, 6, 0.0, 1.0), (2, [2, 4] * 5, 6, 0.9, 1.0)]
    _, want = torch_drain(plain, mix)
    sched, got = torch_drain(pt, mix, spec_flags={1: False, 2: False}, spec="ngram")
    assert got == want  # the sampled row too: every round took the plain decode
    assert sched.spec_stats()["drafted"] == 0 and sched.spec_stats()["verify_rounds"] == 0


def test_sampled_rows_without_drafts_keep_the_plain_tokens(engines):
    """A sampled spec drain in which no row drafts is the plain sampled
    drain; and sampled rows that opt out keep their plain tokens while they
    ride verify windows (k_eff = 0, the plain key) beside a drafting row."""
    _, plain, pt = engines["bf16"]
    mix = [(1, [17, 3, 250, 91, 6], 3, 0.9, 0.95), (2, [44, 8, 120, 77, 200, 13], 3, 1.2, 1.0)]
    _, want = torch_drain(plain, mix)
    sched, got = torch_drain(pt, mix, spec="ngram")
    assert sched.spec_stats()["drafted"] == 0
    assert got == want
    mix = [(1, [3, 5, 7] * 4, 10, 0.0, 1.0), (2, [2, 4] * 6, 10, 0.9, 0.95)]
    for packed in (False, True):
        _, want = torch_drain(plain, mix, packed=packed)
        sched, got = torch_drain(pt, mix, spec_flags={2: False}, spec="ngram", packed=packed)
        assert sched.spec_stats()["verify_rounds"] > 0
        assert got == want


def perturbed_tree(raw, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda t: (t + scale * np.std(t) * rng.standard_normal(t.shape)).astype(t.dtype), raw)


@pytest.mark.parametrize("draft", ["base", "perturbed"])
def test_model_spec_drain_matches_plain_and_jax(raw, draft):
    kw = engine_kwargs(slot_pages=4)  # the draft's runs beside the base's
    tree = raw if draft == "base" else perturbed_tree(raw, 5, 0.5)
    jx = JaxEngine(JaxModelConfig(**TINY), raw, spec_k=K, **kw)
    jx.load_draft_params(tree)
    plain = InferenceEngine(ModelConfig(**TINY), params_from_jax(raw), device="cpu", **kw)
    pt = InferenceEngine(ModelConfig(**TINY), params_from_jax(raw), device="cpu", spec_k=K, **kw)
    pt.load_draft_params(params_from_jax(tree))
    if draft == "base":  # tests/test_compress.py::test_identical_draft_accepts_everything
        mix = [(1, [3, 5, 7] * 4, 8, 0.0, 1.0), (2, [2, 4] * 6, 8, 0.0, 1.0)]
    else:
        mix = [m for m in spec_requests() if m[3] == 0.0] + [(5, [2, 4] * 6, 8, 0.0, 1.0)]
    _, want = torch_drain(plain, mix)
    js, jax_got = jax_drain(jx, mix, spec="model")
    sched, got = torch_drain(pt, mix, spec="model", prefix_cache=True)
    assert got == want == jax_got
    assert sched.prefix_cache is None  # lockstep: model mode turns it off
    p, j = sched.spec_stats(), js.spec_stats()
    assert (p["drafted"], p["accepted"]) == (j["drafted"], j["accepted"])
    assert p["drafted"] > 0 and p["verify_rounds"] > 0
    if draft == "base":
        assert p["accepted"] == p["drafted"]  # the base's own argmax every time
    else:
        assert 0 < p["accepted"] < p["drafted"]


def test_tenant_drain_with_ngram_spec():
    """A slotted base with two tenants (kernel 5's twin at M = B(K+1) rows
    in every verify forward): greedy spec drains, sequential and packed,
    equal the plain drain and JAX's spec drain."""
    cfg = JaxModelConfig(**TINY)
    model = jax_build(cfg, cache_size=CACHE, lora=JAX_SPEC)
    base = jax.tree_util.tree_map(
        np.asarray, jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    kw = dict(engine_kwargs(), lora=SPEC, adapter_slots=3)
    jkw = dict(engine_kwargs(), lora=JAX_SPEC, adapter_slots=3)
    jx = JaxEngine(cfg, base, spec_k=K, **jkw)
    plain = InferenceEngine(ModelConfig(**TINY), params_from_jax(base), device="cpu", **kw)
    pt = InferenceEngine(ModelConfig(**TINY), params_from_jax(base), device="cpu", spec_k=K, **kw)
    factors = {}
    for name, seed in {"tA": 11, "tB": 22}.items():
        tree = perturbed_factors(base, seed)
        factors[name] = (jax_extract(tree), extract_lora_factors(params_from_jax(tree)))
    mix = [(1, [3, 5, 7] * 4, 8, None), (2, [2, 4] * 6, 7, "tA"), (3, [9, 1, 9, 1, 9], 6, "tB"),
           (4, [6, 6, 8] * 3, 6, "tA")]

    def drain(engine, jax_side, **kwargs):
        if jax_side:
            reg = JaxRegistry(None, 3, writer=engine.adapter_writer())
        else:
            reg = AdapterRegistry(None, 3, writer=engine.adapter_writer())
        for name, (fj, fp) in factors.items():
            reg.preload(name, fj if jax_side else fp, SPEC.scale)
        if jax_side:
            sched = JaxScheduler(engine, max_batch=MAX_BATCH, eos_id=9, key=jax.random.PRNGKey(42),
                                 adapter_registry=reg, **kwargs)
            reqs = [JaxRequest(uid=u, prompt=p, max_new_tokens=n, adapter=a) for u, p, n, a in mix]
        else:
            sched = PagedContinuousBatchingScheduler(engine, max_batch=MAX_BATCH, eos_id=9,
                                                     seed=42, adapter_registry=reg, **kwargs)
            reqs = [Request(uid=u, prompt=p, max_new_tokens=n, adapter=a) for u, p, n, a in mix]
        return sched, {u: c.tokens for u, c in sched.run(reqs).items()}

    for packed in (False, True):
        _, want = drain(plain, False, packed=packed)
        _, jax_got = drain(jx, True, spec="ngram", packed=packed)
        sched, got = drain(pt, False, spec="ngram", packed=packed)
        assert got == want == jax_got
        assert sched.spec_stats()["verify_rounds"] > 0
        assert not sched._adapter_row.any()


# -- guards ---------------------------------------------------------------------------


def test_engine_and_scheduler_guards(raw, engines):
    _, plain, pt = engines["bf16"]
    cfg, params = ModelConfig(**TINY), params_from_jax(raw)
    with pytest.raises(ValueError, match="spec_k must be >= 0"):
        InferenceEngine(cfg, params, spec_k=-1, device="cpu", **engine_kwargs())
    with pytest.raises(ValueError, match="requires the paged engine"):
        InferenceEngine(cfg, params, cache_size=CACHE, spec_k=4, device="cpu")
    with pytest.raises(ValueError, match="spec_k >= 1"):
        PagedContinuousBatchingScheduler(plain, max_batch=2, spec="ngram")
    with pytest.raises(ValueError, match="spec must be"):
        PagedContinuousBatchingScheduler(pt, max_batch=2, spec="lookahead")
    with pytest.raises(ValueError, match="load_draft_params"):
        PagedContinuousBatchingScheduler(pt, max_batch=2, spec="model")
    small = InferenceEngine(cfg, params, spec_k=K, device="cpu",
                            **dict(engine_kwargs(), token_budget=MAX_BATCH * (K + 1) - 1))
    with pytest.raises(ValueError, match="window"):
        PagedContinuousBatchingScheduler(small, max_batch=MAX_BATCH, spec="ngram", packed=True)
    PagedContinuousBatchingScheduler(small, max_batch=MAX_BATCH, packed=True)  # spec off: fits
    with pytest.raises(ValueError, match="no draft model"):
        pt.draft_decode_paged(pt.init_pool(), np.zeros((1, 1)), np.zeros((1, 1)),
                              np.zeros((1, CACHE // PAGE)))

    draft_eng = InferenceEngine(cfg, params, spec_k=K, device="cpu", **engine_kwargs())
    with pytest.raises(ValueError, match="missing param leaf"):
        draft_eng.load_draft_params({k: v for k, v in params.items() if "lm_head" not in k})
    bad = dict(params)
    bad["norm.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="has shape"):
        draft_eng.load_draft_params(bad)
    draft_eng.load_draft_params(params)
    with pytest.raises(ValueError, match="packed"):
        PagedContinuousBatchingScheduler(draft_eng, max_batch=2, spec="model", packed=True)
    # disaggregated roles take the prompt-lookup drafter, not a draft model
    assert PagedContinuousBatchingScheduler(draft_eng, max_batch=2, spec="ngram",
                                            role="decode").role == "decode"
    with pytest.raises(ValueError, match="role must be"):
        PagedContinuousBatchingScheduler(draft_eng, max_batch=2, role="donor")
    with pytest.raises(ValueError, match="role"):
        PagedContinuousBatchingScheduler(draft_eng, max_batch=2, spec="model", role="decode")

    model = jax_build(JaxModelConfig(**TINY), cache_size=CACHE, lora=JAX_SPEC)
    lora_raw = jax.tree_util.tree_map(
        np.asarray, jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    slotted = InferenceEngine(cfg, params_from_jax(lora_raw), lora=SPEC, adapter_slots=3,
                              spec_k=K, device="cpu", **engine_kwargs())
    with pytest.raises(ValueError, match="mutually exclusive"):
        slotted.load_draft_params(params)


def write_checkpoint(root, name, state):
    path = ckpt.save_checkpoint(str(root), 0, state, {"update_step": 0})
    target = root / name
    (root / "model_0").rename(target)
    return str(target), path


def test_cli_spec_drains_and_flag_checks(raw, tmp_path):
    cfg_path = write_config(tmp_path)
    base_dir, _ = write_checkpoint(tmp_path, "base", params_from_jax(raw))
    draft_dir, _ = write_checkpoint(tmp_path, "draft", params_from_jax(perturbed_tree(raw, 5, 0.5)))
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("3 5 7 3 5 7 3 5 7\n2 4 2 4 2 4 2 4\n11 12 13\n")
    common = ["--model_config", cfg_path, "--paged", "--page-size", str(PAGE),
              "--cache-size", str(CACHE), "--chunk-size", str(CHUNK), "--max-batch", "2",
              "--max-new-tokens", "8", "--eos-id", "9", "--device", "cpu",
              "--input-file", str(prompts), "--checkpoint", base_dir]
    want, _ = serve_cli.run(common)
    for extra in (["--spec", "ngram"], ["--spec", "ngram", "--packed"],
                  ["--spec", "model", "--draft-checkpoint", draft_dir]):
        got, _ = serve_cli.run(common + extra)
        assert {u: c.tokens for u, c in got.items()} == {u: c.tokens for u, c in want.items()}, extra

    args = serve_cli.parse_args(common + ["--spec", "ngram", "--packed", "--spec-k", "3"])
    sched = serve_cli.build(args)
    assert sched.engine.token_budget == 2 * 4 + CHUNK and sched.engine.spec_k == 3
    args = serve_cli.parse_args(common + ["--spec", "model", "--draft-checkpoint", draft_dir])
    sched = serve_cli.build(args)
    assert sched.engine.num_pages == 2 * 2 * (CACHE // PAGE) + 1 and sched.prefix_cache is None
    assert serve_cli.build(serve_cli.parse_args(common)).engine.spec_k == 0

    no_paged = [a for a in common if a != "--paged"]
    for argv, msg in (
        (no_paged + ["--spec", "ngram"], "--spec requires --paged"),
        (common + ["--spec", "ngram", "--spec-k", "0"], "spec-k"),
        (common + ["--spec", "model"], "--draft-checkpoint"),
        (common + ["--spec", "model", "--draft-checkpoint", draft_dir, "--packed"], "--packed"),
        (common + ["--draft-checkpoint", draft_dir], "only applies"),
        (common + ["--spec", "model", "--draft-checkpoint", draft_dir, "--no-merge",
                   "--adapter-dir", str(tmp_path)], "--adapter-dir"),
    ):
        with pytest.raises(SystemExit, match=msg):
            serve_cli.build(serve_cli.parse_args(argv))
