"""Multi-tenant adapter serving in the PyTorch port, held to the JAX package.

The same numpy-seeded inputs and weights go through both packages at a tiny
Llama (2 layers, hidden 64, LoRA r 4, 3 adapter slots), on the CPU, where
the port's kernel-5 wrapper runs its plain twin and the JAX package runs its
grouped Pallas kernel in interpret mode (or, inside its engine, the gathered
reference that its CPU dispatch picks):

- the kernel-5 twin against ``grouped_lora_matmul(interpret=True)`` and
  ``grouped_lora_reference`` within 1e-5 (f32 sums in another order);
- every ``lora_matmul_grouped`` arm, and ``LoRALinear(num_slots)`` against the
  JAX module within 1e-5;
- engine logits for ``prefill_chunk``, ``decode_paged`` and ``step_paged``
  with a mixed ``adapter_idx`` within 1e-4 (the engine tolerance of
  ``tests/test_torch_llama.py``);
- greedy drains token-identical to the JAX scheduler, sequential and packed,
  with the prefix cache on;
- a tenant never reads another tenant's prefix pages (the JAX package keys
  its prefix cache by tokens alone; the port salts it with the adapter);
- the adapter registry's LRU/refcount logic, slot contention, the port's
  checkpoint directories, merged ``--checkpoint`` serving, and the CLI's
  adapter flag checks.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.core.relora import LoraSpec as JaxLoraSpec, merged_params as jax_merged_params
from relora_tpu.models.lora import LoRALinear as JaxLoRALinear
from relora_tpu.models.params_util import init_params as jax_init_params
from relora_tpu.ops.pallas_lora_matmul import (
    grouped_lora_matmul as jax_grouped,
    grouped_lora_reference as jax_grouped_reference,
)
from relora_tpu.serve.adapters import (
    AdapterRegistry as JaxRegistry,
    extract_lora_factors as jax_extract,
)
from relora_tpu.serve.engine import InferenceEngine as JaxEngine, build_decode_model as jax_build
from relora_tpu.serve.scheduler import (
    PagedContinuousBatchingScheduler as JaxScheduler,
    Request as JaxRequest,
)
from relora_tpu_torch import serve_cli
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.core.relora import LoraSpec
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.models.llama import LlamaForCausalLM
from relora_tpu_torch.models.lora import LoRALinear
from relora_tpu_torch.models.params_util import init_params
from relora_tpu_torch.ops.lora_dispatch import GROUPED_ARMS, lora_matmul_grouped
from relora_tpu_torch.ops.lora_matmul import fused_lora_forward_plain, grouped_lora_matmul
from relora_tpu_torch.serve.adapters import (
    BASE_ADAPTER,
    RELORA_CONFIG_FILE,
    AdapterRegistry,
    default_loader,
    extract_lora_factors,
)
from relora_tpu_torch.serve.engine import InferenceEngine
from relora_tpu_torch.serve.scheduler import PagedContinuousBatchingScheduler, Request
from relora_tpu_torch.train import checkpoint as ckpt
from tests.test_torch_llama import TINY

pytestmark = pytest.mark.torch_port

SPEC_KW = dict(r=4, alpha=8.0)
SPEC, JAX_SPEC = LoraSpec(**SPEC_KW), JaxLoraSpec(**SPEC_KW)
SLOTS = 3
CACHE, PAGE, CHUNK, MAX_BATCH = 32, 8, 8, 3
KERNEL_TOL = 1e-5  # f32 twin vs the JAX kernel: the same sums in another order
TOL = 1e-4  # engine logits after 2 layers, as tests/test_torch_llama.py
TENANTS = {"tA": 11, "tB": 22}  # name -> seed of its factors


# -- kernel 5: the plain twin against the JAX kernel ---------------------------


def grouped_operands(M=6, K=32, N=128, r=4, S=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    a = (rng.standard_normal((S, K, r)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((S, r, N)) * 0.1).astype(np.float32)
    s = np.linspace(0.0, 2.0, S).astype(np.float32)
    idx = (np.arange(M) * 7 % S).astype(np.int32)
    return x, w, a, b, s, idx


def torch_args(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(t)) for t in arrays]


@pytest.mark.parametrize("shape", [(6, 32, 128, 4, 3), (5, 72, 100, 8, 3), (6, 32, 128, 320, 3)],
                         ids=["mixed", "ragged", "rank320"])
def test_grouped_twin_matches_jax_kernel_and_reference(shape):
    M, K, N, r, S = shape
    ops = grouped_operands(M, K, N, r, S)
    got = grouped_lora_matmul(*torch_args(*ops)).numpy()
    jx = [jnp.asarray(t) for t in ops]
    np.testing.assert_allclose(got, np.asarray(jax_grouped(*jx, interpret=True)), atol=KERNEL_TOL)
    np.testing.assert_allclose(got, np.asarray(jax_grouped_reference(*jx)), atol=KERNEL_TOL)
    assert len(set(ops[-1].tolist())) == S  # every slot, slot 0 included, is in use


def test_grouped_twin_one_slot_equals_fused_twin_and_slot_zero_is_base():
    x, w, a, b, s, _ = torch_args(*grouped_operands())
    for j in range(a.shape[0]):
        idx = torch.full((x.shape[0],), j, dtype=torch.int32)
        want, _ = fused_lora_forward_plain(x, w, a[j], b[j], float(s[j]))
        torch.testing.assert_close(grouped_lora_matmul(x, w, a, b, s, idx), want,
                                   atol=KERNEL_TOL, rtol=0)
    a[0], b[0] = 0.0, 0.0
    idx = torch.zeros(x.shape[0], dtype=torch.int32)
    torch.testing.assert_close(grouped_lora_matmul(x, w, a, b, s, idx), x @ w, atol=KERNEL_TOL, rtol=0)


def test_grouped_shape_errors():
    x, w, a, b, s, idx = torch_args(*grouped_operands())
    with pytest.raises(ValueError, match="contraction mismatch"):
        grouped_lora_matmul(x[:, :16], w, a, b, s, idx)
    with pytest.raises(ValueError, match="B stack"):
        grouped_lora_matmul(x, w, a, b[:, :, :64], s, idx)
    with pytest.raises(ValueError, match="adapter_idx"):
        grouped_lora_matmul(x, w, a, b, s, idx[:3])
    with pytest.raises(ValueError, match="B stack"):
        grouped_lora_matmul(x, w, torch.zeros(3, 32, 257), torch.zeros(3, 256, 128), s, idx)
    # any rank is taken: zero adapters of rank 257 leave the base product
    big = torch.zeros(3, 32, 257)
    torch.testing.assert_close(grouped_lora_matmul(x, w, big, torch.zeros(3, 257, 128), s, idx), x @ w,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown grouped arm"):
        lora_matmul_grouped(x, w, a, b, s, idx, arm="fused")
    with pytest.raises(ValueError, match="dense base"):
        lora_matmul_grouped(x, (w.to(torch.int8), torch.ones(1, 128)), a, b, s, idx)


@pytest.mark.parametrize("arm", GROUPED_ARMS + ("auto",))
def test_lora_matmul_grouped_arms_match_jax(arm):
    ops = grouped_operands()
    want = np.asarray(jax_grouped_reference(*[jnp.asarray(t) for t in ops]))
    got = lora_matmul_grouped(*torch_args(*ops), arm=arm)
    np.testing.assert_allclose(got.numpy(), want, atol=KERNEL_TOL)


def test_lora_linear_slots_match_jax_module():
    rng = np.random.default_rng(4)
    B, T, K, N = 2, 3, 32, 48
    x = rng.standard_normal((B, T, K)).astype(np.float32)
    spec_kw = dict(SPEC_KW, num_slots=SLOTS)
    jmod = JaxLoRALinear(features=N, lora=JaxLoraSpec(**spec_kw), dtype=jnp.float32)
    params = nn.meta.unbox(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params = {k: np.asarray(v) for k, v in params.items()}
    assert params["lora_a"].shape == (SLOTS, K, 4) and not params["lora_b"].any()
    np.testing.assert_allclose(params["lora_s"], np.full(SLOTS, 2.0))
    params["lora_a"] = rng.standard_normal(params["lora_a"].shape).astype(np.float32) * 0.1
    params["lora_b"] = rng.standard_normal(params["lora_b"].shape).astype(np.float32) * 0.1
    params["lora_s"] = np.array([0.5, 1.0, 3.0], np.float32)
    pmod = LoRALinear(K, N, lora=LoraSpec(**spec_kw))
    init_state = {k: v.clone() for k, v in pmod.state_dict().items() if k != "weight"}
    assert not init_state["lora_a"].any() and torch.equal(init_state["lora_s"], torch.full((SLOTS,), 2.0))
    pmod.load_state_dict({"weight": torch.from_numpy(params["kernel"].T.copy()),
                          **{k: torch.from_numpy(params[k]) for k in ("lora_a", "lora_b", "lora_s")}})
    for idx in (np.array([2, 1], np.int32), np.array([1, 0, 2, 2, 0, 1], np.int32), None):
        want = jmod.apply({"params": params}, jnp.asarray(x),
                          adapter_idx=None if idx is None else jnp.asarray(idx))
        got = pmod(torch.from_numpy(x), adapter_idx=None if idx is None else torch.from_numpy(idx))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=KERNEL_TOL)


def test_lora_spec_reads_a_jax_sidecar_and_refuses_what_jax_refuses(tmp_path):
    jax_spec = JaxLoraSpec(r=8, alpha=16.0, use_double_quant=False, weights_static=True, num_slots=4)
    (tmp_path / RELORA_CONFIG_FILE).write_text(json.dumps(dataclasses.asdict(jax_spec)))
    spec = ckpt.load_lora_spec(str(tmp_path))
    assert dataclasses.asdict(spec) == dataclasses.asdict(jax_spec)
    for bad, match in ((dict(trainable_scaling=True), "trainable_scaling"), (dict(quantize="int8"), "dense base")):
        with pytest.raises(ValueError, match=match):
            JaxLoraSpec(r=4, num_slots=2, **bad)
        with pytest.raises(ValueError, match=match):
            LoraSpec(r=4, num_slots=2, **bad)


# -- engine and scheduler against the JAX package --------------------------------


def perturbed_factors(raw, seed):
    """``raw`` with every lora_a / lora_b leaf redrawn from numpy (seeded)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {
            k: walk(v) if isinstance(v, dict)
            else (rng.standard_normal(np.shape(v)) * 0.1).astype(np.float32)
            if k in ("lora_a", "lora_b") else v
            for k, v in node.items()
        }

    return walk(raw)


def engine_kwargs():
    return dict(cache_size=CACHE, page_size=PAGE, num_pages=MAX_BATCH * (CACHE // PAGE) + 1,
                chunk_size=CHUNK, token_budget=MAX_BATCH + CHUNK)


@pytest.fixture(scope="module")
def tenant_pair():
    """A JAX and a port engine with 3 slots over the same base, and each
    tenant's factors in both packages' forms."""
    cfg = JaxModelConfig(**TINY)
    model = jax_build(cfg, cache_size=CACHE, lora=JAX_SPEC)
    raw = jax.tree_util.tree_map(
        np.asarray, jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    )
    jx = JaxEngine(cfg, raw, lora=JAX_SPEC, adapter_slots=SLOTS, **engine_kwargs())
    pt = InferenceEngine(ModelConfig(**TINY), params_from_jax(raw), lora=SPEC, adapter_slots=SLOTS,
                         device="cpu", **engine_kwargs())
    factors = {}
    for name, seed in TENANTS.items():
        tree = perturbed_factors(raw, seed)
        factors[name] = (jax_extract(tree), extract_lora_factors(params_from_jax(tree)))
    return jx, pt, factors, raw


def base_only(state):
    return {k: v for k, v in state.items() if ".lora_" not in k}


def registries(pair, slots=SLOTS):
    jx, pt, factors, _ = pair
    rj = JaxRegistry(None, slots, writer=jx.adapter_writer())
    rp = AdapterRegistry(None, slots, writer=pt.adapter_writer())
    for name, (fj, fp) in factors.items():
        assert rj.preload(name, fj, SPEC.scale) == rp.preload(name, fp, SPEC.scale)
    return rj, rp


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_engine_steps_with_mixed_adapters_match_jax(tenant_pair):
    jx, pt = tenant_pair[:2]
    registries(tenant_pair)  # tA in slot 1, tB in slot 2
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (11, 5, 7)]
    slots = [1, 2, 0]
    W = CACHE // PAGE
    tables = (np.arange(MAX_BATCH * W).reshape(MAX_BATCH, W) + 1).astype(np.int32)
    jpool, ppool = jx.init_pool(), pt.init_pool()
    for row, prompt in enumerate(prompts):
        for start in range(0, len(prompt), CHUNK):
            ids = np.zeros((1, CHUNK), np.int32)
            part = prompt[start : start + CHUNK]
            ids[0, : len(part)] = part
            table = tables[row : row + 1]
            jl, jpool = jx.prefill_chunk(jnp.asarray(ids), start, jpool, table, adapter_idx=[slots[row]])
            pl, ppool = pt.prefill_chunk(ids, start, ppool, table, adapter_idx=[slots[row]])
            _close(pl, jl)

    token = np.array([[17], [42], [5]], np.int32)
    pos = np.array([[len(p)] for p in prompts], np.int32)
    jl, jpool = jx.decode_paged(jpool, jnp.asarray(token), pos, tables, adapter_idx=slots)
    pl, ppool = pt.decode_paged(ppool, token, pos, tables, adapter_idx=slots)
    _close(pl, jl)
    # the same token through another slot gives other logits: slots route
    other, _ = pt.decode_paged([{k: t.clone() for k, t in layer.items()} for layer in ppool],
                               token, pos, tables, adapter_idx=[0, 0, 0])
    assert not torch.allclose(other[:2], pl[:2], atol=1e-3)

    ptables = np.zeros((MAX_BATCH + 1, W + 1), np.int32)
    ptables[:MAX_BATCH, :W] = tables
    ids = np.array([[3, 9, 4, 0, 0, 0, 0, 0]], np.int32)
    positions = np.array([[len(p) + 1 for p in prompts] + [CACHE] * 5], np.int32)
    row_map = np.array([0, 1, 2] + [MAX_BATCH] * 5, np.int32)
    adapter_idx = np.array(slots + [0] * 5, np.int32)
    jl, jpool = jx.step_paged(jpool, jnp.asarray(ids), positions, ptables, row_map, adapter_idx=adapter_idx)
    pl, ppool = pt.step_paged(ppool, ids, positions, ptables, row_map, adapter_idx=adapter_idx)
    _close(pl[:, :3], jl[:, :3])
    with pytest.raises(ValueError, match="adapter_idx must have shape"):
        pt.decode_paged(ppool, token, pos, tables, adapter_idx=[1, 2])


def tenant_mix():
    rng = np.random.default_rng(7)
    p = [rng.integers(1, 256, n).tolist() for n in (13, 21, 9, 5)]
    # (uid, prompt, new tokens, adapter); uid 5 repeats uid 2's prompt and tenant
    return [(1, p[0], 6, None), (2, p[1], 5, "tA"), (3, p[2], 8, "tB"), (4, p[3], 7, "tA"),
            (5, p[1], 4, "tA")]


@pytest.mark.parametrize("packed", [False, True], ids=["paged", "packed"])
def test_multi_tenant_drain_token_identical_to_jax(tenant_pair, packed):
    jx, pt = tenant_pair[:2]
    rj, rp = registries(tenant_pair)
    mix = tenant_mix()
    js = JaxScheduler(jx, max_batch=MAX_BATCH, eos_id=9, key=jax.random.PRNGKey(42),
                      packed=packed, adapter_registry=rj)
    want = {u: c.tokens for u, c in js.run(
        [JaxRequest(uid=u, prompt=p, max_new_tokens=n, adapter=a) for u, p, n, a in mix]).items()}
    ps = PagedContinuousBatchingScheduler(pt, max_batch=MAX_BATCH, eos_id=9, seed=42,
                                          packed=packed, adapter_registry=rp)
    got = {u: c.tokens for u, c in ps.run(
        [Request(uid=u, prompt=p, max_new_tokens=n, adapter=a) for u, p, n, a in mix]).items()}
    assert got == want and sorted(got) == [1, 2, 3, 4, 5]
    assert ps.prefix_cache.hits >= 1  # uid 5 reused tA's own pages
    assert all(v["refs"] == 0 for v in ps.adapter_stats()["resident"].values())
    assert not ps._adapter_row.any()  # every retired row went back to slot 0
    ps.prefix_cache.clear()
    assert ps.allocator.used_pages == 0


def test_prefix_pages_never_cross_tenants(tenant_pair):
    """tB after tA on one 20-token prompt (two full pages of 8) equals tB
    alone: tB misses tA's cached pages, while a tenant's own repeat hits."""
    pt = tenant_pair[1]
    _, rp = registries(tenant_pair)
    prompt = np.random.default_rng(3).integers(1, 256, 20).tolist()

    def drain(adapters):
        sched = PagedContinuousBatchingScheduler(pt, max_batch=1, seed=0, adapter_registry=rp)
        done = sched.run([Request(uid=i, prompt=prompt, max_new_tokens=6, adapter=a)
                          for i, a in enumerate(adapters)])
        return [done[i].tokens for i in range(len(adapters))], sched.prefix_cache.hits

    (after_a, b_after), hits = drain(["tA", "tB"])
    (b_alone,), _ = drain(["tB"])
    assert hits == 0 and b_after == b_alone and after_a != b_alone
    (_, base_after), hits = drain(["tA", None])
    (base_alone,), _ = drain([None])
    assert hits == 0 and base_after == base_alone
    for repeat in (["tA", "tA"], [None, BASE_ADAPTER]):
        (first, second), hits = drain(repeat)
        assert hits == 1 and first == second


def test_slot_contention_evicts_then_retries(tenant_pair):
    """Two slots (one loadable), two tenants: tB queues until tA's request
    retires, then evicts tA and completes, token-identical to tB alone."""
    _, _, factors, raw = tenant_pair
    pt = InferenceEngine(ModelConfig(**TINY), params_from_jax(raw), lora=SPEC, adapter_slots=2,
                         device="cpu", **engine_kwargs())
    reg = AdapterRegistry(None, 2, writer=pt.adapter_writer())
    reg.preload("tA", factors["tA"][1], SPEC.scale)
    reg._loader = lambda path, r: (factors["tB"][1], SPEC.scale)
    reg.adapter_path = lambda name: name if name in factors else None
    sched = PagedContinuousBatchingScheduler(pt, max_batch=2, adapter_registry=reg)
    reqs = [Request(uid=i, prompt=[5, 9, 3], max_new_tokens=5, adapter=a) for i, a in enumerate(["tA", "tB"])]
    done = sched.run(reqs)
    assert [len(done[i].tokens) for i in (0, 1)] == [5, 5]
    assert reg.evictions_total == 1 and reg.slot_of("tB") == 1 and reg.slot_of("tA") is None
    solo = PagedContinuousBatchingScheduler(pt, max_batch=1, adapter_registry=reg)
    assert solo.run([reqs[1]])[1].tokens == done[1].tokens


def test_engine_adapter_validation(tenant_pair):
    _, pt, factors, raw = tenant_pair
    with pytest.raises(ValueError, match="adapter_slots"):
        InferenceEngine(ModelConfig(**TINY), params_from_jax(raw), adapter_slots=3, device="cpu",
                        **engine_kwargs())
    with pytest.raises(ValueError, match="adapter_slots"):
        InferenceEngine(ModelConfig(**TINY), params_from_jax(raw), lora=SPEC, adapter_slots=1,
                        device="cpu", **engine_kwargs())
    fp = factors["tA"][1]
    with pytest.raises(ValueError, match="slot"):
        pt.write_adapter_slot(0, fp, 1.0)  # the identity slot is immutable
    with pytest.raises(ValueError, match="slot"):
        pt.write_adapter_slot(SLOTS, fp, 1.0)  # out of range
    before = pt.model.layers[0].self_attn.q_proj.lora_a[1].clone()
    bad = {k: v[..., :2] for k, v in fp.items()}
    with pytest.raises(ValueError, match="shape"):
        pt.write_adapter_slot(1, bad, 1.0)
    assert torch.equal(pt.model.layers[0].self_attn.q_proj.lora_a[1], before)  # left as it was
    bare = InferenceEngine(ModelConfig(**TINY), params_from_jax(raw), lora=SPEC, adapter_slots=2,
                           device="cpu", **engine_kwargs())
    assert not any(p.any() for n, p in bare.model.named_parameters() if n.endswith(("lora_a", "lora_b")))
    with pytest.raises(ValueError, match="engine built with adapter_slots"):
        PagedContinuousBatchingScheduler(
            InferenceEngine(ModelConfig(**TINY), base_only(params_from_jax(raw)), device="cpu",
                            **engine_kwargs()),
            max_batch=1, adapter_registry=AdapterRegistry(None, 2))
    sched = PagedContinuousBatchingScheduler(pt, max_batch=1)
    with pytest.raises(ValueError, match="adapter"):
        sched.validate_request(Request(uid=9, prompt=[1], max_new_tokens=1, adapter="tA"))
    sched = PagedContinuousBatchingScheduler(pt, max_batch=1, adapter_registry=AdapterRegistry(None, 2))
    with pytest.raises(ValueError, match="unknown adapter"):
        sched.validate_request(Request(uid=9, prompt=[1], max_new_tokens=1, adapter="nope"))


# -- the registry's refcounted LRU (tests/test_adapters.py's logic tests) --------


def fake_adapter_dir(tmp_path, names):
    root = tmp_path / "adapters"
    for name in names:
        (root / name).mkdir(parents=True)
        (root / name / RELORA_CONFIG_FILE).write_text(json.dumps({"r": 4, "alpha": 8}))
    return str(root)


def recording_registry(tmp_path, names=("tA", "tB", "tC"), num_slots=3):
    writes = []
    reg = AdapterRegistry(
        fake_adapter_dir(tmp_path, names), num_slots,
        writer=lambda slot, factors, scale: writes.append((slot, factors, scale)),
        loader=lambda path, r: ({"m.lora_a": os.path.basename(path)}, 2.0),
    )
    return reg, writes


def test_registry_identity_slot_and_validation(tmp_path):
    reg, writes = recording_registry(tmp_path)
    assert reg.acquire(None) == 0 and reg.acquire(BASE_ADAPTER) == 0
    reg.release(None)
    reg.release(BASE_ADAPTER)
    assert not writes  # slot 0 is never written
    assert reg.known(BASE_ADAPTER) and reg.known("tA") and not reg.known("nope")
    assert reg.list_adapters() == ["tA", "tB", "tC"]
    with pytest.raises(ValueError, match="num_slots must be >= 2"):
        AdapterRegistry(None, 1)
    with pytest.raises(ValueError, match="reserved"):
        reg.preload(BASE_ADAPTER, {}, 1.0)


def test_registry_load_hit_refcount_and_release(tmp_path):
    reg, writes = recording_registry(tmp_path)
    s1 = reg.acquire("tA")
    assert s1 == 1 and reg.misses_total == 1 and reg.loads_total == 1
    assert writes[-1][0] == 1 and writes[-1][2] == 2.0
    assert reg.acquire("tA") == s1 and reg.hits_total == 1 and reg.loads_total == 1
    assert reg.stats()["resident"]["tA"]["refs"] == 2
    reg.release("tA")
    reg.release("tA")
    assert reg.stats()["resident"]["tA"]["refs"] == 0
    with pytest.raises(ValueError, match="no active requests"):
        reg.release("tA")
    assert reg.slot_of("tA") == s1  # stays warm after release


def test_registry_lru_eviction_skips_pinned(tmp_path):
    reg, _ = recording_registry(tmp_path)
    reg.acquire("tA")
    reg.acquire("tB")
    assert reg.acquire("tC") is None and reg.evictions_total == 0  # both pinned: stay queued
    reg.release("tA")  # unpinned and least recently used: the victim
    assert reg.acquire("tC") == 1 and reg.evictions_total == 1
    assert reg.slot_of("tA") is None and reg.slot_of("tB") == 2
    reg.release("tB")
    reg.release("tC")
    reg.acquire("tB")  # a hit refreshes recency: tC is now the LRU victim
    reg.release("tB")
    assert reg.acquire("tA") == 1 and reg.evictions_total == 2
    assert reg.slot_of("tC") is None and reg.slot_of("tB") == 2


def test_registry_failed_load_keeps_slot_clean(tmp_path):
    calls = []

    def flaky(path, r):
        calls.append(path)
        if len(calls) == 1:
            raise ValueError("corrupt checkpoint")
        return {"m.lora_a": "ok"}, 1.0

    reg = AdapterRegistry(fake_adapter_dir(tmp_path, ["tA"]), 2, loader=flaky)
    with pytest.raises(ValueError, match="corrupt"):
        reg.acquire("tA")
    assert reg.slot_of("tA") is None and reg.stats()["slots_free"] == 1
    assert reg.acquire("tA") == 1
    with pytest.raises(ValueError, match="unknown adapter"):
        reg.acquire("missing")


def test_registry_preload_and_stats(tmp_path):
    reg, writes = recording_registry(tmp_path, num_slots=4)
    assert reg.preload("warm", {"m.lora_a": 1}, 0.5) == 1
    assert reg.preload("warm", {}, 0.5) == 1  # idempotent
    assert writes[-1][0] == 1 and writes[-1][2] == 0.5 and reg.known("warm")
    stats = reg.stats()
    assert stats["num_slots"] == 4 and stats["slots_used"] == 2
    assert stats["resident"]["warm"] == {"slot": 1, "refs": 0}
    reg.acquire("tA")
    reg.acquire("tA")
    reg.release("tA")
    assert reg.stats()["hit_rate"] == 0.5


# -- checkpoints and the CLI ------------------------------------------------------


def write_config(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({**{k: v for k, v in TINY.items() if k != "family"},
                                "model_type": "llama"}))
    return str(path)


def lora_model(seed, spec=SPEC, b_std=0.0):
    with torch.device("cpu"):
        model = LlamaForCausalLM(ModelConfig(**TINY), lora=spec)
    gen = torch.Generator().manual_seed(seed)
    init_params(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * b_std)
    return model


def test_checkpoint_round_trip_and_corruption(tmp_path):
    model = lora_model(0, b_std=0.1)
    state = model.state_dict()
    path = ckpt.save_checkpoint(str(tmp_path), 5, state, {"update_step": 5}, lora_spec=SPEC)
    assert path == ckpt.checkpoint_dir(str(tmp_path), 5)
    assert ckpt.verify_checkpoint(path) == (True, "ok")
    restored = ckpt.restore_params_host(path)
    assert restored.keys() == state.keys() and all(torch.equal(restored[k], state[k]) for k in state)
    with open(os.path.join(path, ckpt.TRAINING_STATE_FILE)) as f:
        assert json.load(f) == {"update_step": 5}
    assert ckpt.load_lora_spec(path) == SPEC
    factors, scale = default_loader(path, expected_r=4)
    assert scale == SPEC.scale and set(factors) == {k for k in state if k.endswith(("lora_a", "lora_b"))}
    with pytest.raises(ValueError, match="r=4"):
        default_loader(path, expected_r=8)
    raw = bytearray((tmp_path / "model_5" / ckpt.PARAMS_FILE).read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (tmp_path / "model_5" / ckpt.PARAMS_FILE).write_bytes(bytes(raw))
    ok, reason = ckpt.verify_checkpoint(path)
    assert not ok and "checksum mismatch for params.pt" in reason
    with pytest.raises(ValueError, match="corrupt"):
        ckpt.restore_serving_params(path)
    orbax = tmp_path / "orbax"
    (orbax / ckpt.ORBAX_SUBDIR).mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        ckpt.restore_params_host(str(orbax))


def test_merged_checkpoint_serving_equals_jax_merge(tenant_pair, tmp_path):
    raw = perturbed_factors(tenant_pair[3], 5)
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_merged_params(jax.tree_util.tree_map(jnp.asarray, raw), JAX_SPEC)))
    path = ckpt.save_checkpoint(str(tmp_path), 1, params_from_jax(raw), {}, lora_spec=SPEC)
    got = ckpt.restore_serving_params(path)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0)
    # the CLI serves it: tokens equal a port engine holding the JAX merge
    args = ["--model_config", write_config(tmp_path), "--checkpoint", path, "--paged",
            "--device", "cpu", "--cache-size", "32", "--page-size", "8", "--chunk-size", "8",
            "--max-new-tokens", "5", "--max-batch", "2", "--prompt", "3 1 4 1 5 9 2 6",
            "--prompt", "2 7 1 8"]
    completions, _ = serve_cli.run(args)
    engine = InferenceEngine(ModelConfig(**TINY), want, device="cpu", cache_size=32, page_size=8,
                             num_pages=9, chunk_size=8)
    direct = PagedContinuousBatchingScheduler(engine, max_batch=2, eos_id=1).run(
        [Request(uid=0, prompt=[3, 1, 4, 1, 5, 9, 2, 6], max_new_tokens=5),
         Request(uid=1, prompt=[2, 7, 1, 8], max_new_tokens=5)])
    assert {u: c.tokens for u, c in completions.items()} == {u: c.tokens for u, c in direct.items()}


def test_cli_serves_adapters_from_checkpoint_dirs(tmp_path):
    base = lora_model(1)
    base_path = ckpt.save_checkpoint(str(tmp_path / "base"), 0, base.state_dict(), {}, lora_spec=SPEC)
    adapters = tmp_path / "adapters"
    for i, name in enumerate(("tA", "tB")):
        tenant = lora_model(2 + i, b_std=0.1)
        factors = extract_lora_factors(tenant.state_dict())
        ckpt.save_checkpoint(str(adapters), 0, factors, {}, lora_spec=LoraSpec(r=4, alpha=4.0 * (i + 1)))
        os.rename(adapters / "model_0", adapters / name)
    args = ["--model_config", write_config(tmp_path), "--checkpoint", base_path, "--no-merge",
            "--adapter-dir", str(adapters), "--adapters", "tA,tB", "--adapter-slots", "3",
            "--paged", "--device", "cpu", "--cache-size", "32", "--page-size", "8",
            "--chunk-size", "8", "--max-new-tokens", "4", "--prompt", "1 2 3"]
    sched = serve_cli.build(serve_cli.parse_args(args))
    stats = sched.adapter_stats()
    assert set(stats["resident"]) == {"tA", "tB"} and stats["loads_total"] == 2
    q_proj = sched.engine.model.layers[0].self_attn.q_proj
    assert q_proj.lora_s.tolist() == [SPEC.scale, 1.0, 2.0]  # each sidecar's alpha / r
    done = sched.run([Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4, adapter=None),
                      Request(uid=1, prompt=[1, 2, 3], max_new_tokens=4, adapter="tB")])
    completions, _ = serve_cli.run(args)
    assert completions[0].tokens == done[0].tokens  # the CLI's rows decode the base
    plain = InferenceEngine(ModelConfig(**TINY), base_only(base.state_dict()), device="cpu",
                            cache_size=32, page_size=8, num_pages=9, chunk_size=8)
    solo = PagedContinuousBatchingScheduler(plain, max_batch=1, eos_id=1).run(
        [Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4)])
    assert done[0].tokens == solo[0].tokens  # slot 0 is the identity


def test_cli_adapter_flag_validation(tmp_path):
    common = ["--model_config", "llama_9m", "--checkpoint", "nowhere", "--prompt", "1 2 3"]
    with pytest.raises(SystemExit, match="requires --no-merge"):
        serve_cli.main(common + ["--adapter-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="requires --adapter-dir"):
        serve_cli.main(common + ["--no-merge", "--adapters", "tA"])
    with pytest.raises(SystemExit, match="requires --adapter-dir"):
        serve_cli.main(common + ["--no-merge", "--adapter-slots", "4"])
    with pytest.raises(SystemExit, match="must be >= 2"):
        serve_cli.main(common + ["--no-merge", "--adapter-dir", str(tmp_path), "--adapter-slots", "1"])
    with pytest.raises(SystemExit, match="not a directory"):
        serve_cli.main(common + ["--no-merge", "--adapter-dir", str(tmp_path / "missing")])
    with pytest.raises(SystemExit, match="excludes --checkpoint"):
        serve_cli.main(["--model_config", "llama_9m", "--random-init", "--no-merge", "--paged",
                        "--device", "cpu", "--prompt", "1 2 3"])
