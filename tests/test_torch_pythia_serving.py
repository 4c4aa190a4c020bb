"""The GPT-NeoX family through every serving path of the port, held to the
JAX package, and the serving CLI's last flags and the fleet tools.

``TINY_NEOX`` of ``tests/test_torch_pythia.py`` (2 layers, hidden 64, 4
heads, rotary_pct 0.25, the parallel residual, nonzero biases and
LayerNorms off their init), f32 compute on the CPU, where every kernel
wrapper runs its plain twin; both packages load the same numpy-seeded
weights through ``models/convert.py::params_from_jax``:

- ``spec="model"`` with a NeoX draft (the base plus seeded noise): tokens,
  drafted and accepted counts equal to the JAX scheduler's; packed refused
  by both packages alike;
- a packed tenant drain over the int8 pool with ``spec="ngram"`` (kernel
  5's twin at M = B(K+1)) equal to JAX's;
- the contiguous engine's tenant drain equal to JAX's;
- ``serve_cli`` over a NeoX checkpoint with ``--no-merge --adapter-dir
  --spec ngram`` behind the HTTP server: SSE streams naming tenants, half
  with ``"spec": false``, equal to the in-process drain;
- ``--no-prefix-cache`` and ``--tokenizer`` as the reference's ``serve.py``;
- ``relora_tpu_torch.tools.fleet_report`` / ``trace_report`` print what
  ``tools/fleet_report.py`` / ``tools/trace_report.py`` print;
- every new or changed module imports with JAX and ``relora_tpu`` blocked.

Drains are token-identical; the tools' outputs byte-identical.
"""

import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.core import relora as jax_relora
from relora_tpu.models.params_util import init_params as jax_init_params
from relora_tpu.serve.adapters import (
    AdapterRegistry as JaxRegistry,
    extract_lora_factors as jax_extract,
)
from relora_tpu.serve.engine import InferenceEngine as JaxEngine, build_decode_model as jax_build
from relora_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxContiguous,
    PagedContinuousBatchingScheduler as JaxScheduler,
    Request as JaxRequest,
)
from relora_tpu_torch import serve_cli
from relora_tpu_torch.config.model import ModelConfig, load_model_config
from relora_tpu_torch.core import relora
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.models.pythia import GPTNeoXForCausalLM
from relora_tpu_torch.serve.adapters import (
    RELORA_CONFIG_FILE,
    AdapterRegistry,
    extract_lora_factors,
)
from relora_tpu_torch.serve.engine import InferenceEngine
from relora_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    PagedContinuousBatchingScheduler,
    Request,
)
from relora_tpu_torch.train.checkpoint import save_checkpoint
from tests.test_torch_pythia import CACHE, CHUNK, PAGE, TINY_NEOX, perturbed
from tests.test_torch_server import Served, serve_in_order

pytestmark = [pytest.mark.torch_port, pytest.mark.serve]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4
MAX_BATCH = 2
EOS = 9
SPEC_KW = dict(r=4, alpha=8.0)
TENANTS = {"tA": 11, "tB": 22, "tC": 33}


def paged_kwargs(kv_dtype="bf16", runs=MAX_BATCH, budget=MAX_BATCH * (K + 1) + CHUNK):
    """A pool of ``runs`` full-length page runs (the draft's beside the
    base's for ``spec="model"``) and the packed budget of K+1 windows."""
    return dict(cache_size=CACHE, page_size=PAGE, num_pages=runs * (CACHE // PAGE) + 1,
                chunk_size=CHUNK, kv_dtype=kv_dtype, token_budget=budget)


def jax_run(sched, mix):
    done = sched.run([JaxRequest(uid=u, prompt=p, max_new_tokens=n, **a) for u, p, n, a in mix])
    return {uid: c.tokens for uid, c in done.items()}


def port_run(sched, mix):
    done = sched.run([Request(uid=u, prompt=p, max_new_tokens=n, **a) for u, p, n, a in mix])
    return {uid: c.tokens for uid, c in done.items()}


def noisy(tree, seed, scale):
    """``tree`` with seeded Gaussian noise of ``scale`` times each leaf's
    std (the chip run's draft: the base plus noise)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda t: (t + scale * np.std(t) * rng.standard_normal(t.shape)).astype(t.dtype), tree)


def seeded_tree(lora, seed):
    """Numpy weights in the tree of the JAX NeoX model at ``TINY_NEOX``
    (with ``lora``'s leaves), its shapes from ``jax.eval_shape``, so no
    JAX init runs: kernels and embeddings N(0, 0.02) as the init draws
    them, biases N(0, 0.05) and LayerNorm scales 1 + N(0, 0.1) (off their
    init, as ``perturbed`` moves them), ``lora_a`` N(0, 1/fan_in) and
    ``lora_b`` zero."""
    cfg = JaxModelConfig(**TINY_NEOX)
    model = type(jax_build(cfg, cache_size=CACHE, lora=lora))(cfg, lora=lora, dtype=jnp.float32,
                                                               scan_layers=True)
    shapes = jax.eval_shape(lambda: jax_init_params(model, jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(seed)
    draws = {"kernel": (0.0, 0.02), "embedding": (0.0, 0.02), "bias": (0.0, 0.05),
             "scale": (1.0, 0.1), "lora_b": (0.0, 0.0)}

    def fill(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v)
                continue
            mean, std = draws[k] if k != "lora_a" else (0.0, 1.0 / np.sqrt(v.shape[-2]))
            out[k] = (mean + std * rng.standard_normal(v.shape)).astype(v.dtype)
        return out

    return fill(shapes)


@pytest.fixture(scope="module")
def serving_params():
    """The NeoX base the spec drains serve (``seeded_tree``, no LoRA)."""
    return seeded_tree(None, 7)


# -- spec="model" with a NeoX draft ------------------------------------------------------


def test_model_spec_drain_with_a_neox_draft_matches_jax(serving_params):
    """A NeoX draft (biased fused QKV, partial rotary, LayerNorm, parallel
    residual) proposes K tokens a round through its own page runs: greedy
    tokens equal the plain drain and JAX's spec drain, drafted and accepted
    counts equal JAX's, and acceptance lies strictly between 0 and 1.  A
    packed model drafter is refused by both packages."""
    draft = noisy(serving_params, 5, 0.5)
    kw = paged_kwargs(runs=2 * MAX_BATCH)
    jx = JaxEngine(JaxModelConfig(**TINY_NEOX), serving_params, spec_k=K, **kw)
    jx.load_draft_params(draft)
    plain = InferenceEngine(ModelConfig(**TINY_NEOX), params_from_jax(serving_params),
                            device="cpu", **kw)
    pt = InferenceEngine(ModelConfig(**TINY_NEOX), params_from_jax(serving_params), device="cpu",
                         spec_k=K, **kw)
    pt.load_draft_params(params_from_jax(draft))
    assert isinstance(pt.draft_model, GPTNeoXForCausalLM)
    rng = np.random.default_rng(4)
    mix = [(1, [3, 5, 7] * 4, 8, {}), (2, rng.integers(1, 256, 13).tolist(), 6, {}),
           (3, [2, 4] * 6, 8, {}), (4, (rng.integers(1, 256, 5).tolist() * 3)[:14], 7, {})]
    want = port_run(PagedContinuousBatchingScheduler(plain, max_batch=MAX_BATCH, eos_id=EOS), mix)
    js = JaxScheduler(jx, max_batch=MAX_BATCH, eos_id=EOS, key=jax.random.PRNGKey(42), spec="model")
    ps = PagedContinuousBatchingScheduler(pt, max_batch=MAX_BATCH, eos_id=EOS, seed=42, spec="model")
    assert port_run(ps, mix) == jax_run(js, mix) == want
    p, j = ps.spec_stats(), js.spec_stats()
    assert (p["drafted"], p["accepted"]) == (j["drafted"], j["accepted"])
    assert 0 < p["accepted"] < p["drafted"] and p["verify_rounds"] > 0
    assert ps.allocator.used_pages == 0  # base and draft runs all came back
    for cls, extra in ((JaxScheduler, {"key": jax.random.PRNGKey(0)}), (PagedContinuousBatchingScheduler, {})):
        with pytest.raises(ValueError, match="incompatible with packed=True"):
            cls(jx if cls is JaxScheduler else pt, max_batch=MAX_BATCH, spec="model", packed=True,
                **extra)


# -- tenants ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tenant_tree():
    """A LoRA NeoX base (``seeded_tree``'s, ``lora_b`` zero) and three
    tenants' factors, in the JAX and the port form."""
    raw = seeded_tree(jax_relora.LoraSpec(**SPEC_KW), 3)
    factors = {}
    for name, seed in TENANTS.items():
        tree = perturbed(raw, seed)  # the tenant's lora_b drawn off zero
        factors[name] = jax_extract(tree), extract_lora_factors(params_from_jax(tree))
    return raw, factors


def registries(jx, pt, factors, slots):
    rj = JaxRegistry(None, slots, writer=jx.adapter_writer())
    rp = AdapterRegistry(None, slots, writer=pt.adapter_writer())
    scale = relora.LoraSpec(**SPEC_KW).scale
    for name, (fj, fp) in factors.items():
        assert rj.preload(name, fj, scale) == rp.preload(name, fp, scale)
    return rj, rp


def tenant_mix(seed, n=6):
    rng = np.random.default_rng(seed)
    names = [None, "tA", "tB", "tC"]
    return [(u, (rng.integers(1, 256, 3).tolist() * 6)[: int(rng.integers(5, 17))],
             int(rng.integers(4, 9)), {"adapter": names[u % 4]}) for u in range(n)]


def test_packed_int8_tenant_spec_drain_matches_jax(tenant_tree):
    """The base and three tenants over 4 slots, packed over the int8 pool
    with ``spec="ngram"``: every verify window's K+1 tokens a row through
    its tenant's slot, token-identical to JAX's packed spec drain."""
    raw, factors = tenant_tree
    jspec, pspec = jax_relora.LoraSpec(**SPEC_KW), relora.LoraSpec(**SPEC_KW)
    kw = paged_kwargs("int8", runs=3)
    jx = JaxEngine(JaxModelConfig(**TINY_NEOX), raw, lora=jspec, adapter_slots=4, spec_k=K, **kw)
    pt = InferenceEngine(ModelConfig(**TINY_NEOX), params_from_jax(raw), lora=pspec,
                         adapter_slots=4, spec_k=K, device="cpu", **kw)
    rj, rp = registries(jx, pt, factors, 4)
    mix = tenant_mix(6)
    want = jax_run(JaxScheduler(jx, max_batch=MAX_BATCH, eos_id=EOS, key=jax.random.PRNGKey(42),
                                packed=True, spec="ngram", adapter_registry=rj), mix)
    sched = PagedContinuousBatchingScheduler(pt, max_batch=MAX_BATCH, eos_id=EOS, seed=42,
                                             packed=True, spec="ngram", adapter_registry=rp)
    assert port_run(sched, mix) == want and sorted(want) == list(range(6))
    assert sched.spec_stats()["verify_rounds"] > 0 and not sched._adapter_row.any()


def test_contiguous_tenant_drain_matches_jax(tenant_tree, tmp_path):
    """The contiguous engine (prefill-on-admission) with 3 adapter slots
    over four names: tenants load, evict and reload mid-drain, and the
    tokens equal JAX's ``ContinuousBatchingScheduler``'s."""
    raw, factors = tenant_tree
    jspec, pspec = jax_relora.LoraSpec(**SPEC_KW), relora.LoraSpec(**SPEC_KW)
    jx = JaxEngine(JaxModelConfig(**TINY_NEOX), raw, lora=jspec, adapter_slots=3, cache_size=CACHE)
    pt = InferenceEngine(ModelConfig(**TINY_NEOX), params_from_jax(raw), lora=pspec,
                         adapter_slots=3, cache_size=CACHE, device="cpu")
    for name in factors:
        (tmp_path / name).mkdir()
        (tmp_path / name / RELORA_CONFIG_FILE).write_text(json.dumps(SPEC_KW))
    scale = pspec.scale
    rj = JaxRegistry(str(tmp_path), 3, writer=jx.adapter_writer(),
                     loader=lambda path, r: (factors[os.path.basename(path)][0], scale))
    rp = AdapterRegistry(str(tmp_path), 3, writer=pt.adapter_writer(),
                         loader=lambda path, r: (factors[os.path.basename(path)][1], scale))
    mix = tenant_mix(9, n=8)
    want = jax_run(JaxContiguous(jx, max_batch=MAX_BATCH, eos_id=EOS, key=jax.random.PRNGKey(42),
                                 adapter_registry=rj), mix)
    sched = ContinuousBatchingScheduler(pt, max_batch=MAX_BATCH, eos_id=EOS, seed=42, adapter_registry=rp)
    assert port_run(sched, mix) == want and sorted(want) == list(range(8))
    assert rp.stats()["evictions_total"] == rj.stats()["evictions_total"] > 0


# -- the CLI: checkpoints, the server, the last two flags -------------------------------


@pytest.fixture(scope="module")
def neox_cli(tmp_path_factory, tenant_tree):
    """An HF ``config.json`` of ``TINY_NEOX`` (``model_type: gpt_neox``), the
    LoRA base as a port checkpoint and the three tenants as adapter
    checkpoints; returns (root, the flags every CLI case shares)."""
    raw, factors = tenant_tree
    root = tmp_path_factory.mktemp("neox_cli")
    hf = dict(model_type="gpt_neox", max_position_embeddings=TINY_NEOX["max_sequence_length"],
              **{k: v for k, v in TINY_NEOX.items() if k not in ("family", "max_sequence_length")})
    (root / "neox").mkdir()
    (root / "neox" / "config.json").write_text(json.dumps(hf))
    assert load_model_config(str(root / "neox")) == ModelConfig(**TINY_NEOX)
    spec = relora.LoraSpec(**SPEC_KW)
    base = save_checkpoint(str(root / "base"), 0, params_from_jax(raw), {"update_step": 0},
                           lora_spec=spec)
    for i, (name, (_, fp)) in enumerate(factors.items()):
        path = save_checkpoint(str(root / "tenants"), i, fp, {"update_step": 0}, lora_spec=spec)
        os.rename(path, root / "tenants" / name)
    flags = ["--model_config", str(root / "neox"), "--checkpoint", base, "--paged", "--device", "cpu",
             "--page-size", str(PAGE), "--cache-size", str(CACHE), "--chunk-size", str(CHUNK),
             "--max-batch", str(MAX_BATCH), "--max-new-tokens", "6", "--eos-id", str(EOS)]
    return root, flags


def test_server_spec_nomerge_tenants_stream_the_in_process_drain(neox_cli, tenant_tree):
    """``serve_cli --no-merge --adapter-dir --adapters tA,tB --spec ngram``
    behind the HTTP server: SSE clients round-robin over [base, tA, tB, tC]
    (tC loaded on demand), every other one with ``"spec": false``; each
    stream equals the in-process drain of the same requests, and that
    drain equals JAX's sequential ``spec="ngram"`` tenant drain over the
    same weights, pool and slots."""
    root, flags = neox_cli
    argv = flags + ["--no-merge", "--adapter-dir", str(root / "tenants"), "--adapters", "tA,tB",
                    "--spec", "ngram", "--spec-k", str(K)]
    rng = np.random.default_rng(12)
    names = [None, "tA", "tB", "tC"]
    payloads = [{"prompt": (rng.integers(1, 256, 4).tolist() * 4)[: 6 + 2 * i],
                 "max_new_tokens": 6, "adapter": names[i % 4], "spec": i % 2 == 0}
                for i in range(8)]
    gate = threading.Event()
    sched = serve_cli.build(serve_cli.parse_args(argv))
    with Served(sched, gate=gate, max_queue=8) as server:
        results = serve_in_order(server.port, server, gate, payloads)
    got = {final["uid"]: tokens for tokens, final in results}
    assert sched.spec_stats()["verify_rounds"] > 0
    mix = [(u, p["prompt"], 6, {"adapter": p["adapter"], "spec": p["spec"]})
           for u, p in enumerate(payloads)]
    fresh = serve_cli.build(serve_cli.parse_args(argv))
    want = port_run(fresh, mix)
    assert got == want and sorted(got) == list(range(8))
    raw, factors = tenant_tree  # the CLI's defaults: 4 slots, a bf16 pool of max_batch runs
    jx = JaxEngine(JaxModelConfig(**TINY_NEOX), raw, lora=jax_relora.LoraSpec(**SPEC_KW),
                   adapter_slots=4, spec_k=K, **dict(paged_kwargs(), token_budget=None))
    rj = JaxRegistry(None, 4, writer=jx.adapter_writer())
    for name, (fj, _) in factors.items():
        rj.preload(name, fj, relora.LoraSpec(**SPEC_KW).scale)
    js = JaxScheduler(jx, max_batch=MAX_BATCH, eos_id=EOS, key=jax.random.PRNGKey(0),
                      spec="ngram", adapter_registry=rj)
    assert jax_run(js, mix) == want
    p, j = fresh.spec_stats(), js.spec_stats()
    assert (p["drafted"], p["accepted"]) == (j["drafted"], j["accepted"]) and j["drafted"] > 0


def test_no_prefix_cache_flag(neox_cli, tmp_path):
    """``--no-prefix-cache`` builds the paged scheduler without its prefix
    cache: a repeated prompt hits nothing, and the tokens equal the cached
    drain's (which does hit)."""
    _, flags = neox_cli
    prompt = " ".join(str(t) for t in np.random.default_rng(2).integers(1, 256, 21))
    path = tmp_path / "prompts.txt"
    path.write_text(f"{prompt}\n{prompt}\n{prompt}\n")
    drains = {}
    for extra in ([], ["--no-prefix-cache"]):
        done, _, sched = serve_cli.drain(flags + ["--max-batch", "1", "--input-file", str(path)]
                                         + extra)
        drains[bool(extra)] = ({u: c.tokens for u, c in done.items()}, sched.prefix_cache)
    (cached, cache), (uncached, none) = drains[False], drains[True]
    assert cache is not None and cache.hits > 0 and none is None
    assert uncached == cached
    assert not serve_cli.parse_args(flags).no_prefix_cache


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    """A word-level tokenizer trained in place (no download) and saved as an
    HF tokenizer directory; its ids fit TINY_NEOX's vocabulary."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    words = [f"w{i}" for i in range(120)]
    tok.train_from_iterator([" ".join(words[i:i + 7]) for i in range(0, 120, 3)],
                            trainers.WordLevelTrainer(special_tokens=["<unk>", "<pad>"]))
    path = tmp_path_factory.mktemp("tokenizer")
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>").save_pretrained(str(path))
    return str(path)


def test_tokenizer_flag_serves_text_prompts(neox_cli, tokenizer_dir, tmp_path, capsys):
    """``--tokenizer DIR``: text prompts drain as the token-id drain of their
    encodings, and the printed lines are ``tokenizer.decode`` of the tokens;
    without the flag a text prompt gets the reference's error."""
    from transformers import AutoTokenizer

    sys.path.insert(0, REPO)
    import serve as jax_serve

    _, flags = neox_cli
    tokenizer = AutoTokenizer.from_pretrained(tokenizer_dir)
    lines = ["w3 w17 w40 w3 w17 w40 w3\n", "w99 w5 w5 w61\n", "w100 w2 w7 w11 w13 w17 w19 w23\n"]
    text, ids = tmp_path / "text.txt", tmp_path / "ids.txt"
    text.write_text("".join(lines))
    encoded = [tokenizer.encode(line) for line in lines]
    ids.write_text("".join(" ".join(map(str, e)) + "\n" for e in encoded))
    got, _ = serve_cli.run(flags + ["--input-file", str(text), "--tokenizer", tokenizer_dir])
    want, _ = serve_cli.run(flags + ["--input-file", str(ids)])
    assert {u: c.tokens for u, c in got.items()} == {u: c.tokens for u, c in want.items()}
    capsys.readouterr()
    assert serve_cli.main(flags + ["--input-file", str(text), "--tokenizer", tokenizer_dir]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed == [tokenizer.decode(want[u].tokens) for u in sorted(want)]
    with pytest.raises(SystemExit) as port_err:
        serve_cli.run(flags + ["--input-file", str(text)])
    with pytest.raises(SystemExit) as ref_err:
        jax_serve._encode(lines[0], None)
    assert str(port_err.value) == str(ref_err.value)
    assert "pass --tokenizer to use text prompts" in str(port_err.value)


# -- the fleet tools -------------------------------------------------------------------------


def write_fleet_series(path):
    """A seeded ``fleet_series.jsonl`` in the collector's schema: three
    replicas' scraped serving series, an autoscaler, a trainer's mfu, and
    the events the report's timeline, SLO and autoscale sections read."""
    rng = np.random.default_rng(17)
    records, t0 = [], 1_700_000_000.0
    for step in range(40):
        t = t0 + 2.0 * step
        for i, src in enumerate(("r0", "r1", "r2")):
            records.append({
                "_source": src, "_time": t + 0.01 * i,
                "up": 0.0 if (src == "r1" and 20 <= step < 24) else 1.0,
                "healthz_queue_depth": float(rng.integers(0, 5)),
                "healthz_active_slots": float(rng.integers(0, 8)),
                "relora_serve_ttft_seconds_p95": float(rng.uniform(0.2, 3.0)),
                "relora_serve_tpot_seconds_p95": float(rng.uniform(0.01, 0.7)),
                "error_rate": float(rng.uniform(0.0, 0.1)),
                "relora_serve_tokens_generated_total_per_s": float(rng.uniform(50, 200)),
                "spec_accept_rate": float(rng.uniform(0.1, 0.9)),
                "spec_mode_model": float(i == 2),
                "adapter_churn": float(rng.uniform(0, 2)),
                "relora_serve_adapter_hit_rate": float(rng.uniform(0.5, 1.0)),
                "tokens_per_dispatch": float(rng.uniform(8, 72)),
                "relora_serve_prefill_stall_share": float(rng.uniform(0, 0.5)),
            })
        records.append({"_source": "autoscaler", "_time": t, "replicas_live": float(2 + step // 15)})
        records.append({"_source": "train", "_time": t, "mfu": float(rng.uniform(0.02, 0.2))})
    events = [
        (10, "health_flip", "r1", {"healthy": False}),
        (12, "supervisor_respawn", "r1", {"replica": 1, "detail": "exit -9"}),
        (15, "autoscale_decision", "autoscaler", {"action": "up", "reason": "ttft_burn",
                                                  "burn_long": 3.2}),
        (22, "slo_burn_alert", "r1", {"state": "firing", "slo": "availability",
                                      "burn_long": 14.5, "burn_short": 20.0}),
        (26, "slo_burn_alert", "r1", {"state": "resolved", "slo": "availability",
                                      "burn_long": 0.5, "burn_short": 0.0}),
        (30, "deploy_complete", "router", {"checkpoint": "model_2", "version": 2}),
        (33, "autoscale_hold", "autoscaler", {"action": "hold", "reason": "cooldown"}),
        (35, "series_anomaly", "r2", {"series": "error_rate", "z": 4.1}),
    ]
    for step, kind, src, fields in events:
        records.append({"_event": kind, "_source": src, "_time": t0 + 2.0 * step + 0.5, **fields})
    records.sort(key=lambda r: r["_time"])
    path.write_text("".join(json.dumps(r) + "\n" for r in records) + '{"torn": ')


def write_spans(tmp_path):
    """Span streams of two processes joined on trace ids (a router's and a
    replica's), and a flight dump, written by the port's own tracer and
    flight recorder."""
    from relora_tpu_torch.obs.flight import FlightRecorder
    from relora_tpu_torch.obs.tracer import Tracer

    recorder = FlightRecorder(span_capacity=64)
    router = Tracer("router", jsonl_path=str(tmp_path / "router_spans_1.jsonl"))
    replica = Tracer("serve", recorder=recorder, jsonl_path=str(tmp_path / "serve_spans_2.jsonl"))
    for i in range(4):
        rid = f"req{i:02d}"
        with router.span("route", trace_id=rid, adapter=None):
            with router.span("proxy_attempt", trace_id=rid, replica="r1", attempt=0):
                with replica.span("request", trace_id=rid, uid=i):
                    with replica.span("queue_wait", trace_id=rid):
                        pass
                    for _ in range(3):
                        with replica.span("decode_step", trace_id=rid, batch=2):
                            pass
        replica.event("finish", trace_id=rid, reason="length")
    router.close()
    replica.close()
    dump = tmp_path / "flight_sigterm_7.json"
    recorder.dump(str(dump), reason="sigterm")
    return [str(tmp_path / "router_spans_1.jsonl"), str(tmp_path / "serve_spans_2.jsonl")], str(dump)


def test_fleet_tools_print_what_the_reference_tools_print(tmp_path):
    """``python -m relora_tpu_torch.tools.fleet_report`` and ``trace_report``
    (JAX and ``relora_tpu`` blocked) against ``tools/fleet_report.py`` and
    ``tools/trace_report.py`` on the same files: stdout equal, exit codes
    equal, the merged Chrome export equal, and an empty file refused alike."""
    series = tmp_path / "fleet_series.jsonl"
    write_fleet_series(series)
    streams, dump = write_spans(tmp_path)
    (tmp_path / "empty.jsonl").write_text("")
    blocked = ("import runpy, sys\n"
               "for name in ('jax', 'jaxlib', 'flax', 'relora_tpu', 'torch'):\n"
               "    sys.modules[name] = None\n"
               "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
               "runpy.run_module(sys.argv[0], run_name='__main__')\n")
    cases = {
        "fleet": ["fleet_report", str(series), "--window-s", "60", "--events", "20"],
        "fleet_json": ["fleet_report", str(series), "--json"],
        "fleet_join": ["fleet_report", str(series), "--join", f"train2={series}"],
        "fleet_empty": ["fleet_report", str(tmp_path / "empty.jsonl")],
        "trace_merged": ["trace_report", *streams, "--chrome", "{out}/chrome.json"],
        "trace_one": ["trace_report", streams[1], "--max-traces", "2"],
        "trace_dump": ["trace_report", dump],
        "trace_empty": ["trace_report", str(tmp_path / "empty.jsonl")],
    }
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    procs = {}
    for label, (tool, *args) in cases.items():
        for side in ("port", "ref"):
            out = tmp_path / f"{label}_{side}"
            out.mkdir()
            argv = [a.format(out=out) for a in args]
            if side == "port":
                cmd = [sys.executable, "-c", blocked, f"relora_tpu_torch.tools.{tool}", *argv]
            else:  # the port's report has no check of the JAX package's BENCH rounds
                cmd = [sys.executable, os.path.join(REPO, "tools", f"{tool}.py"), *argv,
                       *(["--bench-dir", ""] if tool == "fleet_report" else [])]
            procs[label, side] = (subprocess.Popen(cmd, cwd=out, env=env, stdout=subprocess.PIPE,
                                                   stderr=subprocess.PIPE, text=True), out)
    results = {key: (p.communicate(timeout=120), p.returncode, out)
               for key, (p, out) in procs.items()}
    for label in cases:
        (port_out, port_err), port_rc, port_dir = results[label, "port"]
        (ref_out, _), ref_rc, ref_dir = results[label, "ref"]
        assert port_rc == ref_rc, (label, port_err[-2000:])
        assert port_out.replace(str(port_dir), "OUT") == ref_out.replace(str(ref_dir), "OUT"), label
    assert results["fleet_empty", "port"][1] == results["trace_empty", "port"][1] == 1
    fleet = results["fleet", "port"][0][0]
    for section in ("== fleet health ==", "== replica comparison", "== SLO / error budget ==",
                    "== autoscale ==", "== timeline"):
        assert section in fleet
    assert "route" in results["trace_merged", "port"][0][0]
    chrome = [json.loads((results["trace_merged", side][2] / "chrome.json").read_text())
              for side in ("port", "ref")]
    assert chrome[0] == chrome[1] and chrome[0]["traceEvents"]


@pytest.fixture(scope="module", autouse=True)
def import_probe():
    """A process where importing jax, flax or relora_tpu fails imports every
    module this slice adds or changes; the two tools load no torch.  It
    starts when the file's first test sets up and runs beside the drains;
    ``test_new_and_changed_modules_import_without_jax`` reads its result."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'relora_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import relora_tpu_torch.tools.fleet_report, relora_tpu_torch.tools.trace_report\n"
        "assert 'torch' not in sys.modules, 'a fleet tool imported torch'\n"
        "import relora_tpu_torch.serve_cli, relora_tpu_torch.serve.engine\n"
        "import relora_tpu_torch.serve.scheduler, relora_tpu_torch.models.pythia\n"
        "args = relora_tpu_torch.serve_cli.parse_args(['--model_config', 'pythia_1b',"
        " '--no-prefix-cache', '--tokenizer', 'tok'])\n"
        "assert args.no_prefix_cache and args.tokenizer == 'tok'\n"
        "assert 'transformers' not in sys.modules, 'serve_cli imported transformers'\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            env={**os.environ, "PYTHONPATH": REPO}, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def test_new_and_changed_modules_import_without_jax(import_probe):
    """The jax-blocked import of :func:`import_probe` exits 0."""
    _, err = import_probe.communicate(timeout=120)
    assert import_probe.returncode == 0, err[-3000:]
