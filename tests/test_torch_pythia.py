"""The GPT-NeoX / Pythia family in the PyTorch port, held to the JAX package.

Two tiny NeoX configs, f32 compute on the CPU: ``TINY_NEOX`` of
``tests/test_adapters.py`` (2 layers, hidden 64, 4 heads, rotary_pct 0.25,
the parallel residual) and a 4-head hidden-128 variant with the sequential
residual (``WIDE_SEQ``, rotary_dim 8).  Both packages load the same
numpy-seeded weights through ``models/convert.py::params_from_jax``, with
nonzero biases, LayerNorm parameters away from their init and nonzero LoRA
B.  On the CPU every kernel wrapper of the port runs its plain twin; the
JAX package runs its Pallas kernels as its own tests do (interpret mode,
``RELORA_TPU_PALLAS_QUANT=1`` for the dequant matmul).

Tolerances: outputs, gradients and logits within 1e-4 of ``max(1,
max|JAX value|)`` (f32 sums in another order by two frameworks); per-update
training loss within 1e-4; drains token-identical; weights converted,
grafted and initialised bit for bit.  Against HF ``GPTNeoXForCausalLM`` the
logits agree within the atol 2e-4 / rtol 2e-3 of ``tests/test_pythia.py``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta as flax_meta

from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.core import optim as jax_optim
from relora_tpu.core import relora as jax_relora
from relora_tpu.core.partition import partition
from relora_tpu.core.schedules import make_schedule as jax_make_schedule
from relora_tpu.models.hf_compat import graft_base_weights as jax_graft, hf_to_params
from relora_tpu.models.lora import LoRALinear as JaxLoRALinear
from relora_tpu.models.params_util import init_params as jax_init_params, unstack_layers
from relora_tpu.models.pythia import GPTNeoXForCausalLM as JaxNeoX
from relora_tpu.ops.quant import quantize_int8 as jax_quantize_int8
from relora_tpu.serve.adapters import (
    AdapterRegistry as JaxRegistry,
    extract_lora_factors as jax_extract,
)
from relora_tpu.serve.engine import InferenceEngine as JaxEngine, build_decode_model as jax_build
from relora_tpu.serve.scheduler import (
    PagedContinuousBatchingScheduler as JaxScheduler,
    Request as JaxRequest,
)
from relora_tpu.train.state import TrainState as JaxTrainState
from relora_tpu.train.step import make_train_step as jax_make_train_step
from relora_tpu_torch import serve_cli
from relora_tpu_torch.config.model import ModelConfig, load_model_config
from relora_tpu_torch.config.training import TrainingConfig
from relora_tpu_torch.core import relora
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.models.family import causal_lm_class
from relora_tpu_torch.models.llama import LlamaForCausalLM
from relora_tpu_torch.models.lora import LoRALinear
from relora_tpu_torch.models.params_util import init_params
from relora_tpu_torch.models.pythia import GPTNeoXForCausalLM
from relora_tpu_torch.models.warm_start import graft_base_weights, load_warm_start
from relora_tpu_torch.ops import lora_matmul as LM
from relora_tpu_torch.ops import quant_matmul as QM
from relora_tpu_torch.serve.adapters import AdapterRegistry, extract_lora_factors
from relora_tpu_torch.serve.engine import InferenceEngine, build_decode_model
from relora_tpu_torch.serve.scheduler import PagedContinuousBatchingScheduler, Request
from relora_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_NEOX = dict(family="neox", vocab_size=256, hidden_size=64, intermediate_size=160,
                 num_hidden_layers=2, num_attention_heads=4, max_sequence_length=64,
                 rotary_pct=0.25)
WIDE_SEQ = dict(TINY_NEOX, vocab_size=128, hidden_size=128, intermediate_size=256,
                max_sequence_length=32, use_parallel_residual=False)
CONFIGS = [pytest.param(TINY_NEOX, id="parallel"), pytest.param(WIDE_SEQ, id="sequential")]
SPEC_KW = dict(r=4, alpha=8.0, dropout=0.0)
CACHE, PAGE, CHUNK, MAX_BATCH = 32, 8, 8, 2
TOL = 1e-4
LOSS_TOL = 1e-4


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)


def perturbed(tree, seed, factors=True):
    """``tree`` with every bias, LayerNorm scale and (with ``factors``)
    lora_b leaf moved off its init by seeded numpy noise."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if k == "bias" or (k == "lora_b" and factors):
                v = v + (rng.standard_normal(v.shape) * 0.05).astype(v.dtype)
            elif k == "scale" and "layernorm" in "".join(path + (k,)).replace("_layer_norm", "layernorm"):
                v = v + (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
            out[k] = v
        return out

    return walk(tree, ())


def jax_neox_params(cfg_kwargs, spec=None, seed=0):
    """A scanned JAX NeoX init (LoRA leaves with ``spec``), perturbed, as numpy."""
    model = JaxNeoX(JaxModelConfig(**cfg_kwargs), lora=spec, dtype=jnp.float32, scan_layers=True,
                    attention_impl="naive")
    params = jax_init_params(model, jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return model, perturbed(jax.tree_util.tree_map(np.asarray, params), seed + 100)


# -- the model ----------------------------------------------------------------------


@pytest.mark.parametrize("cfg_kwargs", CONFIGS)
def test_training_forward_matches_jax_logits(cfg_kwargs):
    """Logits of the LoRA-wrapped training forward (nonzero biases and B)
    against ``GPTNeoXForCausalLM.apply``, parallel and sequential residual."""
    spec = jax_relora.LoraSpec(**SPEC_KW)
    model, params = jax_neox_params(cfg_kwargs, spec)
    ids = np.random.default_rng(1).integers(0, cfg_kwargs["vocab_size"], (2, 16))
    want = model.apply({"params": params}, jnp.asarray(ids))
    port = GPTNeoXForCausalLM(ModelConfig(**cfg_kwargs), lora=relora.LoraSpec(**SPEC_KW))
    port.load_state_dict(params_from_jax(params))
    got = port(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg_kwargs["vocab_size"])
    _close(got, want)


def test_family_dispatch_and_refusals():
    """The dispatch builds each family's class; a NeoX config never builds a
    Llama (nor the reverse); an unknown family raises.  The HF id of the
    recipe reaches the NeoX model at pythia_1b's width (built on the meta
    device) with the config's parameter count."""
    neox, llama = ModelConfig(**TINY_NEOX), ModelConfig(family="llama")
    assert causal_lm_class(neox) is GPTNeoXForCausalLM
    assert causal_lm_class(llama) is LlamaForCausalLM
    with pytest.raises(ValueError, match="Unknown model family"):
        causal_lm_class(ModelConfig(family="mamba"))
    with pytest.raises(ValueError, match="'llama' family"):
        LlamaForCausalLM(neox)
    with pytest.raises(ValueError, match="'neox' family"):
        GPTNeoXForCausalLM(llama)
    cfg = load_model_config("EleutherAI/pythia-1b")
    assert cfg == load_model_config("pythia_1b") and (cfg.head_dim, cfg.rotary_dim) == (256, 64)
    with torch.device("meta"):
        model = causal_lm_class(cfg)(cfg, dtype=torch.bfloat16)
    assert isinstance(model, GPTNeoXForCausalLM)
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params()


# -- the biased LoRALinear, arm by arm -------------------------------------------------

ARMS = {
    "dense": dict(),
    "fused": dict(fused=True),
    "int8": dict(quantize="int8"),
    "int8_fused": dict(quantize="int8", fused=True),
}
ARM_TWINS = {
    "fused": (LM, "fused_lora_forward_plain"),
    "int8": (QM, "dequant_matmul_plain"),
    "int8_fused": (LM, "fused_lora_int8_forward_plain"),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_biased_lora_linear_matches_jax(arm, monkeypatch):
    """y and the gradients of x, A, B and the bias of LoRALinear(bias=True)
    against the JAX module (``use_bias=True``) with the same base, bias and
    factors, on each arm; the port's fused and int8 arms ran their twins."""
    monkeypatch.setenv("RELORA_TPU_PALLAS_QUANT", "1")
    spec = dict(r=8, alpha=16.0, dropout=0.0, **ARMS[arm])
    jmod = JaxLoRALinear(features=128, use_bias=True, lora=jax_relora.LoraSpec(**spec),
                         dtype=jnp.float32)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, flax_meta.unbox(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    w = (rng.standard_normal((64, 128)) * 0.05).astype(np.float32)
    if "quantize" in spec:
        params["kernel_q"], params["kernel_scale"] = (np.asarray(v) for v in jax_quantize_int8(w))
    else:
        params["kernel"] = w
    assert not params["bias"].any()  # zero at init, as the port's
    params["bias"] = rng.standard_normal(128).astype(np.float32)
    params["lora_b"] = rng.standard_normal(params["lora_b"].shape).astype(np.float32) * 0.1
    cot = rng.standard_normal((4, 16, 128)).astype(np.float32)
    y, vjp = jax.vjp(lambda p, xx: jmod.apply({"params": p}, xx),
                     jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))

    mod = LoRALinear(64, 128, lora=relora.LoraSpec(**spec), bias=True)
    assert mod.bias is not None and not mod.bias.any()
    with torch.no_grad():
        if "quantize" in spec:
            mod.weight_q.copy_(torch.from_numpy(params["kernel_q"].T.copy()))
            mod.weight_scale.copy_(torch.from_numpy(params["kernel_scale"]))
        else:
            mod.weight.copy_(torch.from_numpy(w.T.copy()))
        for name in ("bias", "lora_a", "lora_b"):
            getattr(mod, name).copy_(torch.from_numpy(params[name]))
    relora.set_trainable(mod)
    calls = []
    if arm in ARM_TWINS:
        module, name = ARM_TWINS[arm]
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt)
    out.backward(torch.from_numpy(cot))
    assert bool(calls) == (arm in ARM_TWINS)
    _close(out, y, "y")
    _close(xt.grad, gx, "dx")
    for name in ("bias", "lora_a", "lora_b"):
        _close(getattr(mod, name).grad, gp[name], name)


def test_biased_grouped_lora_linear_matches_jax():
    """The slotted layout (kernel 5's arm) with a bias and a mixed
    ``adapter_idx`` against the JAX module; the arm serves, so outputs only."""
    spec = dict(r=4, alpha=8.0, num_slots=3)
    jmod = JaxLoRALinear(features=48, use_bias=True, lora=jax_relora.LoraSpec(**spec),
                         dtype=jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    params = {k: np.asarray(v) for k, v in flax_meta.unbox(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]).items()}
    for name in ("bias", "lora_a", "lora_b"):
        params[name] = rng.standard_normal(params[name].shape).astype(np.float32) * 0.1
    mod = LoRALinear(32, 48, lora=relora.LoraSpec(**spec), bias=True)
    mod.load_state_dict({"weight": torch.from_numpy(params["kernel"].T.copy()),
                         **{k: torch.from_numpy(params[k]) for k in ("bias", "lora_a", "lora_b",
                                                                     "lora_s")}})
    for idx in (np.array([2, 1], np.int32), np.array([1, 0, 2, 2, 0, 1], np.int32), None):
        want = jmod.apply({"params": params}, jnp.asarray(x),
                          adapter_idx=None if idx is None else jnp.asarray(idx))
        got = mod(torch.from_numpy(x), adapter_idx=None if idx is None else torch.from_numpy(idx))
        _close(got, want)


def test_lora_only_layer_has_no_bias():
    mod = LoRALinear(16, 8, lora=relora.LoraSpec(r=2, lora_only=True), bias=True)
    assert mod.bias is None and mod.weight is None


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["dense", "int8"])
def test_set_trainable_trains_biases_and_layernorms(quantize):
    """Biases, LayerNorms, embeddings and factors train; the frozen bases
    (weight, or weight_q / weight_scale) do not; merges leave biases alone."""
    model = GPTNeoXForCausalLM(ModelConfig(**TINY_NEOX), lora=relora.LoraSpec(r=4,
                                                                               quantize=quantize))
    init_params(model, torch.Generator().manual_seed(0))
    relora.set_trainable(model)
    flags = {n: p.requires_grad for n, p in model.named_parameters()}
    frozen = {n for n, on in flags.items() if not on}
    projections = [n for n, _ in relora.lora_modules(model)]
    assert len(projections) == 4 * TINY_NEOX["num_hidden_layers"]
    leaves = ("weight_q", "weight_scale") if quantize else ("weight",)
    assert frozen == {f"{p}.{leaf}" for p in projections for leaf in leaves}
    for name, on in flags.items():
        if name.endswith(".bias") or "layernorm" in name or "layer_norm" in name:
            assert on, name
    assert flags["embed_in.weight"] and flags["embed_out.weight"]
    with torch.no_grad():
        for _, m in relora.lora_modules(model):
            m.lora_b.normal_(generator=torch.Generator().manual_seed(1))
    biases = {n: p.clone() for n, p in model.named_parameters() if n.endswith(".bias")}
    relora.merge_and_reinit(model, torch.Generator().manual_seed(2), model.lora)
    for name, before in biases.items():
        assert torch.equal(dict(model.named_parameters())[name], before), name


# -- weights ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["lora", "int8", "slotted"])
def test_scanned_and_unrolled_trees_convert_alike(kind):
    """params_from_jax on a scanned and an unrolled NeoX tree gives one state
    dict (LoRA leaves, int8 codes and scales, slotted stacks and biases
    included), which loads strictly into the port's model."""
    spec_kw = {"lora": dict(r=4), "int8": dict(r=4, quantize="int8"),
               "slotted": dict(r=4, num_slots=3)}[kind]
    _, tree = jax_neox_params(TINY_NEOX, jax_relora.LoraSpec(**spec_kw))
    scanned = params_from_jax(tree)
    unrolled = params_from_jax(unstack_layers(tree))
    assert scanned.keys() == unrolled.keys()
    for name in scanned:
        assert torch.equal(scanned[name], unrolled[name]), name
    assert scanned["layers.1.attention.dense.bias"].abs().sum() > 0
    if kind == "int8":
        assert scanned["layers.0.mlp.dense_4h_to_h.weight_q"].dtype == torch.int8
    model = GPTNeoXForCausalLM(ModelConfig(**TINY_NEOX), lora=relora.LoraSpec(**spec_kw))
    model.load_state_dict(scanned)  # strict: names and shapes match the port


def test_init_params_draws_the_reference_initializers():
    """init_params puts ones and zeros exactly where the JAX init does
    (LayerNorm weights ones; LayerNorm and linear biases zero; lora_b zero)
    and normal noise of the same spread elsewhere."""
    model, _ = jax_neox_params(TINY_NEOX, jax_relora.LoraSpec(r=4))
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_init_params(
        model, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))))
    port = GPTNeoXForCausalLM(ModelConfig(**TINY_NEOX), lora=relora.LoraSpec(r=4))
    init_params(port, torch.Generator().manual_seed(0))
    got = dict(port.named_parameters())
    assert got.keys() == ref.keys()
    constants = 0
    for name, want in ref.items():
        if torch.all(want == want.flatten()[0]) and want.numel() > 1:
            constants += 1
            assert torch.equal(got[name], want), name
        else:
            assert abs(got[name].std().item() - want.std().item()) < 0.15 * want.std().item(), name
    # per layer: 2 LayerNorms x 2, 4 biases, 4 lora_b; plus the final LayerNorm's 2
    assert constants == 12 * TINY_NEOX["num_hidden_layers"] + 2


def _write_neox_bin(path, cfg_kwargs, seed=0):
    """An f32 HF GPT-NeoX pytorch_model.bin drawn from a seed: ``gpt_neox.``
    names, ``embed_out.weight`` at the root, biases and LayerNorms
    included, plus a rotary buffer and an unmerged lora leaf that the warm
    start ignores."""
    rng = np.random.default_rng(seed)
    h, i, L, V = (cfg_kwargs[k] for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                                          "vocab_size"))
    shapes = {"attention.query_key_value": (3 * h, h), "attention.dense": (h, h),
              "mlp.dense_h_to_4h": (i, h), "mlp.dense_4h_to_h": (h, i)}
    sd = {"gpt_neox.embed_in.weight": rng.standard_normal((V, h)) * 0.02,
          "gpt_neox.final_layer_norm.weight": 1 + 0.1 * rng.standard_normal(h),
          "gpt_neox.final_layer_norm.bias": 0.1 * rng.standard_normal(h),
          "embed_out.weight": rng.standard_normal((V, h)) * 0.02}
    for layer in range(L):
        for name, shape in shapes.items():
            sd[f"gpt_neox.layers.{layer}.{name}.weight"] = rng.standard_normal(shape) * 0.05
            sd[f"gpt_neox.layers.{layer}.{name}.bias"] = rng.standard_normal(shape[0]) * 0.05
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"gpt_neox.layers.{layer}.{norm}.weight"] = 1 + 0.1 * rng.standard_normal(h)
            sd[f"gpt_neox.layers.{layer}.{norm}.bias"] = 0.1 * rng.standard_normal(h)
    sd["gpt_neox.layers.0.attention.rotary_emb.inv_freq"] = np.ones(4)
    sd["gpt_neox.layers.0.attention.dense.lora_a"] = np.ones((h, 4))
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()},
               path / "pytorch_model.bin")
    return path


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["dense", "int8"])
def test_warm_start_matches_jax_graft(tmp_path, quantize):
    """Every base parameter after load_warm_start of an HF NeoX file equals
    JAX's hf_to_params + graft_base_weights of the same file, bit for bit:
    biases and LayerNorms copied, int8 codes and scales quantized on the fly
    from the weights alone; LoRA leaves keep their init."""
    bin_dir = _write_neox_bin(tmp_path / "warm", TINY_NEOX)
    spec_kw = dict(r=8, dropout=0.0, quantize=quantize)
    model, _ = jax_neox_params(TINY_NEOX, jax_relora.LoraSpec(**spec_kw))
    params = jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    sd = torch.load(bin_dir / "pytorch_model.bin", map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if "lora_" not in k and "rotary" not in k}
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_graft(
        params, hf_to_params(sd, JaxModelConfig(**TINY_NEOX), scan_layers=True))))
    port = GPTNeoXForCausalLM(ModelConfig(**TINY_NEOX), lora=relora.LoraSpec(**spec_kw))
    init_params(port, torch.Generator().manual_seed(0))
    lora_before = {n: p.clone() for n, p in port.named_parameters() if relora.is_lora_name(n)}
    load_warm_start(port, str(bin_dir))
    got = port.state_dict()
    base = [n for n in got if not relora.is_lora_name(n)]
    assert set(base) == {n for n in want if not relora.is_lora_name(n)}
    for name in base:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    assert got["layers.1.attention.query_key_value.bias"].abs().sum() > 0
    if quantize:
        assert got["layers.1.mlp.dense_h_to_4h.weight_q"].abs().max() == 127
    for name, before in lora_before.items():
        assert torch.equal(got[name], before), name


# -- the engine and the schedulers ------------------------------------------------------


def jax_serving_params(cfg_kwargs=TINY_NEOX, lora=None):
    model = jax_build(JaxModelConfig(**cfg_kwargs), cache_size=CACHE, lora=lora)
    base = type(model)(JaxModelConfig(**cfg_kwargs), lora=lora, dtype=jnp.float32,
                       scan_layers=True)
    params = jax_init_params(base, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return perturbed(jax.tree_util.tree_map(np.asarray, params), 7, factors=False)


def engine_kwargs(kv_dtype="bf16", max_batch=MAX_BATCH):
    return dict(cache_size=CACHE, page_size=PAGE, num_pages=3 * (CACHE // PAGE) + 1,
                chunk_size=CHUNK, kv_dtype=kv_dtype, token_budget=max_batch + CHUNK)


@pytest.fixture(scope="module")
def serving_params():
    return jax_serving_params()


@pytest.fixture(scope="module")
def engine_pairs(serving_params):
    """A JAX and a port engine over the same weights, per pool dtype; the
    steps and drains share them (each drain builds its own pool)."""
    pairs = {}
    for kv_dtype in ("bf16", "int8"):
        kw = engine_kwargs(kv_dtype)
        jx = JaxEngine(JaxModelConfig(**TINY_NEOX), serving_params, **kw)
        pt = InferenceEngine(ModelConfig(**TINY_NEOX), params_from_jax(serving_params),
                             device="cpu", **kw)
        assert isinstance(pt.model, GPTNeoXForCausalLM)
        pairs[kv_dtype] = jx, pt
    return pairs


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_steps_match_jax(engine_pairs, kv_dtype):
    """prefill_chunk, decode_paged and step_paged logits agree at f32, over
    bf16-layout (here f32) and int8 pools."""
    jx, pt = engine_pairs[kv_dtype]
    rng = np.random.default_rng(0)
    prompt_a = rng.integers(1, 256, 11).astype(np.int32)
    prompt_b = rng.integers(1, 256, 5).astype(np.int32)
    W = CACHE // PAGE
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jpool, ppool = jx.init_pool(), pt.init_pool()
    for prompt, start, row in ((prompt_a, 0, 0), (prompt_a, 8, 0), (prompt_b, 0, 1)):
        ids = np.zeros((1, CHUNK), np.int32)
        part = prompt[start : start + CHUNK]
        ids[0, : len(part)] = part
        jl, jpool = jx.prefill_chunk(jnp.asarray(ids), start, jpool, tables[row : row + 1])
        pl, ppool = pt.prefill_chunk(ids, start, ppool, tables[row : row + 1])
        _close(pl, jl)
    token = np.array([[17], [42]], np.int32)
    pos = np.array([[11], [5]], np.int32)
    jl, jpool = jx.decode_paged(jpool, jnp.asarray(token), pos, tables)
    pl, ppool = pt.decode_paged(ppool, token, pos, tables)
    assert pl.shape == (2, 256)
    _close(pl, jl)
    ptables = np.zeros((3, W + 1), np.int32)
    ptables[:2, :W] = tables
    ids = np.array([[3, 9, 0, 0, 0, 0, 0, 0]], np.int32)
    positions = np.array([[12, 6] + [CACHE] * 6], np.int32)
    row_map = np.array([0, 1] + [2] * 6, np.int32)
    jl, jpool = jx.step_paged(jpool, jnp.asarray(ids), positions, ptables, row_map)
    pl, ppool = pt.step_paged(ppool, ids, positions, ptables, row_map)
    _close(pl[:, :2], jl[:, :2])
    if kv_dtype == "int8":
        jks = np.asarray(jpool["layers"]["attention"]["k_scale"])[0]
        live = tables.reshape(-1)
        np.testing.assert_allclose(ppool[0]["k_scale"][live].numpy(), jks[live], rtol=1e-5)


def greedy_mix():
    rng = np.random.default_rng(11)
    return [(uid, rng.integers(1, 256, L).tolist(), new)
            for uid, L, new in ((1, 13, 6), (2, 5, 9), (3, 21, 4), (4, 3, 7), (5, 16, 5))]


def jax_drain(engine, mix, packed, **kwargs):
    sched = JaxScheduler(engine, max_batch=MAX_BATCH, eos_id=9, key=jax.random.PRNGKey(42),
                         packed=packed, **kwargs)
    done = sched.run([JaxRequest(uid=u, prompt=p, max_new_tokens=n, **a) for u, p, n, a in mix])
    return {uid: c.tokens for uid, c in done.items()}


def torch_drain(engine, mix, packed, **kwargs):
    sched = PagedContinuousBatchingScheduler(engine, max_batch=MAX_BATCH, eos_id=9, seed=42,
                                             packed=packed, **kwargs)
    done = sched.run([Request(uid=u, prompt=p, max_new_tokens=n, **a) for u, p, n, a in mix])
    sched.prefix_cache.clear()
    assert sched.allocator.used_pages == 0  # every page came back
    return {uid: c.tokens for uid, c in done.items()}, sched


@pytest.mark.parametrize("packed", [False, True], ids=["paged", "packed"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_greedy_drain_token_identical_to_jax(engine_pairs, kv_dtype, packed):
    jx, pt = engine_pairs[kv_dtype]
    mix = [(u, p, n, {}) for u, p, n in greedy_mix()]
    want = jax_drain(jx, mix, packed)
    got, _ = torch_drain(pt, mix, packed)
    assert got == want and sorted(got) == [1, 2, 3, 4, 5]


def test_ngram_spec_drain_token_identical_to_plain(serving_params):
    """``spec="ngram"`` over repeat prompts commits the plain drain's greedy
    tokens, sequential and packed, with drafts accepted."""
    kw = engine_kwargs(max_batch=MAX_BATCH * 5)
    plain = InferenceEngine(ModelConfig(**TINY_NEOX), params_from_jax(serving_params),
                            device="cpu", **kw)
    spec = InferenceEngine(ModelConfig(**TINY_NEOX), params_from_jax(serving_params),
                           device="cpu", spec_k=4, **kw)
    rng = np.random.default_rng(5)
    mix = [(u, (rng.integers(1, 256, 4).tolist() * 4)[:L], 8, {})
           for u, L in ((1, 14), (2, 9), (3, 16))]
    want, _ = torch_drain(plain, mix, packed=False)
    for packed in (False, True):
        got, sched = torch_drain(spec, mix, packed, spec="ngram")
        assert got == want
        assert sched.spec_stats()["verify_rounds"] > 0


def test_tenant_drain_token_identical_to_jax():
    """Two adapters and the base over 4 slots, distinct prompts per tenant,
    sequential then packed: token-identical to the JAX scheduler."""
    jspec, pspec = jax_relora.LoraSpec(r=4, alpha=8.0), relora.LoraSpec(r=4, alpha=8.0)
    raw = jax_serving_params(lora=jspec)
    kw = engine_kwargs()
    jx = JaxEngine(JaxModelConfig(**TINY_NEOX), raw, lora=jspec, adapter_slots=4, **kw)
    pt = InferenceEngine(ModelConfig(**TINY_NEOX), params_from_jax(raw), lora=pspec,
                         adapter_slots=4, device="cpu", **kw)
    rj = JaxRegistry(None, 4, writer=jx.adapter_writer())
    rp = AdapterRegistry(None, 4, writer=pt.adapter_writer())
    for name, seed in (("tA", 11), ("tB", 22)):
        tree = perturbed(raw, seed)  # the tenant's lora_b drawn off zero
        factors = jax_extract(tree), extract_lora_factors(params_from_jax(tree))
        assert rj.preload(name, factors[0], pspec.scale) == rp.preload(name, factors[1], pspec.scale)
    rng = np.random.default_rng(7)
    mix = [(u, rng.integers(1, 256, L).tolist(), n, {"adapter": a})
           for u, L, n, a in ((1, 13, 6, None), (2, 21, 5, "tA"), (3, 9, 8, "tB"),
                              (4, 5, 7, "tA"), (5, 11, 4, "tB"))]
    for packed in (False, True):
        want = jax_drain(jx, mix, packed, adapter_registry=rj)
        got, _ = torch_drain(pt, mix, packed, adapter_registry=rp)
        assert got == want and sorted(got) == [1, 2, 3, 4, 5]


# -- training --------------------------------------------------------------------------

FIT_CFG = WIDE_SEQ | dict(use_parallel_residual=True)
RECIPE = dict(batch_size=4, total_batch_size=8, max_length=16, lr=5e-3, scheduler="cosine_restarts",
              warmup_steps=2, restart_warmup_steps=1, num_training_steps=6, cycle_length=3, relora=3,
              use_peft=True, lora_r=4, lora_dropout=0.0, eval_every=1000, seed=0)


def _data_config(tmp_path):
    path = tmp_path / "data.json"
    path.write_text(json.dumps({"data_path": str(tmp_path / "unused"), "seq_length": 16}))
    return str(path)


def _jax_run(batches, fused):
    """The JAX package's NeoX step, merge and reset under the trainer's
    cadence rule; returns per-update losses, the initial params and the
    tree after every merge (its fresh A)."""
    spec = jax_relora.LoraSpec(r=4, dropout=0.0, fused=fused)
    model, params = jax_neox_params(FIT_CFG, spec)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    mask = jax_relora.trainable_param_mask(params)
    sched = jax_make_schedule("cosine_restarts", lr=5e-3, num_training_steps=6, warmup_steps=2,
                              cycle_length=3, restart_warmup_steps=1)
    tx = jax_optim.build_optimizer(schedule=sched)
    state = JaxTrainState.create(params, tx.init(partition(params, mask)[0]))
    step = jax.jit(jax_make_train_step(model, tx, mask, clip_grad_norm=1.0, schedule=sched))
    losses, merged = [], []
    for u, batch in enumerate(batches, start=1):
        state, metrics = step(state, jnp.asarray(batch), jax.random.PRNGKey(u))
        losses.append(float(metrics["loss"]))
        if u >= 3 and u % 3 == 1:
            state = state.replace(params=jax_relora.merge_and_reinit(state.params,
                                                                     jax.random.PRNGKey(u), spec))
            merged.append(jax.tree_util.tree_map(np.asarray, state.params))
            state = state.replace(opt_state=jax_optim.reset_optimizer_state(
                state.opt_state, mode="zero", ratio=1.0))
    return losses, jax.tree_util.tree_map(np.asarray, params), merged


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_trainer_fit_tracks_jax_loss_per_update(tmp_path, monkeypatch, fused):
    """Trainer.fit on the NeoX model (nonzero biases and B) against the JAX
    step per update within 1e-4 over 6 updates with one merge and one reset;
    fused runs every projection through the fused twins."""
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 128, (6, 2, 4, 1))
    batches = ((starts + np.arange(16)) % 128).astype(np.int32)  # learnable: i -> i+1
    want, params, merged = _jax_run(batches, fused)
    cfg = TrainingConfig(megatron_dataset_config=_data_config(tmp_path), dtype="float32",
                         device="cpu", lora_fused="true" if fused else "false",
                         **RECIPE).finalize()
    trainer = Trainer(cfg, model_cfg=ModelConfig(**FIT_CFG))
    assert isinstance(trainer.model, GPTNeoXForCausalLM)
    trainer.model.load_state_dict(params_from_jax(params))
    queue = []
    for tree in merged:
        sd = params_from_jax(tree)
        queue.extend(sd[f"{name}.lora_a"] for name, _ in relora.lora_modules(trainer.model))
    monkeypatch.setattr(relora, "kaiming_uniform", lambda shape, generator, device: queue.pop(0))
    calls = []
    real = LM.fused_lora_bwd_dx_plain
    monkeypatch.setattr(LM, "fused_lora_bwd_dx_plain", lambda *a: calls.append(1) or real(*a))
    result = trainer.fit(iter(batches))
    got = [r["loss"] for r in result["records"]]
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)
    assert not queue, "every merge took the JAX draw"
    assert len(calls) == (4 * FIT_CFG["num_hidden_layers"] * 2 * 6 if fused else 0)
    assert (result["n_lora_restarts"], result["n_optimizer_resets"]) == (1, 1)
    assert got[-1] < got[0]


def test_cuda_entry_points_raise_without_a_card(tmp_path):
    """pythia_1b's serving and training entry points ask for the card by
    default and raise where there is none, before building anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_cli.run(["--model_config", "pythia_1b", "--random-init", "--paged",
                       "--prompt", "1 2 3"])
    cfg = TrainingConfig(megatron_dataset_config=_data_config(tmp_path), model_config="pythia_1b",
                         **RECIPE).finalize()
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        build_decode_model(load_model_config("pythia_1b"))


def test_cli_trains_and_serves_pythia_on_cpu_without_jax(tmp_path):
    """``relora_tpu_torch.main`` and ``serve_cli`` with ``--device cpu`` on
    an HF GPT-NeoX ``config.json`` (``model_type: gpt_neox``), in a process
    where importing jax, flax or relora_tpu fails: a fused ReLoRA run that
    merges and resets, then a packed drain of the same config."""
    from relora_tpu_torch.data.memmap import MemmapTokenWriter

    rng = np.random.default_rng(0)
    with MemmapTokenWriter(str(tmp_path / "corpus"), dtype=np.uint16) as w:
        for _ in range(120):
            w.add_document((rng.zipf(1.3, rng.integers(20, 200)) % 128).astype(np.uint16))
    (tmp_path / "data.json").write_text(json.dumps(
        {"data_path": str(tmp_path / "corpus"), "split": "90,10,0", "seq_length": 16, "seed": 1}))
    hf = dict(model_type="gpt_neox", vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=32,
              rotary_pct=0.25, use_parallel_residual=True)
    (tmp_path / "neox").mkdir()
    (tmp_path / "neox" / "config.json").write_text(json.dumps(hf))
    train = ["--device", "cpu", "--model_config", str(tmp_path / "neox"),
             "--megatron_dataset_config", str(tmp_path / "data.json"), "--final_eval_tokens", "500",
             "--use_peft", "true", "--lora_fused", "true"]
    for key in ("batch_size", "total_batch_size", "max_length", "lr", "scheduler", "warmup_steps",
                "restart_warmup_steps", "num_training_steps", "cycle_length", "relora", "lora_r",
                "lora_dropout"):
        train += [f"--{key}", str(RECIPE[key])]
    serve = ["--device", "cpu", "--model_config", str(tmp_path / "neox"), "--random-init",
             "--paged", "--packed", "--max-batch", "2", "--max-new-tokens", "5",
             "--prompt", "5 6 7 8 9", "--prompt", "3 1 4 1 5 9 2 6"]
    code = (
        "import json, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'relora_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from relora_tpu_torch import main, serve_cli\n"
        "from relora_tpu_torch.models.pythia import GPTNeoXForCausalLM\n"
        f"result = main.main({train!r})\n"
        f"done, _, sched = serve_cli.drain({serve!r})\n"
        "assert isinstance(sched.engine.model, GPTNeoXForCausalLM)\n"
        "print(json.dumps({'train': {k: v for k, v in result.items() if k != 'records'},\n"
        "                  'tokens': [done[u].tokens for u in sorted(done)]}))\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    train_result = result["train"]
    assert train_result["update_step"] == 6
    assert (train_result["n_lora_restarts"], train_result["n_optimizer_resets"]) == (1, 1)
    assert np.isfinite(train_result["final_eval_loss"])
    assert len(result["tokens"]) == 2 and all(1 <= len(t) <= 5 for t in result["tokens"])
    assert all(0 <= tok < 128 for t in result["tokens"] for tok in t)


# -- against HF transformers ----------------------------------------------------------


@pytest.mark.parametrize("parallel_residual", [True, False], ids=["parallel", "sequential"])
def test_logits_match_hf_neox(parallel_residual):
    """The port's logits equal HF ``GPTNeoXForCausalLM``'s on the same state
    dict (biases and LayerNorms moved off their init), grafted by name."""
    transformers = pytest.importorskip("transformers")
    cfg = ModelConfig(**{**TINY_NEOX, "use_parallel_residual": parallel_residual})
    hf_cfg = transformers.GPTNeoXConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size, rotary_pct=cfg.rotary_pct,
        rotary_emb_base=cfg.rotary_emb_base, max_position_embeddings=cfg.max_sequence_length,
        layer_norm_eps=cfg.layer_norm_eps, use_parallel_residual=parallel_residual,
        tie_word_embeddings=False, hidden_act="gelu",
    )
    torch.manual_seed(0)
    hf = transformers.GPTNeoXForCausalLM(hf_cfg).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith(".bias") or "layernorm" in name or "layer_norm" in name:
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    port = GPTNeoXForCausalLM(cfg)
    graft_base_weights(port, hf.state_dict())
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.numpy()
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
