"""The port's nf4 base against the JAX package's, on the CPU.

nf4 has no kernel in either package: the JAX module dequantizes in ``jnp``
and the port in plain torch (``ops/quant.py``, ``LoRALinear(quantize=
"nf4")``).  Here ``quantize_nf4`` / ``dequantize_nf4``, the nf4
``LoRALinear`` (forward, gradients, fresh init, never dispatched), the
odd-width int8 fallback, the merge, ``merged_params``, ``params_from_jax``,
the warm start, ``Trainer.fit --quantize nf4 --warmed_up_model``, a
checkpoint saved and resumed, and greedy drains of an nf4 checkpoint,
merged and unmerged, are held to ``relora_tpu`` on the same numpy-seeded
inputs.

Tolerances: nf4 codes are bit-equal (the same f32 division and the same
midpoints on both sides).  Under double quant the per-column mean of the
block scales reduces in another order in torch and in XLA, so ``bscale_q``
may differ by one step: mismatches are counted (at most 1% of the entries)
and held within one step, and the dequantized weights within 1e-6 of the
column's largest weight.  Layer outputs and gradients within 1e-5 of
``max(1, max|JAX value|)``; per-update training loss within 1e-4; greedy
drains token-identical.  A merged base is held to the requant rule: the two
packages compute ``A @ B`` in another order, so a last-ulp difference may
flip a code at a midpoint, hence at least 99.9% of the codes are equal and
the dequantized weights agree within one quantization step (the widest
codebook gap times the block's scale).
"""

import json
import logging

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
from relora_tpu.models.llama import LlamaForCausalLM as JaxLlama
from relora_tpu.models.lora import LoRALinear as JaxLoRALinear
from relora_tpu.models.params_util import init_params as jax_init_params
from relora_tpu.ops import quant as jq
from relora_tpu.serve.engine import InferenceEngine as JaxEngine, build_decode_model as jax_build
from relora_tpu.serve.scheduler import (
    PagedContinuousBatchingScheduler as JaxScheduler,
    Request as JaxRequest,
)
from relora_tpu.train.state import TrainState as JaxTrainState
from relora_tpu.train.step import make_train_step as jax_make_train_step
from relora_tpu_torch import serve_cli
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.config.training import TrainingConfig
from relora_tpu_torch.core import relora
from relora_tpu_torch.models import lora as lora_module
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.models.llama import LlamaForCausalLM
from relora_tpu_torch.models.lora import LoRALinear
from relora_tpu_torch.models.params_util import init_params
from relora_tpu_torch.models.warm_start import graft_base_weights, load_warm_start
from relora_tpu_torch.obs.memory import tensor_bytes
from relora_tpu_torch.ops import lora_dispatch
from relora_tpu_torch.ops import lora_matmul as LM
from relora_tpu_torch.ops.quant import (
    NF4_CODEBOOK,
    NF4_LEAVES,
    dequantize_nf4,
    jax_nf4_name,
    nf4_block_for,
    quant_bytes_per_param,
    quantize_nf4,
)
from relora_tpu_torch.serve.engine import InferenceEngine
from relora_tpu_torch.serve.scheduler import PagedContinuousBatchingScheduler, Request
from relora_tpu_torch.train import checkpoint as ckpt
from relora_tpu_torch.train.trainer import Trainer
from tests.test_torch_quant import RECIPE, TINY, _close, _count_calls, _data_config, _write_bin

pytestmark = pytest.mark.torch_port

LOSS_TOL = 1e-4
BSCALE_MISMATCH_MAX = 0.01  # share of bscale_q entries one step off JAX's
MERGE_MIN_EQUAL = 0.999
GAP = float(np.diff(NF4_CODEBOOK).max())  # the widest codebook gap: one step per unit scale
PROJ = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
        "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def _jax_leaves(w, double_quant=True):
    return {k: np.asarray(v) for k, v in jq.quantize_nf4(jnp.asarray(w), double_quant=double_quant).items()}


def _assert_leaves_match(got, want, name=""):
    """Codes bit-equal, ``bscale_q`` within one step on at most 1% of the
    entries, the dequantized weights within 1e-6 of each column's largest."""
    got = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in got.items()}
    for leaf in ("codes", "bscale_q", "bscale_scale", "bscale_offset"):
        assert got[leaf].dtype == want[leaf].dtype and got[leaf].shape == want[leaf].shape, (name, leaf)
    np.testing.assert_array_equal(got["codes"], want["codes"], err_msg=name)
    off = got["bscale_q"].astype(np.float64) - want["bscale_q"].astype(np.float64)
    if want["bscale_q"].dtype == np.int8:
        assert np.abs(off).max() <= 1 and (off != 0).mean() <= BSCALE_MISMATCH_MAX, (name, off)
    else:
        np.testing.assert_array_equal(got["bscale_q"], want["bscale_q"], err_msg=name)
    w_got = dequantize_nf4({k: torch.tensor(v) for k, v in got.items()}).numpy()
    w_want = np.asarray(jq.dequantize_nf4({k: jnp.asarray(v) for k, v in want.items()}))
    col = np.abs(w_want).max(axis=0, keepdims=True)
    assert (np.abs(w_got - w_want) <= 1e-6 * np.maximum(col, 1e-12)).all(), name


# ------------------------------------------------------------ quantization


@pytest.mark.parametrize("double_quant", [True, False], ids=["dq", "f32scale"])
@pytest.mark.parametrize("width", [64, 96, 768, 2560])
def test_quantize_nf4_matches_jax(width, double_quant):
    """Codes bit-equal, block scales by the requant rule, the layout and
    dtypes JAX's; the block is the largest power of two <= 64 dividing
    ``in`` (32 at 96), and dequantize equals JAX's on the same leaves."""
    rng = np.random.default_rng(width)
    w = (rng.standard_normal((width, 48)) * 0.05).astype(np.float32)
    want = _jax_leaves(w, double_quant)
    got = quantize_nf4(torch.from_numpy(w), double_quant=double_quant)
    assert nf4_block_for(width) == (32 if width == 96 else 64)
    assert tuple(got["bscale_q"].shape) == (width // nf4_block_for(width), 48)
    _assert_leaves_match(got, want, f"w{width}")
    same = dequantize_nf4({k: torch.tensor(v) for k, v in want.items()}).numpy()
    np.testing.assert_array_equal(same, np.asarray(jq.dequantize_nf4(
        {k: jnp.asarray(v) for k, v in want.items()})))
    # the error bound of a blockwise absmax codebook: half the widest gap
    block = nf4_block_for(width)
    blocks = w.reshape(width // block, block, 48)
    err = np.abs(dequantize_nf4(got).numpy().reshape(blocks.shape) - blocks)
    assert (err <= np.abs(blocks).max(axis=1, keepdims=True) * (GAP / 2 + 1e-2) + 1e-6).all()


def test_odd_width_raises_and_bytes_per_param_match_jax():
    with pytest.raises(ValueError, match="even"):
        nf4_block_for(9)
    with pytest.raises(ValueError, match="even"):
        quantize_nf4(torch.zeros(9, 4))
    for mode in ("int8", "nf4", "nf4-f32scale"):
        for shape in ((2048, 8192), (8192, 2048), (768, 2560)):
            assert quant_bytes_per_param(mode, *shape) == jq.quant_bytes_per_param(mode, *shape)
    assert {jax_nf4_name(p) for p in NF4_LEAVES} == set(jq.NF4_MODULE_LEAVES)


# ------------------------------------------------------------- the module


def _nf4_pair(bias, double_quant, seed=1, in_f=64, out_f=128):
    """The JAX LoRALinear(nf4) params with seeded leaves, B and bias, and
    the port's module loaded with the same arrays."""
    spec = dict(r=8, alpha=16.0, dropout=0.0, quantize="nf4", use_double_quant=double_quant)
    jmod = JaxLoRALinear(features=out_f, use_bias=bias, lora=jax_relora.LoraSpec(**spec),
                         dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 16, in_f)).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, flax_meta.unbox(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    leaves = _jax_leaves((rng.standard_normal((in_f, out_f)) * 0.05).astype(np.float32), double_quant)
    params.update({"kernel_" + k: v for k, v in leaves.items()})
    params["lora_b"] = rng.standard_normal(params["lora_b"].shape).astype(np.float32)
    if bias:
        params["bias"] = rng.standard_normal(out_f).astype(np.float32)
    mod = LoRALinear(in_f, out_f, lora=relora.LoraSpec(**spec), bias=bias, dtype=torch.float32)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.from_numpy(params[jax_nf4_name(name) if name in NF4_LEAVES else name]))
    relora.set_trainable(mod)
    return jmod, params, mod, x


@pytest.mark.parametrize("double_quant", [True, False], ids=["dq", "f32scale"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_lora_linear_nf4_matches_jax(bias, double_quant):
    """y and the gradients of x, A, B (and the bias) against the JAX
    LoRALinear(nf4) at f32; the nf4 leaves are frozen and get none."""
    jmod, params, mod, x = _nf4_pair(bias, double_quant)
    cot = np.random.default_rng(9).standard_normal((4, 16, 128)).astype(np.float32)
    y, vjp = jax.vjp(lambda p, xx: jmod.apply({"params": p}, xx),
                     jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt)
    out.backward(torch.from_numpy(cot))
    _close(out, y, "y")
    _close(xt.grad, gx, "dx")
    for name in ("lora_a", "lora_b") + (("bias",) if bias else ()):
        _close(getattr(mod, name).grad, gp[name], name)
    assert all(getattr(mod, p).grad is None and not getattr(mod, p).requires_grad for p in NF4_LEAVES)


@pytest.mark.parametrize("double_quant", [True, False], ids=["dq", "f32scale"])
def test_fresh_nf4_init_is_w_zero_as_in_jax(double_quant):
    """Codes 0x77 (codebook entry 7 is 0.0), bscale_q zeros under double
    quant and ones without, scales ones, offsets zeros: the JAX module's
    init, W = 0; init_params leaves them alone."""
    spec = dict(r=4, quantize="nf4", use_double_quant=double_quant)
    jmod = JaxLoRALinear(features=32, lora=jax_relora.LoraSpec(**spec), dtype=jnp.float32)
    jparams = flax_meta.unbox(jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 64))))["params"]
    model = LlamaForCausalLM(ModelConfig(**TINY), lora=relora.LoraSpec(**spec))
    init_params(model, torch.Generator().manual_seed(0))
    mod = LoRALinear(64, 32, lora=relora.LoraSpec(**spec))
    for name in NF4_LEAVES:
        want = np.asarray(jparams[jax_nf4_name(name)])
        got = getattr(mod, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    proj = model.layers[1].mlp.up_proj
    assert not dequantize_nf4({l: getattr(proj, p) for p, l in NF4_LEAVES.items()}).any()
    assert bool((proj.weight_codes == 0x77).all())


@pytest.mark.parametrize("fused", [True, "auto"], ids=["fused", "auto"])
def test_nf4_never_dispatches_and_saves_no_dequantized_weight(fused, monkeypatch):
    """Under fused=True or "auto" an nf4 projection takes the plain
    dequantize-matmul (the reference dispatches only a dense or int8 base):
    neither lora_matmul nor the cost model is asked.  Autograd keeps the
    nf4 leaves, never an (in, out) float weight."""
    def refuse(*args, **kwargs):
        raise AssertionError("an nf4 projection reached the dispatcher")

    monkeypatch.setattr(lora_dispatch, "lora_matmul", refuse)
    monkeypatch.setattr(lora_dispatch, "choose_arm", refuse)
    mod = LoRALinear(64, 128, lora=relora.LoraSpec(r=8, dropout=0.0, quantize="nf4", fused=fused))
    init_params_like = torch.Generator().manual_seed(0)
    with torch.no_grad():
        mod.lora_a.normal_(generator=init_params_like)
        mod.lora_b.normal_(generator=init_params_like)
    relora.set_trainable(mod)
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    x = torch.randn(2, 8, 64, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = mod(x)
    y.sum().backward()
    assert x.grad is not None and mod.lora_a.grad is not None
    assert ((64, 128), torch.float32) not in saved and ((128, 64), torch.float32) not in saved
    assert ((32, 128), torch.uint8) in saved


# ------------------------------------------------------ the odd-width fallback


def test_odd_width_falls_back_to_int8_as_jax(monkeypatch, caplog):
    """JAX's case (intermediate 9): down_proj stores int8 and, under
    --lora_fused true, goes through the int8 fused arm, while the nf4
    projections stay plain; one warning per module name and width; the
    logits and a merge of the mixed base equal JAX's."""
    import dataclasses

    cfg = dict(vocab_size=64, hidden_size=64, intermediate_size=9, num_hidden_layers=2,
               num_attention_heads=2, max_sequence_length=32)
    spec = dict(r=4, alpha=32.0, dropout=0.0, quantize="nf4")
    jmodel = JaxLlama(JaxModelConfig(**cfg), lora=jax_relora.LoraSpec(**spec, fused=True),
                      dtype=jnp.float32, scan_layers=True, attention_impl="naive")
    ids = np.random.default_rng(1).integers(0, 64, (2, 16)).astype(np.int32)
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_params(jmodel, jax.random.PRNGKey(0), ids))
    rng = np.random.default_rng(2)
    layers = jparams["layers"]
    for group, name in (("self_attn", "q_proj"), ("mlp", "gate_proj")):
        node = layers[group][name]
        L, half, out_f = node["kernel_codes"].shape
        w = (rng.standard_normal((L, 2 * half, out_f)) * 0.05).astype(np.float32)
        for leaf, v in jax.vmap(jq.quantize_nf4)(jnp.asarray(w)).items():
            node["kernel_" + leaf] = np.asarray(v)
    down = layers["mlp"]["down_proj"]
    assert "kernel_q" in down and "kernel_codes" not in down
    w = (rng.standard_normal(down["kernel_q"].shape) * 0.05).astype(np.float32)
    q, s = jax.vmap(jq.quantize_int8)(jnp.asarray(w))
    down["kernel_q"], down["kernel_scale"] = np.asarray(q), np.asarray(s)
    for node in (layers["mlp"]["down_proj"], layers["self_attn"]["q_proj"]):
        node["lora_b"] = (rng.standard_normal(node["lora_b"].shape) * 0.1).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids)))

    monkeypatch.setattr(lora_module, "_NF4_FALLBACK_WARNED", set())
    with caplog.at_level(logging.WARNING, logger=lora_module.logger.name):
        model = LlamaForCausalLM(ModelConfig(**cfg), lora=relora.LoraSpec(**spec, fused=True))
        LlamaForCausalLM(ModelConfig(**cfg), lora=relora.LoraSpec(**spec, fused=True))
    warned = [r.getMessage() for r in caplog.records
              if r.name == lora_module.logger.name and "nf4 requested" in r.getMessage()]
    assert len(warned) == 1 and "'down_proj'" in warned[0] and "in_features=9" in warned[0]
    model.load_state_dict(params_from_jax(jparams))
    relora.set_trainable(model)
    mlp = model.layers[0].mlp
    assert mlp.down_proj.quantize == "int8" and mlp.down_proj.weight_q.dtype == torch.int8
    assert mlp.up_proj.quantize == "nf4" and getattr(mlp.up_proj, "weight_q", None) is None
    fused_calls = _count_calls(monkeypatch, LM, "fused_lora_int8_forward_plain")
    dx_calls = _count_calls(monkeypatch, LM, "fused_lora_int8_bwd_dx_plain")
    out = model(torch.from_numpy(ids).long())
    _close(out, want, "logits")
    assert len(fused_calls) == cfg["num_hidden_layers"]  # down_proj alone, one a layer
    out.float().logsumexp(-1).mean().backward()
    assert len(dx_calls) == cfg["num_hidden_layers"]

    jspec = jax_relora.LoraSpec(**spec)
    merged = jax_relora.merge_and_reinit(jparams, jax.random.PRNGKey(3), jspec)
    relora.merge_and_reinit(model, torch.Generator().manual_seed(3), relora.LoraSpec(**spec))
    after = params_from_jax(jax.tree_util.tree_map(np.asarray, merged))
    sd = model.state_dict()
    for i in range(cfg["num_hidden_layers"]):
        q = sd[f"layers.{i}.mlp.down_proj.weight_q"]
        assert (q == after[f"layers.{i}.mlp.down_proj.weight_q"]).float().mean() >= MERGE_MIN_EQUAL
        codes = sd[f"layers.{i}.self_attn.q_proj.weight_codes"]
        assert (codes == after[f"layers.{i}.self_attn.q_proj.weight_codes"]).float().mean() >= MERGE_MIN_EQUAL
    assert dataclasses.asdict(relora.LoraSpec(**spec))["use_double_quant"] is True


# ---------------------------------------------------------------- the merge


def _nf4_module_params(seed, in_f=128, out_f=96, r=8, double_quant=True, zero_cols=()):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((in_f, out_f)) * 0.05).astype(np.float32)
    p = {"kernel_" + k: v for k, v in _jax_leaves(w, double_quant).items()}
    p["lora_a"] = (rng.standard_normal((in_f, r)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((r, out_f)) * 0.05).astype(np.float32)
    b[:, list(zero_cols)] = 0.0
    p["lora_b"] = b
    return p


def _port_nf4_module(params, spec):
    mod = LoRALinear(params["lora_a"].shape[0], params["lora_b"].shape[1], lora=spec)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.from_numpy(params[jax_nf4_name(name) if name in NF4_LEAVES else name]))
    return mod


def _module_leaves(mod):
    return {leaf: getattr(mod, param).detach() for param, leaf in NF4_LEAVES.items()}


@pytest.mark.parametrize("double_quant", [True, False], ids=["dq", "f32scale"])
def test_nf4_merge_matches_jax_to_the_requant_rule(double_quant):
    """One merge: at least 99.9% of the codes equal JAX's, the dequantized
    bases within one step, the layout (bscale_q's dtype) kept, codes
    unmoved where the delta is zero; A re-drawn and B zeroed."""
    params = _nf4_module_params(4, double_quant=double_quant, zero_cols=range(0, 96, 5))
    spec = dict(r=8, alpha=8.0, quantize="nf4", use_double_quant=double_quant)
    want = jax_relora.merge_and_reinit({"m": params}, jax.random.PRNGKey(0),
                                       jax_relora.LoraSpec(**spec))["m"]
    mod = _port_nf4_module(params, relora.LoraSpec(**spec))
    relora.merge_and_reinit(mod, torch.Generator().manual_seed(0), relora.LoraSpec(**spec))
    got = _module_leaves(mod)
    assert got["bscale_q"].dtype == (torch.int8 if double_quant else torch.float32)
    assert (got["codes"].numpy() == np.asarray(want["kernel_codes"])).mean() >= MERGE_MIN_EQUAL
    w_got = dequantize_nf4(got).numpy()
    w_want = np.asarray(jq.dequantize_nf4({k: want["kernel_" + k] for k in NF4_LEAVES.values()}))
    block = nf4_block_for(128)
    scale = np.abs(w_want).reshape(128 // block, block, 96).max(axis=1)
    step = np.repeat(scale, block, axis=0) * GAP
    assert (np.abs(w_got - w_want) <= step + 1e-7).all()
    # the delta's zero columns keep their codes (double quant re-encodes
    # every column's scales, so only codes are held there)
    before = params["kernel_codes"]
    np.testing.assert_array_equal(got["codes"].numpy()[:, ::5], before[:, ::5])
    assert not mod.lora_b.any() and not np.allclose(mod.lora_a.detach().numpy(), params["lora_a"])


def _merge_cycles(n_cycles, seed, delta_scale=0.02):
    """The JAX test's drift run on the port: n merges of seeded deltas from
    a representable start, against an f32 oracle adding the same deltas."""
    rng = np.random.default_rng(seed)
    w0 = (rng.standard_normal((128, 64)) * 0.05).astype(np.float32)
    spec = relora.LoraSpec(r=4, alpha=4.0, quantize="nf4")
    mod = LoRALinear(128, 64, lora=spec)
    with torch.no_grad():
        for param, leaf in NF4_LEAVES.items():
            getattr(mod, param).copy_(quantize_nf4(torch.from_numpy(w0))[leaf])
    oracle = dequantize_nf4(_module_leaves(mod)).double()
    for c in range(n_cycles):
        a = torch.from_numpy(rng.standard_normal((128, 4)).astype(np.float32) * delta_scale)
        b = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32) * delta_scale)
        with torch.no_grad():
            mod.lora_a.copy_(a)
            mod.lora_b.copy_(b)
        oracle = oracle + a.double() @ b.double()  # alpha / r = 1
        relora.merge_and_reinit(mod, torch.Generator().manual_seed(c), spec)
    one_shot = (dequantize_nf4(quantize_nf4(oracle.float())).double() - oracle).abs().max().item()
    return dequantize_nf4(_module_leaves(mod)).double(), oracle, one_shot


def test_nf4_merge_drift_over_12_cycles_stays_within_3x_one_quantization():
    """JAX's bound (tests/test_quant.py): 12 dequantize-add-requantize
    cycles stay within 3x one quantization's error of the exact oracle."""
    deq, oracle, one_shot = _merge_cycles(12, 0)
    assert (deq - oracle).abs().max().item() < 3.0 * one_shot


def test_nf4_merge_zero_delta_is_a_fixed_point():
    """B = 0: codes bit-exact over 5 merges, the scales stable to float
    rounding (double quant re-encodes the block scales each merge)."""
    deq0, _, _ = _merge_cycles(0, 1)
    rng = np.random.default_rng(1)
    w0 = (rng.standard_normal((128, 64)) * 0.05).astype(np.float32)
    spec = relora.LoraSpec(r=4, alpha=4.0, quantize="nf4")
    mod = LoRALinear(128, 64, lora=spec)
    with torch.no_grad():
        for param, leaf in NF4_LEAVES.items():
            getattr(mod, param).copy_(quantize_nf4(torch.from_numpy(w0))[leaf])
    codes0 = mod.weight_codes.clone()
    for c in range(5):
        mod.lora_b.data.zero_()
        relora.merge_and_reinit(mod, torch.Generator().manual_seed(c), spec)
    assert torch.equal(mod.weight_codes, codes0)
    deq5 = dequantize_nf4(_module_leaves(mod)).double()
    assert (deq5 - deq0).abs().max().item() < 1e-6 * deq0.abs().max().item()


def test_merged_params_dequantizes_nf4_as_jax():
    """merged_params: an nf4 module becomes a plain f32 (out, in) weight,
    the dequantized base plus the delta, its nf4 and LoRA leaves dropped;
    equal to JAX's merged_params within 1e-6."""
    params = _nf4_module_params(6)
    spec = dict(r=8, alpha=8.0, quantize="nf4")
    want = jax_relora.merged_params({"m": params}, jax_relora.LoraSpec(**spec))["m"]
    mod = _port_nf4_module(params, relora.LoraSpec(**spec))
    got = relora.merged_params({f"m.{k}": v for k, v in mod.state_dict().items()},
                               relora.LoraSpec(**spec))
    assert set(got) == {"m.weight"} and got["m.weight"].dtype == torch.float32
    np.testing.assert_allclose(got["m.weight"].numpy(), np.asarray(want["kernel"]).T, atol=1e-6, rtol=0)


# ------------------------------------------------- conversion and warm start


def _jax_nf4_model(double_quant=True, fused=False):
    spec = jax_relora.LoraSpec(r=8, dropout=0.0, quantize="nf4", use_double_quant=double_quant,
                               fused=fused)
    return JaxLlama(JaxModelConfig(**TINY), lora=spec, dtype=jnp.float32, scan_layers=True,
                    attention_impl="naive")


def _jax_grafted(model, bin_dir):
    params = jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    sd = torch.load(bin_dir / "pytorch_model.bin", map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if "lora_" not in k and "rotary" not in k}
    return jax_graft(params, hf_to_params(sd, JaxModelConfig(**TINY), scan_layers=True))


@pytest.mark.parametrize("double_quant", [True, False], ids=["dq", "f32scale"])
def test_warm_start_and_params_from_jax_match_jax_graft_leaf_for_leaf(tmp_path, double_quant):
    """params_from_jax carries the JAX graft's nf4 leaves unchanged (dtype,
    layout, values); the port's own warm start of the same file gives every
    base leaf of it, nf4 by the requant rule (codes bit-equal), the rest bit
    for bit; LoRA leaves keep their init."""
    bin_dir = _write_bin(tmp_path / "warm")
    jtree = jax.tree_util.tree_map(np.asarray, _jax_grafted(_jax_nf4_model(double_quant), bin_dir))
    want = params_from_jax(jtree)
    node = jtree["layers"]["mlp"]["up_proj"]
    for param in NF4_LEAVES:
        leaf = want[f"layers.1.mlp.up_proj.{param}"].numpy()
        assert leaf.dtype == node[jax_nf4_name(param)].dtype
        np.testing.assert_array_equal(leaf, node[jax_nf4_name(param)][1])
    spec = relora.LoraSpec(r=8, quantize="nf4", use_double_quant=double_quant)
    model = LlamaForCausalLM(ModelConfig(**TINY), lora=spec)
    init_params(model, torch.Generator().manual_seed(0))
    lora_before = {n: p.clone() for n, p in model.named_parameters() if relora.is_lora_name(n)}
    load_warm_start(model, str(bin_dir))
    got = model.state_dict()
    assert {n for n in got if not relora.is_lora_name(n)} == {
        n for n in want if not relora.is_lora_name(n)}
    for i in range(TINY["num_hidden_layers"]):
        for name in PROJ:
            prefix = f"layers.{i}.{name}."
            _assert_leaves_match({l: got[prefix + p] for p, l in NF4_LEAVES.items()},
                                 {l: want[prefix + p].numpy() for p, l in NF4_LEAVES.items()},
                                 prefix)
    for name in (n for n in got if not relora.is_lora_name(n) and n.rsplit(".", 1)[-1] not in NF4_LEAVES):
        assert torch.equal(got[name], want[name]), name
    for name, before in lora_before.items():
        assert torch.equal(got[name], before), name
    source = torch.load(bin_dir / "pytorch_model.bin", weights_only=True)
    for bad in (torch.zeros(3, 3), torch.zeros(256, 64)):
        with pytest.raises(ValueError, match="shape mismatch"):
            graft_base_weights(model, {**source, "model.layers.0.mlp.up_proj.weight": bad})


# ------------------------------------------------------------- the trainer


def _jax_nf4_run(batches, bin_dir):
    """The JAX step over the grafted nf4 model, merge and reset under the
    trainer's cadence; returns per-update losses, the grafted params and
    the params after every merge."""
    model = _jax_nf4_model()
    params = _jax_grafted(model, bin_dir)
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
            state = state.replace(params=jax_relora.merge_and_reinit(
                state.params, jax.random.PRNGKey(u), model.lora))
            merged.append(jax.tree_util.tree_map(np.asarray, state.params))
            state = state.replace(opt_state=jax_optim.reset_optimizer_state(
                state.opt_state, mode="zero", ratio=1.0))
    return losses, jax.tree_util.tree_map(np.asarray, params), merged


def _batches(n=6):
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 128, (n, 2, 4, 1))
    return ((starts + np.arange(16)) % 128).astype(np.int32)  # learnable: i -> i+1


def test_trainer_fit_nf4_warm_start_tracks_jax(tmp_path, monkeypatch):
    """Trainer.fit --quantize nf4 --warmed_up_model DIR --lora_fused true
    (nf4 never dispatches) against the JAX step over the JAX graft of the
    same file: per update within 1e-4 over 6 updates with one merge and one
    reset; the merge moves every projection's codes or scales; memory_plan
    counts the nf4 leaves by their bytes."""
    bin_dir = _write_bin(tmp_path / "warm")
    batches = _batches()
    want, params, merged_trees = _jax_nf4_run(batches, bin_dir)
    save_dir = tmp_path / "run"
    cfg = TrainingConfig(megatron_dataset_config=_data_config(tmp_path), dtype="float32",
                         device="cpu", quantize="nf4", warmed_up_model=str(bin_dir),
                         lora_fused="true", save_dir=str(save_dir), **RECIPE).finalize()
    trainer = Trainer(cfg, model_cfg=ModelConfig(**TINY))
    assert trainer.lora_spec.quantize == "nf4" and trainer.lora_spec.use_double_quant
    grafted = params_from_jax(params)
    # the JAX graft's leaves, so both runs start from one base
    trainer.model.load_state_dict({n: v for n, v in grafted.items()
                                   if relora.is_lora_name(n) or n.endswith(tuple(NF4_LEAVES))},
                                  strict=False)
    queue = []
    for tree in merged_trees:
        after = params_from_jax(tree)
        queue.extend(after[f"{name}.lora_a"] for name, _ in relora.lora_modules(trainer.model))
    monkeypatch.setattr(relora, "kaiming_uniform", lambda shape, generator, device: queue.pop(0))
    monkeypatch.setattr(lora_dispatch, "lora_matmul", None)  # nf4 never dispatches
    before = {n: v.clone() for n, v in trainer.model.state_dict().items() if n.endswith(tuple(NF4_LEAVES))}
    result = trainer.fit(iter(batches))

    got = [r["loss"] for r in result["records"]]
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)
    assert not queue and (result["n_lora_restarts"], result["n_optimizer_resets"]) == (1, 1)
    final = trainer.model.state_dict()
    for i in range(TINY["num_hidden_layers"]):
        for name in PROJ:
            prefix = f"layers.{i}.{name}."
            assert final[prefix + "weight_codes"].dtype == torch.uint8
            assert any(not torch.equal(final[prefix + p], before[prefix + p]) for p in NF4_LEAVES)
    with open(save_dir / "metrics.jsonl") as f:
        plan = next(json.loads(line) for line in f if '"memory_plan"' in line)
    # the nf4 leaves by their bytes: codes 1 B a pair of weights, bscale_q
    # 1 B a block, scale and offset 4 B a column
    reckoned = sum(p.numel() + (2 * p.shape[0] // 64) * p.shape[1] + 8 * p.shape[1]
                   for name, p in trainer.model.named_parameters() if name.endswith("weight_codes"))
    nf4 = [p for n, p in trainer.model.named_parameters() if n.endswith(tuple(NF4_LEAVES))]
    assert tensor_bytes(nf4) == reckoned
    assert plan["params_bytes"] == tensor_bytes(trainer.model.parameters())
    assert got[-1] < got[0]


def test_nf4_checkpoint_resumes_bit_for_bit(tmp_path):
    """A straight nf4 run of 6 updates against one saved at update 3 and
    resumed from it: the nf4 leaves restored bit for bit, the losses after
    the resume and the final state equal; the sidecar carries quantize and
    use_double_quant and loads into the JAX package's LoraSpec too."""
    bin_dir = _write_bin(tmp_path / "warm")
    batches = _batches()
    kw = dict(megatron_dataset_config=_data_config(tmp_path), dtype="float32", device="cpu",
              quantize="nf4", warmed_up_model=str(bin_dir), **RECIPE)
    straight = Trainer(TrainingConfig(**kw).finalize(), model_cfg=ModelConfig(**TINY))
    want = [r["loss"] for r in straight.fit(iter(batches))["records"]]
    first = Trainer(TrainingConfig(**{**kw, "num_training_steps": 6}, save_dir=str(tmp_path / "a"),
                                   save_every=3).finalize(), model_cfg=ModelConfig(**TINY))
    first.fit(iter(batches[:3]))
    path = str(tmp_path / "a" / "model_3")
    with open(f"{path}/{ckpt.RELORA_CONFIG_FILE}") as f:
        sidecar = json.load(f)
    assert sidecar["quantize"] == "nf4" and sidecar["use_double_quant"] is True
    assert jax_relora.LoraSpec(**sidecar).quantize == "nf4"
    saved = ckpt.restore_params_host(path)
    resumed = Trainer(TrainingConfig(**kw, resume_from=path).finalize(), model_cfg=ModelConfig(**TINY))
    for name, v in resumed.model.state_dict().items():
        assert torch.equal(v, saved[name]), name
    got = [r["loss"] for r in resumed.fit(iter(batches[3:]))["records"]]
    assert got == want[3:]
    for (name, x), (_, y) in zip(straight.model.state_dict().items(),
                                 resumed.model.state_dict().items()):
        assert torch.equal(x, y), name


# ----------------------------------------------------------------- serving

CACHE, PAGE, CHUNK, MAX_BATCH = 32, 8, 8, 3
SERVE_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, max_sequence_length=64)


def _engine_kwargs():
    return dict(cache_size=CACHE, page_size=PAGE, num_pages=MAX_BATCH * (CACHE // PAGE) + 1,
                chunk_size=CHUNK, token_budget=MAX_BATCH + CHUNK)


def _mix():
    rng = np.random.default_rng(5)
    return [(u, rng.integers(1, 256, n).tolist(), m)
            for u, n, m in ((1, 13, 6), (2, 21, 5), (3, 9, 8), (4, 5, 7))]


@pytest.fixture(scope="module")
def nf4_checkpoint(tmp_path_factory):
    """A JAX nf4 decode tree (nf4 leaves quantized by the JAX package from
    seeded weights, LoRA factors drawn), its port checkpoint, and the JAX
    package's greedy drains of it unmerged and merged."""
    cfg = JaxModelConfig(**SERVE_TINY)
    spec = dict(r=4, alpha=8.0, quantize="nf4")
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(
        jax_build(cfg, cache_size=CACHE, lora=jax_relora.LoraSpec(**spec)), jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(3)

    def fill(node):
        for k, v in list(node.items()):
            if isinstance(v, dict):
                fill(v)
        if "kernel_codes" in node:
            L, half, out_f = node["kernel_codes"].shape
            w = (rng.standard_normal((L, 2 * half, out_f)) * 0.08).astype(np.float32)
            for leaf, v in jax.vmap(jq.quantize_nf4)(jnp.asarray(w)).items():
                node["kernel_" + leaf] = np.asarray(v)
            for k in ("lora_a", "lora_b"):
                node[k] = (rng.standard_normal(node[k].shape) * 0.1).astype(np.float32)

    fill(tree)
    jspec = jax_relora.LoraSpec(**spec)
    reqs = [JaxRequest(uid=u, prompt=p, max_new_tokens=n) for u, p, n in _mix()]
    drains = {}
    for merge in (False, True):
        params = jax_relora.merged_params(tree, jspec) if merge else tree
        jx = JaxEngine(cfg, params, lora=None if merge else jspec, **_engine_kwargs())
        sched = JaxScheduler(jx, max_batch=MAX_BATCH, eos_id=9, key=jax.random.PRNGKey(42))
        drains[merge] = {u: c.tokens for u, c in sched.run(reqs).items()}
    path = ckpt.save_checkpoint(str(tmp_path_factory.mktemp("nf4") / "ck"), 3, params_from_jax(tree),
                                {"update_step": 3}, lora_spec=relora.LoraSpec(**spec))
    return path, spec, drains


@pytest.mark.parametrize("merge", [False, True], ids=["no_merge", "merged"])
def test_nf4_checkpoint_greedy_drain_token_identical_to_jax(nf4_checkpoint, merge, tmp_path):
    """serve_cli's loading of the checkpoint (merged through merged_params,
    or --no-merge: the nf4 LoRALinear on the plain path) drained greedily
    by the port's scheduler, token for token the JAX package's drain of the
    same tree."""
    path, spec, drains = nf4_checkpoint
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps({**SERVE_TINY, "model_type": "llama"}))
    args = serve_cli.parse_args(
        ["--model_config", str(config), "--checkpoint", path, "--paged", "--device", "cpu"]
        + ([] if merge else ["--no-merge"]))
    params, lora = serve_cli.load_params(args, ModelConfig(**SERVE_TINY), torch.float32,
                                         torch.device("cpu"))
    assert (lora is None) == merge
    if merge:
        assert not any(k.endswith(tuple(NF4_LEAVES)) for k in params)
    pt = InferenceEngine(ModelConfig(**SERVE_TINY), params, lora=lora, device="cpu", **_engine_kwargs())
    if not merge:
        proj = pt.model.layers[0].mlp.up_proj
        assert proj.quantize == "nf4" and proj.lora.fused == "auto" and proj.weight_codes.dtype == torch.uint8
    sched = PagedContinuousBatchingScheduler(pt, max_batch=MAX_BATCH, eos_id=9, seed=42)
    got = {u: c.tokens for u, c in sched.run(
        [Request(uid=u, prompt=p, max_new_tokens=n) for u, p, n in _mix()]).items()}
    assert got == drains[merge] and sorted(got) == [1, 2, 3, 4]


def test_tenants_refuse_an_nf4_base():
    with pytest.raises(ValueError, match="dense base"):
        relora.LoraSpec(r=4, quantize="nf4", num_slots=2)
