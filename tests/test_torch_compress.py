"""The port's compression subsystem against the JAX package's, on the CPU.

``relora_tpu_torch/compress`` (masks, their application, the sidecar, the
magnitude re-init, the draft exporter), ``core/relora.merge_and_reinit(mask=,
a_init=)``, the trainer's prune state and ``tools/export_hf --pruned`` are
held to ``relora_tpu`` on the same numpy-seeded weights, carried across by
``params_from_jax``, at a tiny Llama and a tiny GPT-NeoX over JAX trees with
unrolled layers (the names the sidecar uses).

Tolerances: masks exactly equal after layout, thresholds bit-equal (the
f32 quantile, also over a pool past 2**24 magnitudes), sidecar checksums
equal.  The masked merge: dense within 1e-6, int8 and nf4 by the requant
rule (the two packages sum ``A @ B`` in another order, so a last-ulp
difference may flip a code at a midpoint: at least 99.9% of codes equal, the
dequantized weights within one quantization step), pruned positions exactly
0 in every storage.  ``Trainer.fit`` across a prune event with the
magnitude re-init: per-update losses within 1e-4, mask checksums equal.
Exports within 1e-6 of the JAX tools' output with the same zeros.
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

from relora_tpu.compress import draft as jax_draft
from relora_tpu.compress import prune as jax_prune
from relora_tpu.compress import resets as jax_resets
from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.core import optim as jax_optim
from relora_tpu.core import relora as jax_relora
from relora_tpu.core.partition import partition
from relora_tpu.core.schedules import make_schedule as jax_make_schedule
from relora_tpu.models import hf_compat as jax_hf
from relora_tpu.models.llama import LlamaForCausalLM as JaxLlama
from relora_tpu.models.params_util import init_params as jax_init_params, stack_layers
from relora_tpu.models.pythia import GPTNeoXForCausalLM as JaxNeoX
from relora_tpu.ops import quant as jq
from relora_tpu.train import checkpoint as jax_ckpt
from relora_tpu.train.state import TrainState as JaxTrainState
from relora_tpu.train.step import make_train_step as jax_make_train_step
from relora_tpu_torch.compress import draft, prune, resets
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.config.training import TrainingConfig
from relora_tpu_torch.core import relora
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.models.family import causal_lm_class
from relora_tpu_torch.models.warm_start import graft_base_weights
from relora_tpu_torch.ops.quant import NF4_CODEBOOK, dequantize_int8, dequantize_nf4, nf4_leaves_from_module
from relora_tpu_torch.tools import export_hf
from relora_tpu_torch.train import checkpoint as ckpt
from relora_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_LLAMA = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=2, max_sequence_length=32)
TINY_NEOX = dict(family="neox", vocab_size=128, hidden_size=32, intermediate_size=96,
                 num_hidden_layers=2, num_attention_heads=2, max_sequence_length=32,
                 rotary_pct=0.25)
FAMILIES = {"llama": TINY_LLAMA, "neox": TINY_NEOX}
LORA = dict(r=4, alpha=8.0, dropout=0.0)
STORAGES = {"f32": {}, "bf16": {"base_dtype": "bf16"}, "int8": {"quantize": "int8"},
            "nf4": {"quantize": "nf4"}}
MODES = [(0.0, "global", None), (0.3, "global", None), (0.5, "global", None),
         (0.9, "global", None), (0.0, "per_matrix", None), (0.3, "per_matrix", None),
         (0.5, "per_matrix", None), (0.9, "per_matrix", None), (0.0, "global", "2:4"),
         (0.0, "global", "1:4")]
DENSE_TOL = 1e-6
LOSS_TOL = 1e-4
MERGE_MIN_EQUAL = 0.999
NF4_GAP = float(np.diff(NF4_CODEBOOK).max())  # the widest codebook gap: one step per unit scale


# ------------------------------------------------------------------ weights

QUANTIZE_NF4 = jax.jit(jq.quantize_nf4, static_argnames="double_quant")  # the test data's nf4 leaves


def jax_model(cfg, spec):
    cls = JaxNeoX if cfg.get("family") == "neox" else JaxLlama
    return cls(JaxModelConfig(**cfg), lora=spec, dtype=jnp.float32, scan_layers=False,
               attention_impl="naive")


def seeded_tree(cfg, storage, seed):
    """Numpy weights in the unrolled tree of the JAX model of ``cfg`` with
    LoRA in ``storage`` (shapes from ``jax.eval_shape``, no JAX init):
    kernels N(0, 0.05), an int8 base of codes in [-3, 3] (ties everywhere:
    a column's equal codes share one scale), an nf4 base quantized by the
    JAX package, ``lora_a`` N(0, 0.1), ``lora_b`` N(0, 0.05)."""
    spec = jax_relora.LoraSpec(**LORA, **STORAGES[storage])
    model = jax_model(cfg, spec)
    shapes = jax.eval_shape(lambda: jax_init_params(model, jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(seed)

    def normal(shape, std, mean=0.0):
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)

    def fill(node):
        out = {}
        if "kernel_q" in node:
            in_f, out_f = node["kernel_q"].shape
            out["kernel_q"] = rng.integers(-3, 4, (in_f, out_f)).astype(np.int8)
            out["kernel_scale"] = rng.uniform(0.01, 0.02, (1, out_f)).astype(np.float32)
        if "kernel_codes" in node:
            half, out_f = node["kernel_codes"].shape
            dq = node["kernel_bscale_q"].dtype == jnp.int8
            leaves = QUANTIZE_NF4(jnp.asarray(normal((2 * half, out_f), 0.05)), double_quant=dq)
            out.update({"kernel_" + k: np.asarray(v) for k, v in leaves.items()})
        for k, v in node.items():
            if k in out:
                continue
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "scale":
                out[k] = normal(v.shape, 0.1, 1.0)
            else:
                std = {"lora_a": 0.1, "lora_b": 0.05, "kernel": 0.05, "bias": 0.05}.get(k, 0.02)
                out[k] = normal(v.shape, std).astype(v.dtype)
        return out

    return fill(jax.tree_util.tree_map(lambda s: s, shapes)), spec


def port_model(cfg, storage, tree):
    config = ModelConfig(**cfg)
    model = causal_lm_class(config)(config, lora=relora.LoraSpec(**LORA, **STORAGES[storage]))
    model.load_state_dict(params_from_jax(tree))
    return model


@pytest.fixture(scope="module")
def trees():
    """``{(family, storage): (tree, spec)}``, built once."""
    cache = {}

    def get(family, storage, seed=0):
        key = (family, storage, seed)
        if key not in cache:
            cache[key] = seeded_tree(FAMILIES[family], storage, seed)
        return cache[key]

    return get


def jax_mask_dict(jmask):
    """A JAX mask tree as the port's ``{module name: (in, out) keep}``."""
    return {prune.port_name(path): np.asarray(keep) for path, keep in jax_prune._mask_items(jmask)}


def assert_masks_equal(got, want):
    assert sorted(got) == sorted(want)
    for name, keep in got.items():
        assert keep.dtype == torch.bool, name
        np.testing.assert_array_equal(keep.cpu().numpy(), want[name], err_msg=name)


def cache_jax_bases(monkeypatch):
    """Dequantize each JAX module's base once for all the modes of a test
    (``relora_tpu.compress.prune._module_base``, the same arrays: a cache)."""
    real, seen = jax_prune._module_base, {}

    def cached(node):
        if id(node) not in seen:
            seen[id(node)] = (node, real(node))
        return seen[id(node)][1]

    monkeypatch.setattr(jax_prune, "_module_base", cached)


def spy_thresholds(monkeypatch):
    """Record every threshold both packages compute, as (pool size, value)."""
    seen = {"jax": [], "port": []}
    real_jq, real_port = jnp.quantile, prune.quantile_linear

    def jax_spy(a, q, *args, **kw):
        out = real_jq(a, q, *args, **kw)
        seen["jax"].append((int(np.size(a)), float(out)))
        return out

    def port_spy(values, q):
        out = real_port(values, q)
        seen["port"].append((values.numel(), out))
        return out

    monkeypatch.setattr(jnp, "quantile", jax_spy)
    monkeypatch.setattr(prune, "quantile_linear", port_spy)
    return seen


def base_of(model, name):
    """The module's base as f32 ``(in, out)``, dequantized."""
    module = model.get_submodule(name)
    if getattr(module, "weight_codes", None) is not None:
        return dequantize_nf4(nf4_leaves_from_module(module))
    if getattr(module, "weight_q", None) is not None:
        return dequantize_int8(module.weight_q, module.weight_scale).t()
    return module.weight.float().t()


# -------------------------------------------------------------------- masks


@pytest.mark.parametrize("storage", list(STORAGES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_magnitude_mask_matches_jax(trees, monkeypatch, family, storage):
    """Every scope and sparsity, and 2:4 and 1:4, over every storage: masks
    exactly equal after layout (non-square projections included), each
    threshold bit-equal to ``jnp.quantile``'s."""
    tree, _ = trees(family, storage)
    model = port_model(FAMILIES[family], storage, tree)
    seen = spy_thresholds(monkeypatch)
    cache_jax_bases(monkeypatch)
    for sparsity, scope, nm in MODES:
        want = jax_mask_dict(jax_prune.magnitude_mask(tree, sparsity, scope=scope, nm=nm))
        got = prune.magnitude_mask(model, sparsity, scope=scope, nm=nm)
        assert_masks_equal(got, want)
        if nm is None and sparsity == 0.0:
            assert all(bool(k.all()) for k in got.values())
    assert len(seen["jax"]) == 3 * (1 + len(want)) and sorted(seen["port"]) == sorted(seen["jax"])
    shapes = {tuple(k.shape) for k in got.values()}
    assert any(a != b for a, b in shapes), "a non-square projection"


def test_global_threshold_past_2_24_magnitudes_is_bit_equal(monkeypatch):
    """One global pool of 16,785,408 magnitudes (two 4096 x 2049 bases):
    past 2**24 JAX's f32 index rounds and ``torch.quantile`` refuses; the
    port's threshold equals ``jnp.quantile``'s bit for bit and the masks are
    equal."""
    rng = np.random.default_rng(3)
    tree, state = {}, {}
    for name in ("a", "b"):
        w = rng.standard_normal((4096, 2049)).astype(np.float32)
        w[: 4096 // 3] = np.round(w[: 4096 // 3] * 16) / 16  # ties at the cut too
        lora_a = np.zeros((4096, 1), np.float32)
        tree[name] = {"kernel": w, "lora_a": lora_a, "lora_b": np.zeros((1, 2049), np.float32)}
        state[f"{name}.weight"], state[f"{name}.lora_a"] = torch.from_numpy(w.T), torch.from_numpy(lora_a)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(torch.zeros((1 << 24) + 1), 0.5)
    seen = spy_thresholds(monkeypatch)
    want = jax_mask_dict(jax_prune.magnitude_mask(tree, 0.3))
    got = prune.magnitude_mask(state, 0.3)
    assert seen["jax"] == seen["port"] and seen["jax"][0][0] == 2 * 4096 * 2049 > 1 << 24
    assert_masks_equal(got, want)


@pytest.mark.parametrize("nm", ["2:4", "1:4", "3:8"])
def test_nm_ties_in_an_int8_base_break_as_jax(nm):
    """Codes of equal size in one output column share one scale, so groups
    along the input axis tie: both packages rank a tie by row and keep the
    later rows (stable argsorts), group by group."""
    rng = np.random.default_rng(5)
    q = rng.integers(-2, 3, (64, 24)).astype(np.int8)
    scale = rng.uniform(0.5, 1.0, (1, 24)).astype(np.float32)
    tree = {"m": {"kernel_q": q, "kernel_scale": scale, "lora_a": np.zeros((64, 2), np.float32)}}
    state = {"m.weight_q": torch.from_numpy(q.T.copy()), "m.weight_scale": torch.from_numpy(scale),
             "m.lora_a": torch.zeros(64, 2)}
    n, m = prune.parse_nm(nm)
    groups = np.abs(q).reshape(64 // m, m, 24)
    cut = np.sort(groups, axis=1)[:, m - n - 1: m - n + 1]
    assert (cut[:, 0] == cut[:, 1]).mean() > 0.3, "most groups tie at the cut"
    got = prune.magnitude_mask(state, 0.0, nm=nm)
    assert_masks_equal(got, jax_mask_dict(jax_prune.magnitude_mask(tree, 0.0, nm=nm)))
    assert (got["m"].reshape(64 // m, m, 24).sum(1) == n).all()


def test_mask_arguments_are_refused_as_jax():
    state = {"m.weight": torch.zeros(8, 8), "m.lora_a": torch.zeros(8, 2)}
    for kw, err in ((dict(sparsity=1.0), ValueError), (dict(sparsity=0.5, scope="layer"), ValueError),
                    (dict(sparsity=0.0, nm="4:4"), ValueError), (dict(sparsity=0.0, nm="2"), ValueError),
                    (dict(sparsity=0.5, paths=["x"]), prune.PruneMaskMismatchError)):
        with pytest.raises(err):
            prune.magnitude_mask(state, **kw)
    with pytest.raises(ValueError, match="in_features % M"):
        prune.magnitude_mask({"m.weight": torch.zeros(8, 6), "m.lora_a": torch.zeros(6, 2)}, 0.0, nm="2:4")
    with pytest.raises(ValueError, match="no prunable"):
        prune.magnitude_mask({"m.weight": torch.zeros(8, 8)}, 0.5)


# ----------------------------------------------------------------- apply


@pytest.mark.parametrize("storage", list(STORAGES))
def test_apply_mask_zeroes_exactly_as_jax(trees, storage):
    """A 50% global mask applied in place: pruned positions exactly 0 in
    every storage; the bases equal JAX's ``apply_mask`` (dense and int8 bit
    for bit, nf4 codes bit-equal with block scales within one step);
    applying it again changes nothing in dense and int8."""
    tree, _ = trees("llama", storage)
    model = port_model(TINY_LLAMA, storage, tree)
    jmask = jax_prune.magnitude_mask(tree, 0.5)
    mask = prune.magnitude_mask(model, 0.5)
    assert prune.apply_mask(model, mask) is model
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_prune.apply_mask(tree, jmask)))
    sd = model.state_dict()
    for name, keep in mask.items():
        assert not base_of(model, name)[~keep].any(), name
        for leaf in ("weight", "weight_q", "weight_scale", "weight_codes"):
            key = f"{name}.{leaf}"
            if key in sd:
                np.testing.assert_array_equal(sd[key].float().numpy(), want[key].float().numpy(),
                                              err_msg=key)
        if storage == "nf4":
            off = (sd[f"{name}.weight_bscale_q"].float() - want[f"{name}.weight_bscale_q"].float()).abs()
            assert off.max() <= 1 and (off != 0).float().mean() <= 0.01
    if storage in ("f32", "bf16", "int8"):
        before = {k: v.clone() for k, v in sd.items()}
        prune.apply_mask(model, mask)
        assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("target", ["model", "state_dict"])
def test_apply_mask_refuses_before_writing(trees, target):
    """A mask naming a module the weights lack, or of another shape, raises
    PruneMaskMismatchError before anything is written, as JAX's does."""
    tree, _ = trees("llama", "f32")
    model = port_model(TINY_LLAMA, "f32", tree)
    weights = model if target == "model" else {k: v.clone() for k, v in model.state_dict().items()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    good = prune.magnitude_mask(model, 0.5)
    first = next(iter(good))
    cases = [({first: good[first], "layers.9.mlp.down_proj": good[first]}, "absent"),
             ({first: good[first], "layers.0.mlp.down_proj": good["layers.0.mlp.up_proj"]}, "shape")]
    for bad, match in cases:
        with pytest.raises(prune.PruneMaskMismatchError, match=match):
            prune.apply_mask(weights, bad)
        jbad = jax_prune._build_tree({prune.jax_path(k): v.numpy() for k, v in bad.items()})
        with pytest.raises(jax_prune.PruneMaskMismatchError, match=match):
            jax_prune.apply_mask(tree, jbad)
    after = model.state_dict() if target == "model" else weights
    assert all(torch.equal(before[k], after[k]) for k in before)


# ----------------------------------------------------------------- merge


def jax_draws(tree, key, jspec):
    """The kaiming draws JAX's merge takes at ``key``, module by module: its
    merge without ``a_init`` draws the same keys and keeps them as A."""
    raw = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_relora.merge_and_reinit(tree, key, jspec)))
    return {k[: -len(".lora_a")]: v for k, v in raw.items() if k.endswith(".lora_a")}


def feed_draws(monkeypatch, model, *draws):
    """Feed the JAX draws to the port's ``kaiming_uniform`` in module order,
    one merge after another; returns the queue (empty when all were taken)."""
    queue = [d[name] for d in draws for name, _ in relora.lora_modules(model)]
    monkeypatch.setattr(relora, "kaiming_uniform", lambda shape, generator, device: queue.pop(0))
    return queue


@pytest.mark.parametrize("storage", list(STORAGES))
def test_masked_merge_with_the_magnitude_reinit_matches_jax(trees, monkeypatch, storage):
    """``merge_and_reinit(mask=, a_init=magnitude_a_init)`` against JAX's
    with the same A draw: the mask applied to the merged f32 base before the
    cast or requant (pruned positions exactly 0), dense within 1e-6 (bf16: a
    cast of values within 1e-6), int8 and nf4 by the requant rule; A within
    1e-5 of its largest entry; B zero, so the delta is zero."""
    tree, jspec = trees("llama", storage)
    model = port_model(TINY_LLAMA, storage, tree)
    spec = relora.LoraSpec(**LORA, **STORAGES[storage])
    jmask = jax_prune.magnitude_mask(tree, 0.5, scope="per_matrix")
    mask = prune.magnitude_mask(model, 0.5, scope="per_matrix")
    key = jax.random.PRNGKey(7)
    queue = feed_draws(monkeypatch, model, jax_draws(tree, key, jspec))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_relora.merge_and_reinit(
        tree, key, jspec, a_init=jax_resets.magnitude_a_init, mask=jmask)))
    relora.merge_and_reinit(model, torch.Generator(), spec, a_init=resets.magnitude_a_init, mask=mask)
    assert not queue
    got = model.state_dict()
    for name, module in relora.lora_modules(model):
        assert not base_of(model, name)[~mask[name]].any(), name
        assert not module.lora_b.any() and not relora.lora_delta(module, spec).any()
        a, wa = got[f"{name}.lora_a"], want[f"{name}.lora_a"]
        assert (a - wa).abs().max() <= 1e-5 * wa.abs().max(), name
        if storage in ("f32", "bf16"):
            w, ww = got[f"{name}.weight"].float(), want[f"{name}.weight"].float()
            tol = DENSE_TOL if storage == "f32" else float(ww.abs().max()) * 2.0 ** -8
            assert (w - ww).abs().max() <= tol, name
            if storage == "bf16":  # a cast flips only where f32 values straddle a rounding point
                assert (w == ww).float().mean() >= MERGE_MIN_EQUAL, name
        elif storage == "int8":
            q, s = got[f"{name}.weight_q"], got[f"{name}.weight_scale"]
            wq, ws = want[f"{name}.weight_q"], want[f"{name}.weight_scale"]
            assert (q == wq).float().mean() >= MERGE_MIN_EQUAL, name
            step = torch.maximum(s, ws).t()
            assert ((q.float() * s.t() - wq.float() * ws.t()).abs() <= step * (1 + 1e-6)).all()
        else:
            codes, wcodes = got[f"{name}.weight_codes"], want[f"{name}.weight_codes"]
            assert (codes == wcodes).float().mean() >= MERGE_MIN_EQUAL, name
            mine, theirs = base_of(model, name), dequantize_nf4(
                {leaf: want[f"{name}.{param}"] for param, leaf in relora.NF4_LEAVES.items()})
            col = theirs.abs().amax(dim=0, keepdim=True)  # bounds each block's scale
            assert ((mine - theirs).abs() <= col * NF4_GAP * (1 + 1e-6)).all(), name


def test_a_init_none_is_todays_merge(trees):
    """``a_init=None``, no mask: the same bits as the merge before either
    existed (a kaiming draw from the generator)."""
    tree, _ = trees("llama", "f32")
    one, two = (port_model(TINY_LLAMA, "f32", tree) for _ in range(2))
    spec = relora.LoraSpec(**LORA)
    relora.merge_and_reinit(one, torch.Generator().manual_seed(3), spec)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for _, m in relora.lora_modules(two):
            m.weight.copy_((m.weight.float() + relora.lora_delta(m, spec)).to(m.weight.dtype))
            m.lora_a.copy_(relora.kaiming_uniform(m.lora_a.shape, gen, m.lora_a.device))
            m.lora_b.zero_()
    for (k, v), w in zip(one.state_dict().items(), two.state_dict().values()):
        assert torch.equal(v, w), k
    assert resets.make_reinit_fn("random") is None
    assert resets.make_reinit_fn("magnitude") is resets.magnitude_a_init
    with pytest.raises(ValueError, match="reset_init"):
        resets.make_reinit_fn("kaiming")


# --------------------------------------------------------------- sidecar


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sidecar_round_trips_with_the_jax_package(trees, tmp_path, family):
    """The port's sidecar: the JAX package's ``load_mask`` reads it (its crc
    check included) as the mask JAX builds over the unrolled tree, the meta
    equals JAX's ``save_mask`` meta key for key, and the port reads JAX's
    sidecar back, a scanned tree's (stacked layers) as the unrolled one."""
    tree, _ = trees(family, "int8")
    model = port_model(FAMILIES[family], "int8", tree)
    jmask = jax_prune.magnitude_mask(tree, 0.4)
    mask = prune.magnitude_mask(model, 0.4)
    meta = {"target_sparsity": 0.4, "scope": "global", "nm": None, "computed_at_step": 4}
    ours = prune.save_mask(str(tmp_path / "port"), mask, meta)
    theirs = jax_prune.save_mask(str(tmp_path / "jax"), jmask, meta)
    assert json.loads((tmp_path / "port" / prune.PRUNE_META_FILE).read_text()) == json.loads(
        (tmp_path / "jax" / prune.PRUNE_META_FILE).read_text())
    assert ours["mask_crc32"] == theirs["mask_crc32"] == prune.mask_checksum(mask) == \
        jax_prune.mask_checksum(jmask)
    read, _ = jax_prune.load_mask(str(tmp_path / "port"))
    assert jax_prune.mask_checksum(read) == theirs["mask_crc32"]
    assert_masks_equal(mask, jax_mask_dict(read))
    back, back_meta = prune.load_mask(str(tmp_path / "jax"))
    assert_masks_equal(back, jax_mask_dict(jmask)) and back_meta == theirs
    scanned = stack_layers(jax.tree_util.tree_map(np.asarray, jmask), FAMILIES[family]["num_hidden_layers"])
    jax_prune.save_mask(str(tmp_path / "scanned"), scanned, meta)
    assert_masks_equal(prune.load_mask(str(tmp_path / "scanned"))[0], jax_mask_dict(jmask))


def test_checkpoint_covers_the_sidecar_and_drops_a_stale_pair(tmp_path):
    """``save_checkpoint(prune_mask=)`` writes the pair before the manifest,
    which lists both files: a flipped byte in the mask fails
    ``verify_checkpoint``, a wrong recorded crc fails ``load_mask``, and a
    rewrite of the directory without a mask leaves no stale pair."""
    state = {"m.weight": torch.randn(6, 8), "m.lora_a": torch.randn(8, 2)}
    mask = prune.magnitude_mask(state, 0.5)
    path = ckpt.save_checkpoint(str(tmp_path), 3, state, {"update_step": 3},
                                prune_mask=mask, prune_meta={"scope": "global"})
    manifest = json.loads(open(os.path.join(path, ckpt.MANIFEST_FILE)).read())
    assert {prune.PRUNE_MASK_FILE, prune.PRUNE_META_FILE} <= set(manifest["files"])
    assert ckpt.verify_checkpoint(path) == (True, "ok")
    blob = os.path.join(path, prune.PRUNE_MASK_FILE)
    data = bytearray(open(blob, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(blob, "wb").write(bytes(data))
    ok, reason = ckpt.verify_checkpoint(path)
    assert not ok and prune.PRUNE_MASK_FILE in reason
    path = ckpt.save_checkpoint(str(tmp_path), 3, state, {"update_step": 3}, prune_mask=mask)
    meta_path = os.path.join(path, prune.PRUNE_META_FILE)
    meta = json.loads(open(meta_path).read())
    open(meta_path, "w").write(json.dumps({**meta, "mask_crc32": meta["mask_crc32"] ^ 1}))
    with pytest.raises(prune.PruneMaskMismatchError, match="crc32"):
        prune.load_mask(path)
    path = ckpt.save_checkpoint(str(tmp_path), 3, state, {"update_step": 3})
    assert not os.path.exists(blob) and not os.path.exists(meta_path)
    assert ckpt.verify_checkpoint(path) == (True, "ok") and prune.load_mask(path) == (None, None)


# ---------------------------------------------------------------- trainer


RECIPE = dict(batch_size=4, total_batch_size=8, max_length=16, lr=5e-3, scheduler="cosine_restarts",
              warmup_steps=2, restart_warmup_steps=1, num_training_steps=9, cycle_length=3, relora=3,
              use_peft=True, lora_r=4, lora_dropout=0.0, eval_every=1000, seed=0)
PRUNE = dict(prune_sparsity=0.5, prune_scope="global", reset_init="magnitude")


def _batches(n, seed=0):
    starts = np.random.default_rng(seed).integers(0, 128, (n, 2, 4, 1))
    return ((starts + np.arange(16)) % 128).astype(np.int32)  # learnable: i -> i+1


def _cfg(tmp_path, **kw):
    data = tmp_path / "data.json"
    data.write_text(json.dumps({"data_path": str(tmp_path / "unused"), "seq_length": 16}))
    return TrainingConfig(megatron_dataset_config=str(data), dtype="float32", device="cpu",
                          **{**RECIPE, **PRUNE, **kw}).finalize()


def _jax_run(batches):
    """The JAX package's step, merge and reset under the JAX trainer's rule,
    with its prune event (``relora_tpu/train/trainer.py:531-575``): the
    first merge unmasked with the magnitude re-init, then the mask from the
    merged base applied; later merges masked.  Returns per-update losses,
    the initial params, the kaiming draws of each merge and the mask."""
    spec = jax_relora.LoraSpec(r=4, dropout=0.0)
    model = jax_model(TINY_LLAMA, spec)
    params = jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    trainable = jax_relora.trainable_param_mask(params)
    sched = jax_make_schedule("cosine_restarts", lr=5e-3, num_training_steps=9, warmup_steps=2,
                              cycle_length=3, restart_warmup_steps=1)
    tx = jax_optim.build_optimizer(schedule=sched)
    state = JaxTrainState.create(params, tx.init(partition(params, trainable)[0]))
    step = jax.jit(jax_make_train_step(model, tx, trainable, clip_grad_norm=1.0, schedule=sched))
    losses, draws, mask = [], [], None
    for u, batch in enumerate(batches, start=1):
        state, metrics = step(state, jnp.asarray(batch), jax.random.PRNGKey(u))
        losses.append(float(metrics["loss"]))
        if u >= 3 and u % 3 == 1:
            key = jax.random.fold_in(jax.random.PRNGKey(2), u)
            draws.append(jax_draws(state.params, key, spec))
            merged = jax_relora.merge_and_reinit(state.params, key, spec,
                                                 a_init=jax_resets.magnitude_a_init, mask=mask)
            if mask is None:
                mask = jax_prune.magnitude_mask(merged, 0.5, scope="global")
                merged = jax_prune.apply_mask(merged, mask)
            state = state.replace(params=merged, opt_state=jax_optim.reset_optimizer_state(
                state.opt_state, mode="zero", ratio=1.0))
    return losses, jax.tree_util.tree_map(np.asarray, params), draws, mask


def _events(save_dir, name):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r.get("_event") == name]


def test_trainer_fit_across_a_prune_event_tracks_jax(tmp_path, monkeypatch):
    """9 updates, merges at 4 and 7: the mask computed once at 4 from the
    merged base, the magnitude re-init at both, the merge at 7 masked.
    Per-update losses within 1e-4 of JAX's; the prune_mask_computed event's
    crc, the trainer's mask and the last checkpoint's sidecar equal JAX's
    mask checksum; pruned positions stay exactly 0."""
    batches = _batches(9)
    want, params, draws, jmask = _jax_run(batches)
    trainer = Trainer(_cfg(tmp_path, save_dir=str(tmp_path / "run")), model_cfg=ModelConfig(**TINY_LLAMA))
    trainer.model.load_state_dict(params_from_jax(params))
    queue = feed_draws(monkeypatch, trainer.model, *draws)
    result = trainer.fit(iter(batches))
    got = [r["loss"] for r in result["records"]]
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)
    assert not queue and result["n_lora_restarts"] == 2
    crc = jax_prune.mask_checksum(jmask)
    [event] = _events(str(tmp_path / "run"), "prune_mask_computed")
    assert event["_step"] == 4 and event["mask_crc32"] == crc == prune.mask_checksum(trainer._prune_mask)
    assert abs(event["sparsity"] - 0.5) < 1e-3
    saved, meta = prune.load_mask(str(tmp_path / "run" / "model_9"))
    assert meta["mask_crc32"] == crc and meta["computed_at_step"] == 4
    assert_masks_equal(trainer._prune_mask, jax_mask_dict(jmask))
    for name, keep in trainer._prune_mask.items():
        assert not base_of(trainer.model, name)[~keep].any(), name


def test_resume_restores_the_mask_and_the_run(tmp_path):
    """A run stopped at update 6 and resumed takes the mask from model_6's
    sidecar, prunes no second time, and ends where the straight run ends."""
    batches = _batches(9, seed=1)
    straight = Trainer(_cfg(tmp_path, save_dir=str(tmp_path / "a")), model_cfg=ModelConfig(**TINY_LLAMA))
    want = [r["loss"] for r in straight.fit(iter(batches))["records"]]
    first = Trainer(_cfg(tmp_path, save_dir=str(tmp_path / "b"), num_training_steps=9),
                    model_cfg=ModelConfig(**TINY_LLAMA))
    first.fit(iter(batches[:6]))
    resumed = Trainer(_cfg(tmp_path, save_dir=str(tmp_path / "b"), autoresume=True),
                      model_cfg=ModelConfig(**TINY_LLAMA))
    assert resumed.update_step == 6
    assert_masks_equal(resumed._prune_mask, {k: v.numpy() for k, v in first._prune_mask.items()})
    got = [r["loss"] for r in resumed.fit(iter(batches[6:]))["records"]]
    assert got == want[6:]
    assert len(_events(str(tmp_path / "b"), "prune_mask_computed")) == 1
    for (k, v), w in zip(resumed.model.state_dict().items(), straight.model.state_dict().values()):
        assert torch.equal(v, w), k


@pytest.mark.parametrize("spike_at,target,masked", [((7, 8), 6, True), ((5, 6), 3, False)])
def test_spike_rollback_resyncs_the_mask(tmp_path, spike_at, target, masked):
    """A rollback to a checkpoint after the prune event takes its sidecar's
    mask (no second prune event); to one before it, none (the next merge
    computes a new one)."""
    save_dir = str(tmp_path / "run")
    batches = _batches(12, seed=2)
    trainer = Trainer(_cfg(tmp_path, save_dir=save_dir, save_every=3, num_training_steps=12,
                           spike_threshold=3.0, spike_window=8, spike_min_history=4,
                           spike_patience=2, spike_rollback_margin=1, max_spike_rollbacks=1),
                      model_cfg=ModelConfig(**TINY_LLAMA))
    step, handle = trainer._train_step, trainer._handle_spike
    after = []

    def spiking(state, batch, seeds):
        metrics = step(state, batch, seeds)
        if trainer.update_step + 1 in spike_at and len(after) == 0:
            metrics = {**metrics, "loss": metrics["loss"] + 50.0}
        return metrics

    def spy(spike, can_realign):
        out = handle(spike, can_realign)
        after.append(None if trainer._prune_mask is None else prune.mask_checksum(trainer._prune_mask))
        return out

    trainer._train_step, trainer._handle_spike = spiking, spy
    result = trainer.fit(iter(batches), train_iter_factory=lambda: iter(batches[trainer.update_step:]))
    [rollback] = _events(save_dir, "rollback")
    assert result["n_rollbacks"] == 1 and rollback["target"] == os.path.join(save_dir, f"model_{target}")
    events = _events(save_dir, "prune_mask_computed")
    if masked:
        assert after == [events[0]["mask_crc32"]] and len(events) == 1
    else:
        assert after == [None] and len(events) == 2
    assert prune.mask_checksum(trainer._prune_mask) == events[-1]["mask_crc32"]


# ------------------------------------------------------------ draft, export


def _hf_config_json(path, cfg):
    d = dict(cfg, model_type="gpt_neox" if cfg.get("family") == "neox" else "llama",
             max_position_embeddings=cfg["max_sequence_length"])
    d.pop("family", None)
    path.write_text(json.dumps(d))
    return str(path)


def _both_checkpoints(tmp_path, family, tree, jspec, jmask):
    """The same unmerged weights as a JAX checkpoint (orbax) and a port one,
    each with its own package's sidecar of the same mask when given."""
    jpath = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 6, {"params": tree}, {"update_step": 6},
                                     lora_spec=jspec)
    if jmask is not None:
        jax_prune.save_mask(jpath, jmask, {"scope": "global"})
    jax_ckpt.wait_for_save()
    mask = None if jmask is None else {k: torch.tensor(v) for k, v in jax_mask_dict(jmask).items()}
    path = ckpt.save_checkpoint(str(tmp_path / "port"), 6, params_from_jax(tree), {"update_step": 6},
                                lora_spec=relora.LoraSpec(**LORA), prune_mask=mask,
                                prune_meta={"scope": "global"})
    return jpath, path


@pytest.mark.parametrize("family", list(FAMILIES))
def test_export_hf_pruned_matches_the_jax_tool(trees, tmp_path, family):
    """``tools.export_hf --pruned`` of a port checkpoint against
    ``tools/export_hf.py --pruned`` of the same weights and mask in a JAX
    checkpoint (``relora_tpu.models.hf_compat.params_to_hf`` of the merged,
    masked tree): the same keys, values within 1e-6 with the same zeros,
    ``config.json`` equal key for key; read back through
    ``graft_base_weights`` into a fresh model it holds those weights.  A
    checkpoint without a sidecar, or with a mask that does not fit, is
    refused."""
    sys.path.insert(0, REPO)
    from tools.export_hf import main as jax_export

    cfg = FAMILIES[family]
    tree, jspec = trees(family, "f32", seed=1)
    jmask = jax_prune.magnitude_mask(tree, 0.5)
    jpath, path = _both_checkpoints(tmp_path, family, tree, jspec, jmask)
    config = _hf_config_json(tmp_path / "config.json", cfg)
    jax_export(["--checkpoint", jpath, "--model_config", config, "--out", str(tmp_path / "jout"), "--pruned"])
    export_hf.main(["--checkpoint", path, "--model_config", config, "--out", str(tmp_path / "out"),
                    "--pruned", "--device", "cpu"])
    got = torch.load(tmp_path / "out" / "pytorch_model.bin", weights_only=True)
    want = torch.load(tmp_path / "jout" / "pytorch_model.bin", weights_only=True)
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and (v - want[k]).abs().max() <= DENSE_TOL, k
        assert torch.equal(v == 0, want[k] == 0), k
    masked = jax_prune.apply_mask(jax_relora.merged_params(tree, jspec), jmask)
    reference = jax_hf.params_to_hf(jax.tree_util.tree_map(np.asarray, masked), JaxModelConfig(**cfg))
    assert sorted(reference) == sorted(got)
    assert all((got[k] - torch.tensor(np.asarray(v, np.float32))).abs().max() <= DENSE_TOL
               for k, v in reference.items())
    assert json.loads((tmp_path / "out" / "config.json").read_text()) == json.loads(
        (tmp_path / "jout" / "config.json").read_text())
    fresh = causal_lm_class(ModelConfig(**cfg))(ModelConfig(**cfg))
    graft_base_weights(fresh, got)
    hf = {k.removeprefix("model.").removeprefix("gpt_neox."): v for k, v in got.items()}
    assert all(torch.equal(p, hf[n]) for n, p in fresh.named_parameters())
    unpruned = ckpt.save_checkpoint(str(tmp_path / "plain"), 6, params_from_jax(tree), {"update_step": 6},
                                    lora_spec=relora.LoraSpec(**LORA))
    with pytest.raises(SystemExit, match="no prune_mask"):
        export_hf.main(["--checkpoint", unpruned, "--model_config", config, "--out",
                        str(tmp_path / "x"), "--pruned", "--device", "cpu"])
    stray = {k: torch.tensor(v) for k, v in jax_mask_dict(jmask).items()}
    stray["layers.7.mlp.x"] = torch.ones(2, 2, dtype=torch.bool)
    bad = ckpt.save_checkpoint(str(tmp_path / "bad"), 6, params_from_jax(tree), {"update_step": 6},
                               lora_spec=relora.LoraSpec(**LORA), prune_mask=stray)
    with pytest.raises(prune.PruneMaskMismatchError, match="absent"):
        export_hf.main(["--checkpoint", bad, "--model_config", config, "--out", str(tmp_path / "y"),
                        "--pruned", "--device", "cpu"])


@pytest.mark.parametrize("sidecar", [True, False], ids=["sidecar", "sparsity"])
def test_draft_export_matches_jax(trees, tmp_path, sidecar):
    """``export_draft_checkpoint`` against ``relora_tpu.compress.draft.
    build_draft_params`` on the same weights: with a sidecar its mask, else
    ``--sparsity 0.6`` over the merged bases at the unmerged checkpoint's
    LoRA modules.  The pruned weights within 1e-6 with the same zeros; the
    manifest's ``pruned`` block (sparsity, crc equal to JAX's); the output
    verifies and loads through ``restore_serving_params``."""
    tree, jspec = trees("neox", "f32", seed=2)
    jmask = jax_prune.magnitude_mask(tree, 0.4) if sidecar else None
    jpath, path = _both_checkpoints(tmp_path, "neox", tree, jspec, jmask)
    kw = {} if sidecar else {"sparsity": 0.6}
    want_params, want_mask, want_meta = jax_draft.build_draft_params(jpath, **kw)
    out = draft.main([path, str(tmp_path / "draft"), "--device", "cpu"]
                     + ([] if sidecar else ["--sparsity", "0.6"]))
    assert out == os.path.join(str(tmp_path / "draft"), "model_6")
    assert ckpt.verify_checkpoint(out) == (True, "ok")
    got = ckpt.restore_serving_params(out)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_params))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert (v - want[k]).abs().max() <= DENSE_TOL and torch.equal(v == 0, want[k] == 0), k
    crc = jax_prune.mask_checksum(want_mask)
    manifest = json.loads(open(os.path.join(out, ckpt.MANIFEST_FILE)).read())
    stats = jax_prune.sparsity_stats(want_mask)
    assert manifest["metadata"]["pruned"] == {"sparsity": round(stats["sparsity"], 6), "mask_crc32": crc,
                                              "source_checkpoint": os.path.abspath(path)}
    mask, meta = prune.load_mask(out)
    assert meta["mask_crc32"] == crc and {k: meta[k] for k in want_meta} == want_meta
    assert ckpt.load_training_state(out)["draft_export"] is True
    if not sidecar:
        with pytest.raises(ValueError, match="nothing to prune"):
            draft.build_draft_params(path)


def test_cli_prunes_drafts_and_exports_without_jax(tmp_path):
    """``python -m relora_tpu_torch.main --prune_sparsity 0.5 --reset_init
    magnitude``, then ``-m relora_tpu_torch.compress.draft`` and ``-m
    relora_tpu_torch.tools.export_hf --pruned`` over its last checkpoint, in
    a process where importing jax, flax or relora_tpu fails: the sidecar's
    crc is the run's event's, the draft and the export carry it."""
    from relora_tpu_torch.data.memmap import MemmapTokenWriter

    rng = np.random.default_rng(0)
    with MemmapTokenWriter(str(tmp_path / "corpus"), dtype=np.uint16) as w:
        for _ in range(120):
            w.add_document((rng.zipf(1.3, rng.integers(20, 200)) % 128).astype(np.uint16))
    (tmp_path / "data.json").write_text(json.dumps(
        {"data_path": str(tmp_path / "corpus"), "split": "90,10,0", "seq_length": 16, "seed": 1}))
    config = _hf_config_json(tmp_path / "tiny.json", TINY_LLAMA)
    run = str(tmp_path / "run")
    train = ["--device", "cpu", "--model_config", config, "--megatron_dataset_config",
             str(tmp_path / "data.json"), "--final_eval_tokens", "200", "--save_dir", run,
             "--use_peft", "true", "--prune_sparsity", "0.5", "--reset_init", "magnitude"]
    for key in ("batch_size", "total_batch_size", "max_length", "lr", "scheduler", "warmup_steps",
                "restart_warmup_steps", "num_training_steps", "cycle_length", "relora", "lora_r"):
        train += [f"--{key}", str(RECIPE[key])]
    last = os.path.join(run, "model_9")
    runs = [("relora_tpu_torch.main", train),
            ("relora_tpu_torch.compress.draft", [last, str(tmp_path / "draft"), "--device", "cpu"]),
            ("relora_tpu_torch.tools.export_hf", ["--checkpoint", last, "--model_config", config,
                                                  "--out", str(tmp_path / "hf"), "--pruned",
                                                  "--device", "cpu", "--dtype", "bf16"])]
    code = (
        "import sys, runpy\n"
        "for name in ('jax', 'jaxlib', 'flax', 'relora_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for module, argv in {runs!r}:\n"
        "    sys.argv = [module] + argv\n"
        "    runpy.run_module(module, run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    [event] = _events(run, "prune_mask_computed")
    crc = event["mask_crc32"]
    assert prune.load_mask(last)[1]["mask_crc32"] == crc and ckpt.verify_checkpoint(last)[0]
    drafted = os.path.join(str(tmp_path / "draft"), "model_9")
    assert ckpt.verify_checkpoint(drafted) == (True, "ok")
    assert json.loads(open(os.path.join(drafted, ckpt.MANIFEST_FILE)).read())["metadata"]["pruned"][
        "mask_crc32"] == crc
    hf = json.loads((tmp_path / "hf" / "config.json").read_text())
    assert hf["relora_tpu_pruning"]["mask_crc32"] == crc and hf["torch_dtype"] == "bfloat16"
    sd = torch.load(tmp_path / "hf" / "pytorch_model.bin", weights_only=True)
    assert sd["model.layers.0.mlp.down_proj.weight"].dtype == torch.bfloat16
