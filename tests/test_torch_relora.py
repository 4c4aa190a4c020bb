"""The port's ReLoRA modules against their JAX counterparts, module by module.

Same numpy-seeded inputs through both packages at f32 on the CPU:
``LoRALinear`` (output and gradients of x, A, B, s), ``merge_and_reinit``
(merged base, B zeroed, A re-drawn inside the kaiming bound), the schedules
at every step, AdamW against the optax chain, the optimizer resets, the NaN
gate, and the Megatron batches.  Randomness that the packages draw from
different generators (the A re-draw, random moment pruning) is checked by
its bounds and the fraction it zeroes.
"""

import functools
import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta as flax_meta

from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.config.training import TrainingConfig as JaxTrainingConfig
from relora_tpu.core import optim as jax_optim
from relora_tpu.core import relora as jax_relora
from relora_tpu.core import schedules as jax_schedules
from relora_tpu.core.partition import partition
from relora_tpu.data.megatron import build_train_valid_test_iterators as jax_iterators
from relora_tpu.data.memmap import MemmapTokenWriter
from relora_tpu.models.llama import LlamaForCausalLM as JaxLlama
from relora_tpu.models.lora import LoRALinear as JaxLoRALinear
from relora_tpu.models.params_util import init_params as jax_init_params
from relora_tpu.train.state import TrainState as JaxTrainState
from relora_tpu.train.step import make_train_step as jax_make_train_step
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.config.training import TrainingConfig
from relora_tpu_torch.core import optim, relora, schedules
from relora_tpu_torch.data.megatron import build_train_valid_test_iterators
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.models.llama import LlamaForCausalLM
from relora_tpu_torch.models.lora import LoRALinear
from relora_tpu_torch.train.step import TrainState, make_train_step

pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, max_sequence_length=32)
TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def jax_lora_params(spec, seed=0, b_scale=0.05):
    """A JAX LoRA llama init with nonzero B, as numpy (cached: read only)."""
    model = JaxLlama(JaxModelConfig(**TINY), lora=spec, dtype=jnp.float32, scan_layers=True,
                     attention_impl="naive")
    params = _np_tree(jax_init_params(model, jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "lora_b":
            return (rng.standard_normal(leaf.shape) * b_scale).astype(leaf.dtype)
        return leaf

    return model, jax.tree_util.tree_map_with_path(fill, params)


def torch_model(spec, params):
    model = LlamaForCausalLM(ModelConfig(**TINY), dtype=torch.float32, attention_arm="naive",
                             lora=spec, param_dtype=torch.float32)
    model.load_state_dict(params_from_jax(params))
    relora.set_trainable(model, lora_only=False)
    return model


# --------------------------------------------------------------------------- LoRALinear


@pytest.mark.parametrize("trainable_scaling", [False, True], ids=["static", "tanh_s"])
@pytest.mark.parametrize("lora_only", [False, True], ids=["base", "lora_only"])
def test_lora_linear_matches_jax(trainable_scaling, lora_only):
    """y and the gradients of x, A, B (and s) agree at f32, dropout off."""
    spec = dict(r=4, alpha=8.0, dropout=0.0, trainable_scaling=trainable_scaling, lora_only=lora_only)
    jmod = JaxLoRALinear(features=24, lora=jax_relora.LoraSpec(**spec), dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    params = _np_tree(flax_meta.unbox(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    params["lora_b"] = rng.standard_normal(params["lora_b"].shape).astype(np.float32)
    if trainable_scaling:
        params["lora_s"] = np.array([0.7], np.float32)
    cot = rng.standard_normal((3, 5, 24)).astype(np.float32)

    def jf(p, xx):
        return jmod.apply({"params": p}, xx)

    y, vjp = jax.vjp(jf, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))

    mod = LoRALinear(16, 24, lora=relora.LoraSpec(**spec), dtype=torch.float32)
    with torch.no_grad():
        if not lora_only:
            mod.weight.copy_(torch.from_numpy(params["kernel"].T.copy()))
        for name in ("lora_a", "lora_b") + (("lora_s",) if trainable_scaling else ()):
            getattr(mod, name).copy_(torch.tensor(params[name]))
    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt, dropout_seed=123)  # dropout 0: the seed changes nothing
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=TOL, rtol=0)
    # gradients sum up to 15 products of O(10) terms: 1e-5 relative as well
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=TOL, rtol=TOL)
    for name in ("lora_a", "lora_b") + (("lora_s",) if trainable_scaling else ()):
        np.testing.assert_allclose(getattr(mod, name).grad.numpy(), np.asarray(gp[name]),
                                   atol=TOL, rtol=TOL, err_msg=name)


def test_lora_dropout_reuses_masks_under_remat():
    """With dropout on, a seed draws the same masks in the recompute of a
    checkpointed layer: gradients with remat equal those without."""
    spec = relora.LoraSpec(r=4, dropout=0.3)
    _, params = jax_lora_params(jax_relora.LoraSpec(r=4, dropout=0.0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 12)))
    grads = []
    for remat in (False, True):
        model = torch_model(spec, params)
        model.remat = remat
        model(tokens, dropout_seed=77).float().square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], rtol=0, atol=0)
    plain = torch_model(spec, params)
    assert not torch.equal(plain(tokens, dropout_seed=77), plain(tokens)), "dropout had no effect"


def test_training_forward_matches_jax_logits():
    """The port's training forward from a JAX LoRA init (nonzero B), scanned
    and unrolled trees, against the JAX model's logits at f32."""
    spec = jax_relora.LoraSpec(r=4, dropout=0.0)
    jmodel, params = jax_lora_params(spec)
    tokens = np.random.default_rng(2).integers(0, 128, (2, 16)).astype(np.int32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens)))
    unrolled = {k: v for k, v in params.items() if k != "layers"}
    for i in range(TINY["num_hidden_layers"]):
        unrolled[f"layers_{i}"] = jax.tree_util.tree_map(lambda a: a[i], params["layers"])
    for tree in (params, unrolled):
        model = torch_model(relora.LoraSpec(r=4, dropout=0.0), tree)
        got = model(torch.from_numpy(tokens).long()).detach().numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# --------------------------------------------------------------------------- merge


@pytest.mark.parametrize("base_dtype", [None, "bf16"], ids=["f32", "bf16"])
def test_merge_and_reinit_matches_jax(base_dtype):
    """Merged bases agree with the JAX merge (1e-6 at f32; one bf16 rounding
    for a bf16 base), B is zero and A is re-drawn inside the kaiming bound."""
    jspec = jax_relora.LoraSpec(r=4, alpha=8.0, dropout=0.0, base_dtype=base_dtype)
    _, params = jax_lora_params(jspec)
    merged = _np_tree(jax_relora.merge_and_reinit(
        jax.tree_util.tree_map(jnp.asarray, params), jax.random.PRNGKey(5), jspec))
    spec = relora.LoraSpec(r=4, alpha=8.0, dropout=0.0, base_dtype=base_dtype)
    model = torch_model(spec, params)
    old_a = {n: m.lora_a.detach().clone() for n, m in relora.lora_modules(model)}
    relora.merge_and_reinit(model, torch.Generator().manual_seed(5), spec)
    want = params_from_jax(merged)
    tol = dict(atol=1e-6, rtol=0) if base_dtype is None else dict(atol=1e-6, rtol=2**-8)
    n_modules = 0
    for name, module in relora.lora_modules(model):
        n_modules += 1
        assert module.weight.dtype == (torch.bfloat16 if base_dtype else torch.float32)
        torch.testing.assert_close(module.weight.float(), want[f"{name}.weight"], **tol)
        assert torch.count_nonzero(module.lora_b) == 0
        bound = 1.0 / np.sqrt(module.lora_a.shape[0])
        assert module.lora_a.abs().max() <= bound
        assert not torch.equal(module.lora_a, old_a[name])
    assert n_modules == 7 * TINY["num_hidden_layers"]


def test_merge_runs_full_f32_and_skips_lora_only():
    """lora_delta is the f64 product to f32 rounding; a lora_only module
    keeps its factors untouched, as in the reference."""
    spec = relora.LoraSpec(r=3, alpha=6.0, dropout=0.0)
    mod = LoRALinear(64, 48, lora=spec)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    want = (mod.lora_a.double() @ mod.lora_b.double() * spec.scale).t()
    got = relora.lora_delta(mod, spec)
    assert got.dtype == torch.float32
    assert ((got.double() - want).abs().max() / want.abs().max()).item() < 1e-6
    only = LoRALinear(8, 8, lora=relora.LoraSpec(r=2, lora_only=True))
    with torch.no_grad():
        only.lora_a.fill_(1.0)
        only.lora_b.fill_(1.0)
    relora.merge_and_reinit(only, g, only.lora)
    assert only.weight is None and bool((only.lora_a == 1).all()) and bool((only.lora_b == 1).all())


# --------------------------------------------------------------------------- schedules


@pytest.mark.parametrize("kind,kwargs", [
    ("linear", dict(warmup_steps=3)),
    ("cosine", dict(warmup_steps=3, cycle_length=8)),
    ("cosine", dict(warmup_steps=2, cycle_length=None)),
    ("cosine_restarts", dict(warmup_steps=2, cycle_length=6, restart_warmup_steps=2)),
    ("cosine_restarts", dict(warmup_steps=2, cycle_length=6, restart_warmup_steps=1, adjust_step=3)),
], ids=["linear", "cosine_cycles", "cosine", "restarts", "restarts_adjusted"])
def test_schedules_match_jax_at_every_step(kind, kwargs):
    common = dict(lr=1e-3, num_training_steps=24, min_lr_ratio=0.1, **kwargs)
    jf = jax_schedules.make_schedule(kind, **common)
    pf = schedules.make_schedule(kind, **common)
    steps = np.arange(26)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(steps)))
    got = np.array([pf(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_schedule_validation_matches_jax():
    for kw in (dict(num_training_steps=8, cycle_length=3), dict(num_training_steps=9, cycle_length=1)):
        common = dict(lr=1e-3, warmup_steps=2, restart_warmup_steps=1, **kw)
        with pytest.raises(ValueError):
            jax_schedules.make_schedule("cosine_restarts", **common)
        with pytest.raises(ValueError):
            schedules.make_schedule("cosine_restarts", **common)


# --------------------------------------------------------------------------- optimizer


def _param_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "q": {"lora_a": rng.standard_normal((6, 2)).astype(np.float32),
              "lora_b": rng.standard_normal((2, 5)).astype(np.float32)},
        "norm": {"scale": rng.standard_normal((5,)).astype(np.float32)},
    }


def _torch_params(tree):
    names = ["q.lora_a", "q.lora_b", "norm.scale"]
    leaves = [tree["q"]["lora_a"], tree["q"]["lora_b"], tree["norm"]["scale"]]
    module = torch.nn.Module()
    for name, leaf in zip(names, leaves):
        parent, _, attr = name.rpartition(".")
        if not hasattr(module, parent):
            module.add_module(parent, torch.nn.Module())
        getattr(module, parent).register_parameter(attr, torch.nn.Parameter(torch.tensor(leaf)))
    return module, names


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_steps_match_optax_chain(weight_decay):
    tree = _param_tree()
    lrs = [1e-2, 5e-3, 2e-3]
    tx = jax_optim.build_optimizer(schedule=lambda c: jnp.asarray(lrs)[c], weight_decay=weight_decay)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)
    module, names = _torch_params(tree)
    opt = optim.build_optimizer(module.parameters(), weight_decay=weight_decay)
    rng = np.random.default_rng(3)
    for lr in lrs:
        grads = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), tree)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        for name, p in module.named_parameters():
            parent, attr = name.split(".")
            p.grad = torch.tensor(grads[parent][attr])
        optim.set_lr(opt, lr)
        opt.step()
    for name, p in module.named_parameters():
        parent, attr = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[parent][attr]), atol=1e-6, rtol=0)


def _moment_pair(seed=4):
    """An optax Adam state and a torch AdamW holding the same moments."""
    tree = _param_tree(seed)
    tx = jax_optim.build_optimizer(schedule=lambda c: 1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)
    grads = jax.tree_util.tree_map(lambda p: p * 0.5 + 0.1, params)
    for _ in range(2):
        _, state = tx.update(grads, state, params)
    module, _ = _torch_params(tree)
    opt = optim.build_optimizer(module.parameters())
    for p in module.parameters():
        p.grad = torch.ones_like(p)
    optim.set_lr(opt, 0.0)
    opt.step()
    adam = state[0]
    for name, p in module.named_parameters():
        parent, attr = name.split(".")
        opt.state[p]["exp_avg"].copy_(torch.tensor(np.asarray(adam.mu[parent][attr])))
        opt.state[p]["exp_avg_sq"].copy_(torch.tensor(np.asarray(adam.nu[parent][attr])))
    return state, module, opt


@pytest.mark.parametrize("mode", ["zero", "magnitude"])
def test_optimizer_reset_matches_jax_exactly(mode):
    """zero and magnitude resets prune exactly the JAX entries, LoRA moments
    only, and keep every step count."""
    state, module, opt = _moment_pair()
    ratio = 0.4 if mode == "magnitude" else 1.0
    reset = jax_optim.reset_optimizer_state(state, mode=mode, ratio=ratio)
    steps = {n: opt.state[p]["step"].clone() for n, p in module.named_parameters()}
    optim.reset_optimizer_state(opt, module, mode=mode, ratio=ratio)
    adam = reset[0]
    for name, p in module.named_parameters():
        parent, attr = name.split(".")
        np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), np.asarray(adam.mu[parent][attr]))
        np.testing.assert_array_equal(opt.state[p]["exp_avg_sq"].numpy(), np.asarray(adam.nu[parent][attr]))
        assert torch.equal(opt.state[p]["step"], steps[name])
    np.testing.assert_allclose(optim.zeroed_fraction(opt), float(jax_optim.zeroed_fraction(reset)), rtol=1e-6)


def test_random_reset_zeroes_the_ratio():
    """Random pruning draws other bits than jax.random: check the fraction
    of LoRA moment entries it zeroes."""
    module = torch.nn.Module()
    module.lora_a = torch.nn.Parameter(torch.randn(200, 100))
    opt = optim.build_optimizer(module.parameters())
    module.lora_a.grad = torch.randn(200, 100)
    optim.set_lr(opt, 0.0)
    opt.step()
    optim.reset_optimizer_state(opt, module, mode="random", ratio=0.3,
                                generator=torch.Generator().manual_seed(0))
    frac = float((opt.state[module.lora_a]["exp_avg"] == 0).float().mean())
    assert abs(frac - 0.3) < 0.01
    assert optim.zeroed_fraction(opt) == pytest.approx(0.3, abs=0.01)


def test_nan_gate_rolls_back_like_jax():
    """An update whose loss is NaN leaves parameters, moments and the
    schedule count unchanged in both packages; the next update agrees."""
    jspec = jax_relora.LoraSpec(r=4, dropout=0.0)
    jmodel, params = jax_lora_params(jspec, b_scale=0.0)
    mask = jax_relora.trainable_param_mask(params)
    sched = jax_schedules.make_schedule("linear", lr=1e-2, num_training_steps=10, warmup_steps=2)
    tx = jax_optim.build_optimizer(schedule=sched)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState.create(jparams, tx.init(partition(jparams, mask)[0]))
    jstep = jax.jit(jax_make_train_step(jmodel, tx, mask, clip_grad_norm=1.0, schedule=sched))

    model = torch_model(relora.LoraSpec(r=4, dropout=0.0), params)
    opt = optim.build_optimizer(p for p in model.parameters() if p.requires_grad)
    state = TrainState()
    step = make_train_step(model, opt, clip_grad_norm=1.0,
                           schedule=schedules.make_schedule("linear", lr=1e-2, num_training_steps=10,
                                                            warmup_steps=2))
    rng = np.random.default_rng(7)
    batches = rng.integers(0, 128, (3, 2, 2, 12)).astype(np.int32)
    key = jax.random.PRNGKey(0)

    jstate, jm = jstep(jstate, jnp.asarray(batches[0]), key)
    m = step(state, torch.from_numpy(batches[0]).long())
    assert m["loss"] == pytest.approx(float(jm["loss"]), abs=1e-5)

    # poison the embedding of one token of the batch: its loss is NaN
    bad = int(batches[1, 0, 0, 0])
    jemb = np.asarray(jstate.params["embed_tokens"]["embedding"]).copy()
    jemb[bad] = np.nan
    jstate = jstate.replace(params={**jstate.params, "embed_tokens": {"embedding": jnp.asarray(jemb)}})
    saved_row = model.embed_tokens.weight[bad].detach().clone()
    with torch.no_grad():
        model.embed_tokens.weight[bad] = float("nan")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = {n: opt.state[p]["exp_avg"].clone() for n, p in model.named_parameters() if p in opt.state}
    steps = {n: opt.state[p]["step"].clone() for n, p in model.named_parameters() if p in opt.state}
    jstate, jm = jstep(jstate, jnp.asarray(batches[1]), key)
    m = step(state, torch.from_numpy(batches[1]).long())
    assert m["skipped"] == 1.0 and float(jm["skipped"]) == 1.0
    assert m["n_skipped"] == int(jm["n_skipped"]) == 1
    for n, p in model.named_parameters():
        assert torch.equal(p.detach().nan_to_num(), before[n].nan_to_num()), n
        if n in moments:
            assert torch.equal(opt.state[p]["exp_avg"], moments[n]), n
            assert torch.equal(opt.state[p]["step"], steps[n]), n

    # restore the row on both sides; the next update takes the next rate
    jemb[bad] = saved_row.numpy()
    jstate = jstate.replace(params={**jstate.params, "embed_tokens": {"embedding": jnp.asarray(jemb)}})
    with torch.no_grad():
        model.embed_tokens.weight[bad] = saved_row
    jstate, jm = jstep(jstate, jnp.asarray(batches[2]), key)
    m = step(state, torch.from_numpy(batches[2]).long())
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert m["loss"] == pytest.approx(float(jm["loss"]), abs=1e-5)
    assert m["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=1e-4)


# --------------------------------------------------------------------------- data


class _Stub:
    n_batch_shards = 1
    grad_accum = 2
    update_step = 0


def _write_corpus(prefix, seed, n_docs=60):
    rng = np.random.default_rng(seed)
    with MemmapTokenWriter(str(prefix), dtype=np.uint16) as w:
        for _ in range(n_docs):
            w.add_document(rng.integers(0, 1000, rng.integers(5, 90)))


@pytest.mark.parametrize("layout", ["split", "blend"])
def test_megatron_batches_equal_jax(tmp_path, layout):
    """Train and eval batches from a tiny written corpus: the port's
    iterators (NumPy packers) equal the JAX package's (C++ helper)."""
    src = tmp_path / "src"
    src.mkdir()
    _write_corpus(src / "a", 0)
    _write_corpus(src / "b", 1)
    common = dict(batch_size=2, total_batch_size=4, max_length=16, num_training_steps=6,
                  final_eval_tokens=-1, use_peft=False)
    batches = {}
    for side in ("jax", "torch"):
        root = tmp_path / side
        shutil.copytree(src, root)  # each side builds its own index caches
        if layout == "split":
            data = {"data_path": str(root / "a"), "split": "80,15,5", "seq_length": 16, "seed": 3}
        else:
            data = {"train_data_paths": [str(root / "a"), str(root / "b")],
                    "valid_data_paths": [str(root / "b")], "train_data_weights": [0.7, 0.3],
                    "seq_length": 16, "seed": 3}
        path = root / "data.json"
        path.write_text(json.dumps(data))
        if side == "jax":
            cfg = JaxTrainingConfig(megatron_dataset_config=str(path), **common).finalize()
            train, evals = jax_iterators(cfg, _Stub())
        else:
            cfg = TrainingConfig(megatron_dataset_config=str(path), **common).finalize()
            train, evals = build_train_valid_test_iterators(cfg, _Stub())
        batches[side] = (list(train()), list(evals()))
    for got, want in zip(batches["torch"], batches["jax"]):
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_data_config_reads_json_without_pyyaml(tmp_path, monkeypatch):
    """Where PyYAML is missing a JSON-form data config still loads (JSON is
    valid YAML, so the JAX package reads the same file); any other YAML
    raises a clear error."""
    from relora_tpu_torch.data.megatron import MegatronDataConfig

    monkeypatch.setitem(sys.modules, "yaml", None)
    good = tmp_path / "data.json"
    good.write_text(json.dumps({"data_path": "corpus", "split": "9,1,0", "seq_length": 64}))
    cfg = MegatronDataConfig.from_yaml(str(good))
    assert (cfg.data_path, cfg.split, cfg.seq_length) == ("corpus", "9,1,0", 64)
    bad = tmp_path / "data.yaml"
    bad.write_text("data_path: corpus\nseq_length: 64\n")
    with pytest.raises(ValueError, match="JSON-form"):
        MegatronDataConfig.from_yaml(str(bad))
