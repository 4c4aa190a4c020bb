"""The chunked loss and the remat policies of the port against the JAX
package's, on the CPU at f32.

``chunked_softmax_ce`` (``loss_impl="chunked"``) is held to ``relora_tpu``'s
on the same hidden states, head and targets (a vocab the chunk does not
divide, ``-100`` targets): value and the gradients in hidden and head within
1e-5 of ``max(1, max|JAX value|)``.  Its peak is held too: no tensor of the
forward or the backward is as large as the ``(T, V)`` logits.  A chunked
train step and eval are within 1e-5 of the dense ones, and the chunked step
within 1e-4 of the JAX package's chunked step.  Each remat policy (``full``,
``dots``, ``dots_narrow``, ``dots_all``) gives gradients bit-equal to no
remat (LoRA dropout on: the seeded masks recompute alike) and a loss and
gradients within 1e-5 of the JAX model under the same policy; a dispatch-
mode counter shows which matmuls each policy recomputes in the backward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint as torch_checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.core import optim as jax_optim
from relora_tpu.core import relora as jax_relora
from relora_tpu.core.partition import combine, partition
from relora_tpu.models.llama import LlamaForCausalLM as JaxLlama
from relora_tpu.models.params_util import init_params as jax_init_params
from relora_tpu.models.pythia import GPTNeoXForCausalLM as JaxNeoX
from relora_tpu.train.losses import causal_lm_loss as jax_causal_lm_loss
from relora_tpu.train.losses import chunked_softmax_ce as jax_chunked_ce
from relora_tpu.train.state import TrainState as JaxTrainState
from relora_tpu.train.step import make_train_step as jax_make_train_step
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.core import optim, relora
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.models.family import causal_lm_class
from relora_tpu_torch.models.params_util import REMAT_POLICIES, init_params, remat_context_fn
from relora_tpu_torch.obs.mfu import step_flops
from relora_tpu_torch.train.losses import causal_lm_loss, chunked_softmax_ce, shifted_targets
from relora_tpu_torch.train.step import TrainState, eval_step, lm_loss, make_train_step
from tests.test_torch_train import _run_cli

pytestmark = pytest.mark.torch_port

TOL = 1e-5
LOSS_TOL = 1e-4
TINY = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, max_sequence_length=32)
NEOX_TINY = dict(TINY, family="neox", rotary_pct=0.5, use_parallel_residual=True)
CHUNK = 24  # 100 = 4 x 24 + 4: the last chunk is ragged


def _close(got, want, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)


# ------------------------------------------------------------ the chunked loss


@pytest.mark.parametrize("chunk", [CHUNK, 100, 128], ids=["ragged", "whole", "wider"])
def test_chunked_ce_matches_jax_value_and_gradients(chunk):
    """(B, S, E) hidden, (V, E) head (JAX's (E, V) kernel transposed),
    targets with -100 entries: the mean loss, n_tokens and the gradients in
    hidden and head equal JAX's chunked_softmax_ce."""
    rng = np.random.default_rng(0)
    B, S, E, V = 2, 12, 16, 100
    h = rng.standard_normal((B, S, E)).astype(np.float32)
    kernel = (rng.standard_normal((E, V)) * 0.3).astype(np.float32)
    tgt = rng.integers(0, V, (B, S)).astype(np.int32)
    tgt[0, :3] = -100
    tgt[1, -1] = -100
    (loss, n), vjp = jax.vjp(lambda hh, kk: jax_chunked_ce(hh, kk, jnp.asarray(tgt), chunk),
                             jnp.asarray(h), jnp.asarray(kernel))
    gh, gk = vjp((jnp.ones(()), jnp.zeros(())))
    ht = torch.from_numpy(h).requires_grad_()
    head = torch.from_numpy(kernel.T.copy()).requires_grad_()
    got, nt = chunked_softmax_ce(ht, head, torch.from_numpy(tgt).long(), chunk)
    got.backward()
    _close(got, loss, "loss")
    assert float(nt) == float(n) == B * S - 4
    _close(ht.grad, gh, "d_hidden")
    _close(head.grad, np.asarray(gk).T, "d_head")


def test_chunked_ce_equals_dense_and_never_holds_the_logits():
    """Against the dense loss over the full logits (f32): value and
    gradients within 1e-5; every tensor the chunked forward and backward
    make stays below the (T, V) logits' size (the peak is O(T x chunk))."""
    rng = np.random.default_rng(1)
    B, S, E, V, chunk = 2, 64, 32, 300, 64
    h = torch.from_numpy(rng.standard_normal((B, S, E)).astype(np.float32)).requires_grad_()
    head = torch.from_numpy((rng.standard_normal((V, E)) * 0.2).astype(np.float32)).requires_grad_()
    ids = torch.from_numpy(rng.integers(0, V, (B, S)))
    dense, _ = causal_lm_loss(h @ head.t(), ids)
    gd = torch.autograd.grad(dense, (h, head))

    class Largest(TorchDispatchMode):
        largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.shape != head.shape:
                    Largest.largest = max(Largest.largest, t.numel())
            return out

    with Largest():
        loss, n = chunked_softmax_ce(h, head, shifted_targets(ids), chunk)
        gc = torch.autograd.grad(loss, (h, head))
    assert abs(loss.item() - dense.item()) <= TOL and float(n) == B * (S - 1)
    for got, want, name in zip(gc, gd, ("d_hidden", "d_head")):
        _close(got, want.numpy(), name)
    assert Largest.largest <= B * S * chunk < B * S * V


# ------------------------------------------------------- the chunked train step


def _jax_model(cfg, **kw):
    family = JaxNeoX if cfg.get("family") == "neox" else JaxLlama
    return family(JaxModelConfig(**cfg), lora=jax_relora.LoraSpec(r=4, dropout=0.0),
                  dtype=jnp.float32, scan_layers=True, attention_impl="naive", **kw)


def _port_model(cfg, params, **kw):
    model = causal_lm_class(ModelConfig(**cfg))(
        ModelConfig(**cfg), lora=relora.LoraSpec(r=4, dropout=0.0), attention_arm="naive", **kw)
    model.load_state_dict(params_from_jax(params))
    relora.set_trainable(model)
    return model


def _with_b(params, seed=3):
    """The JAX tree with every lora_b drawn nonzero, so the factors matter."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else (rng.standard_normal(np.shape(v)) * 0.1).astype(np.float32) if k == "lora_b"
                else np.asarray(v) for k, v in node.items()}

    return walk(params)


def _batch(seed=0, ga=2, micro=2, seq=16, vocab=100):
    return np.random.default_rng(seed).integers(0, vocab, (ga, micro, seq)).astype(np.int32)


@pytest.mark.parametrize("family", ["llama", "neox"])
def test_chunked_train_step_and_eval_match_dense_and_jax(family):
    """One update: the chunked step's loss and grad norm within 1e-5 of the
    dense step's, and every gradient of a microbatch's loss within 1e-5;
    within 1e-4 of the JAX chunked step; eval chunked equals eval dense."""
    cfg = NEOX_TINY if family == "neox" else TINY
    model = _jax_model(cfg)
    params = _with_b(jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)))
    batch = _batch()
    mask = jax_relora.trainable_param_mask(params)
    tx = jax_optim.build_optimizer(schedule=lambda s: 1e-3)
    state = JaxTrainState.create(params, tx.init(partition(params, mask)[0]))
    step = jax.jit(jax_make_train_step(model, tx, mask, clip_grad_norm=1.0, loss_impl="chunked",
                                       vocab_chunk=CHUNK))
    _, jm = step(state, jnp.asarray(batch), jax.random.PRNGKey(1))

    out, models = {}, {}
    for impl in ("dense", "chunked"):
        pm = _port_model(cfg, params)
        opt = optim.build_optimizer(p for p in pm.parameters() if p.requires_grad)
        train_step = make_train_step(pm, opt, clip_grad_norm=1.0, schedule=lambda s: 1e-3,
                                     loss_impl=impl, vocab_chunk=CHUNK)
        out[impl] = train_step(TrainState(), torch.from_numpy(batch).long())
        models[impl] = pm
    for key in ("loss", "grad_norm"):
        assert abs(out["chunked"][key] - out["dense"][key]) <= TOL * max(1.0, abs(out["dense"][key])), key
        assert abs(out["chunked"][key] - float(jm[key])) <= LOSS_TOL, key
    tokens = torch.from_numpy(batch[0]).long()
    grads = {}
    for impl in ("dense", "chunked"):
        pm = _port_model(cfg, params)
        lm_loss(pm, tokens, None, impl, CHUNK)[0].backward()
        grads[impl] = {n: p.grad for n, p in pm.named_parameters() if p.requires_grad}
    for name, g in grads["chunked"].items():
        _close(g, grads["dense"][name].numpy(), name)
    (sd, nd), (sc, nc) = (eval_step(models["dense"], tokens),
                          eval_step(models["dense"], tokens, "chunked", CHUNK))
    assert float(nd) == float(nc) and abs(float(sd) - float(sc)) <= TOL * float(nd)


# ---------------------------------------------------------------- remat policies


class MatmulCount(TorchDispatchMode):
    """Counts mm/addmm (no batch dims) and bmm calls."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm"):
            self.counts["mm"] += 1
        elif name in ("bmm", "baddbmm"):
            self.counts["bmm"] += 1
        return func(*args, **(kwargs or {}))


def _backward_counts(model, ids, seed):
    with torch_checkpoint.set_checkpoint_early_stop(False):
        loss, _ = causal_lm_loss(model(ids, dropout_seed=seed), ids)
        with MatmulCount() as mode:
            loss.backward()
    return loss, mode.counts


@pytest.mark.parametrize("family", ["llama", "neox"])
def test_remat_policies_recompute_what_they_name(family):
    """Under LoRA dropout: every policy's gradients bit-equal to no remat;
    the backward's matmuls less those of no remat are what the policy
    recomputes: full every projection and factor product (3 a projection)
    and attention's two batched products, dots only those two, dots_narrow
    also the base and B products wider than hidden (gate/up; fused QKV and
    h_to_4h), dots_all nothing."""
    cfg = NEOX_TINY if family == "neox" else TINY
    config = ModelConfig(**cfg)
    ids = torch.from_numpy(_batch(seq=16, vocab=100)[0]).long()
    counts, grads = {}, {}
    for policy in (None,) + REMAT_POLICIES:
        model = causal_lm_class(config)(
            config, lora=relora.LoraSpec(r=4, dropout=0.1), attention_arm="naive",
            remat=policy is not None, remat_policy=policy or "full")
        init_params(model, torch.Generator().manual_seed(0))
        relora.set_trainable(model)
        _, counts[policy] = _backward_counts(model, ids, seed=7)
        grads[policy] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    for policy in REMAT_POLICIES:
        assert grads[policy].keys() == grads[None].keys()
        for name, g in grads[policy].items():
            assert torch.equal(g, grads[None][name]), (policy, name)
    layers = cfg["num_hidden_layers"]
    projections = 4 if family == "neox" else 7
    wide = 2 if family == "neox" else 2  # fused QKV, h_to_4h | gate, up
    recomputed = {p: {k: counts[p][k] - counts[None][k] for k in ("mm", "bmm")} for p in REMAT_POLICIES}
    assert recomputed == {
        "full": {"mm": 3 * projections * layers, "bmm": 2 * layers},
        "dots": {"mm": 0, "bmm": 2 * layers},
        "dots_narrow": {"mm": 2 * wide * layers, "bmm": 2 * layers},
        "dots_all": {"mm": 0, "bmm": 0},
    }


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_policy_loss_and_grads_match_jax(policy):
    """The port under a policy against the JAX model under the same policy
    (remat=True, scan_layers): loss and every trainable gradient within
    1e-5."""
    model = _jax_model(TINY, remat=True, remat_policy=policy)
    params = _with_b(jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)))
    ids = _batch(seq=16)[0]
    mask = jax_relora.trainable_param_mask(params)
    trainable, frozen = partition(params, mask)

    def loss_fn(tr):
        logits = model.apply({"params": combine(tr, frozen)}, jnp.asarray(ids))
        return jax_causal_lm_loss(logits, jnp.asarray(ids))[0]

    loss, jg = jax.value_and_grad(loss_fn)(trainable)
    # frozen leaves (None in the gradient tree) filled from the params
    want = params_from_jax(combine(jax.tree_util.tree_map(np.asarray, jg), params))
    pm = _port_model(TINY, params, remat=True, remat_policy=policy)
    got, _ = causal_lm_loss(pm(torch.from_numpy(ids).long()), torch.from_numpy(ids).long())
    got.backward()
    assert abs(got.item() - float(loss)) <= TOL
    for name, p in pm.named_parameters():
        if p.requires_grad:
            _close(p.grad, want[name].numpy(), name)


def test_remat_policy_names_are_checked():
    assert remat_context_fn("full") is torch_checkpoint.noop_context_fn
    with pytest.raises(ValueError, match="Unknown remat policy"):
        remat_context_fn("dots_some")
    with pytest.raises(ValueError, match="max_save_width"):
        remat_context_fn("dots_narrow")


@pytest.mark.parametrize("remat_policy,loss_impl", [
    ("dots", "dense"), ("dots_narrow", "dense"), ("dots_all", "dense"), ("full", "chunked"),
])
def test_step_flops_counts_what_the_policy_and_loss_recompute(remat_policy, loss_impl):
    """step_flops under a remat policy or the chunked loss against
    FlopCounterMode over one plain-arm update (early stop off, so every
    recomputed product runs)."""
    config = ModelConfig(**TINY)
    model = causal_lm_class(config)(config, lora=relora.LoraSpec(r=4, dropout=0.0),
                                    attention_arm="naive", remat=True, remat_policy=remat_policy)
    init_params(model, torch.Generator().manual_seed(0))
    relora.set_trainable(model)
    opt = optim.build_optimizer(p for p in model.parameters() if p.requires_grad)
    step = make_train_step(model, opt, loss_impl=loss_impl, vocab_chunk=CHUNK)
    batch = torch.from_numpy(_batch()).long()
    with torch_checkpoint.set_checkpoint_early_stop(False), FlopCounterMode(display=False) as fc:
        step(TrainState(), batch)
    want = step_flops(config, microbatch=2, seq=16, grad_accum=2, lora_r=4, remat=True,
                      remat_policy=remat_policy, loss_impl=loss_impl, attention="naive")
    assert fc.get_total_flops() == want


def test_cli_trains_with_the_three_levers_on_cpu_without_jax(tmp_path):
    """``main --quantize nf4 --warmed_up_model DIR --loss_impl chunked
    --vocab_chunk 48 --remat true --remat_policy dots_narrow`` runs in a
    process where importing jax, flax or relora_tpu fails: 6 updates, a
    merge and a reset, a finite chunked eval."""
    from relora_tpu_torch.models.llama import LlamaForCausalLM
    from tests.test_torch_train import TINY as TRAIN_TINY

    dense = LlamaForCausalLM(ModelConfig(**TRAIN_TINY))
    init_params(dense, torch.Generator().manual_seed(7))
    (tmp_path / "warm").mkdir()
    torch.save({f"model.{k}" if k != "lm_head.weight" else k: v for k, v in dense.state_dict().items()},
               tmp_path / "warm" / "pytorch_model.bin")
    result, fused_calls = _run_cli(tmp_path, [
        "--quantize", "nf4", "--warmed_up_model", str(tmp_path / "warm"), "--lora_fused", "true",
        "--lora_dropout", "0", "--loss_impl", "chunked", "--vocab_chunk", "48",
        "--remat", "true", "--remat_policy", "dots_narrow"])
    assert fused_calls == 0  # nf4 never dispatches
    assert dataclasses.asdict(relora.LoraSpec(r=4, quantize="nf4"))["quantize"] == "nf4"
