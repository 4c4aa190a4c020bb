"""The port's fused LoRA composite against the JAX package's fused kernels.

On the CPU the three wrappers (forward, dx, dA/dB) run their plain twins;
the CUDA kernels run only on the card, where ``chip_smoke.py`` holds them to
these twins.  Here the twins, ``FusedLoRAMatmul`` and its gradients, the
``lora_dispatch`` arms, ``LoRALinear(fused=True)`` and ``Trainer.fit`` with
``lora_fused="true"`` are held to ``relora_tpu``'s Pallas kernels run in
interpret mode (and its ``lora_matmul`` arms), on the same numpy inputs, at
f32.  Tolerance: 1e-5 of ``max(1, max|JAX value|)`` for every output and
gradient, since both sides compute in f32 and sum in another order, so the
error scales with the largest partial sums.  Per-update training loss: 1e-4,
as in ``tests/test_torch_train.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta as flax_meta

import relora_tpu.ops.pallas_lora_matmul as jax_plm
from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.core import optim as jax_optim
from relora_tpu.core import relora as jax_relora
from relora_tpu.core.partition import partition
from relora_tpu.core.schedules import make_schedule as jax_make_schedule
from relora_tpu.models.llama import LlamaForCausalLM as JaxLlama
from relora_tpu.models.lora import LoRALinear as JaxLoRALinear
from relora_tpu.models.params_util import init_params as jax_init_params
from relora_tpu.ops.lora_dispatch import lora_matmul as jax_lora_matmul
from relora_tpu.train.state import TrainState as JaxTrainState
from relora_tpu.train.step import make_train_step as jax_make_train_step
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.config.training import TrainingConfig
from relora_tpu_torch.core import relora
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.models.llama import LlamaForCausalLM
from relora_tpu_torch.models.lora import LoRALinear
from relora_tpu_torch.ops import lora_matmul as LM
from relora_tpu_torch.ops.lora_dispatch import lora_matmul
from relora_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.torch_port

TOL = 1e-5
LOSS_TOL = 1e-4
# widths that tile for the JAX fused kernel (N % 128 == 0, M = 4 x 16 = 64),
# so the JAX side really runs the interpreted kernels
TINY = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=2, max_sequence_length=32)
RECIPE = dict(batch_size=4, total_batch_size=8, max_length=16, lr=5e-3, scheduler="cosine_restarts",
              warmup_steps=2, restart_warmup_steps=1, num_training_steps=6, cycle_length=3, relora=3,
              use_peft=True, lora_r=4, lora_dropout=0.0, eval_every=1000, seed=0)


def _operands(M, K, N, r, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    a = (rng.standard_normal((K, r)) / np.sqrt(K)).astype(np.float32)
    b = (rng.standard_normal((r, N)) * 0.5).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)
    return x, w, a, b, g


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _close(got, want, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("r", [8, 128, 320])
def test_forward_twin_matches_jax_interpret_kernel(r):
    """y and z of the forward twin against the JAX forward kernel (interpret)."""
    x, w, a, b, _ = _operands(64, 256, 128, r, seed=r)
    y, z = jax_plm._forward(64, 128, True, jnp.float32, jnp.asarray(x), (jnp.asarray(w),),
                            jnp.asarray(a), jnp.asarray(b), jnp.full((1, 1), 0.5, jnp.float32))
    got_y, got_z = LM.fused_lora_forward(*_t(x, w, a, b), 0.5)
    _close(got_y, y, "y")
    _close(got_z, z, "z")
    assert got_y.dtype == torch.float32 and got_z.dtype == torch.float32


def _jax_vjp(x, w, a, b, g, s, **kw):
    """y and the gradients of x, A, B (and s when it is an array) of the JAX
    fused function with a stop_gradient base."""
    args = [jnp.asarray(v) for v in (x, a, b)]
    tensor_s = not isinstance(s, float)
    if tensor_s:
        args.append(jnp.asarray(s))

    def fn(xx, aa, bb, *ss):
        scale = ss[0] if ss else s
        if kw:
            return jax_lora_matmul(xx, jax.lax.stop_gradient(jnp.asarray(w)), aa, bb, scale, **kw)
        return jax_plm.fused_lora_matmul(xx, jax.lax.stop_gradient(jnp.asarray(w)), aa, bb, scale,
                                         interpret=True)

    y, vjp = jax.vjp(fn, *args)
    return [np.asarray(v) for v in (y, *vjp(jnp.asarray(g)))]


def _torch_grads(x, w, a, b, g, s, fn=LM.fused_lora_matmul):
    leaves = [t.requires_grad_() for t in _t(x, a, b)]
    st = torch.tensor(s).requires_grad_() if not isinstance(s, float) else s
    wt = _t(w)[0]
    y = fn(leaves[0], wt, leaves[1], leaves[2], st)
    y.backward(_t(g)[0])
    out = [y] + [t.grad for t in leaves] + ([st.grad] if not isinstance(s, float) else [])
    assert wt.grad is None, "the frozen base gets no gradient"
    return out


@pytest.mark.parametrize("scale", [0.5, np.array([0.7], np.float32)], ids=["static", "tensor_s"])
def test_gradients_match_jax_grad_of_fused_kernel(scale):
    """dx, dA, dB (and ds for a tensor scale) through FusedLoRAMatmul's
    twins against jax.vjp of the fused kernel with stop_gradient(W)."""
    x, w, a, b, g = _operands(64, 256, 128, 8, seed=3)
    want = _jax_vjp(x, w, a, b, g, scale)
    got = _torch_grads(x, w, a, b, g, scale)
    for name, gt, wt in zip(("y", "dx", "dA", "dB", "ds"), got, want):
        _close(gt, wt, name)


@pytest.mark.parametrize("scale", [0.5, np.array([0.7], np.float32)], ids=["static", "tensor_s"])
def test_rank_past_256_matches_jax_fused_arm(scale):
    """r = 320, past the 256 the port's kernels once refused: y and the
    gradients through lora_matmul(arm="fused") against the JAX dispatcher's
    fused arm, whose kernels take any rank (interpret)."""
    x, w, a, b, g = _operands(64, 256, 128, 320, seed=5)
    want = _jax_vjp(x, w, a, b, g, scale, arm="fused", interpret=True)
    got = _torch_grads(x, w, a, b, g, scale,
                       fn=lambda xx, ww, aa, bb, ss: lora_matmul(xx, ww, aa, bb, ss, arm="fused"))
    for name, gt, wt in zip(("y", "dx", "dA", "dB", "ds"), got, want):
        _close(gt, wt, name)


def test_ragged_shape_matches_jax_fused_arm():
    """M=10, N=100 do not tile for JAX, whose fused arm falls back to ordered;
    the port's fused path takes them as they are."""
    x, w, a, b, g = _operands(10, 64, 100, 4, seed=5)
    want = _jax_vjp(x, w, a, b, g, 0.25, arm="fused", interpret=True)
    got = _torch_grads(x, w, a, b, g, 0.25)
    for name, gt, wt in zip(("y", "dx", "dA", "dB"), got, want):
        _close(gt, wt, name)


def test_twins_individually_match_autograd():
    """Each twin on its own against autograd of the plain composite, with u
    handed from dx to dA/dB and recomputed without it."""
    x, w, a, b, g = _t(*_operands(40, 48, 24, 6, seed=7))
    leaves = [t.clone().requires_grad_() for t in (x, a, b)]
    (leaves[0] @ w + (leaves[0] @ leaves[1]) @ leaves[2] * 0.3).backward(g)
    dx, u = LM.fused_lora_bwd_dx(g, w, a, b, 0.3)
    for given_u in (u, None):
        da, db = LM.fused_lora_bwd_dab(g, x, x @ a, b, 0.3, given_u)
        _close(da, leaves[1].grad.numpy(), "dA")
        _close(db, leaves[2].grad.numpy(), "dB")
    _close(dx, leaves[0].grad.numpy(), "dx")
    _close(u, (g @ b.t()).numpy(), "u")


@pytest.mark.parametrize("arm", ["fused", "ordered", "merged"])
def test_dispatch_arms_match_jax(arm):
    """lora_matmul per arm against the JAX dispatcher's same arm, leading
    batch dims kept."""
    x, w, a, b, _ = _operands(64, 256, 128, 8, seed=11)
    x3 = x.reshape(4, 16, 256)
    want = jax_lora_matmul(*map(jnp.asarray, (x3, w, a, b)), 0.25, arm=arm, interpret=True)
    got = lora_matmul(*_t(x3, w, a, b), 0.25, arm=arm)
    _close(got, want, arm)


def test_dispatch_auto_and_unknown_arms_raise():
    x, w, a, b, _ = _t(*_operands(8, 16, 8, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lora_matmul(x, w, a, b, 1.0, arm="auto")
    with pytest.raises(ValueError, match="unknown arm"):
        lora_matmul(x, w, a, b, 1.0, arm="tiled")
    with pytest.raises(ValueError, match="contraction mismatch"):
        LM.fused_lora_matmul(x, w[:8], a, b)
    with pytest.raises(ValueError, match="factor shapes"):
        LM.fused_lora_matmul(x, w, torch.zeros(16, 300), torch.zeros(299, 8))
    # any rank is taken: zero factors of rank 300 leave the base product
    torch.testing.assert_close(LM.fused_lora_matmul(x, w, torch.zeros(16, 300), torch.zeros(300, 8)),
                               x @ w, rtol=0, atol=0)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("trainable_scaling", [False, True], ids=["static", "tanh_s"])
def test_lora_linear_fused_matches_jax(trainable_scaling, monkeypatch):
    """y and the gradients of x, A, B (and s) of LoRALinear(fused=True)
    against the JAX LoRALinear(LoraSpec(fused=True)), whose kernel grad is a
    symbolic zero; the port's base gets none."""
    spec = dict(r=8, alpha=16.0, dropout=0.0, trainable_scaling=trainable_scaling, fused=True)
    jmod = JaxLoRALinear(features=128, lora=jax_relora.LoraSpec(**spec), dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, flax_meta.unbox(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    params["lora_b"] = rng.standard_normal(params["lora_b"].shape).astype(np.float32)
    if trainable_scaling:
        params["lora_s"] = np.array([0.7], np.float32)
    cot = rng.standard_normal((4, 16, 128)).astype(np.float32)
    y, vjp = jax.vjp(lambda p, xx: jmod.apply({"params": p}, xx),
                     jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))
    assert not np.asarray(gp["kernel"]).any()

    mod = LoRALinear(64, 128, lora=relora.LoraSpec(**spec), dtype=torch.float32)
    names = ("lora_a", "lora_b") + (("lora_s",) if trainable_scaling else ())
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(params["kernel"].T.copy()))
        for name in names:
            getattr(mod, name).copy_(torch.tensor(params[name]))
    calls = _count_calls(monkeypatch, LM, "fused_lora_forward_plain")
    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt, dropout_seed=123)  # dropout 0: the fused path despite the seed
    out.backward(torch.from_numpy(cot))
    assert calls, "LoRALinear(fused=True) took the fused path"
    _close(out, y, "y")
    _close(xt.grad, gx, "dx")
    for name in names:
        _close(getattr(mod, name).grad, gp[name], name)
    assert mod.weight.grad is None


def test_dropout_keeps_the_historical_path_and_eval_takes_the_kernels(monkeypatch):
    """With a seed and dropout > 0 the fused layer equals the unfused one
    bit for bit and never calls the fused twin; without a seed (eval) it
    runs the fused path."""
    fused = LoRALinear(32, 48, lora=relora.LoraSpec(r=4, dropout=0.3, fused=True))
    plain = LoRALinear(32, 48, lora=relora.LoraSpec(r=4, dropout=0.3))
    with torch.no_grad():
        for p in fused.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 6, 32, generator=torch.Generator().manual_seed(0))
    calls = _count_calls(monkeypatch, LM, "fused_lora_forward_plain")
    assert torch.equal(fused(x, dropout_seed=5), plain(x, dropout_seed=5))
    assert not calls
    torch.testing.assert_close(fused(x), plain(x), rtol=0, atol=TOL)
    assert len(calls) == 1


def _jax_fused_params(seed=0):
    spec = jax_relora.LoraSpec(r=4, dropout=0.0, fused=True)
    model = JaxLlama(JaxModelConfig(**TINY), lora=spec, dtype=jnp.float32, scan_layers=True,
                     attention_impl="naive")
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(model, jax.random.PRNGKey(seed), jnp.zeros((1, 16), jnp.int32)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if str(getattr(path[-1], "key", path[-1])) == "lora_b":
            return (rng.standard_normal(leaf.shape) * 0.05).astype(leaf.dtype)
        return leaf

    return model, jax.tree_util.tree_map_with_path(fill, params)


def _torch_fused_model(params, remat=False):
    model = LlamaForCausalLM(ModelConfig(**TINY), dtype=torch.float32, attention_arm="naive",
                             lora=relora.LoraSpec(r=4, dropout=0.0, fused=True),
                             param_dtype=torch.float32, remat=remat)
    model.load_state_dict(params_from_jax(params))
    relora.set_trainable(model)
    return model


def test_fused_model_from_params_from_jax_matches_jax(monkeypatch):
    """A fused llama loaded through params_from_jax: logits and the LoRA
    gradients of one loss against the JAX fused model."""
    jmodel, params = _jax_fused_params()
    tokens = np.random.default_rng(2).integers(0, 128, (4, 16)).astype(np.int32)

    def loss(p):
        return jnp.mean(jnp.square(jmodel.apply({"params": p}, jnp.asarray(tokens))))

    want_loss, want_grads = jax.value_and_grad(loss)(jax.tree_util.tree_map(jnp.asarray, params))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))
    calls = _count_calls(monkeypatch, LM, "fused_lora_bwd_dab_plain")
    model = _torch_fused_model(params)
    got_loss = model(torch.from_numpy(tokens).long()).square().mean()
    got_loss.backward()
    assert len(calls) == 7 * TINY["num_hidden_layers"]
    _close(got_loss, want_loss, "loss")
    for name, p in model.named_parameters():
        if relora.is_lora_name(name):
            _close(p.grad, want[name].numpy(), name)


def test_remat_recomputes_through_the_function_bit_equal():
    """Per-layer remat (non-reentrant checkpoint) recomputes the fused
    Function: gradients equal those without remat bit for bit."""
    _, params = _jax_fused_params(seed=1)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 128, (2, 16)))
    grads = []
    for remat in (False, True):
        model = _torch_fused_model(params, remat=remat)
        model(tokens, dropout_seed=9).square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], rtol=0, atol=0)


def test_cpu_takes_twins_and_counts_no_launch():
    x, w, a, b, g = _operands(16, 32, 24, 4)
    counters = (LM.fused_lora_forward, LM.fused_lora_bwd_dx, LM.fused_lora_bwd_dab)
    before = [c.launches for c in counters]
    _torch_grads(x, w, a, b, g, 0.5)
    assert [c.launches for c in counters] == before


def test_cpu_forward_counts_no_launch_of_either_path():
    """A CPU forward runs the twin: neither the tensor-core nor the FMA
    kernel's count moves, even for the layout the tensor cores take."""
    x, w, a, b, _ = _t(*_operands(16, 32, 24, 8))
    x, w, a, b = (t.bfloat16() for t in (x, w, a, b))
    w = w.t().contiguous().t()  # the model's (N, K) storage, transposed
    assert LM.forward_path(x.dtype, w.stride(), 32, 24, 8) == "tc"
    before = (LM.fused_lora_forward.launches, LM.fused_lora_forward.tc_launches)
    y, z = LM.fused_lora_forward(x, w, a, b, 0.5)
    want_y, want_z = LM.fused_lora_forward_plain(x, w, a, b, 0.5)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(z, want_z, rtol=0, atol=0)
    assert (LM.fused_lora_forward.launches, LM.fused_lora_forward.tc_launches) == before


def test_cpu_dx_counts_no_launch_of_either_path():
    """A CPU dx runs the twin: neither the tensor-core nor the FMA kernel's
    count moves, even for the layout the tensor cores take."""
    _, w, a, b, g = _t(*_operands(16, 32, 24, 8))
    g, w, a, b = (t.bfloat16() for t in (g, w, a, b))
    w = w.t().contiguous().t()  # the model's (N, K) storage, transposed
    assert LM.forward_path(g.dtype, w.stride(), 32, 24, 8) == "tc"
    before = (LM.fused_lora_bwd_dx.launches, LM.fused_lora_bwd_dx.tc_launches)
    dx, u = LM.fused_lora_bwd_dx(g, w, a, b, 0.5)
    want_dx, want_u = LM.fused_lora_bwd_dx_plain(g, w, a, b, 0.5)
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=0)
    torch.testing.assert_close(u, want_u, rtol=0, atol=0)
    assert (LM.fused_lora_bwd_dx.launches, LM.fused_lora_bwd_dx.tc_launches) == before


def test_dx_twin_matches_jax_interpret_kernel_at_a_ragged_tensor_core_shape():
    """dx of the dx twin against the JAX dx kernel (interpret) at M = 200, K =
    72, N = 104, r = 8: widths that are multiples of 8 but not of the
    tensor-core tiles, the shape chip_smoke.py checks the CUDA dx at; u
    against g @ Bᵀ."""
    _, w, a, b, g = _operands(200, 72, 104, 8, seed=9)
    dx = jax_plm._backward_dx(8, True, jnp.asarray(g), (jnp.asarray(w),), jnp.asarray(a),
                              jnp.asarray(b), jnp.full((1, 1), 0.5, jnp.float32), jnp.float32)
    gt, wt, at, bt = _t(g, w, a, b)
    got_dx, got_u = LM.fused_lora_bwd_dx(gt, wt.t().contiguous().t(), at, bt, 0.5)
    _close(got_dx, dx, "dx")
    _close(got_u, g @ b.T, "u")


# (dtype, base strides of the logical (K, N) base, K, N, r, aligned) -> path
FORWARD_PATHS = {
    "bf16_transposed_view": (torch.bfloat16, (1, 768), 768, 768, 128, True, "tc"),
    "bf16_ragged_multiples_of_8": (torch.bfloat16, (1, 72), 72, 104, 8, True, "tc"),
    "bf16_padded_row_stride": (torch.bfloat16, (1, 776), 768, 2560, 320, True, "tc"),
    "f32_transposed_view": (torch.float32, (1, 768), 768, 768, 128, True, "fma"),
    "bf16_contiguous_kn": (torch.bfloat16, (768, 1), 768, 768, 128, True, "fma"),
    "bf16_N_100": (torch.bfloat16, (1, 72), 72, 100, 8, True, "fma"),
    "bf16_K_100": (torch.bfloat16, (1, 100), 100, 104, 8, True, "fma"),
    "bf16_r_4": (torch.bfloat16, (1, 768), 768, 768, 4, True, "fma"),
    "bf16_row_stride_not_8": (torch.bfloat16, (1, 772), 768, 768, 128, True, "fma"),
    "bf16_unaligned": (torch.bfloat16, (1, 768), 768, 768, 128, False, "fma"),
}


@pytest.mark.parametrize("case", list(FORWARD_PATHS))
def test_forward_path_rule(case):
    """The tensor cores take bf16 with the base's k contiguous at a row
    stride, K, N and r multiples of 8 and aligned pointers; everything else
    the f32 FMA kernel."""
    dtype, strides, K, N, r, aligned, want = FORWARD_PATHS[case]
    assert LM.forward_path(dtype, strides, K, N, r, aligned) == want


def test_lora_linear_fused_base_takes_the_tensor_core_path(monkeypatch):
    """The base view ``LoRALinear._fused`` hands the kernel (its ``(out,
    in)`` weight in bf16, transposed) meets the tensor-core rule at widths
    that are multiples of 8, and so do the cotangent, base and factors its
    backward hands the dx."""
    spec = relora.LoraSpec(r=8, alpha=16.0, dropout=0.0, fused=True)
    layer = LoRALinear(64, 40, lora=spec, dtype=torch.bfloat16)
    base = layer.weight.detach().to(torch.bfloat16).t()
    assert base.shape == (64, 40)
    assert LM.forward_path(torch.bfloat16, base.stride(), 64, 40, 8) == "tc"
    seen, real = [], LM.fused_lora_bwd_dx

    def spy(g, w, a, b, s):
        seen.append((g.dtype, g.is_contiguous(), w.stride(), tuple(w.shape), a.shape[1]))
        return real(g, w, a, b, s)

    monkeypatch.setattr(LM, "fused_lora_bwd_dx", spy)
    x = torch.randn((2, 3, 64), dtype=torch.bfloat16, requires_grad=True)
    layer(x).float().square().sum().backward()
    assert len(seen) == 1 and x.grad is not None
    dtype, contiguous, strides, (K, N), r = seen[0]
    assert contiguous and (K, N, r) == (64, 40, 8)
    assert LM.forward_path(dtype, strides, K, N, r) == "tc"


@pytest.mark.parametrize("wrapper", ["forward", "bwd_dx", "bwd_dab"])
def test_non_cpu_tensor_never_takes_the_twin(wrapper):
    """A tensor on any device but the CPU goes to the kernel path, which
    refuses what is not a CUDA tensor before touching the library."""
    x, w, a, b, g = (t.to("meta") for t in _t(*_operands(8, 16, 8, 2)))
    args = {"forward": (x, w, a, b), "bwd_dx": (g, w, a, b),
            "bwd_dab": (g, x, torch.empty((8, 2), device="meta"), b)}[wrapper]
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(LM, f"fused_lora_{wrapper}")(*args)


# ----------------------------------------------------------------- the slice


def _data_config(tmp_path):
    path = tmp_path / "data.json"
    path.write_text(json.dumps({"data_path": str(tmp_path / "unused"), "seq_length": 16}))
    return str(path)


def _jax_fused_run(batches):
    """The JAX package's step with LoraSpec(fused=True), merge and reset
    under the trainer's cadence rule; returns per-update losses, the initial
    params and the fresh A of every merge."""
    spec = jax_relora.LoraSpec(r=4, dropout=0.0, fused=True)
    model = JaxLlama(JaxModelConfig(**TINY), lora=spec, dtype=jnp.float32, scan_layers=True,
                     attention_impl="naive")
    params = jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    mask = jax_relora.trainable_param_mask(params)
    sched = jax_make_schedule("cosine_restarts", lr=5e-3, num_training_steps=6, warmup_steps=2,
                              cycle_length=3, restart_warmup_steps=1)
    tx = jax_optim.build_optimizer(schedule=sched)
    state = JaxTrainState.create(params, tx.init(partition(params, mask)[0]))
    step = jax.jit(jax_make_train_step(model, tx, mask, clip_grad_norm=1.0, schedule=sched))
    losses, fresh_a = [], []
    for u, batch in enumerate(batches, start=1):
        state, metrics = step(state, jnp.asarray(batch), jax.random.PRNGKey(u))
        losses.append(float(metrics["loss"]))
        if u >= 3 and u % 3 == 1:
            state = state.replace(params=jax_relora.merge_and_reinit(state.params, jax.random.PRNGKey(u), spec))
            fresh_a.append(jax.tree_util.tree_map(np.asarray, state.params))
            state = state.replace(opt_state=jax_optim.reset_optimizer_state(state.opt_state, mode="zero", ratio=1.0))
    return losses, jax.tree_util.tree_map(np.asarray, params), fresh_a


def test_trainer_fit_fused_tracks_jax_fused_step(tmp_path, monkeypatch):
    """Trainer.fit with lora_fused="true", dropout 0, against the JAX train
    step with LoraSpec(fused=True), per update within 1e-4 over 6 updates
    with one merge and one reset; the JAX side traced its fused forward
    kernel and the port ran its fused twins."""
    traces = _count_calls(monkeypatch, jax_plm, "_forward")
    jax.clear_caches()  # the fused kernel must trace anew for the spy to see it
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 128, (6, 2, 4, 1))
    batches = ((starts + np.arange(16)) % 128).astype(np.int32)  # learnable: i -> i+1
    want, params, merged_trees = _jax_fused_run(batches)
    assert traces, "the JAX train step traced the fused Pallas kernel"

    cfg = TrainingConfig(megatron_dataset_config=_data_config(tmp_path), dtype="float32",
                         device="cpu", lora_fused="true", **RECIPE).finalize()
    trainer = Trainer(cfg, model_cfg=ModelConfig(**TINY))
    assert trainer.lora_spec.fused is True
    trainer.model.load_state_dict(params_from_jax(params))
    queue = []
    for tree in merged_trees:
        sd = params_from_jax(tree)
        queue.extend(sd[f"{name}.lora_a"] for name, _ in relora.lora_modules(trainer.model))
    monkeypatch.setattr(relora, "kaiming_uniform", lambda shape, generator, device: queue.pop(0))
    calls = _count_calls(monkeypatch, LM, "fused_lora_bwd_dx_plain")
    result = trainer.fit(iter(batches))

    got = [r["loss"] for r in result["records"]]
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)
    assert not queue, "every merge took the JAX draw"
    assert len(calls) == 7 * TINY["num_hidden_layers"] * 2 * 6
    assert (result["n_lora_restarts"], result["n_optimizer_resets"]) == (1, 1)
    assert got[-1] < got[0]
