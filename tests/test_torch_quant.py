"""The port's int8-base path against the JAX package's, on the CPU.

On the CPU kernel 8 (``ops/quant_matmul``) and the int8 fused forward and dx
(``ops/lora_matmul``) run their plain twins; the CUDA kernels run only on the
card, where ``chip_smoke.py`` holds them to these twins.  Here the twins,
their autograd Functions, the ``lora_dispatch`` arms with an ``(q, qscale)``
base, ``LoRALinear(quantize="int8")``, the int8 merge, the warm start and
``Trainer.fit`` with ``--quantize int8 --warmed_up_model`` are held to
``relora_tpu`` run as its own tests run it: the Pallas kernels in interpret
mode, with ``RELORA_TPU_PALLAS_QUANT=1`` for the dequant matmul.  Inputs are
made with numpy from a seed and handed to both packages.  Widths tile for
the JAX kernels (N % 128 == 0, M = 4 x 16), so the JAX side really runs them.

Tolerances: quantization is bit-equal (the same f32 division and
round-half-to-even on both sides); every other output and gradient within
1e-5 of ``max(1, max|JAX value|)``, both sides computing in f32 and summing
in another order; per-update training loss within 1e-4.  A merged int8 base
is held to the requant rule: the two packages compute ``A @ B`` in another
order, so a last-ulp difference may flip a code at a .5 tie or move a
column's absmax, hence the dequantized weights agree within one quantization
step per element, at least 99.9% of the codes are equal, and codes are
exactly equal where the delta is zero.  The gradient of a trainable scale
sums ``g ⊙ branch`` over every element, with cancellation, so it is held to
1e-5 of the sum of its terms' magnitudes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta as flax_meta

import relora_tpu.ops.pallas_lora_matmul as jax_plm
import relora_tpu.ops.pallas_quant_matmul as jax_pqm
from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.core import optim as jax_optim
from relora_tpu.core import relora as jax_relora
from relora_tpu.core.partition import partition
from relora_tpu.core.schedules import make_schedule as jax_make_schedule
from relora_tpu.models.hf_compat import graft_base_weights as jax_graft, hf_to_params
from relora_tpu.models.llama import LlamaForCausalLM as JaxLlama
from relora_tpu.models.lora import LoRALinear as JaxLoRALinear
from relora_tpu.models.params_util import init_params as jax_init_params
from relora_tpu.ops.lora_dispatch import lora_matmul as jax_lora_matmul
from relora_tpu.ops.quant import quantize_int8 as jax_quantize_int8
from relora_tpu.train.state import TrainState as JaxTrainState
from relora_tpu.train.step import make_train_step as jax_make_train_step
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.config.training import TrainingConfig
from relora_tpu_torch.core import relora
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.models.llama import LlamaForCausalLM
from relora_tpu_torch.models.lora import LoRALinear
from relora_tpu_torch.models.params_util import init_params
from relora_tpu_torch.models.warm_start import graft_base_weights, load_warm_start
from relora_tpu_torch.ops import lora_matmul as LM
from relora_tpu_torch.ops import quant_matmul as QM
from relora_tpu_torch.ops.lora_dispatch import lora_matmul
from relora_tpu_torch.ops.quant import dequantize_int8, quantize_int8
from relora_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.torch_port

TOL = 1e-5
LOSS_TOL = 1e-4
TINY = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=2, max_sequence_length=32)
RECIPE = dict(batch_size=4, total_batch_size=8, max_length=16, lr=5e-3, scheduler="cosine_restarts",
              warmup_steps=2, restart_warmup_steps=1, num_training_steps=6, cycle_length=3, relora=3,
              use_peft=True, lora_r=8, lora_dropout=0.0, eval_every=1000, seed=0)
PROJ = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
        "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def _t(*arrays):
    return [torch.from_numpy(np.array(x, copy=True)) for x in arrays]


def _close(got, want, name, magnitude=None):
    """``got`` within TOL of ``max(1, magnitude)``, the magnitude being
    max|want| unless given (a sum with cancellation is held to the sum of
    its terms' magnitudes)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if magnitude is None:
        magnitude = float(np.abs(want).max())
    atol = TOL * max(1.0, magnitude)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)


def _int8_operands(M, K, N, r, seed=0):
    """x, the int8 base (q (K, N), qscale (1, N)) quantized by the JAX
    package from a seeded f32 weight, A, B and a cotangent g, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    q, qs = (np.asarray(v) for v in jax_quantize_int8(jnp.asarray(w)))
    a = (rng.standard_normal((K, r)) / np.sqrt(K)).astype(np.float32)
    b = (rng.standard_normal((r, N)) * 0.5).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)
    return x, q, qs, a, b, g


def _q_layout(q: np.ndarray, transposed: bool) -> torch.Tensor:
    """The (K, N) codes as the model passes them (the (N, K) storage's
    transposed view) or as a contiguous tensor."""
    return torch.from_numpy(q.T.copy()).t() if transposed else torch.from_numpy(q.copy())


# -------------------------------------------------------------- quantization


def test_quantize_int8_codes_bit_equal_to_jax():
    """Codes and scales bit-equal to relora_tpu.ops.quant.quantize_int8 of the
    (in, out) transpose, including a zero channel (scale clamped at 1e-12)
    and values on .5 ties; dequantize matches too."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((96, 80)) * 0.05).astype(np.float32)  # (out, in)
    w[3] = 0.0
    w[5, :4] = [1.27, -0.635, 0.005, 0.015]  # absmax 1.27: scale 0.01, codes at ties
    jq, js = (np.asarray(v) for v in jax_quantize_int8(jnp.asarray(w.T)))
    q, s = quantize_int8(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and tuple(s.shape) == (1, 96)
    np.testing.assert_array_equal(q.numpy(), jq.T)
    np.testing.assert_array_equal(s.numpy(), js)
    assert not q[3].any() and s[0, 3].item() == np.float32(1e-12)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(), (jq.astype(np.float32) * js).T)
    assert dequantize_int8(q, s, torch.bfloat16).dtype == torch.bfloat16


# ----------------------------------------------------------------- kernel 8


@pytest.mark.parametrize("transposed", [True, False], ids=["qT_view", "q_contiguous"])
def test_dequant_matmul_matches_jax_interpret_kernel(transposed):
    """y, dx and dscale through DequantMatmul against the JAX dequant_matmul
    (interpret=True) and its VJP; the twin alone gives the same y."""
    x, q, qs, _, _, g = _int8_operands(64, 256, 128, 8, seed=1)

    def fn(xx, ss):
        return jax_pqm.dequant_matmul(xx, jnp.asarray(q), ss, block_m=64, block_n=128,
                                      interpret=True)

    y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(qs))
    want_dx, want_ds = vjp(jnp.asarray(g))

    xt, st = (t.requires_grad_() for t in _t(x, qs))
    qt = _q_layout(q, transposed)
    got = QM.dequant_matmul(xt, qt, st)
    got.backward(_t(g)[0])
    _close(got, y, "y")
    _close(xt.grad, want_dx, "dx")
    _close(st.grad, want_ds, "dscale")
    _close(QM.dequant_matmul_plain(*_t(x), qt, _t(qs)[0]), y, "plain y")


def test_dequant_matmul_leading_dims_and_no_scale_grad():
    """(B, S, K) input keeps its leading dims; a frozen scale gets no
    gradient and q never does."""
    x, q, qs, _, _, _ = _int8_operands(24, 32, 40, 2, seed=2)
    xt = torch.from_numpy(x.reshape(2, 12, 32)).requires_grad_()
    y = QM.dequant_matmul(xt, *_t(q, qs))
    assert tuple(y.shape) == (2, 12, 40)
    y.sum().backward()
    _close(xt.grad.reshape(24, 32), np.ones((24, 40), np.float32) @ (q * qs).T, "dx")
    with pytest.raises(ValueError, match="contraction mismatch"):
        QM.dequant_matmul(xt, *_t(q[:8], qs))


# --------------------------------------------------------- kernels 4, 6 int8


@pytest.mark.parametrize("r", [8, 128, 320])
def test_int8_twins_match_jax_interpret_kernels(r):
    """y, z of the int8 forward twin and dx of the int8 dx twin against the
    JAX int8 forward and dx kernels (interpret); u against g @ Bᵀ."""
    x, q, qs, a, b, g = _int8_operands(64, 256, 128, r, seed=r)
    s = jnp.full((1, 1), 0.5, jnp.float32)
    base = (jnp.asarray(q), jnp.asarray(qs))
    y, z = jax_plm._forward(64, 128, True, jnp.float32, jnp.asarray(x), base, jnp.asarray(a),
                            jnp.asarray(b), s)
    dx = jax_plm._backward_dx(64, True, jnp.asarray(g), base, jnp.asarray(a), jnp.asarray(b), s,
                              jnp.float32)
    xt, qst, at, bt, gt = _t(x, qs, a, b, g)
    qt = _q_layout(q, True)
    got_y, got_z = LM.fused_lora_int8_forward(xt, qt, qst, at, bt, 0.5)
    got_dx, got_u = LM.fused_lora_int8_bwd_dx(gt, qt, qst, at, bt, 0.5)
    _close(got_y, y, "y")
    _close(got_z, z, "z")
    _close(got_dx, dx, "dx")
    _close(got_u, g @ b.T, "u")


def _jax_int8_vjp(x, q, qs, a, b, g, s, **kw):
    """y and the gradients of x, qscale, A, B (and s when it is an array) of
    the JAX int8 fused function (or the dispatcher's arm given in kw)."""
    args = [jnp.asarray(v) for v in (x, qs, a, b)]
    tensor_s = not isinstance(s, float)
    if tensor_s:
        args.append(jnp.asarray(s))

    def fn(xx, qq, aa, bb, *ss):
        scale = ss[0] if ss else s
        if kw:
            return jax_lora_matmul(xx, (jnp.asarray(q), qq), aa, bb, scale, **kw)
        return jax_plm.fused_lora_matmul_int8(xx, jnp.asarray(q), qq, aa, bb, scale, interpret=True)

    y, vjp = jax.vjp(fn, *args)
    return [np.asarray(v) for v in (y, *vjp(jnp.asarray(g)))]


def _torch_int8_grads(x, q, qs, a, b, g, s):
    xt, qst, at, bt = (t.requires_grad_() for t in _t(x, qs, a, b))
    st = torch.tensor(s).requires_grad_() if not isinstance(s, float) else s
    y = LM.fused_lora_matmul_int8(xt, _q_layout(q, True), qst, at, bt, st)
    y.backward(_t(g)[0])
    return [y, xt.grad, qst.grad, at.grad, bt.grad] + ([st.grad] if not isinstance(s, float) else [])


@pytest.mark.parametrize("r", [8, 320])
@pytest.mark.parametrize("scale", [0.5, np.array([0.7], np.float32)], ids=["static", "tensor_s"])
def test_fused_int8_gradients_match_jax_grad(scale, r):
    """y, dx, dqscale, dA, dB (and ds) through FusedLoRAMatmulInt8 against
    jax.vjp of fused_lora_matmul_int8 (interpret), at r = 8 and at r = 320,
    past the 256 the port's kernels once refused."""
    x, q, qs, a, b, g = _int8_operands(64, 256, 128, r, seed=3)
    want = _jax_int8_vjp(x, q, qs, a, b, g, scale)
    got = _torch_int8_grads(x, q, qs, a, b, g, scale)
    for name, gt, wt in zip(("y", "dx", "dqscale", "dA", "dB", "ds"), got, want):
        _close(gt, wt, name)


def test_fused_int8_ragged_shape_matches_jax_fused_arm():
    """M=10, N=100 do not tile for JAX, whose fused arm falls back to
    ordered over the dequantized base; the port's fused path takes them."""
    x, q, qs, a, b, g = _int8_operands(10, 64, 100, 4, seed=5)
    want = _jax_int8_vjp(x, q, qs, a, b, g, 0.25, arm="fused", interpret=True)
    got = _torch_int8_grads(x, q, qs, a, b, g, 0.25)
    for name, gt, wt in zip(("y", "dx", "dqscale", "dA", "dB"), got, want):
        _close(gt, wt, name)


@pytest.mark.parametrize("arm", ["fused", "ordered", "merged"])
def test_dispatch_arms_with_int8_base_match_jax(arm):
    """lora_matmul per arm with an (q, qscale) base against the JAX
    dispatcher's same arm, leading batch dims kept."""
    x, q, qs, a, b, _ = _int8_operands(64, 256, 128, 8, seed=11)
    x3 = x.reshape(4, 16, 256)
    want = jax_lora_matmul(jnp.asarray(x3), (jnp.asarray(q), jnp.asarray(qs)), jnp.asarray(a),
                           jnp.asarray(b), 0.25, arm=arm, interpret=True)
    xt, qst, at, bt = _t(x3, qs, a, b)
    got = lora_matmul(xt, (_q_layout(q, True), qst), at, bt, 0.25, arm=arm)
    _close(got, want, arm)


def test_cpu_takes_twins_and_counts_no_launch():
    x, q, qs, a, b, g = _int8_operands(16, 32, 24, 4)
    counters = (LM.fused_lora_int8_forward, LM.fused_lora_int8_bwd_dx, LM.fused_lora_bwd_dab,
                QM.dequant_matmul)
    before = [c.launches for c in counters]
    _torch_int8_grads(x, q, qs, a, b, g, 0.5)
    QM.dequant_matmul(*_t(x, q, qs))
    assert [c.launches for c in counters] == before


def test_cpu_int8_forward_counts_no_launch_of_either_path():
    """A CPU int8 forward runs the twin: neither path's count moves, even
    for the codes' layout the tensor cores take."""
    x, q, qs, a, b, _ = _int8_operands(16, 32, 24, 8)
    x, a, b = (t.bfloat16() for t in _t(x, a, b))
    qt, qst = _q_layout(q, True), torch.from_numpy(qs.copy())
    assert LM.forward_path(x.dtype, qt.stride(), 32, 24, 8) == "tc"
    before = (LM.fused_lora_int8_forward.launches, LM.fused_lora_int8_forward.tc_launches)
    y, z = LM.fused_lora_int8_forward(x, qt, qst, a, b, 0.5)
    want_y, want_z = LM.fused_lora_int8_forward_plain(x, qt, qst, a, b, 0.5)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(z, want_z, rtol=0, atol=0)
    assert (LM.fused_lora_int8_forward.launches, LM.fused_lora_int8_forward.tc_launches) == before


def test_cpu_int8_dx_counts_no_launch_of_either_path():
    """A CPU int8 dx runs the twin: neither path's count moves, even for the
    codes' layout the tensor cores take."""
    _, q, qs, a, b, g = _int8_operands(16, 32, 24, 8)
    g, a, b = (t.bfloat16() for t in _t(g, a, b))
    qt, qst = _q_layout(q, True), torch.from_numpy(qs.copy())
    assert LM.forward_path(g.dtype, qt.stride(), 32, 24, 8) == "tc"
    before = (LM.fused_lora_int8_bwd_dx.launches, LM.fused_lora_int8_bwd_dx.tc_launches)
    dx, u = LM.fused_lora_int8_bwd_dx(g, qt, qst, a, b, 0.5)
    want_dx, want_u = LM.fused_lora_int8_bwd_dx_plain(g, qt, qst, a, b, 0.5)
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=0)
    torch.testing.assert_close(u, want_u, rtol=0, atol=0)
    assert (LM.fused_lora_int8_bwd_dx.launches, LM.fused_lora_int8_bwd_dx.tc_launches) == before


def test_int8_dx_twin_matches_jax_interpret_kernel_at_a_ragged_tensor_core_shape():
    """dx of the int8 dx twin against the JAX int8 dx kernel (interpret) at
    M = 200, K = 72, N = 104, r = 8, the ragged shape chip_smoke.py checks
    the CUDA int8 dx at (the scale along the contraction axis); u against
    g @ Bᵀ."""
    _, q, qs, a, b, g = _int8_operands(200, 72, 104, 8, seed=9)
    dx = jax_plm._backward_dx(8, True, jnp.asarray(g), (jnp.asarray(q), jnp.asarray(qs)),
                              jnp.asarray(a), jnp.asarray(b), jnp.full((1, 1), 0.5, jnp.float32),
                              jnp.float32)
    gt, qst, at, bt = _t(g, qs, a, b)
    got_dx, got_u = LM.fused_lora_int8_bwd_dx(gt, _q_layout(q, True), qst, at, bt, 0.5)
    _close(got_dx, dx, "dx")
    _close(got_u, g @ b.T, "u")


def test_lora_linear_int8_fused_base_takes_the_tensor_core_path(monkeypatch):
    """The codes ``LoRALinear._fused`` hands the int8 forward (the ``(in,
    out)`` view of its ``(out, in)`` codes, bf16 activations and factors)
    meet the tensor-core rule at widths that are multiples of 8, and so do
    the cotangent, codes and factors its backward hands the int8 dx."""
    spec = relora.LoraSpec(r=8, alpha=16.0, dropout=0.0, quantize="int8", fused=True)
    layer = LoRALinear(64, 40, lora=spec, dtype=torch.bfloat16)
    seen = {}
    for name in ("fused_lora_int8_forward", "fused_lora_int8_bwd_dx"):
        real = getattr(LM, name)

        def spy(act, q, qscale, a, b, s, _name=name, _real=real):
            seen[_name] = (act.dtype, act.is_contiguous(), q.stride(), tuple(q.shape), a.shape[1])
            return _real(act, q, qscale, a, b, s)

        monkeypatch.setattr(LM, name, spy)
    x = torch.randn((2, 3, 64), dtype=torch.bfloat16, requires_grad=True)
    layer(x).float().square().sum().backward()
    assert sorted(seen) == ["fused_lora_int8_bwd_dx", "fused_lora_int8_forward"]
    for name, (dtype, contiguous, strides, (K, N), r) in seen.items():
        assert contiguous and (K, N, r) == (64, 40, 8), name
        assert LM.forward_path(dtype, strides, K, N, r) == "tc", name


# (activation dtype, codes transposed?, K, N, r) -> the int8 forward's path
INT8_FORWARD_PATHS = {
    "bf16_codes_transposed_view": (torch.bfloat16, True, 128, 256, 8, "tc"),
    "bf16_ragged_multiples_of_8": (torch.bfloat16, True, 72, 104, 8, "tc"),
    "f32_codes_transposed_view": (torch.float32, True, 128, 256, 8, "fma"),
    "bf16_codes_contiguous_kn": (torch.bfloat16, False, 128, 256, 8, "fma"),
    "bf16_N_100": (torch.bfloat16, True, 72, 100, 8, "fma"),
}


@pytest.mark.parametrize("case", list(INT8_FORWARD_PATHS))
def test_int8_forward_path_rule(case):
    """The int8 forward takes the tensor cores by the dense rule, with the
    codes' strides as the base's: the model's (N, K) codes, transposed, at
    bf16 and widths that are multiples of 8."""
    dtype, transposed, K, N, r, want = INT8_FORWARD_PATHS[case]
    q = _q_layout(np.zeros((K, N), np.int8), transposed)
    assert LM.forward_path(dtype, q.stride(), K, N, r) == want


# (activation dtype, codes transposed?, K, N, 16-byte aligned?) -> kernel 8's path
DEQUANT_PATHS = {
    "bf16_codes_transposed_view": (torch.bfloat16, True, 768, 2560, True, "tc"),
    "bf16_ragged_multiples_of_8": (torch.bfloat16, True, 72, 104, True, "tc"),
    "f32_codes_transposed_view": (torch.float32, True, 768, 768, True, "fma"),
    "bf16_codes_contiguous_kn": (torch.bfloat16, False, 768, 768, True, "fma"),
    "bf16_N_100": (torch.bfloat16, True, 72, 100, True, "fma"),
    "bf16_K_100": (torch.bfloat16, True, 100, 104, True, "fma"),
    "bf16_unaligned": (torch.bfloat16, True, 768, 768, False, "fma"),
}


@pytest.mark.parametrize("case", list(DEQUANT_PATHS))
def test_dequant_matmul_path_rule(case):
    """Kernel 8 takes the tensor cores by the fused kernels' rule with no
    rank (``r=None``): bf16 x, the model's (N, K) codes transposed, K and N
    multiples of 8, aligned pointers; everything else the FMA GEMM.  A rank
    that is no multiple of 8 would refuse the fused paths, never kernel 8."""
    dtype, transposed, K, N, aligned, want = DEQUANT_PATHS[case]
    q = _q_layout(np.zeros((K, N), np.int8), transposed)
    assert LM.forward_path(dtype, q.stride(), K, N, None, aligned) == want
    if want == "tc":
        assert LM.forward_path(dtype, q.stride(), K, N, 4, aligned) == "fma"


def test_cpu_dequant_matmul_counts_no_launch_of_either_path():
    """A CPU kernel-8 call runs the twin, even for the layout the tensor
    cores take: neither count moves."""
    x, q, qs, _, _, _ = _int8_operands(16, 32, 24, 8)
    xt = torch.from_numpy(x).bfloat16()
    qt, qst = _q_layout(q, True), torch.from_numpy(qs.copy())
    assert LM.forward_path(xt.dtype, qt.stride(), 32, 24, None) == "tc"
    before = (QM.dequant_matmul.launches, QM.dequant_matmul.tc_launches)
    y = QM.dequant_matmul(xt, qt, qst)
    torch.testing.assert_close(y, QM.dequant_matmul_plain(xt, qt, qst), rtol=0, atol=0)
    assert (QM.dequant_matmul.launches, QM.dequant_matmul.tc_launches) == before


@pytest.mark.parametrize("wrapper", ["int8_forward", "int8_bwd_dx", "dequant_matmul"])
def test_non_cpu_tensor_never_takes_the_twin(wrapper):
    """A tensor on any device but the CPU goes to the kernel path, which
    refuses what is not a CUDA tensor before touching the library."""
    x, q, qs, a, b, g = (t.to("meta") for t in _t(*_int8_operands(8, 16, 8, 2)))
    call = {"int8_forward": lambda: LM.fused_lora_int8_forward(x, q, qs, a, b),
            "int8_bwd_dx": lambda: LM.fused_lora_int8_bwd_dx(g, q, qs, a, b),
            "dequant_matmul": lambda: QM.dequant_matmul(x, q, qs)}[wrapper]
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()


# ---------------------------------------------------------------- LoRALinear


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("trainable_scaling", [False, True], ids=["static", "tanh_s"])
def test_lora_linear_int8_matches_jax(fused, trainable_scaling, monkeypatch):
    """y and the gradients of x, A, B (and s) of LoRALinear(quantize="int8")
    against the JAX LoRALinear with the same codes, scales and factors: the
    unfused JAX layer runs the Pallas dequant matmul (RELORA_TPU_PALLAS_QUANT=1,
    interpret), the fused one the int8 fused kernel.  The codes and scales
    get no gradient in the port."""
    monkeypatch.setenv("RELORA_TPU_PALLAS_QUANT", "1")
    spec = dict(r=8, alpha=16.0, dropout=0.0, trainable_scaling=trainable_scaling,
                quantize="int8", fused=fused)
    jmod = JaxLoRALinear(features=128, lora=jax_relora.LoraSpec(**spec), dtype=jnp.float32)
    assert jmod.pallas_quant
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, flax_meta.unbox(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    w = (rng.standard_normal((64, 128)) * 0.05).astype(np.float32)
    params["kernel_q"], params["kernel_scale"] = (np.asarray(v) for v in jax_quantize_int8(w))
    params["lora_b"] = rng.standard_normal(params["lora_b"].shape).astype(np.float32)
    if trainable_scaling:
        params["lora_s"] = np.array([0.7], np.float32)
    cot = rng.standard_normal((4, 16, 128)).astype(np.float32)
    y, vjp = jax.vjp(lambda p, xx: jmod.apply({"params": p}, xx),
                     jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))

    mod = LoRALinear(64, 128, lora=relora.LoraSpec(**spec), dtype=torch.float32)
    names = ("lora_a", "lora_b") + (("lora_s",) if trainable_scaling else ())
    with torch.no_grad():
        mod.weight_q.copy_(torch.from_numpy(params["kernel_q"].T.copy()))
        mod.weight_scale.copy_(torch.from_numpy(params["kernel_scale"]))
        for name in names:
            getattr(mod, name).copy_(torch.tensor(params[name]))
    relora.set_trainable(mod)
    twin = (LM, "fused_lora_int8_forward_plain") if fused else (QM, "dequant_matmul_plain")
    calls = _count_calls(monkeypatch, *twin)
    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt, dropout_seed=123)  # dropout 0: the fused path despite the seed
    out.backward(torch.from_numpy(cot))
    assert calls, f"LoRALinear(int8, fused={fused}) took {twin[1]}"
    _close(out, y, "y")
    _close(xt.grad, gx, "dx")
    # ds sums g ⊙ ((x@A)@B) over 8192 elements that cancel: held to the
    # magnitude of its terms
    branch = (x.astype(np.float64) @ params["lora_a"]) @ params["lora_b"]
    terms = float(np.abs(cot * branch).sum())
    for name in names:
        _close(getattr(mod, name).grad, gp[name], name, terms if name == "lora_s" else None)
    assert mod.weight_q.grad is None and mod.weight_scale.grad is None


def test_int8_spec_layout_freezing_and_refusals():
    """Codes (out, in) int8 at 0 and scales (1, out) f32 at 1 (W = 0), frozen
    and counted as the JAX package counts kernel_q/kernel_scale; nf4 and
    unknown modes refuse."""
    model = LlamaForCausalLM(ModelConfig(**TINY), lora=relora.LoraSpec(r=8, quantize="int8"))
    relora.set_trainable(model)
    proj = model.layers[0].mlp.down_proj
    assert proj.weight is None and proj.weight_q.dtype == torch.int8
    assert tuple(proj.weight_q.shape) == (128, 256) and tuple(proj.weight_scale.shape) == (1, 128)
    assert not proj.weight_q.any() and bool((proj.weight_scale == 1).all())
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert len(frozen) == 2 * 7 * TINY["num_hidden_layers"]
    assert all(n.endswith(("weight_q", "weight_scale")) for n in frozen)

    jmodel = JaxLlama(JaxModelConfig(**TINY), lora=jax_relora.LoraSpec(r=8, quantize="int8"),
                      dtype=jnp.float32, scan_layers=True, attention_impl="naive")
    jparams = jax_init_params(jmodel, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    assert relora.split_param_counts(model) == jax_relora.split_param_counts(jparams)
    with pytest.raises(NotImplementedError, match="nf4"):
        LoRALinear(8, 8, lora=relora.LoraSpec(r=2, quantize="nf4"))
    with pytest.raises(NotImplementedError, match="nf4"):
        relora.merge_and_reinit(model, torch.Generator(), relora.LoraSpec(r=8, quantize="nf4"))
    with pytest.raises(ValueError, match="quantize"):
        relora.LoraSpec(r=2, quantize="int4")


# --------------------------------------------------------------------- merge


def _int8_module_params(seed, out_f=256, in_f=128, r=8, zero_cols=()):
    """A JAX LoRALinear(int8) param dict with real codes, A and nonzero B;
    the listed output columns of B are zero, so their delta is zero."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((in_f, out_f)) * 0.05).astype(np.float32)
    q, s = (np.asarray(v) for v in jax_quantize_int8(w))
    b = (rng.standard_normal((r, out_f)) * 0.05).astype(np.float32)
    b[:, list(zero_cols)] = 0.0
    return {"kernel_q": q, "kernel_scale": s,
            "lora_a": (rng.uniform(-1, 1, (in_f, r)) / np.sqrt(in_f)).astype(np.float32),
            "lora_b": b}


def _port_int8_module(params, spec):
    mod = LoRALinear(params["kernel_q"].shape[0], params["kernel_q"].shape[1], lora=spec)
    with torch.no_grad():
        mod.weight_q.copy_(torch.from_numpy(params["kernel_q"].T.copy()))
        mod.weight_scale.copy_(torch.from_numpy(params["kernel_scale"]))
        mod.lora_a.copy_(torch.from_numpy(params["lora_a"]))
        mod.lora_b.copy_(torch.from_numpy(params["lora_b"]))
    return mod


def test_int8_merge_matches_jax_to_the_requant_rule():
    """merge_and_reinit of an int8 base against relora_tpu's: dequantized
    weights within one quantization step, >= 99.9% of codes equal, codes and
    scales exactly equal in the zero-delta columns; then A re-drawn and B
    zeroed."""
    zero_cols = tuple(range(0, 256, 5))
    params = _int8_module_params(0, zero_cols=zero_cols)
    spec = dict(r=8, alpha=16.0, quantize="int8")
    want = jax_relora.merge_and_reinit({"m": params}, jax.random.PRNGKey(0),
                                       jax_relora.LoraSpec(**spec))["m"]
    jq, js = np.asarray(want["kernel_q"]), np.asarray(want["kernel_scale"])
    mod = _port_int8_module(params, relora.LoraSpec(**spec))
    relora.merge_and_reinit(mod, torch.Generator().manual_seed(0), relora.LoraSpec(**spec))
    q, s = mod.weight_q.numpy().T, mod.weight_scale.numpy()
    assert q.dtype == np.int8 and not (q == params["kernel_q"]).all(), "the merge moved the codes"
    step = np.maximum(s, js)
    assert (np.abs(q * s - jq * js) <= step * (1 + 1e-6)).all()
    assert (q == jq).mean() >= 0.999
    cols = list(zero_cols)
    np.testing.assert_array_equal(q[:, cols], params["kernel_q"][:, cols])
    np.testing.assert_array_equal(q[:, cols], jq[:, cols])
    np.testing.assert_array_equal(s[:, cols], js[:, cols])
    assert not mod.lora_b.any() and not torch.equal(mod.lora_a, torch.from_numpy(params["lora_a"]))


def test_int8_merge_zero_delta_is_a_fixed_point():
    """With B = 0 five merges leave the int8 base bit-exact
    (tests/test_quant.py's zero-delta fixed point)."""
    params = _int8_module_params(1)
    params["lora_b"][:] = 0.0
    spec = relora.LoraSpec(r=8, quantize="int8")
    mod = _port_int8_module(params, spec)
    for i in range(5):
        relora.merge_and_reinit(mod, torch.Generator().manual_seed(i), spec)
        mod.lora_b.data.zero_()
    np.testing.assert_array_equal(mod.weight_q.numpy().T, params["kernel_q"])
    np.testing.assert_array_equal(mod.weight_scale.numpy(), params["kernel_scale"])


# ---------------------------------------------------------------- warm start


def _write_bin(path, seed=0, extra=True):
    """An f32 HF-named llama pytorch_model.bin at TINY widths, drawn from a
    seed ("model." prefix, lm_head without it); with ``extra`` also a rotary
    buffer and an unmerged lora leaf, which the warm start ignores."""
    rng = np.random.default_rng(seed)
    h, i, L = TINY["hidden_size"], TINY["intermediate_size"], TINY["num_hidden_layers"]
    shapes = {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, h), "self_attn.v_proj": (h, h),
              "self_attn.o_proj": (h, h), "mlp.gate_proj": (i, h), "mlp.up_proj": (i, h),
              "mlp.down_proj": (h, i)}
    sd = {"model.embed_tokens.weight": rng.standard_normal((TINY["vocab_size"], h)) * 0.02,
          "model.norm.weight": 1 + 0.1 * rng.standard_normal(h),
          "lm_head.weight": rng.standard_normal((TINY["vocab_size"], h)) * 0.02}
    for layer in range(L):
        for name, shape in shapes.items():
            sd[f"model.layers.{layer}.{name}.weight"] = rng.standard_normal(shape) * 0.05
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"model.layers.{layer}.{norm}.weight"] = 1 + 0.1 * rng.standard_normal(h)
    if extra:
        sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(h // 4)
        sd["model.layers.0.self_attn.q_proj.lora_a"] = np.ones((h, 4))
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()},
               path / "pytorch_model.bin")
    return path


def _jax_model(quantize, fused=False):
    spec = jax_relora.LoraSpec(r=8, dropout=0.0, quantize=quantize, fused=fused)
    return JaxLlama(JaxModelConfig(**TINY), lora=spec, dtype=jnp.float32, scan_layers=True,
                    attention_impl="naive")


def _jax_grafted(model, bin_dir):
    params = jax_init_params(model, jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    sd = torch.load(bin_dir / "pytorch_model.bin", map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if "lora_" not in k and "rotary" not in k}
    return jax_graft(params, hf_to_params(sd, JaxModelConfig(**TINY), scan_layers=True))


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["dense", "int8"])
def test_warm_start_matches_jax_graft(tmp_path, quantize):
    """Every base parameter after load_warm_start equals the JAX
    graft_base_weights of the same pytorch_model.bin, bit for bit: codes and
    scales quantized on the fly from the f32 source; LoRA leaves keep their
    init."""
    bin_dir = _write_bin(tmp_path / "warm")
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, _jax_grafted(_jax_model(quantize),
                                                                           bin_dir)))
    model = LlamaForCausalLM(ModelConfig(**TINY), lora=relora.LoraSpec(r=8, quantize=quantize))
    init_params(model, torch.Generator().manual_seed(0))
    lora_before = {n: p.clone() for n, p in model.named_parameters() if relora.is_lora_name(n)}
    load_warm_start(model, str(bin_dir))
    got = model.state_dict()
    base = [n for n in got if not relora.is_lora_name(n)]
    assert set(base) == {n for n in want if not relora.is_lora_name(n)}
    for name in base:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    if quantize:
        assert got["layers.1.mlp.up_proj.weight_q"].abs().max() == 127
    for name, before in lora_before.items():
        assert torch.equal(got[name], before), name


def test_warm_start_refuses_mismatches_and_checkpoints(tmp_path):
    bin_dir = _write_bin(tmp_path / "warm", extra=False)
    sd = torch.load(bin_dir / "pytorch_model.bin", weights_only=True)
    model = LlamaForCausalLM(ModelConfig(**TINY), lora=relora.LoraSpec(r=8, quantize="int8"))
    bad = dict(sd)
    bad["model.layers.0.mlp.up_proj.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        graft_base_weights(model, bad)
    missing = {k: v for k, v in sd.items() if k != "model.norm.weight"}
    with pytest.raises(KeyError, match="norm.weight"):
        graft_base_weights(model, missing)
    (tmp_path / "ckpt" / "state").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        load_warm_start(model, str(tmp_path / "ckpt"))
    with pytest.raises(ValueError, match="pytorch_model.bin"):
        load_warm_start(model, str(tmp_path))


# ------------------------------------------------------------------ the slice


def _data_config(tmp_path):
    path = tmp_path / "data.json"
    path.write_text(json.dumps({"data_path": str(tmp_path / "unused"), "seq_length": 16}))
    return str(path)


def _jax_int8_run(batches, bin_dir, fused):
    """The JAX package's step over the grafted int8 model, merge and reset
    under the trainer's cadence rule; returns per-update losses, the grafted
    params and the params after every merge."""
    model = _jax_model("int8", fused)
    params = _jax_grafted(model, bin_dir)
    spec = model.lora
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
            state = state.replace(params=jax_relora.merge_and_reinit(state.params, jax.random.PRNGKey(u), spec))
            merged.append(jax.tree_util.tree_map(np.asarray, state.params))
            state = state.replace(opt_state=jax_optim.reset_optimizer_state(state.opt_state, mode="zero", ratio=1.0))
    return losses, jax.tree_util.tree_map(np.asarray, params), merged


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_trainer_fit_int8_warm_start_tracks_jax(tmp_path, monkeypatch, fused):
    """Trainer.fit with --quantize int8 --warmed_up_model DIR --lora_dropout 0
    (and --lora_fused true) against the JAX train step over the JAX graft of
    the same file, per update within 1e-4 over 6 updates with one merge and
    one reset.  The port's base comes from its own warm start (equal to the
    JAX graft); only the LoRA init and the merge's fresh A are carried over.
    The JAX side traced its Pallas kernel; the port ran its int8 twins."""
    monkeypatch.setenv("RELORA_TPU_PALLAS_QUANT", "1")
    spied = (jax_plm, "_forward") if fused else (jax_pqm, "_pallas_forward")
    traces = _count_calls(monkeypatch, *spied)
    jax.clear_caches()  # the kernel must trace anew for the spy to see it
    bin_dir = _write_bin(tmp_path / "warm")
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 128, (6, 2, 4, 1))
    batches = ((starts + np.arange(16)) % 128).astype(np.int32)  # learnable: i -> i+1
    want, params, merged_trees = _jax_int8_run(batches, bin_dir, fused)
    assert traces, f"the JAX train step traced {spied[1]}"

    cfg = TrainingConfig(megatron_dataset_config=_data_config(tmp_path), dtype="float32",
                         device="cpu", quantize="int8", warmed_up_model=str(bin_dir),
                         lora_fused="true" if fused else "false", **RECIPE).finalize()
    trainer = Trainer(cfg, model_cfg=ModelConfig(**TINY))
    assert trainer.lora_spec.quantize == "int8" and trainer.lora_spec.fused is fused
    grafted = params_from_jax(params)
    sd = trainer.model.state_dict()
    for name in (n for n in sd if n.endswith(("weight_q", "weight_scale"))):
        assert torch.equal(sd[name], grafted[name]), name
    trainer.model.load_state_dict({n: v for n, v in grafted.items() if relora.is_lora_name(n)},
                                  strict=False)
    queue = []
    for tree in merged_trees:
        after = params_from_jax(tree)
        queue.extend(after[f"{name}.lora_a"] for name, _ in relora.lora_modules(trainer.model))
    monkeypatch.setattr(relora, "kaiming_uniform", lambda shape, generator, device: queue.pop(0))
    twin = (LM, "fused_lora_int8_bwd_dx_plain") if fused else (QM, "dequant_matmul_plain")
    calls = _count_calls(monkeypatch, *twin)
    result = trainer.fit(iter(batches))

    got = [r["loss"] for r in result["records"]]
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)
    assert not queue, "every merge took the JAX draw"
    per_update = 7 * TINY["num_hidden_layers"] * 2
    assert len(calls) == per_update * 6
    assert (result["n_lora_restarts"], result["n_optimizer_resets"]) == (1, 1)
    final = trainer.model.state_dict()
    after = params_from_jax(merged_trees[-1])
    for name in PROJ:
        q = final[f"layers.0.{name}.weight_q"]
        assert q.dtype == torch.int8 and not torch.equal(q, grafted[f"layers.0.{name}.weight_q"])
        assert (q == after[f"layers.0.{name}.weight_q"]).float().mean() >= 0.999
    assert got[-1] < got[0]


def test_warm_start_counters_set_the_schedule_origin(tmp_path):
    """training_state.json beside the weights: the trainer starts at its
    update_step, global_step and tokens_seen, and the schedule restarts
    there with a fresh warmup (relora_tpu/train/trainer.py:311-319)."""
    bin_dir = _write_bin(tmp_path / "warm", extra=False)
    (bin_dir / "training_state.json").write_text(
        json.dumps({"update_step": 3, "global_step": 6, "tokens_seen": 384}))
    cfg = TrainingConfig(megatron_dataset_config=_data_config(tmp_path), dtype="float32",
                         device="cpu", quantize="int8", warmed_up_model=str(bin_dir),
                         **{**RECIPE, "num_training_steps": 9}).finalize()
    trainer = Trainer(cfg, model_cfg=ModelConfig(**TINY))
    assert (trainer.update_step, trainer.global_step, trainer.tokens_seen) == (3, 6, 384)
    assert trainer.scheduler_start_step == 3
    batches = np.random.default_rng(1).integers(0, 128, (6, 2, 4, 16))
    result = trainer.fit(iter(batches))
    assert result["update_step"] == 9 and result["records"][0]["lr"] == 0.0
    assert result["n_lora_restarts"] == 1  # at update 7: (7 - 3) % 3 == 1
