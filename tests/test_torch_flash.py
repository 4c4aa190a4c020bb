"""The port's flash attention (forward and both backward twins) against the
JAX package's training attention arms.

On the CPU the flash wrappers run their plain twins: the forward twin, the
dK/dV twin and the dQ twin, the backward from the saved log-sum-exp (the
CUDA kernels run only on the card, where ``chip_smoke.py`` holds them to
these twins).  Here ``FlashAttention`` and its gradients are held to the JAX
package's ``dot_product_attention(impl="naive")`` and ``impl="xla"`` and
their ``jax.vjp``, on the same numpy inputs, at f32.  Tolerance 1e-5: both
sides compute in f32 and sum in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relora_tpu.ops.attention import dot_product_attention as jax_attention
from relora_tpu_torch.ops import flash_attention as FA
from relora_tpu_torch.ops.attention import dot_product_attention
from relora_tpu_torch.ops.attention_dispatch import choose_training_arm

pytestmark = pytest.mark.torch_port

TOL = 1e-5


def _inputs(S, N, n_kv, H, seed=0, B=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, N, H)).astype(np.float32)
    k = rng.standard_normal((B, S, n_kv, H)).astype(np.float32)
    v = rng.standard_normal((B, S, n_kv, H)).astype(np.float32)
    dout = rng.standard_normal((B, S, N, H)).astype(np.float32)
    return q, k, v, dout


@functools.partial(jax.jit, static_argnums=0)
def _jax_vjp(impl, q, k, v, dout):
    fn = lambda a, b, c: jax_attention(a, b, c, causal=True, impl=impl)
    out, vjp = jax.vjp(fn, q, k, v)
    return (out, *vjp(dout))


def _jax_with_vjp(impl, q, k, v, dout):
    return [np.asarray(x) for x in _jax_vjp(impl, *(jnp.asarray(a) for a in (q, k, v, dout)))]


def _torch_with_grads(q, k, v, dout):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = FA.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    return [x.detach().numpy() for x in (out, *grads)]


@pytest.mark.parametrize("impl", ["naive", "xla"])
@pytest.mark.parametrize("H", [16, 48])
@pytest.mark.parametrize("n_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("S", [8, 40, 128])
def test_flash_twins_match_jax(S, n_kv, H, impl):
    """out, dq, dk, dv through FlashAttention's twins vs the JAX arm + vjp."""
    q, k, v, dout = _inputs(S, 4, n_kv, H, seed=S + H + n_kv)
    want = _jax_with_vjp(impl, q, k, v, dout)
    got = _torch_with_grads(q, k, v, dout)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=name)


def test_twins_individually_match_naive_autograd():
    """Each twin on its own: forward (out, lse), dK/dV and dQ from the saved
    lse against autograd through the port's naive arm."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(40, 4, 2, 16, seed=3))
    scale = 16**-0.5
    out, lse = FA.flash_attention_forward_plain(q, k, v, scale)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(2, 40, 2, 2, 16), k) * scale
    logits = logits.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(), float("-inf"))
    np.testing.assert_allclose(
        lse.numpy(), torch.logsumexp(logits, -1).reshape(2, 4, 40).numpy(), atol=TOL, rtol=0
    )
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = dot_product_attention(*leaves, impl="naive")
    dq, dk, dv = torch.autograd.grad(ref, leaves, dout)
    delta = FA.flash_attention_delta(out, dout)
    dk2, dv2 = FA.flash_attention_bwd_dkdv_plain(q, k, v, dout, lse, delta, scale)
    dq2 = FA.flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, scale)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), atol=TOL, rtol=0)
    for got, want in ((dq2, dq), (dk2, dk), (dv2, dv)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)


def test_cpu_takes_twins_and_counts_no_launch():
    """CPU tensors run the twins: no kernel launch is counted, and auto
    resolves to the naive arm on the CPU."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(8, 4, 4, 16))
    counters = (FA.flash_attention_forward, FA.flash_attention_bwd_dkdv, FA.flash_attention_bwd_dq)
    before = [c.launches for c in counters]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(dot_product_attention(*leaves, impl="flash"), leaves, dout)
    assert [c.launches for c in counters] == before
    assert choose_training_arm(q) == "naive"
    np.testing.assert_allclose(
        dot_product_attention(q, k, v, impl="auto").numpy(),
        dot_product_attention(q, k, v, impl="flash").numpy(), atol=TOL, rtol=0,
    )


@pytest.mark.parametrize("wrapper", ["forward", "bwd_dkdv", "bwd_dq"])
def test_non_cpu_tensor_never_takes_the_twin(wrapper):
    """A tensor on any device but the CPU goes to the kernel path, which
    refuses what is not a CUDA tensor before touching the library."""
    q, k, v, dout = (torch.from_numpy(x).to("meta") for x in _inputs(8, 4, 4, 16))
    rows = torch.empty((2, 4, 8), device="meta")
    args = (q, k, v) if wrapper == "forward" else (q, k, v, dout, rows, rows)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(FA, f"flash_attention_{wrapper}")(*args)
