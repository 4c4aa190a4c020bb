"""Kernel 3 past head_dim 128: the flash twins at H = 256 against JAX, and
the wrappers' head-dim check.

Pythia-1B (hidden 2048, 8 heads) and Llama configs with 256-wide heads train
through kernel 3 on the card, whose wide kernels (bf16: Q's fragments read
from shared memory at each key tile, a two-pass dK/dV; f32: 32-row tiles)
``chip_smoke.py`` holds to these twins.  Here ``FlashAttention``'s twins and
their gradients at H = 256 are held to the JAX package's
``dot_product_attention`` (``impl="naive"``) and its ``jax.vjp`` on the same
numpy inputs, at f32, and each twin on its own (forward, dK/dV, dQ from the
saved log-sum-exp) to autograd through the port's naive arm.  Tolerance
1e-5: f32 on both sides, sums in another order.
"""

import numpy as np
import pytest
import torch

from relora_tpu.ops.attention import dot_product_attention as jax_attention
from relora_tpu_torch.ops import flash_attention as FA
from relora_tpu_torch.ops.attention import dot_product_attention

pytestmark = pytest.mark.torch_port

TOL = 1e-5
H = 256


def _inputs(S, N, n_kv, seed, B=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, N, H)).astype(np.float32)
    k = rng.standard_normal((B, S, n_kv, H)).astype(np.float32)
    v = rng.standard_normal((B, S, n_kv, H)).astype(np.float32)
    dout = rng.standard_normal((B, S, N, H)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("N,n_kv", [(2, 2), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("S", [8, 40])
def test_flash_twins_match_jax_at_head_dim_256(S, N, n_kv):
    """out, dq, dk, dv through FlashAttention's twins vs the JAX naive arm
    and its vjp."""
    import jax
    import jax.numpy as jnp

    q, k, v, dout = _inputs(S, N, n_kv, seed=S + N)
    fn = lambda a, b, c: jax_attention(a, b, c, causal=True, impl="naive")
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(x) for x in (out, *vjp(jnp.asarray(dout)))]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got_out = FA.flash_attention(*leaves)
    grads = torch.autograd.grad(got_out, leaves, torch.from_numpy(dout))
    got = [x.detach().numpy() for x in (got_out, *grads)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=name)


def test_twins_individually_match_naive_autograd_at_head_dim_256():
    """The forward twin (out, lse), the dK/dV twin and the dQ twin from the
    saved lse, each against autograd through the port's naive arm."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(24, 4, 2, seed=7))
    scale = H**-0.5
    out, lse = FA.flash_attention_forward_plain(q, k, v, scale)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = dot_product_attention(*leaves, impl="naive")
    dq, dk, dv = torch.autograd.grad(ref, leaves, dout)
    delta = FA.flash_attention_delta(out, dout)
    dk2, dv2 = FA.flash_attention_bwd_dkdv_plain(q, k, v, dout, lse, delta, scale)
    dq2 = FA.flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, scale)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), atol=TOL, rtol=0)
    for got, want in ((dq2, dq), (dk2, dk), (dv2, dv)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("head_dim,ok", [(2, True), (48, True), (128, True), (130, True),
                                         (250, True), (256, True), (258, False), (512, False),
                                         (49, False), (0, False)])
def test_head_dim_check_admits_even_widths_to_256(head_dim, ok):
    """The wrappers take every even head_dim up to 256 and refuse the rest
    before any pointer is passed."""
    assert FA.MAX_HEAD_DIM == 256
    if ok:
        FA.check_head_dim(head_dim)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            FA.check_head_dim(head_dim)
