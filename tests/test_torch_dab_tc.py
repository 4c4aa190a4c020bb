"""Kernel 7's tensor-core design (the fused LoRA dA/dB) evaluated on the CPU.

The CUDA path (``csrc/lora_matmul.cu``: ``dab_split_kernel``,
``dab_tc_kernel``, ``lora_dab_reduce_kernel``) runs only on the card, where
``chip_smoke.py`` holds it to ``fused_lora_bwd_dab_plain``.  Here its
arithmetic is evaluated in torch on the CPU: u and z split into hi =
bf16(v) and lo = bf16(v - hi), each chunk of :func:`dab_chunks` (from M
alone) contracted against both halves, the partials summed in chunk order,
then scaled by s.  That evaluation is held to the plain twin and to the JAX
package's ``_backward_dab`` Pallas kernel run in interpret mode, on the same
numpy inputs.  x and g are bf16 values (the path's operands are bf16, so
they enter the products exactly).  Tolerance: 1e-5 of ``max(1, max|want|)``:
the halves carry u and z to 2^-17 of their value, and the sums run in f32 in
another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import relora_tpu.ops.pallas_lora_matmul as jax_plm
from relora_tpu_torch.ops import lora_matmul as LM

pytestmark = pytest.mark.torch_port

TOL = 1e-5
S = 0.25


def _operands(M, K, N, r, seed):
    """x (M, K) and g (M, N) bf16 values as f32; z (M, r) f32; B (r, N)."""
    rng = np.random.default_rng(seed)
    bf16 = lambda shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float()
    x, g = bf16((M, K)), bf16((M, N))
    z = torch.from_numpy(rng.standard_normal((M, r)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal((r, N))).astype(np.float32))
    return x, g, z, b


def _halves(v):
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _design(g, x, z, u, s):
    """The bf16 path's arithmetic: per chunk, L^T hi + L^T lo (dA: L = x, R =
    u; dB^T: L = g, R = z), the chunks summed in order, then times s."""
    (uh, ul), (zh, zl) = _halves(u), _halves(z)
    da = torch.zeros((x.shape[1], u.shape[1]))
    dbt = torch.zeros((g.shape[1], z.shape[1]))
    for m0, m1 in LM.dab_chunks(x.shape[0]):
        xs, gs = x[m0:m1].t(), g[m0:m1].t()
        da = da + (xs @ uh[m0:m1] + xs @ ul[m0:m1])
        dbt = dbt + (gs @ zh[m0:m1] + gs @ zl[m0:m1])
    return da * s, dbt.t() * s


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.mark.parametrize("M", [1, 511, 512, 513, 1100, 4096])
def test_chunks_cover_every_row_once_from_M_alone(M):
    """The M-chunk schedule covers rows 0..M-1 once, in order, in chunks of
    DAB_CHUNK rows (the last one ragged), and takes nothing but M."""
    import inspect

    assert list(inspect.signature(LM.dab_chunks).parameters) == ["M"]
    chunks = LM.dab_chunks(M)
    assert [m for m0, m1 in chunks for m in range(m0, m1)] == list(range(M))
    assert all(m1 - m0 == LM.DAB_CHUNK for m0, m1 in chunks[:-1])
    assert 0 < chunks[-1][1] - chunks[-1][0] <= LM.DAB_CHUNK
    assert len(chunks) == -(-M // LM.DAB_CHUNK)


def test_halves_carry_the_value_to_2_pow_minus_17():
    """hi + lo is v to within 2^-17 of |v| (one bf16 would be 2^-9)."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32)) * 37.0
    hi, lo = _halves(v)
    assert torch.all((hi + lo - v).abs() <= 2.0**-17 * v.abs())
    assert (hi - v).abs().max() > 2.0**-12 * v.abs().max()  # one half alone is not enough


# (M, K, N, r, JAX block rows): a ragged M over three chunks, M below one
# chunk, and a rank past 256
CASES = {
    "ragged_M_three_chunks": (1100, 48, 40, 16, 100),
    "M_below_one_chunk": (72, 32, 24, 8, 72),
    "rank_320": (600, 32, 24, 320, 200),
}


@pytest.mark.parametrize("case", list(CASES))
def test_design_matches_twin_and_jax_interpret_kernel(case):
    """The split-and-chunk evaluation against fused_lora_bwd_dab_plain (with
    u from dx, and computing it) and JAX's _backward_dab (interpret)."""
    M, K, N, r, bm = CASES[case]
    x, g, z, b = _operands(M, K, N, r, seed=M + r)
    u = g @ b.t()
    da, db = _design(g, x, z, u, S)
    for twin in (LM.fused_lora_bwd_dab_plain(g, x, z, b, S, u), LM.fused_lora_bwd_dab_plain(g, x, z, b, S)):
        _close(da, twin[0], "dA vs twin")
        _close(db, twin[1], "dB vs twin")
    jda, jdb = jax_plm._backward_dab(bm, True, jnp.asarray(g.numpy()), jnp.asarray(x.numpy()),
                                     jnp.asarray(z.numpy()), jnp.asarray(b.numpy()),
                                     jnp.full((1, 1), S, jnp.float32))
    _close(da, jda, "dA vs JAX")
    _close(db, jdb, "dB vs JAX")
    # the CPU wrapper runs the twin and counts no launch of either path
    before = (LM.fused_lora_bwd_dab.launches, LM.fused_lora_bwd_dab.tc_launches)
    got = LM.fused_lora_bwd_dab(g, x, z, b, S, u)
    _close(got[0], da, "wrapper dA")
    assert (LM.fused_lora_bwd_dab.launches, LM.fused_lora_bwd_dab.tc_launches) == before


# (dtype, K, N, r, aligned) -> path: forward_path's rule with no base
DAB_PATHS = {
    "bf16_llama_250m": (torch.bfloat16, 768, 2560, 128, True, "tc"),
    "bf16_ragged_multiples_of_8": (torch.bfloat16, 72, 104, 8, True, "tc"),
    "bf16_rank_320": (torch.bfloat16, 768, 768, 320, True, "tc"),
    "f32": (torch.float32, 768, 768, 128, True, "fma"),
    "bf16_N_100": (torch.bfloat16, 72, 100, 8, True, "fma"),
    "bf16_r_4": (torch.bfloat16, 768, 768, 4, True, "fma"),
    "bf16_unaligned": (torch.bfloat16, 768, 768, 128, False, "fma"),
}


@pytest.mark.parametrize("case", list(DAB_PATHS))
def test_dab_path_rule(case):
    dtype, K, N, r, aligned, want = DAB_PATHS[case]
    assert LM.dab_path(dtype, K, N, r, aligned) == want
