"""The PyTorch port's paged engine against the JAX engine, logits per step.

JAX weights from ``init_params`` cross into the port through
``params_from_jax``; both engines then run the same sequence of paged steps
(two chunked prefills, a decode step, a packed step) from zero pools, at f32
on the CPU, and every step's logits must agree within 1e-4 — bf16-free f32
math summed in a different order by two frameworks.  The int8 pool runs the
same sequence: its running-max scale updates must match step for step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.models.params_util import init_params as jax_init_params, unstack_layers
from relora_tpu.serve.engine import InferenceEngine as JaxEngine, build_decode_model as jax_build
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.models.params_util import init_params
from relora_tpu_torch.serve.engine import InferenceEngine, build_decode_model

pytestmark = pytest.mark.torch_port

TINY = dict(
    family="llama",
    vocab_size=256,
    hidden_size=64,
    intermediate_size=160,
    num_hidden_layers=2,
    num_attention_heads=4,
    max_sequence_length=64,
)
CACHE, PAGE, CHUNK = 32, 8, 8
TOL = 1e-4


def jax_params(cfg=JaxModelConfig(**TINY)):
    model = jax_build(cfg, cache_size=CACHE)
    base = type(model)(cfg, dtype=jnp.float32, scan_layers=True)
    params = jax_init_params(base, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params)


def engines(kv_dtype, params, cfg_kwargs=TINY):
    kw = dict(
        cache_size=CACHE, page_size=PAGE, num_pages=3 * (CACHE // PAGE) + 1,
        chunk_size=CHUNK, kv_dtype=kv_dtype, token_budget=2 + CHUNK,
    )
    jx = JaxEngine(JaxModelConfig(**cfg_kwargs), params, **kw)
    pt = InferenceEngine(ModelConfig(**cfg_kwargs), params_from_jax(params), device="cpu", **kw)
    return jx, pt


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_steps_match_jax(kv_dtype):
    """prefill_chunk, decode_paged and step_paged logits agree at f32."""
    params = jax_params()
    jx, pt = engines(kv_dtype, params)
    rng = np.random.default_rng(0)
    prompt_a = rng.integers(1, 256, 11).astype(np.int32)
    prompt_b = rng.integers(1, 256, 5).astype(np.int32)
    W = CACHE // PAGE
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jpool, ppool = jx.init_pool(), pt.init_pool()

    def chunk(prompt, start, row):
        ids = np.zeros((1, CHUNK), np.int32)
        part = prompt[start : start + CHUNK]
        ids[0, : len(part)] = part
        return ids, tables[row : row + 1]

    for prompt, start, row in ((prompt_a, 0, 0), (prompt_a, 8, 0), (prompt_b, 0, 1)):
        ids, table = chunk(prompt, start, row)
        jl, jpool = jx.prefill_chunk(jnp.asarray(ids), start, jpool, table)
        pl, ppool = pt.prefill_chunk(ids, start, ppool, table)
        _close(pl, jl)

    token = np.array([[17], [42]], np.int32)
    pos = np.array([[11], [5]], np.int32)
    jl, jpool = jx.decode_paged(jpool, jnp.asarray(token), pos, tables)
    pl, ppool = pt.decode_paged(ppool, token, pos, tables)
    assert pl.shape == (2, 256)
    _close(pl, jl)

    # packed: both rows decode one token, pad tokens ride the null row
    ptables = np.zeros((3, W + 1), np.int32)
    ptables[:2, :W] = tables
    ids = np.array([[3, 9, 0, 0, 0, 0, 0, 0]], np.int32)
    positions = np.array([[12, 6] + [CACHE] * 6], np.int32)
    row_map = np.array([0, 1] + [2] * 6, np.int32)
    jl, jpool = jx.step_paged(jpool, jnp.asarray(ids), positions, ptables, row_map)
    pl, ppool = pt.step_paged(ppool, ids, positions, ptables, row_map)
    _close(pl[:, :2], jl[:, :2])
    assert np.isfinite(pl.numpy()).all()

    if kv_dtype == "int8":
        # the pools themselves agree: codes exactly (bar a rare rounding
        # tie), scales to f32 precision, on every live page
        jk = np.asarray(jpool["layers"]["self_attn"]["k"])[0]
        jks = np.asarray(jpool["layers"]["self_attn"]["k_scale"])[0]
        live = tables.reshape(-1)
        np.testing.assert_allclose(ppool[0]["k_scale"][live].numpy(), jks[live], rtol=1e-5)
        codes_diff = np.abs(ppool[0]["k"][live].numpy().astype(int) - jk[live].astype(int))
        assert codes_diff.max() <= 1 and (codes_diff > 0).mean() < 0.01


def test_unrolled_layout_converts_like_scanned():
    params = jax_params()
    scanned = params_from_jax(params)
    unrolled = params_from_jax(unstack_layers(params))
    assert scanned.keys() == unrolled.keys()
    for name in scanned:
        assert torch.equal(scanned[name], unrolled[name]), name
    model = build_decode_model(ModelConfig(**TINY), device="cpu")
    model.load_state_dict(scanned)  # strict: names and shapes match the port


def test_init_params_draws_the_reference_initializers():
    cfg = ModelConfig(**TINY)
    model = init_params(build_decode_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    again = init_params(build_decode_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    for (name, p), (_, p2) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(p, p2), name
        if name.endswith("norm.weight"):
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            assert abs(p.std().item() - cfg.initializer_range) < 0.1 * cfg.initializer_range, name
