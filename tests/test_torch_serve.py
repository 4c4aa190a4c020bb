"""The PyTorch port's schedulers against the JAX package's, end to end.

Greedy drains through the port's ``PagedContinuousBatchingScheduler``,
sequential and packed, must be token-identical to ``relora_tpu``'s on the
same weights (the ``tests/test_packed.py`` request mix, greedy rows only:
torch and JAX draw different random bits, so sampled rows are compared by
distribution instead).  Also: the port's filtered sampling distribution
equals the JAX one, a sampled stream does not depend on what shares its
batch, and no module of the port imports JAX or the JAX package.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relora_tpu.serve.engine import InferenceEngine as JaxEngine
from relora_tpu.serve.sampling import top_k_mask as jax_top_k_mask, top_p_mask as jax_top_p_mask
from relora_tpu.serve.scheduler import (
    PagedContinuousBatchingScheduler as JaxScheduler,
    Request as JaxRequest,
)
from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.serve.engine import InferenceEngine
from relora_tpu_torch.serve.sampling import filtered_probs
from relora_tpu_torch.serve.scheduler import PagedContinuousBatchingScheduler, Request
from tests.test_torch_llama import CACHE, CHUNK, PAGE, TINY, jax_params

pytestmark = pytest.mark.torch_port

MAX_BATCH = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    params = jax_params()
    kw = dict(
        cache_size=CACHE, page_size=PAGE, num_pages=3 * (CACHE // PAGE) + 1,
        chunk_size=CHUNK, token_budget=MAX_BATCH + CHUNK,
    )
    jx = JaxEngine(JaxModelConfig(**TINY), params, **kw)
    pt = InferenceEngine(ModelConfig(**TINY), params_from_jax(params), device="cpu", **kw)
    return jx, pt


def greedy_mix():
    """Page-straddling and multi-chunk prompts staggered through two slots,
    with uid 4 likely to hit EOS (id 9)."""
    rng = np.random.default_rng(11)
    return [
        (uid, rng.integers(1, 256, L).tolist(), new)
        for uid, L, new in ((1, 13, 6), (2, 5, 9), (3, 21, 4), (4, 3, 7), (5, 16, 5))
    ]


def jax_drain(engine, mix, packed):
    sched = JaxScheduler(engine, max_batch=MAX_BATCH, eos_id=9,
                         key=jax.random.PRNGKey(42), packed=packed)
    done = sched.run([JaxRequest(uid=u, prompt=p, max_new_tokens=n) for u, p, n in mix])
    return {uid: c.tokens for uid, c in done.items()}


def torch_drain(engine, requests, packed, prefix_cache=True):
    sched = PagedContinuousBatchingScheduler(
        engine, max_batch=MAX_BATCH, eos_id=9, seed=42, packed=packed,
        prefix_cache=prefix_cache,
    )
    done = sched.run(requests)
    if prefix_cache:
        sched.prefix_cache.clear()
    assert sched.allocator.used_pages == 0  # every page came back
    return {uid: c.tokens for uid, c in done.items()}


@pytest.mark.parametrize("packed", [False, True], ids=["paged", "packed"])
def test_greedy_drain_token_identical_to_jax(pair, packed):
    jx, pt = pair
    mix = greedy_mix()
    want = jax_drain(jx, mix, packed)
    got = torch_drain(pt, [Request(uid=u, prompt=p, max_new_tokens=n) for u, p, n in mix], packed)
    assert got == want
    assert sorted(got) == [1, 2, 3, 4, 5]


def test_packed_and_sequential_drains_agree(pair):
    """Packing changes the dispatch, not the tokens, sampled rows included."""
    _, pt = pair
    rng = np.random.default_rng(3)
    reqs = [
        Request(uid=1, prompt=rng.integers(1, 256, 13).tolist(), max_new_tokens=6),
        Request(uid=2, prompt=rng.integers(1, 256, 5).tolist(), max_new_tokens=9,
                temperature=0.8, top_p=0.9),
        Request(uid=3, prompt=rng.integers(1, 256, 21).tolist(), max_new_tokens=4,
                temperature=1.1),
    ]
    assert torch_drain(pt, reqs, packed=True) == torch_drain(pt, reqs, packed=False)


@pytest.mark.parametrize("top_k,top_p,temperature", [(0, 1.0, 1.0), (20, 0.9, 0.7), (5, 0.5, 1.3)])
def test_filtered_distribution_matches_jax(top_k, top_p, temperature):
    logits = np.random.default_rng(top_k).standard_normal((4, 256)).astype(np.float32) * 3
    filtered = jax_top_p_mask(jax_top_k_mask(jnp.asarray(logits), top_k), jnp.full((4,), top_p))
    want = np.asarray(jax.nn.softmax(filtered / temperature, axis=-1))
    got = filtered_probs(
        torch.from_numpy(logits), temperature=temperature, top_k=top_k, top_p=top_p
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_sampled_stream_is_batch_independent(pair):
    """A sampled request draws the same tokens alone and crowded."""
    _, pt = pair
    probe = Request(uid=7, prompt=[7, 3, 11, 5, 2, 13, 1], max_new_tokens=8,
                    temperature=1.0, top_p=0.95)
    solo = torch_drain(pt, [probe], packed=True, prefix_cache=False)
    rng = np.random.default_rng(5)
    crowd = [
        Request(uid=2, prompt=rng.integers(1, 256, 4).tolist(), max_new_tokens=9,
                temperature=0.9),
        probe,
        Request(uid=3, prompt=rng.integers(1, 256, 19).tolist(), max_new_tokens=5),
    ]
    for packed in (True, False):
        crowded = torch_drain(pt, crowd, packed=packed, prefix_cache=False)
        assert crowded[7] == solo[7]


def test_port_imports_no_jax():
    """No source line of the port or chip_smoke.py imports jax, flax or
    relora_tpu, and importing every module loads none of them."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|relora_tpu)\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(root, name)
        for root, _, names in os.walk(os.path.join(REPO, "relora_tpu_torch"))
        for name in names
        if name.endswith(".py")
    ]
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path
    code = (
        "import importlib, pkgutil, sys\n"
        "import relora_tpu_torch\n"
        "for m in pkgutil.walk_packages(relora_tpu_torch.__path__, 'relora_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'relora_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('relora_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 10
