"""The LoRA cost model and ``--lora_fused auto``, against the JAX package, on
the CPU.

- Under the reference's constants (``lora_dispatch.V5E``) the port's
  ``estimate_arm_times``, ``estimate_grouped_arm_times``, ``choose_arm`` and
  ``choose_grouped_arm`` equal ``relora_tpu.ops.lora_dispatch``'s exactly
  over a grid of shapes, byte widths and ``weights_static``, and reproduce
  the regimes of ``tests/test_lora_kernels.py::test_choose_arm_regimes``.
  Where the JAX package's ``plan_blocks`` finds no tiling it strikes the
  fused arm (and for an N with no lane divisor the grouped kernel arms); the
  port's kernels mask ragged tiles, so there the two are compared with the
  port's arm struck too (``fused_available=False``, ``grouped_available=False``).
- ``LoRALinear(fused="auto")`` output and gradients equal the JAX
  ``LoRALinear``'s with the same parameters at f32 within 1e-5 of
  ``max(1, max|JAX value|)`` (``tests/test_torch_quant.py``'s tolerance),
  over a dense and an int8 base, with and without dropout: with dropout
  active, training takes the historical path and eval the dispatcher.
- A single-tenant unmerged (``--no-merge``) greedy drain, sequential and
  packed, over a dense and an int8 base, is token-identical to the JAX
  scheduler's over the same parameters; the CLI serves a checkpoint so.
- The H100 model's picks at the slice's shapes rank as ``chip_smoke.py``'s
  auto-arms phase measured them on the card.
"""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta as flax_meta

import relora_tpu.ops.lora_dispatch as jd
from relora_tpu.config.model import ModelConfig as JaxModelConfig
from relora_tpu.core.relora import LoraSpec as JaxLoraSpec
from relora_tpu.models.lora import LoRALinear as JaxLoRALinear
from relora_tpu.models.params_util import init_params as jax_init_params
from relora_tpu.ops.quant import quantize_int8 as jax_quantize_int8
from relora_tpu.serve.engine import InferenceEngine as JaxEngine, build_decode_model as jax_build
from relora_tpu.serve.scheduler import (
    PagedContinuousBatchingScheduler as JaxScheduler,
    Request as JaxRequest,
)
from relora_tpu_torch import serve_cli
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.core import relora
from relora_tpu_torch.models.convert import params_from_jax
from relora_tpu_torch.models.lora import LoRALinear
from relora_tpu_torch.ops import lora_dispatch as pd
from relora_tpu_torch.serve.engine import InferenceEngine
from relora_tpu_torch.serve.scheduler import PagedContinuousBatchingScheduler, Request
from relora_tpu_torch.train import checkpoint as ckpt
from tests.test_torch_llama import TINY

pytestmark = pytest.mark.torch_port

TOL = 1e-5
V5E = pd.V5E
WIDTHS = (100, 128, 768, 2048, 2560, 8192)
RANKS = (8, 128, 320)
BYTES = ((2, 2), (2, 1), (4, 4), (4, 1), (2, 4))  # (act_bytes, base_bytes)


# -- the cost model under the reference's constants ----------------------------


@pytest.mark.parametrize("weights_static", [False, True], ids=["training", "static"])
@pytest.mark.parametrize("M", [1, 7, 8, 40, 64, 72, 512, 4096, 65536])
def test_arm_model_equals_jax_under_the_reference_constants(M, weights_static):
    for K, N, r, (act, base) in itertools.product(WIDTHS, WIDTHS, RANKS, BYTES):
        args = (M, K, N, r, act, base)
        want = jd.estimate_arm_times(*args, weights_static)
        assert pd.estimate_arm_times(*args, weights_static, roofline=V5E) == want, args
        tiles = jd.plan_blocks(M, N) is not None
        for available in (True, False):
            pick = jd.choose_arm(*args, fused_available=available, weights_static=weights_static)
            got = pd.choose_arm(*args, fused_available=available and tiles,
                                weights_static=weights_static, roofline=V5E)
            assert got == pick, (args, available)
        assert pd.choose_arm(*args, weights_static=weights_static, allow=("merged", "ordered"),
                             roofline=V5E) == jd.choose_arm(
            *args, weights_static=weights_static, allow=("merged", "ordered"))


@pytest.mark.parametrize("M", [1, 8, 40, 72, 512])
def test_grouped_model_equals_jax_under_the_reference_constants(M):
    for K, N, r, G, (act, base) in itertools.product(WIDTHS[:4], WIDTHS[:4], RANKS[:2], (1, 3, 8),
                                                     BYTES[:3]):
        args = (M, K, N, r, G, act, base)
        assert pd.estimate_grouped_arm_times(*args, roofline=V5E) == jd.estimate_grouped_arm_times(*args)
        lanes = any(N % c == 0 for c in jd.BLOCK_N_CANDIDATES)
        for available in (True, False):
            pick = jd.choose_grouped_arm(*args, grouped_available=available)
            assert pd.choose_grouped_arm(*args, grouped_available=available and lanes,
                                         roofline=V5E) == pick, (args, available)


# tests/test_lora_kernels.py::test_choose_arm_regimes, case by case; the
# untileable M = 7 is struck by plan_blocks there and by fused_available here
REGIMES = {
    "decode_static_merged": (dict(M=8, K=2048, N=2048, r=128, weights_static=True), {}, "merged"),
    "training_fused": (dict(M=512, K=2048, N=2048, r=128), {}, "fused"),
    "very_large_m_merged": (dict(M=65536, K=2048, N=2048, r=128), {}, "merged"),
    "no_fused_backend": (dict(M=512, K=2048, N=2048, r=128, fused_available=False), {}, "!fused"),
    "untileable": (dict(M=7, K=2048, N=2048, r=128), dict(fused_available=False), "!fused"),
    "allow_restricts": (dict(M=512, K=2048, N=2048, r=128, allow=("ordered",)), {}, "ordered"),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_choose_arm_regimes_of_the_reference(regime):
    kw, port_kw, want = REGIMES[regime]
    pick = jd.choose_arm(**kw)
    got = pd.choose_arm(**{**kw, **port_kw}, roofline=V5E)
    assert got == pick
    assert (got != want[1:]) if want.startswith("!") else (got == want)


def test_auto_picks_no_kernel_arm_on_the_cpu_and_costs_the_backward(monkeypatch):
    """A CPU tensor never takes the fused or grouped kernel arm under auto;
    the model is asked with backward=True exactly when autograd will run."""
    asked = []
    real = pd.choose_arm

    def spy(*args, **kwargs):
        asked.append((kwargs["fused_available"], kwargs["backward"], kwargs["weights_static"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(pd, "choose_arm", spy)
    rng = np.random.default_rng(0)
    x, w, a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((64, 32), (32, 48), (32, 4), (4, 48)))
    a.requires_grad_()
    y = pd.lora_matmul(x, w, a, b, 0.5)
    y.sum().backward()
    with torch.no_grad():
        pd.lora_matmul(x, w, a, b, 0.5, weights_static=True)
    assert asked == [(False, True, False), (False, False, True)]
    assert a.grad is not None
    times = pd.estimate_arm_times(4096, 768, 768, 128, backward=True)
    assert all(t > f for t, f in zip(times.values(), pd.estimate_arm_times(4096, 768, 768, 128).values()))
    assert pd.choose_grouped_arm(8, 768, 768, 128, 4, grouped_available=False) == "gathered"
    assert pd.choose_grouped_arm(8, 768, 768, 128, 4) in ("grouped", "looped")


# -- LoRALinear(fused="auto") against the JAX module ---------------------------


def _close(got, want, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, atol=TOL * max(1.0, float(np.abs(want).max())), rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("quantize", [None, "int8"], ids=["dense", "int8"])
def test_lora_linear_auto_matches_jax(quantize, dropout, monkeypatch):
    spec = dict(r=8, alpha=16.0, dropout=dropout, quantize=quantize, fused="auto")
    jmod = JaxLoRALinear(features=128, lora=JaxLoraSpec(**spec), dtype=jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, flax_meta.unbox(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    w = (rng.standard_normal((64, 128)) * 0.05).astype(np.float32)
    if quantize:
        params["kernel_q"], params["kernel_scale"] = (np.asarray(v) for v in jax_quantize_int8(w))
    else:
        params["kernel"] = w
    params["lora_b"] = rng.standard_normal(params["lora_b"].shape).astype(np.float32)
    cot = rng.standard_normal((4, 16, 128)).astype(np.float32)
    y, vjp = jax.vjp(lambda p, xx: jmod.apply({"params": p}, xx, deterministic=True),
                     jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))

    mod = LoRALinear(64, 128, lora=relora.LoraSpec(**spec), dtype=torch.float32)
    with torch.no_grad():
        if quantize:
            mod.weight_q.copy_(torch.from_numpy(params["kernel_q"].T.copy()))
            mod.weight_scale.copy_(torch.from_numpy(params["kernel_scale"]))
        else:
            mod.weight.copy_(torch.from_numpy(params["kernel"].T.copy()))
        for name in ("lora_a", "lora_b"):
            getattr(mod, name).copy_(torch.from_numpy(params[name]))
    relora.set_trainable(mod)
    calls = []
    real = pd.lora_matmul
    monkeypatch.setattr(pd, "lora_matmul", lambda *a, **k: calls.append(k["arm"]) or real(*a, **k))

    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt)  # eval (no seed): the dispatcher, whatever the dropout
    out.backward(torch.from_numpy(cot))
    assert calls == ["auto"]
    _close(out, y, "y")
    _close(xt.grad, gx, "dx")
    for name in ("lora_a", "lora_b"):
        _close(getattr(mod, name).grad, gp[name], name)
    mod(torch.from_numpy(x), dropout_seed=7)  # training: active dropout keeps the historical path
    assert calls == (["auto"] if dropout else ["auto", "auto"])


# -- single-tenant unmerged serving against the JAX scheduler ------------------

CACHE, PAGE, CHUNK, MAX_BATCH = 32, 8, 8, 3


def _engine_kwargs():
    return dict(cache_size=CACHE, page_size=PAGE, num_pages=MAX_BATCH * (CACHE // PAGE) + 1,
                chunk_size=CHUNK, token_budget=MAX_BATCH + CHUNK)


def _quantized(int8_tree, dense_tree):
    """``int8_tree`` with each ``kernel_q``/``kernel_scale`` pair quantized by
    the JAX package from ``dense_tree``'s kernel at the same place."""
    out = {}
    for k, v in int8_tree.items():
        if isinstance(v, dict):
            out[k] = _quantized(v, dense_tree[k])
        elif k == "kernel_q":
            out["kernel_q"], out["kernel_scale"] = (
                np.asarray(t) for t in jax_quantize_int8(jnp.asarray(dense_tree["kernel"])))
        elif k != "kernel_scale":
            out[k] = v
    return out


def _with_factors(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else (rng.standard_normal(np.shape(v)) * 0.1).astype(np.float32)
                if k in ("lora_a", "lora_b") else v for k, v in node.items()}

    return walk(tree)


@pytest.fixture(scope="module", params=[None, "int8"], ids=["dense", "int8"])
def unmerged_pair(request):
    """A JAX and a port engine serving the same LoRA factors unmerged (the
    JAX serve.py --no-merge path), over a dense or an int8 base."""
    cfg = JaxModelConfig(**TINY)
    spec = dict(r=4, alpha=8.0, quantize=request.param)
    init = lambda s: jax.tree_util.tree_map(np.asarray, jax_init_params(
        jax_build(cfg, cache_size=CACHE, lora=JaxLoraSpec(**s)), jax.random.PRNGKey(0),
        jnp.zeros((1, 8), jnp.int32)))
    raw = init({**spec, "quantize": None})
    if request.param:
        raw = _quantized(init(spec), raw)
    raw = _with_factors(raw, 3)
    jx = JaxEngine(cfg, raw, lora=JaxLoraSpec(**spec), **_engine_kwargs())
    pt = InferenceEngine(ModelConfig(**TINY), params_from_jax(raw), lora=relora.LoraSpec(**spec),
                         device="cpu", **_engine_kwargs())
    return jx, pt, raw, spec


def _mix():
    rng = np.random.default_rng(5)
    return [(u, rng.integers(1, 256, n).tolist(), m)
            for u, n, m in ((1, 13, 6), (2, 21, 5), (3, 9, 8), (4, 5, 7))]


@pytest.mark.parametrize("packed", [False, True], ids=["paged", "packed"])
def test_unmerged_greedy_drain_token_identical_to_jax(unmerged_pair, packed):
    jx, pt = unmerged_pair[:2]
    proj = pt.model.layers[0].mlp.down_proj
    assert proj.lora.weights_static and proj.lora.fused == "auto"
    assert (getattr(proj, "weight_q", None) is not None) == (unmerged_pair[3]["quantize"] == "int8")
    js = JaxScheduler(jx, max_batch=MAX_BATCH, eos_id=9, key=jax.random.PRNGKey(42), packed=packed)
    want = {u: c.tokens for u, c in js.run(
        [JaxRequest(uid=u, prompt=p, max_new_tokens=n) for u, p, n in _mix()]).items()}
    ps = PagedContinuousBatchingScheduler(pt, max_batch=MAX_BATCH, eos_id=9, seed=42, packed=packed)
    got = {u: c.tokens for u, c in ps.run(
        [Request(uid=u, prompt=p, max_new_tokens=n) for u, p, n in _mix()]).items()}
    assert got == want and sorted(got) == [1, 2, 3, 4]


def test_cli_serves_a_checkpoint_unmerged(unmerged_pair, tmp_path):
    """``serve_cli --checkpoint C --no-merge`` without ``--adapter-dir``: the
    spec from the sidecar, the params unmerged, the drain equal to the
    engine's; a corrupt checkpoint is refused."""
    _, pt, raw, spec = unmerged_pair
    path = ckpt.save_checkpoint(str(tmp_path / "ck"), 3, params_from_jax(raw), {"update_step": 3},
                                lora_spec=relora.LoraSpec(**spec))
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps({**{k: v for k, v in TINY.items() if k != "family"},
                                  "model_type": "llama"}))
    args = ["--model_config", str(config), "--checkpoint", path, "--no-merge", "--paged",
            "--device", "cpu", "--cache-size", str(CACHE), "--page-size", str(PAGE),
            "--chunk-size", str(CHUNK), "--max-new-tokens", "5", "--max-batch", "2",
            "--prompt", "3 1 4 1 5 9 2 6", "--prompt", "2 7 1 8"]
    completions, _ = serve_cli.run(args)
    direct = PagedContinuousBatchingScheduler(pt, max_batch=2, eos_id=ModelConfig(**TINY).eos_token_id).run(
        [Request(uid=0, prompt=[3, 1, 4, 1, 5, 9, 2, 6], max_new_tokens=5),
         Request(uid=1, prompt=[2, 7, 1, 8], max_new_tokens=5)])
    assert {u: c.tokens for u, c in completions.items()} == {u: c.tokens for u, c in direct.items()}
    with open(f"{path}/{ckpt.TRAINING_STATE_FILE}", "w") as f:
        f.write("{}")
    with pytest.raises(SystemExit, match="corrupt"):
        serve_cli.run(args)


# -- the H100 model against the card -------------------------------------------

# chip_smoke.py's auto-arms phase on an NVIDIA H100 80GB HBM3 (700 W), one
# table per run: each arm of lora_matmul timed back to back at llama_250m's
# and pythia_1b's projection shapes, r = 128, bf16 activations, the median of
# three runs in turns; "fwd_bwd" includes one autograd.grad call per
# iteration (ten calls timed, so the same arm's time moves up to 2.7x from
# run to run).  The runs' hosts differ (one eager op took 11.4, 8.4, 7.1
# and 5.9 µs an in-place add, 16.9, 16.0, 15.4 and 11.3 µs an 8 x 8
# matmul), and where the launch term decides a pick (decode, llama_250m)
# the ranking follows the host, so each pick is held against the runs
# together.
MEASURED_US = {  # run: {(K, N, base, mode, M): (fused, ordered, merged) µs a call}
    "host_11us": {
        (768, 768, "bf16", "fwd", 4096): (100.2, 84.1, 71.8),
        (768, 768, "int8", "fwd", 4096): (105.8, 119.6, 107.1),
        (768, 768, "bf16", "fwd_bwd", 4096): (1237.1, 1057.2, 881.9),
        (768, 768, "int8", "fwd_bwd", 4096): (1251.8, 1118.8, 926.6),
        (768, 768, "bf16", "decode", 8): (130.3, 95.7, 72.3),
        (768, 768, "int8", "decode", 8): (143.6, 163.1, 148.3),
        (768, 768, "bf16", "decode", 72): (100.6, 86.6, 71.8),
        (768, 768, "int8", "decode", 72): (97.9, 103.3, 87.5),
        (768, 2560, "bf16", "fwd", 4096): (114.4, 88.4, 62.6),
        (768, 2560, "int8", "fwd", 4096): (118.3, 139.9, 109.5),
        (768, 2560, "bf16", "fwd_bwd", 4096): (1108.2, 869.4, 818.9),
        (768, 2560, "int8", "fwd_bwd", 4096): (1071.9, 995.6, 911.0),
        (768, 2560, "bf16", "decode", 8): (113.5, 82.6, 72.9),
        (768, 2560, "int8", "decode", 8): (150.2, 182.2, 168.3),
        (768, 2560, "bf16", "decode", 72): (119.3, 108.4, 84.2),
        (768, 2560, "int8", "decode", 72): (121.0, 152.5, 136.1),
        (2560, 768, "bf16", "fwd", 4096): (126.9, 100.8, 83.5),
        (2560, 768, "int8", "fwd", 4096): (139.1, 153.6, 133.9),
        (2560, 768, "bf16", "fwd_bwd", 4096): (1144.6, 905.9, 931.9),
        (2560, 768, "int8", "fwd_bwd", 4096): (1075.0, 1025.2, 905.0),
        (2560, 768, "bf16", "decode", 8): (109.1, 80.4, 62.4),
        (2560, 768, "int8", "decode", 8): (95.6, 112.0, 103.4),
        (2560, 768, "bf16", "decode", 72): (92.6, 73.8, 60.3),
        (2560, 768, "int8", "decode", 72): (94.5, 115.7, 111.1),
        (2048, 6144, "bf16", "fwd", 4096): (470.9, 261.1, 271.9),
        (2048, 6144, "int8", "fwd", 4096): (543.9, 373.6, 382.3),
        (2048, 6144, "bf16", "fwd_bwd", 4096): (1010.0, 839.6, 764.1),
        (2048, 6144, "int8", "fwd_bwd", 4096): (1191.5, 995.7, 964.2),
        (2048, 6144, "bf16", "decode", 8): (90.6, 90.3, 143.8),
        (2048, 6144, "int8", "decode", 8): (130.7, 155.8, 254.3),
        (2048, 6144, "bf16", "decode", 72): (107.5, 93.4, 143.3),
        (2048, 6144, "int8", "decode", 72): (79.0, 141.6, 254.1),
        (2048, 2048, "bf16", "fwd", 4096): (171.9, 98.7, 98.2),
        (2048, 2048, "int8", "fwd", 4096): (195.6, 142.1, 136.9),
        (2048, 2048, "bf16", "fwd_bwd", 4096): (933.4, 880.5, 739.4),
        (2048, 2048, "int8", "fwd_bwd", 4096): (971.5, 921.4, 855.0),
        (2048, 2048, "bf16", "decode", 8): (106.1, 85.8, 73.0),
        (2048, 2048, "int8", "decode", 8): (126.6, 161.9, 136.0),
        (2048, 2048, "bf16", "decode", 72): (84.5, 77.4, 61.0),
        (2048, 2048, "int8", "decode", 72): (81.1, 106.3, 90.9),
        (2048, 8192, "bf16", "fwd", 4096): (622.7, 338.5, 349.7),
        (2048, 8192, "int8", "fwd", 4096): (723.6, 490.1, 501.9),
        (2048, 8192, "bf16", "fwd_bwd", 4096): (1308.0, 953.8, 920.9),
        (2048, 8192, "int8", "fwd_bwd", 4096): (1559.2, 1052.4, 982.9),
        (2048, 8192, "bf16", "decode", 8): (80.2, 65.2, 184.3),
        (2048, 8192, "int8", "decode", 8): (129.9, 176.9, 336.0),
        (2048, 8192, "bf16", "decode", 72): (105.1, 91.2, 190.0),
        (2048, 8192, "int8", "decode", 72): (81.3, 179.6, 330.4),
        (8192, 2048, "bf16", "fwd", 4096): (600.6, 247.5, 357.0),
        (8192, 2048, "int8", "fwd", 4096): (705.0, 390.1, 491.3),
        (8192, 2048, "bf16", "fwd_bwd", 4096): (1306.0, 867.2, 862.2),
        (8192, 2048, "int8", "fwd_bwd", 4096): (1530.5, 921.4, 929.0),
        (8192, 2048, "bf16", "decode", 8): (151.8, 105.4, 199.4),
        (8192, 2048, "int8", "decode", 8): (177.3, 179.3, 336.6),
        (8192, 2048, "bf16", "decode", 72): (158.5, 108.8, 194.6),
        (8192, 2048, "int8", "decode", 72): (187.0, 184.3, 337.6),
    },
    "host_8us": {
        (768, 768, "bf16", "fwd", 4096): (101.3, 89.7, 69.9),
        (768, 768, "int8", "fwd", 4096): (103.2, 129.4, 113.8),
        (768, 768, "bf16", "fwd_bwd", 4096): (511.5, 361.0, 315.4),
        (768, 768, "int8", "fwd_bwd", 4096): (408.0, 407.5, 328.8),
        (768, 768, "bf16", "decode", 8): (77.5, 66.5, 55.7),
        (768, 768, "int8", "decode", 8): (90.3, 105.8, 104.6),
        (768, 768, "bf16", "decode", 72): (108.4, 94.6, 73.5),
        (768, 768, "int8", "decode", 72): (81.5, 93.2, 86.9),
        (768, 2560, "bf16", "fwd", 4096): (105.3, 88.0, 56.0),
        (768, 2560, "int8", "fwd", 4096): (116.9, 109.3, 83.0),
        (768, 2560, "bf16", "fwd_bwd", 4096): (438.1, 434.7, 369.2),
        (768, 2560, "int8", "fwd_bwd", 4096): (416.8, 475.9, 434.7),
        (768, 2560, "bf16", "decode", 8): (65.1, 63.4, 48.9),
        (768, 2560, "int8", "decode", 8): (100.7, 120.8, 104.4),
        (768, 2560, "bf16", "decode", 72): (73.0, 64.5, 49.1),
        (768, 2560, "int8", "decode", 72): (113.8, 136.4, 119.0),
        (2560, 768, "bf16", "fwd", 4096): (116.7, 73.2, 52.7),
        (2560, 768, "int8", "fwd", 4096): (131.0, 95.3, 82.6),
        (2560, 768, "bf16", "fwd_bwd", 4096): (362.6, 416.3, 281.0),
        (2560, 768, "int8", "fwd_bwd", 4096): (560.5, 399.5, 329.9),
        (2560, 768, "bf16", "decode", 8): (93.2, 84.4, 67.7),
        (2560, 768, "int8", "decode", 8): (68.1, 95.8, 74.9),
        (2560, 768, "bf16", "decode", 72): (97.1, 87.2, 71.4),
        (2560, 768, "int8", "decode", 72): (68.2, 89.3, 79.3),
        (2048, 6144, "bf16", "fwd", 4096): (464.8, 257.9, 266.6),
        (2048, 6144, "int8", "fwd", 4096): (555.2, 375.0, 383.5),
        (2048, 6144, "bf16", "fwd_bwd", 4096): (997.5, 509.3, 572.3),
        (2048, 6144, "int8", "fwd_bwd", 4096): (1201.9, 626.6, 686.3),
        (2048, 6144, "bf16", "decode", 8): (68.5, 64.2, 143.8),
        (2048, 6144, "int8", "decode", 8): (95.8, 140.0, 255.2),
        (2048, 6144, "bf16", "decode", 72): (68.3, 60.6, 142.7),
        (2048, 6144, "int8", "decode", 72): (70.2, 141.1, 254.1),
        (2048, 2048, "bf16", "fwd", 4096): (170.9, 98.9, 98.2),
        (2048, 2048, "int8", "fwd", 4096): (198.9, 136.5, 137.0),
        (2048, 2048, "bf16", "fwd_bwd", 4096): (476.9, 448.5, 220.5),
        (2048, 2048, "int8", "fwd_bwd", 4096): (492.5, 380.2, 313.7),
        (2048, 2048, "bf16", "decode", 8): (70.2, 62.1, 54.8),
        (2048, 2048, "int8", "decode", 8): (69.3, 84.3, 91.5),
        (2048, 2048, "bf16", "decode", 72): (69.1, 72.2, 53.5),
        (2048, 2048, "int8", "decode", 72): (100.1, 119.2, 105.6),
        (2048, 8192, "bf16", "fwd", 4096): (626.9, 340.1, 350.9),
        (2048, 8192, "int8", "fwd", 4096): (717.2, 487.2, 500.6),
        (2048, 8192, "bf16", "fwd_bwd", 4096): (1308.2, 653.6, 752.9),
        (2048, 8192, "int8", "fwd_bwd", 4096): (1572.2, 799.5, 894.2),
        (2048, 8192, "bf16", "decode", 8): (102.0, 90.2, 184.1),
        (2048, 8192, "int8", "decode", 8): (83.0, 177.6, 336.3),
        (2048, 8192, "bf16", "decode", 72): (87.3, 84.5, 189.9),
        (2048, 8192, "int8", "decode", 72): (102.6, 180.0, 331.3),
        (8192, 2048, "bf16", "fwd", 4096): (591.3, 240.2, 352.9),
        (8192, 2048, "int8", "fwd", 4096): (697.7, 389.5, 491.2),
        (8192, 2048, "bf16", "fwd_bwd", 4096): (1310.9, 592.7, 780.6),
        (8192, 2048, "int8", "fwd_bwd", 4096): (1564.2, 746.0, 901.3),
        (8192, 2048, "bf16", "decode", 8): (150.0, 91.3, 199.4),
        (8192, 2048, "int8", "decode", 8): (177.5, 179.6, 336.7),
        (8192, 2048, "bf16", "decode", 72): (157.9, 96.2, 195.2),
        (8192, 2048, "int8", "decode", 72): (182.8, 182.1, 337.7),
    },
    "host_7us": {
        (768, 768, "bf16", "fwd", 4096): (97.7, 81.8, 71.1),
        (768, 768, "int8", "fwd", 4096): (107.4, 129.3, 94.9),
        (768, 768, "bf16", "fwd_bwd", 4096): (803.6, 689.0, 630.8),
        (768, 768, "int8", "fwd_bwd", 4096): (635.9, 811.8, 544.3),
        (768, 768, "bf16", "decode", 8): (96.0, 106.8, 82.6),
        (768, 768, "int8", "decode", 8): (96.8, 127.9, 120.5),
        (768, 768, "bf16", "decode", 72): (94.0, 99.3, 79.2),
        (768, 768, "int8", "decode", 72): (116.2, 136.4, 103.4),
        (768, 2560, "bf16", "fwd", 4096): (109.5, 90.5, 76.6),
        (768, 2560, "int8", "fwd", 4096): (128.9, 145.3, 117.5),
        (768, 2560, "bf16", "fwd_bwd", 4096): (773.3, 626.2, 471.2),
        (768, 2560, "int8", "fwd_bwd", 4096): (750.0, 619.0, 594.0),
        (768, 2560, "bf16", "decode", 8): (113.6, 102.6, 101.7),
        (768, 2560, "int8", "decode", 8): (152.2, 166.8, 146.7),
        (768, 2560, "bf16", "decode", 72): (146.3, 131.0, 103.1),
        (768, 2560, "int8", "decode", 72): (112.8, 139.3, 116.3),
        (2560, 768, "bf16", "fwd", 4096): (172.1, 129.5, 89.0),
        (2560, 768, "int8", "fwd", 4096): (138.9, 112.5, 107.2),
        (2560, 768, "bf16", "fwd_bwd", 4096): (716.5, 552.6, 508.4),
        (2560, 768, "int8", "fwd_bwd", 4096): (649.1, 755.7, 777.0),
        (2560, 768, "bf16", "decode", 8): (106.8, 83.1, 73.7),
        (2560, 768, "int8", "decode", 8): (99.4, 139.2, 168.8),
        (2560, 768, "bf16", "decode", 72): (82.9, 119.2, 57.0),
        (2560, 768, "int8", "decode", 72): (143.5, 175.3, 161.9),
        (2048, 6144, "bf16", "fwd", 4096): (463.5, 263.3, 269.0),
        (2048, 6144, "int8", "fwd", 4096): (542.0, 378.7, 386.4),
        (2048, 6144, "bf16", "fwd_bwd", 4096): (1056.2, 1177.8, 880.8),
        (2048, 6144, "int8", "fwd_bwd", 4096): (1209.9, 1190.0, 1036.5),
        (2048, 6144, "bf16", "decode", 8): (151.0, 128.0, 144.9),
        (2048, 6144, "int8", "decode", 8): (136.1, 168.8, 257.3),
        (2048, 6144, "bf16", "decode", 72): (122.8, 117.6, 146.0),
        (2048, 6144, "int8", "decode", 72): (78.2, 143.2, 259.3),
        (2048, 2048, "bf16", "fwd", 4096): (171.7, 101.6, 100.2),
        (2048, 2048, "int8", "fwd", 4096): (198.8, 155.0, 154.9),
        (2048, 2048, "bf16", "fwd_bwd", 4096): (1147.0, 1047.1, 969.1),
        (2048, 2048, "int8", "fwd_bwd", 4096): (1239.8, 1185.2, 1006.7),
        (2048, 2048, "bf16", "decode", 8): (128.0, 119.4, 96.1),
        (2048, 2048, "int8", "decode", 8): (130.3, 156.3, 139.7),
        (2048, 2048, "bf16", "decode", 72): (94.8, 97.3, 68.6),
        (2048, 2048, "int8", "decode", 72): (93.8, 121.4, 112.0),
        (2048, 8192, "bf16", "fwd", 4096): (634.2, 342.7, 354.8),
        (2048, 8192, "int8", "fwd", 4096): (717.7, 493.0, 513.2),
        (2048, 8192, "bf16", "fwd_bwd", 4096): (1321.0, 685.6, 771.6),
        (2048, 8192, "int8", "fwd_bwd", 4096): (1569.4, 809.9, 916.2),
        (2048, 8192, "bf16", "decode", 8): (135.2, 114.1, 185.9),
        (2048, 8192, "int8", "decode", 8): (94.4, 181.1, 333.9),
        (2048, 8192, "bf16", "decode", 72): (106.4, 88.4, 192.2),
        (2048, 8192, "int8", "decode", 72): (146.7, 187.0, 335.1),
        (8192, 2048, "bf16", "fwd", 4096): (596.5, 245.3, 348.5),
        (8192, 2048, "int8", "fwd", 4096): (715.1, 398.6, 506.6),
        (8192, 2048, "bf16", "fwd_bwd", 4096): (1319.7, 628.2, 794.9),
        (8192, 2048, "int8", "fwd_bwd", 4096): (1543.0, 744.0, 944.4),
        (8192, 2048, "bf16", "decode", 8): (154.7, 140.4, 193.4),
        (8192, 2048, "int8", "decode", 8): (178.1, 181.3, 348.4),
        (8192, 2048, "bf16", "decode", 72): (157.5, 98.1, 194.9),
        (8192, 2048, "int8", "decode", 72): (181.8, 188.0, 350.0),
    },
    "host_6us": {
        (768, 768, "bf16", "fwd", 4096): (75.5, 92.5, 73.6),
        (768, 768, "int8", "fwd", 4096): (106.1, 128.6, 112.0),
        (768, 768, "bf16", "fwd_bwd", 4096): (810.0, 792.9, 673.3),
        (768, 768, "int8", "fwd_bwd", 4096): (863.1, 772.6, 726.2),
        (768, 768, "bf16", "decode", 8): (80.8, 80.2, 58.9),
        (768, 768, "int8", "decode", 8): (71.4, 84.9, 73.4),
        (768, 768, "bf16", "decode", 72): (68.5, 60.6, 49.5),
        (768, 768, "int8", "decode", 72): (121.4, 150.8, 131.4),
        (768, 2560, "bf16", "fwd", 4096): (105.6, 88.7, 56.6),
        (768, 2560, "int8", "fwd", 4096): (136.1, 149.3, 142.9),
        (768, 2560, "bf16", "fwd_bwd", 4096): (901.7, 751.5, 688.1),
        (768, 2560, "int8", "fwd_bwd", 4096): (915.3, 921.4, 805.5),
        (768, 2560, "bf16", "decode", 8): (79.3, 68.4, 53.1),
        (768, 2560, "int8", "decode", 8): (123.6, 160.3, 120.2),
        (768, 2560, "bf16", "decode", 72): (69.4, 59.5, 46.4),
        (768, 2560, "int8", "decode", 72): (67.3, 86.2, 75.2),
        (2560, 768, "bf16", "fwd", 4096): (117.1, 57.9, 56.4),
        (2560, 768, "int8", "fwd", 4096): (129.7, 83.3, 73.8),
        (2560, 768, "bf16", "fwd_bwd", 4096): (929.3, 792.7, 794.3),
        (2560, 768, "int8", "fwd_bwd", 4096): (914.0, 885.9, 853.0),
        (2560, 768, "bf16", "decode", 8): (111.2, 79.0, 59.5),
        (2560, 768, "int8", "decode", 8): (118.2, 139.3, 110.3),
        (2560, 768, "bf16", "decode", 72): (98.9, 75.2, 58.2),
        (2560, 768, "int8", "decode", 72): (101.8, 130.7, 117.3),
        (2048, 6144, "bf16", "fwd", 4096): (474.6, 265.2, 275.6),
        (2048, 6144, "int8", "fwd", 4096): (540.6, 377.5, 382.8),
        (2048, 6144, "bf16", "fwd_bwd", 4096): (1013.2, 851.3, 769.9),
        (2048, 6144, "int8", "fwd_bwd", 4096): (1187.1, 780.4, 773.3),
        (2048, 6144, "bf16", "decode", 8): (71.0, 69.5, 144.6),
        (2048, 6144, "int8", "decode", 8): (128.3, 162.5, 255.5),
        (2048, 6144, "bf16", "decode", 72): (73.3, 68.8, 143.6),
        (2048, 6144, "int8", "decode", 72): (73.9, 141.9, 255.3),
        (2048, 2048, "bf16", "fwd", 4096): (172.7, 99.3, 99.2),
        (2048, 2048, "int8", "fwd", 4096): (195.5, 136.3, 135.5),
        (2048, 2048, "bf16", "fwd_bwd", 4096): (918.6, 791.1, 701.8),
        (2048, 2048, "int8", "fwd_bwd", 4096): (852.7, 805.6, 762.8),
        (2048, 2048, "bf16", "decode", 8): (68.5, 65.5, 54.8),
        (2048, 2048, "int8", "decode", 8): (86.4, 112.5, 98.8),
        (2048, 2048, "bf16", "decode", 72): (67.3, 63.5, 53.9),
        (2048, 2048, "int8", "decode", 72): (107.8, 137.6, 122.6),
        (2048, 8192, "bf16", "fwd", 4096): (630.7, 342.2, 357.0),
        (2048, 8192, "int8", "fwd", 4096): (713.8, 490.2, 502.2),
        (2048, 8192, "bf16", "fwd_bwd", 4096): (1312.4, 1006.6, 936.6),
        (2048, 8192, "int8", "fwd_bwd", 4096): (1560.6, 869.5, 903.7),
        (2048, 8192, "bf16", "decode", 8): (119.2, 98.3, 185.1),
        (2048, 8192, "int8", "decode", 8): (126.0, 178.4, 337.5),
        (2048, 8192, "bf16", "decode", 72): (81.9, 82.2, 190.6),
        (2048, 8192, "int8", "decode", 72): (99.8, 181.7, 332.2),
        (8192, 2048, "bf16", "fwd", 4096): (592.1, 241.7, 354.8),
        (8192, 2048, "int8", "fwd", 4096): (709.6, 392.8, 495.5),
        (8192, 2048, "bf16", "fwd_bwd", 4096): (1312.6, 760.9, 788.2),
        (8192, 2048, "int8", "fwd_bwd", 4096): (1567.1, 829.3, 918.9),
        (8192, 2048, "bf16", "decode", 8): (152.5, 67.6, 200.7),
        (8192, 2048, "int8", "decode", 8): (177.3, 181.2, 337.9),
        (8192, 2048, "bf16", "decode", 72): (158.2, 91.8, 195.6),
        (8192, 2048, "int8", "decode", 72): (182.8, 184.1, 339.0),
    },
}

# the pick's time, as the geometric mean over the runs, may trail the
# fastest arm it may take by this much (the largest such gap is 1.08x,
# llama_250m 768 -> 2560, int8 base, forward).  One run alone differs by
# up to 1.28x (768 -> 768, int8 base, forward+backward: ordered 812 µs
# against fused 636 in the 7 µs host's run, 1119 against 1252 in the
# 11 µs host's), the size of a race between two host-bound arms
PIN_SLACK = 1.2


def _geomean(values):
    return float(np.exp(np.mean(np.log(values))))


@pytest.mark.parametrize("K,N", sorted({k[:2] for k in MEASURED_US["host_8us"]}))
def test_h100_picks_rank_as_the_card_measured(K, N):
    for case in MEASURED_US["host_8us"]:
        k, n, base, mode, M = case
        if (k, n) != (K, N):
            continue
        static = mode == "decode"
        pick = pd.choose_arm(M, K, N, 128, 2, 1 if base == "int8" else 2,
                             weights_static=static, backward=mode == "fwd_bwd")
        us = {arm: _geomean([run[case][i] for run in MEASURED_US.values()])
              for i, arm in enumerate(pd.ARMS)}
        best = min(us[arm] for arm in pd.candidate_arms(weights_static=static))
        assert us[pick] <= PIN_SLACK * best, (base, mode, M, pick, us)
        assert pick != "fused" or base == "int8"  # bf16: kernels 4/6/7 lose to cuBLAS here


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "training"])
@pytest.mark.parametrize("M", [8, 4096, 65536])
def test_h100_merges_only_static_weights(M, backward):
    """Under H100 the merged arm, whose bf16 ``W + s·A@B`` rounds a training
    delta away, is no pick unless the weights are static; under V5E it still
    is where the reference's model picks it."""
    for K, N in ((768, 768), (2048, 8192)):
        assert pd.choose_arm(M, K, N, 128, backward=backward) != "merged"
        assert "merged" not in pd.candidate_arms(weights_static=False)
        assert "merged" in pd.candidate_arms(weights_static=False, roofline=V5E)
    if not backward:
        assert pd.choose_arm(M, 768, 768, 128, weights_static=True) == "merged"
    assert pd.choose_arm(65536, 2048, 2048, 128, roofline=V5E) == "merged"
