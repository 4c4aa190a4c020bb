#!/usr/bin/env python3
"""Quickest proof that the PyTorch port serves on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build   — nvcc builds every kernel of ``relora_tpu_torch/csrc`` for sm_90a.
2. kernels — each kernel against its plain PyTorch twin on the card, at
             llama_250m (N=16, H=48) and llama_1b (N=32, H=64) widths, page 16,
             table width 64, B=8 with S in {1, 5} and a packed T=72, for f32,
             bf16 and int8 pools; then each is timed at the main path's shape
             beside its plain twin, a gather + scaled_dot_product_attention
             yardstick, and its bound.
3. drains  — ``relora_tpu_torch.serve_cli`` drains 16 requests (prompts of
             32-512 tokens, 64 new tokens each) for llama_250m at full width,
             ``--random-init --dtype bf16 --max-batch 8 --paged``: at
             ``--kv-dtype bf16``, with ``--packed``, and at ``--kv-dtype int8``.
             The launch counters are zeroed before each drain and read after;
             the drain fails if its kernel never launched.
4. f32     — one ``decode_paged`` and one ``step_paged`` step at f32, the
             kernel arm against the plain arm, compared on logits.

Output: a ``{"kernels": [...]}`` line, one line per drain, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and last
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
REPO = os.path.dirname(os.path.abspath(__file__))
WIDTHS = {"llama_250m": (16, 48), "llama_1b": (32, 64)}  # (heads, head_dim)
PAGE, TABLE_W, BATCH, PACKED_T = 16, 64, 8, 72
# kernel vs plain twin on one card: f32 sums in another order (1e-6 scale);
# bf16 outputs round once to bf16 (2^-7 relative at |out| < 4 gives 2e-2)
KERNEL_TOL = {"f32": 1e-4, "bf16": 2e-2, "int8": 2e-2}
LOGIT_TOL = 2e-3  # f32 logits after 24 layers, kernel arm vs plain arm


def _dtypes(torch, pool):
    q = torch.float32 if pool == "f32" else torch.bfloat16
    return q, {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[pool]


def make_pool_case(torch, device, *, heads, head_dim, pool, S, seed, packed=False):
    """Inputs of one kernel call: every row owns TABLE_W pages of one shared
    pool and sits at a random position of a 1024-token cache.  Packed: the
    B rows' decode tokens, a 56-token prefill of row B, then pad tokens on
    the all-null last row at the null position (the scheduler's layout)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q_dtype, kv_dtype = _dtypes(torch, pool)
    n_kv = heads
    num_pages = (BATCH + 1) * TABLE_W + 1
    shape = (num_pages, PAGE, n_kv, head_dim)
    k = torch.randn(shape, generator=g, device=device)
    v = torch.randn(shape, generator=g, device=device)
    scales = {}
    if pool == "int8":
        ks = torch.rand((num_pages, n_kv), generator=g, device=device) * 0.02 + 0.01
        vs = torch.rand((num_pages, n_kv), generator=g, device=device) * 0.02 + 0.01
        k = torch.randint(-127, 128, shape, generator=g, device=device)
        v = torch.randint(-127, 128, shape, generator=g, device=device)
        scales = {"k_scale": ks, "v_scale": vs}
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    perm = torch.randperm((BATCH + 1) * TABLE_W, generator=g, device=device) + 1
    tables = perm.reshape(BATCH + 1, TABLE_W).to(torch.int32)
    cache = TABLE_W * PAGE
    base = torch.randint(32, cache - S, (BATCH,), generator=g, device=device)
    if not packed:
        pos = (base[:, None] + torch.arange(S, device=device)[None, :]).to(torch.int32)
        q = torch.randn((BATCH, S, heads, head_dim), generator=g, device=device)
        return dict(q=q.to(q_dtype), pool_k=k, pool_v=v, block_tables=tables[:BATCH].contiguous(),
                    positions=pos, **scales)
    n_prefill = PACKED_T - BATCH - 8
    ptables = torch.zeros((BATCH + 2, TABLE_W + 1), dtype=torch.int32, device=device)
    ptables[: BATCH + 1, :TABLE_W] = tables
    row_map = torch.tensor(
        list(range(BATCH)) + [BATCH] * n_prefill + [BATCH + 1] * 8,
        dtype=torch.int32, device=device,
    )
    pos = torch.cat([
        base,
        torch.arange(n_prefill, device=device),
        torch.full((8,), cache, device=device),
    ]).to(torch.int32)
    q = torch.randn((1, PACKED_T, heads, head_dim), generator=g, device=device)
    return dict(q=q.to(q_dtype), pool_k=k, pool_v=v, block_tables=ptables,
                row_map=row_map, positions=pos, **scales)


def bound(torch, case, packed=False):
    """Least time for the call on an H100 SXM: the bytes it must move (the
    K/V pages its queries can see, each once, plus q, out, tables, positions
    and scales) over 3.35 TB/s, against the f32 operations on visible keys
    (QK and PV, 4*H each) over 67 TFLOP/s."""
    q, pk = case["q"], case["pool_k"]
    tables, pos = case["block_tables"], case["positions"]
    if packed:
        tables = tables[case["row_map"].long()]
        pos = pos.reshape(-1, 1)
    n_kv, H = pk.shape[2], pk.shape[3]
    last = torch.clamp(pos.max(dim=1).values, max=tables.shape[1] * PAGE - 1)
    pages = set()
    for row, p in zip(tables.tolist(), last.tolist()):
        pages.update(row[: p // PAGE + 1])
    kv_bytes = 2 * len(pages) * PAGE * n_kv * H * pk.element_size()
    other = 2 * q.numel() * q.element_size() + tables.numel() * 4 + pos.numel() * 4
    if "k_scale" in case:
        other += 2 * len(pages) * n_kv * 4
    visible = (torch.clamp(pos, max=tables.shape[1] * PAGE - 1) + 1).sum().item()
    flops = 4.0 * H * visible * q.shape[2]  # per visible key, per head
    t_bytes = (kv_bytes + other) / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def library_call(torch, case, packed=False):
    """One PyTorch yardstick for the same function: gather the pages (and
    dequantize), then scaled_dot_product_attention with the visibility mask.
    Timed only; the port never calls it."""
    import torch.nn.functional as F

    from relora_tpu_torch.ops.attention import dequantize_gathered_pages, gather_kv_pages

    q, tables, pos = case["q"], case["block_tables"], case["positions"]
    if packed:
        tables = tables[case["row_map"].long()]
        q = q.reshape(-1, 1, q.shape[2], q.shape[3])
        pos = pos.reshape(-1, 1)

    def call():
        k = gather_kv_pages(case["pool_k"], tables)
        v = gather_kv_pages(case["pool_v"], tables)
        if "k_scale" in case:
            k = dequantize_gathered_pages(k, case["k_scale"], tables)
            v = dequantize_gathered_pages(v, case["v_scale"], tables)
        k, v = k.to(q.dtype).transpose(1, 2), v.to(q.dtype).transpose(1, 2)
        mask = torch.arange(k.shape[2], device=q.device)[None, None, :] <= pos[..., None]
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask[:, None]
        )
        return out.transpose(1, 2).reshape(case["q"].shape)

    return call


def time_ms(torch, fn, iters=30):
    """Median device time of ``fn`` over ``iters`` launches, CUDA events
    around each, with a 128 MiB write between launches so the K/V pages come
    from device memory as in a forward (each layer has its own pool)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def check_kernels(torch, device):
    """Phase 2: every kernel against its plain twin, then timings."""
    from relora_tpu_torch.ops import attention as A

    worst = {"paged_decode_attention": 0.0, "packed_paged_attention": 0.0}
    for model, (heads, head_dim) in WIDTHS.items():
        for pool in ("f32", "bf16", "int8"):
            cases = [(S, False) for S in (1, 5)] + [(1, True)]
            for S, packed in cases:
                case = make_pool_case(torch, device, heads=heads, head_dim=head_dim,
                                      pool=pool, S=S, seed=S + 7 * packed, packed=packed)
                scales = {k: case[k] for k in ("k_scale", "v_scale") if k in case}
                if packed:
                    args = (case["q"], case["pool_k"], case["pool_v"], case["block_tables"],
                            case["row_map"], case["positions"])
                    got = A.packed_paged_attention(*args, **scales)
                    want = A.packed_paged_attention_plain(*args, **scales)
                    name = "packed_paged_attention"
                else:
                    args = (case["q"], case["pool_k"], case["pool_v"], case["block_tables"],
                            case["positions"])
                    got = A.paged_decode_attention(*args, **scales)
                    want = A.paged_decode_attention_plain(*args, **scales)
                    name = "paged_decode_attention"
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = bool(torch.isfinite(got.float()).all()) and err <= KERNEL_TOL[pool]
                print(f"kernel-check {name} {model} pool={pool} S={S} "
                      f"max_abs_err={err:.3e} tol={KERNEL_TOL[pool]:g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain twin ({model}, {pool}, S={S})")
                if model == "llama_250m":
                    worst[name] = max(worst[name], err)

    rows = []
    heads, head_dim = WIDTHS["llama_250m"]
    for name, packed, line in (
        ("paged_decode_attention", False, 331),
        ("packed_paged_attention", True, 532),
    ):
        case = make_pool_case(torch, device, heads=heads, head_dim=head_dim, pool="bf16",
                              S=1, seed=99, packed=packed)
        fn = getattr(A, name)
        plain = getattr(A, name + "_plain")
        keys = ("q", "pool_k", "pool_v", "block_tables") + (("row_map",) if packed else ()) + ("positions",)
        args = [case[k] for k in keys]
        bound_ms, bound_by = bound(torch, case, packed)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "relora_tpu_torch/csrc/paged_attention.cu",
            "replaces": f"relora_tpu/ops/attention.py:{line}",
            "launches": 0,
            "max_abs_err": worst[name],
            "ms": time_ms(torch, lambda: fn(*args)),
            "plain_ms": time_ms(torch, lambda: plain(*args)),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": time_ms(torch, library_call(torch, case, packed)),
        })
    return rows


def write_prompts(path, vocab, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(32, 513, 16)
    with open(path, "w") as f:
        for L in lengths:
            f.write(" ".join(str(t) for t in rng.integers(2, vocab, L)) + "\n")
    return int(lengths.sum())


def drains(torch, prompts):
    """Phase 3: the main path through the CLI's entry point, three ways."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.ops import attention as A

    base = ["--model_config", "llama_250m", "--random-init", "--dtype", "bf16",
            "--max-batch", "8", "--paged", "--max-new-tokens", "64",
            "--input-file", prompts]
    launches = {"paged_decode_attention": 0, "packed_paged_attention": 0}
    results = []
    for label, extra, kernel in (
        ("bf16", ["--kv-dtype", "bf16"], "paged_decode_attention"),
        ("packed", ["--kv-dtype", "bf16", "--packed"], "packed_paged_attention"),
        ("int8", ["--kv-dtype", "int8"], "paged_decode_attention"),
    ):
        A.paged_decode_attention.launches = 0
        A.packed_paged_attention.launches = 0
        completions, seconds = serve_cli.run(base + extra)
        counts = {
            "paged_decode_attention": A.paged_decode_attention.launches,
            "packed_paged_attention": A.packed_paged_attention.launches,
        }
        tokens = [c.tokens for c in completions.values()]
        if len(tokens) != 16 or not all(1 <= len(t) <= 64 for t in tokens):
            raise AssertionError(f"drain {label}: malformed completions")
        if not all(0 <= tok < 32100 for t in tokens for tok in t):
            raise AssertionError(f"drain {label}: token id out of the vocabulary")
        if counts[kernel] == 0:
            raise AssertionError(f"drain {label}: {kernel} never launched")
        for k in launches:
            launches[k] += counts[k]
        n = sum(len(t) for t in tokens)
        line = {"drain": label, "requests": 16, "tokens": n, "seconds": seconds,
                "tokens_per_s": n / seconds, "launches": counts}
        print(json.dumps(line))
        results.append(line)
    return launches, results


def f32_comparison(torch, device):
    """Phase 4: the same decode_paged and step_paged at f32 through the
    kernel arm and the plain arm, from identical pools; logits compared."""
    import numpy as np

    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.models.params_util import init_params
    from relora_tpu_torch.ops import attention as A
    from relora_tpu_torch.serve.engine import InferenceEngine, build_decode_model

    cfg = load_model_config("llama_250m")
    model = init_params(build_decode_model(cfg, device=device),
                        torch.Generator(device=device).manual_seed(1))
    W = cfg.max_sequence_length // PAGE
    engine = InferenceEngine(cfg, model, cache_size=cfg.max_sequence_length, page_size=PAGE,
                             num_pages=(BATCH + 1) * W + 1, chunk_size=64,
                             token_budget=BATCH + 64, device=device)
    rng = np.random.default_rng(3)
    lengths = rng.integers(32, 513, BATCH)
    tables = (np.arange(BATCH * W).reshape(BATCH, W) + 1).astype(np.int32)
    pool = engine.init_pool()
    for row, L in enumerate(lengths):
        prompt = rng.integers(2, cfg.vocab_size, L)
        for start in range(0, L, 64):
            ids = np.zeros((1, 64), np.int32)
            part = prompt[start : start + 64]
            ids[0, : len(part)] = part
            _, pool = engine.prefill_chunk(ids, start, pool, tables[row : row + 1])

    def both(step):
        out = {}
        for arm in ("auto", "naive"):
            engine.model.attention_arm = arm
            pool_copy = [{k: t.clone() for k, t in layer.items()} for layer in pool]
            out[arm] = step(pool_copy).float()
        engine.model.attention_arm = "auto"
        torch.cuda.synchronize()
        return (out["auto"] - out["naive"]).abs().max().item(), out["auto"]

    token = rng.integers(2, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
    n0 = A.paged_decode_attention.launches
    err_d, logits = both(lambda p: engine.decode_paged(p, token, lengths[:, None], tables)[0])
    if A.paged_decode_attention.launches == n0:
        raise AssertionError("f32 decode_paged did not reach the kernel")
    ptables = np.zeros((BATCH + 2, W + 1), np.int32)
    ptables[:BATCH, :W] = tables
    ptables[BATCH, :W] = np.arange(W) + 1 + BATCH * W
    n_new = 64 - 8
    ids = np.concatenate([token[:, 0], rng.integers(2, cfg.vocab_size, n_new), np.zeros(8, int)])
    positions = np.concatenate([lengths, np.arange(n_new), np.full(8, cfg.max_sequence_length)])
    row_map = np.array(list(range(BATCH)) + [BATCH] * n_new + [BATCH + 1] * 8, np.int32)
    n1 = A.packed_paged_attention.launches
    err_p, plogits = both(lambda p: engine.step_paged(
        p, ids[None].astype(np.int32), positions[None].astype(np.int32), ptables, row_map)[0])
    if A.packed_paged_attention.launches == n1:
        raise AssertionError("f32 step_paged did not reach the kernel")
    for name, err, out in (("decode_paged", err_d, logits), ("step_paged", err_p, plogits)):
        ok = bool(torch.isfinite(out).all()) and err <= LOGIT_TOL
        print(f"f32-compare {name} shape={tuple(out.shape)} max_abs_err={err:.3e} "
              f"tol={LOGIT_TOL:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f32 {name}: kernel arm and plain arm disagree")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to prove",
              file=sys.stderr)
        return 2
    try:
        import relora_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    from relora_tpu_torch.ops import _build

    device = torch.device("cuda")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f}s")

    rows = check_kernels(torch, device)
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    prompts = os.path.join(work, "prompts.txt")
    write_prompts(prompts, 32100)
    launches, _ = drains(torch, prompts)
    for row in rows:
        row["launches"] = launches[row["name"]]
    f32_comparison(torch, device)

    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
