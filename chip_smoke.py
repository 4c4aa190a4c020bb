#!/usr/bin/env python3
"""Quickest proof that the PyTorch port serves and trains on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build     — nvcc builds every kernel of ``relora_tpu_torch/csrc`` for
               sm_90a, one process per source, all started together.
2. kernels   — the paged kernels (1-2) against their plain PyTorch twins on
               the card, at llama_250m (N=16, H=48) and llama_1b (N=32, H=64)
               widths, page 16, table width 64, B=8 with S in {1, 5} and a
               packed T=72, for f32, bf16 and int8 pools; then each is timed at
               the main path's shape beside its plain twin, a gather +
               scaled_dot_product_attention yardstick, and its bound.
3. kernels-3 — the HMMA count of each bf16 flash kernel's SASS
               (``cuobjdump -sass``: the tensor cores are used); the flash
               forward, dK/dV and dQ kernels against their twins: the train
               phase's shape (B=8, S=512, N=16, H=48), grouped heads (N=16,
               n_kv=4, H=64), an unaligned S=200, llama_40m's H=52,
               llama_7b's H=128 and H=50 with grouped heads at S=200, at
               bf16 (tensor-core kernels) and f32 (FMA kernels); then each,
               forward+backward together and the backward alone, timed
               beside its twin, a scaled_dot_product_attention(is_causal=True)
               yardstick (forward, its backward alone from a saved output,
               both) and its bound.
4. drains    — ``relora_tpu_torch.serve_cli`` drains 16 requests (prompts of
               32-512 tokens, 64 new tokens each) for llama_250m at full width,
               ``--random-init --dtype bf16 --max-batch 8 --paged``: at
               ``--kv-dtype bf16``, with ``--packed``, and at ``--kv-dtype int8``.
               The launch counters are zeroed before each drain and read after;
               the drain fails if its kernel never launched.
5. f32       — one ``decode_paged`` and one ``step_paged`` step at f32, the
               kernel arm against the plain arm, compared on logits.
6. train     — ``relora_tpu_torch.main`` trains llama_250m (full width and
               depth, bf16, LoRA r=128 with dropout 0.1) for 9 updates of two
               8 x 512 microbatches on a seeded Zipf corpus written under
               ``build/chip_smoke/``, merging and resetting every 3 updates.
               Fails unless every loss is finite and the last is below the
               first, the run merged and reset at updates 4 and 7, and the
               flash launch counters (zeroed before, read after) equal
               layers x microbatches x updates (+ layers x eval batches for
               the forward).
7. f32-train — one update of a 2-layer llama_250m at f32, the flash arm
               against the naive arm on loss and gradient norm, then one merge
               against an f64 oracle.
8. kernels-4 — the fused LoRA forward, dx and dA/dB kernels (4, 6, 7)
               against their twins: the three llama_250m projection shapes
               (M=4096, r=128; (K, N) = (768, 768), (768, 2560), (2560, 768))
               at bf16 and f32 with W the transposed view the model passes, a
               contiguous W, a ragged M=200, K=72, N=100, r=8, a rank past
               256 (M=1024, K=N=768, r=320), and a tensor scale through the
               autograd Function (ds too); then each timed
               per shape beside its twin, the ordered cuBLAS chain of the
               default path and its bound.
9. fused-train — the train phase again with ``--lora_fused true
               --lora_dropout 0``: the same checks, and the fused launch
               counters equal 7 x layers x (microbatches x updates + eval
               batches) for the forward and 7 x layers x microbatches x
               updates for dx and dA/dB.
10. f32-fused — one update of a 2-layer llama_250m at f32 (TF32 off),
               ``lora_fused`` true against false from the same weights
               (nonzero B) and batch, on loss and gradient norm.
11. kernels-8 — kernel 8 (the int8 dequant matmul) and the int8 fused
               forward and dx (4-int8, 6-int8) against their twins: the three
               projection shapes at bf16 and f32 with q the transposed view of
               the (N, K) codes the model passes, a contiguous (K, N) q, a
               ragged M=200, K=72, N=100, r=8, r=320 at M=1024, K=N=768,
               and a tensor scale through
               FusedLoRAMatmulInt8 (ds and dqscale too) and DequantMatmul;
               then each timed per shape beside its twin, the dequantize +
               cuBLAS chain of the JAX default path and its bound.
12. int8_train — a seeded full-rank llama_250m ``pytorch_model.bin`` (f32)
               written under ``build/chip_smoke/``, then the train phase with
               ``--quantize int8 --warmed_up_model DIR``: the train checks,
               codes nonzero after the warm start and int8 after the merges
               at updates 4 and 7 (which move them), kernel 8 launched 7 x
               layers x (microbatches x updates + eval batches) times and no
               fused kernel.
13. int8_fused_train — the same with ``--lora_fused true --lora_dropout 0``:
               4-int8 launched 7 x layers x (microbatches x updates + eval
               batches) times, 6-int8 and kernel 7 7 x layers x microbatches
               x updates, kernel 8 never.
14. f32-int8 — one update of a 2-layer int8 llama_250m at f32 (TF32 off),
               the fused-int8 arm against the unfused kernel-8 arm from the
               same warm-started weights (nonzero B) and batch, on loss and
               gradient norm; then one int8 merge on the card against an f64
               oracle, to the requant rule.

15. kernels-5 — kernel 5 (the grouped multi-tenant LoRA forward) against its
               twin at bf16 and f32: M in {8, 64, 72} (decode rows, a prefill
               chunk, a packed step) x the three projection shapes, r=128,
               S=4 slots, a mixed idx that includes slot 0, W the transposed
               view; a ragged M=5, K=72, N=100, r=8, S=3; and r=320 (two
               rank chunks of the z pass) at M=72, K=N=768, S=4; then each M and
               shape timed beside its twin, the gathered chain (cuBLAS x @ W
               plus the gathered bmm composite) and its bound.
16. adapters  — a seeded llama_250m base (LoRA r=128) and three seeded tenant
               adapters (tA, tB, tC; alpha 32, 64, 16) written under
               ``build/chip_smoke/`` by ``train/checkpoint.save_checkpoint``;
               then the 16 prompts drained by ``serve_cli --checkpoint BASE
               --no-merge --adapter-dir D --adapters tA,tB`` (base rows
               through kernel 5), round-robin over [base, tA, tB, tC] through
               the scheduler API with 4 slots, sequential and packed, and
               with 3 slots, so adapters load from disk and evict mid-traffic.
               Each drain fails unless kernel 5 launched 7 x 24 times per
               forward; then tenant rows must differ from the base row on a
               shared prompt, and tB after tA on one prompt must equal tB
               alone (the prefix cache is keyed per adapter).
17. f32-adapters — one ``decode_paged`` and one ``step_paged`` step of a
               slotted llama_250m at f32 with a mixed ``adapter_idx``, the
               kernel arm (kernel 5, the paged kernels) against the plain arm
               (the gathered composite, naive attention), compared on logits.

``python3 chip_smoke.py --ab DIR [--train [FLAGS...]]`` times another
checkout's package instead (see :func:`ab`); it checks nothing.

Output: a forward+backward timing line, one line per drain, a train line, a
LoRA timing line, a fused-train line, an int8 timing line, the int8 train
lines, a grouped timing line and one line per adapter drain, a
``{"kernels": [...]}`` line, the card's ``nvidia-smi
--query-gpu=name,power.limit`` line, and last ``{"ok": true, "device":
{...}}``.  Without CUDA, or without the package beside it, it exits non-zero
and prints no result.
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


SLEEP_CYCLES = 10_000_000  # ~5 ms of the H100's clock: longer than any call's enqueue


def time_ms(torch, fn, iters=30):
    """Median device time of ``fn`` over ``iters`` launches, CUDA events
    around each, with a 128 MiB write between launches so the K/V pages come
    from device memory as in a forward (each layer has its own pool).  The
    device sleeps before each start event, so the host has enqueued the
    whole call by the time the window opens: the window holds the device's
    time alone, not the wrapper's Python and launch cost (which a short
    kernel would otherwise wait behind)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
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


# kernel 3 cases: (B, S, N, n_kv, H, dtype); the first is the train phase's
# shape (llama_250m, --batch_size 8 --max_length 512), then grouped-query
# heads at llama_1b's head_dim, an S that is no multiple of the 64-row tile,
# llama_40m's H = 52 (padded to 64 on the card, 8-byte copies), llama_7b's
# H = 128 (the 32-row backward tiles), and H = 50 with grouped heads and a
# ragged S (4-byte copies)
FLASH_CASES = [
    (8, 512, 16, 16, 48, "bf16"), (8, 512, 16, 16, 48, "f32"),
    (2, 512, 16, 4, 64, "bf16"), (2, 512, 16, 4, 64, "f32"),
    (2, 200, 16, 16, 48, "bf16"), (2, 200, 16, 16, 48, "f32"),
    (4, 512, 8, 8, 52, "bf16"), (4, 512, 8, 8, 52, "f32"),
    (1, 512, 32, 32, 128, "bf16"), (1, 512, 32, 32, 128, "f32"),
    (2, 200, 4, 2, 50, "bf16"), (2, 200, 4, 2, 50, "f32"),
]
# error relative to max(1, max|twin|): f32 sums the same terms in another
# order (1e-6 scale at S=512); bf16 outputs round once to bf16 (2^-8 relative)
FLASH_TOL = {"f32": 1e-4, "bf16": 1e-2}
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
FLASH_NAMES = ("flash_attention_forward", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")


def make_flash_case(torch, device, B, S, N, n_kv, H, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    q = torch.randn((B, S, N, H), generator=g, device=device).to(dt)
    k = torch.randn((B, S, n_kv, H), generator=g, device=device).to(dt)
    v = torch.randn((B, S, n_kv, H), generator=g, device=device).to(dt)
    dout = torch.randn((B, S, N, H), generator=g, device=device).to(dt)
    return q, k, v, dout


def flash_bound(q, k, kernel):
    """Least time on an H100 SXM: each input read once and each output
    written once over 3.35 TB/s, against the causal matmul work (in units of
    B*N*S^2*H: forward 2, dK/dV 4 with the recomputed QK^T, dQ 3, forward
    plus backward 2 + 5) over the bf16 tensor-core peak."""
    B, S, N, H = q.shape
    qb = q.numel() * q.element_size()
    kb = k.numel() * k.element_size()
    rows = B * N * S * 4  # one f32 per (b, head, row): lse or delta
    bytes_, units = {
        "forward": (2 * qb + 2 * kb + rows, 2),
        "dkdv": (2 * qb + 4 * kb + 2 * rows, 4),
        "dq": (3 * qb + 2 * kb + 2 * rows, 3),
        "fwd_bwd": (4 * qb + 4 * kb, 7),
    }[kernel]
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = units * B * N * S * S * H / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


FLASH_TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel")


def count_hmma(lib_path):
    """``{kernel: HMMA instructions in its SASS}`` of the bf16 flash kernels
    in the built library (all head-dim instantiations summed), read with
    ``cuobjdump -sass``: nonzero shows the tensor cores are used."""
    from relora_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts = dict.fromkeys(FLASH_TC_KERNELS, 0)
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in FLASH_TC_KERNELS if k in line), None)
        elif current and "HMMA" in line:
            counts[current] += 1
    print(json.dumps({"sass_hmma": counts, "library": os.path.relpath(str(lib_path), REPO)}))
    if not all(counts.values()):
        raise AssertionError(f"a bf16 flash kernel has no HMMA instruction: {counts}")
    return counts


def check_flash_kernels(torch, device):
    """Phase kernels-3: the three flash kernels against their twins on the
    card, then timings at the train phase's shape."""
    import torch.nn.functional as F

    from relora_tpu_torch.ops import flash_attention as FA

    worst = dict.fromkeys(FLASH_NAMES, 0.0)
    for i, (B, S, N, n_kv, H, dtype) in enumerate(FLASH_CASES):
        q, k, v, dout = make_flash_case(torch, device, B, S, N, n_kv, H, dtype, seed=11 + i)
        scale = H**-0.5
        want_out, want_lse = FA.flash_attention_forward_plain(q, k, v, scale)
        delta = FA.flash_attention_delta(want_out, dout)
        got_out, got_lse = FA.flash_attention_forward(q, k, v, scale)
        pairs = {
            "flash_attention_forward": [(got_out, want_out), (got_lse, want_lse)],
            "flash_attention_bwd_dkdv": list(zip(
                FA.flash_attention_bwd_dkdv(q, k, v, dout, want_lse, delta, scale),
                FA.flash_attention_bwd_dkdv_plain(q, k, v, dout, want_lse, delta, scale))),
            "flash_attention_bwd_dq": [(
                FA.flash_attention_bwd_dq(q, k, v, dout, want_lse, delta, scale),
                FA.flash_attention_bwd_dq_plain(q, k, v, dout, want_lse, delta, scale))],
        }
        torch.cuda.synchronize()
        for name, outs in pairs.items():
            err = rel = peak = 0.0
            finite = True
            for got, want in outs:
                got, want = got.float(), want.float()
                finite = finite and bool(torch.isfinite(got).all() and torch.isfinite(want).all())
                diff = (got - want).abs().max().item()
                err = max(err, diff)
                peak = max(peak, want.abs().max().item())
                rel = max(rel, diff / max(1.0, want.abs().max().item()))
            ok = finite and peak > 0 and rel <= FLASH_TOL[dtype]
            print(f"kernel-check {name} B={B} S={S} N={N} n_kv={n_kv} H={H} {dtype} "
                  f"max_abs_err={err:.3e} rel_err={rel:.3e} max_abs={peak:.3e} "
                  f"tol={FLASH_TOL[dtype]:g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain twin ({B, S, N, n_kv, H, dtype})")
            if i == 0:
                worst[name] = err

    B, S, N, n_kv, H, dtype = FLASH_CASES[0]
    q, k, v, dout = make_flash_case(torch, device, B, S, N, n_kv, H, dtype, seed=99)
    scale = H**-0.5
    out, lse = FA.flash_attention_forward(q, k, v, scale)
    delta = FA.flash_attention_delta(out, dout)
    bwd = (q, k, v, dout, lse, delta, scale)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    # SDPA's backward alone, from one saved forward: dQ, dK and dV together
    sdpa_in = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_in, is_causal=True)
    dout_t = dout.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, sdpa_in, dout_t, retain_graph=True)

    sdpa_bwd_ms = time_ms(torch, sdpa_bwd)

    def fwd_bwd(attend, inputs, cotangent):
        leaves = [x.detach().requires_grad_() for x in inputs]
        return torch.autograd.grad(attend(*leaves), leaves, cotangent)

    def plain_fwd_bwd():
        o, l = FA.flash_attention_forward_plain(q, k, v, scale)
        d = FA.flash_attention_delta(o, dout)
        FA.flash_attention_bwd_dkdv_plain(q, k, v, dout, l, d, scale)
        FA.flash_attention_bwd_dq_plain(q, k, v, dout, l, d, scale)

    # the backward rows both carry SDPA's backward, which computes dQ, dK and
    # dV in one call
    rows = []
    for name, kernel, fn, plain, library_ms in (
        ("flash_attention_forward", "forward", lambda: FA.flash_attention_forward(q, k, v, scale),
         lambda: FA.flash_attention_forward_plain(q, k, v, scale), time_ms(torch, sdpa)),
        ("flash_attention_bwd_dkdv", "dkdv", lambda: FA.flash_attention_bwd_dkdv(*bwd),
         lambda: FA.flash_attention_bwd_dkdv_plain(*bwd), sdpa_bwd_ms),
        ("flash_attention_bwd_dq", "dq", lambda: FA.flash_attention_bwd_dq(*bwd),
         lambda: FA.flash_attention_bwd_dq_plain(*bwd), sdpa_bwd_ms),
    ):
        bound_ms, bound_by = flash_bound(q, k, kernel)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "relora_tpu_torch/csrc/flash_attention.cu",
            "replaces": "relora_tpu/ops/attention.py:84",
            "launches": 0,
            "max_abs_err": worst[name],
            "ms": time_ms(torch, fn),
            "plain_ms": time_ms(torch, plain),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        })
    bound_ms, bound_by = flash_bound(q, k, "fwd_bwd")
    pair = {
        "flash_fwd_bwd": "forward+backward",
        "shape": [B, S, N, n_kv, H, dtype],
        "ms": time_ms(torch, lambda: fwd_bwd(FA.flash_attention, (q, k, v), dout)),
        "plain_ms": time_ms(torch, plain_fwd_bwd),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": time_ms(torch, lambda: fwd_bwd(
            lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True),
            (qt, kt, vt), dout_t)),
        "backward_ms": time_ms(torch, lambda: (FA.flash_attention_bwd_dkdv(*bwd),
                                               FA.flash_attention_bwd_dq(*bwd))),
        "library_backward_ms": sdpa_bwd_ms,
    }
    print(json.dumps(pair))
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


TRAIN_UPDATES = 9
TRAIN_MICRO = 2
TRAIN_ARGS = [
    "--model_config", "llama_250m", "--dtype", "bfloat16",
    "--batch_size", "8", "--total_batch_size", "16", "--max_length", "512",
    "--use_peft", "true", "--lora_r", "128", "--lr", "1e-3", "--relora", "3",
    "--cycle_length", "3", "--scheduler", "cosine_restarts", "--warmup_steps", "2",
    "--restart_warmup_steps", "1", "--num_training_steps", str(TRAIN_UPDATES),
    "--eval_every", "1000",
]
# f32-train: flash arm vs naive arm after 2 layers (f32 sums in another
# order, 1e-6 scale per op); the merge vs an f64 oracle at f32 rounding
F32_TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "merge": 1e-6}


def write_corpus(work, vocab=32100, seed=0):
    """A seeded Megatron memmap corpus of Zipf-distributed token ids (so the
    loss has something to learn) and its JSON-form data config."""
    import numpy as np

    from relora_tpu_torch.data.memmap import MemmapTokenWriter

    rng = np.random.default_rng(seed)
    prefix = os.path.join(work, "zipf_corpus")
    with MemmapTokenWriter(prefix, dtype=np.uint16) as w:
        for _ in range(600):
            w.add_document((rng.zipf(1.2, int(rng.integers(200, 1500))) - 1) % vocab)
    path = os.path.join(work, "zipf_data.json")
    with open(path, "w") as f:
        json.dump({"data_path": prefix, "split": "95,5,0", "seq_length": 512, "seed": 1234}, f)
    return path


LORA_NAMES = ("fused_lora_forward", "fused_lora_bwd_dx", "fused_lora_bwd_dab")
INT8_NAMES = ("dequant_matmul", "fused_lora_int8_forward", "fused_lora_int8_bwd_dx")


def _counters():
    """``{name: wrapper}`` of every kernel wrapper a training run launches."""
    from relora_tpu_torch.ops import flash_attention as FA
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.ops import quant_matmul as QM

    return {**{n: getattr(FA, n) for n in FLASH_NAMES}, **{n: getattr(LM, n) for n in LORA_NAMES},
            "dequant_matmul": QM.dequant_matmul,
            **{n: getattr(LM, n) for n in INT8_NAMES[1:]}}


class MergeWatch:
    """Wraps the trainer's ``merge_and_reinit`` to read every int8 base
    around each merge: the codes' dtype, how many are nonzero before, and
    whether the merge moved them."""

    def __init__(self, torch):
        from relora_tpu_torch.train import trainer

        self.torch, self.trainer, self.real = torch, trainer, trainer.merge_and_reinit
        self.merges = []

    def __enter__(self):
        self.trainer.merge_and_reinit = self._merge
        return self

    def __exit__(self, *exc):
        self.trainer.merge_and_reinit = self.real

    def _merge(self, model, *args, **kwargs):
        from relora_tpu_torch.core.relora import lora_modules

        codes = [m.weight_q for _, m in lora_modules(model) if getattr(m, "weight_q", None) is not None]
        before = [q.clone() for q in codes]
        out = self.real(model, *args, **kwargs)
        self.merges.append({
            "modules": len(codes),
            "nonzero_before": sum(int(q.count_nonzero()) for q in before),
            "int8_after": all(q.dtype == self.torch.int8 for q in codes),
            "moved": sum(int(not self.torch.equal(q, b)) for q, b in zip(codes, before)),
        })
        return out


def train(torch, data_config, label="train", extra=()):
    """Phases train, fused-train, int8_train and int8_fused_train:
    ``relora_tpu_torch.main`` on the card, counters read around the run, and
    for an int8 base each merge's codes read around it."""
    from relora_tpu_torch import main as train_main
    from relora_tpu_torch.config.model import load_model_config

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    with MergeWatch(torch) as watch:
        result = train_main.main(TRAIN_ARGS + list(extra) + ["--megatron_dataset_config", data_config])
    launches = {n: c.launches for n, c in counters.items()}

    records = result["records"]
    losses = [r["loss"] for r in records]
    layers = load_model_config("llama_250m").num_hidden_layers
    backward = layers * TRAIN_MICRO * TRAIN_UPDATES
    forward = backward + layers * result["eval_batches"]
    fused = "--lora_fused" in extra
    int8 = "--quantize" in extra
    want = {
        "flash_attention_forward": forward,
        "flash_attention_bwd_dkdv": backward,
        "flash_attention_bwd_dq": backward,
        "fused_lora_forward": 7 * forward if fused and not int8 else 0,
        "fused_lora_bwd_dx": 7 * backward if fused and not int8 else 0,
        "fused_lora_bwd_dab": 7 * backward if fused else 0,
        "dequant_matmul": 7 * forward if int8 and not fused else 0,
        "fused_lora_int8_forward": 7 * forward if int8 and fused else 0,
        "fused_lora_int8_bwd_dx": 7 * backward if int8 and fused else 0,
    }
    merges_at = [r["update_step"] for a, r in zip([None] + records, records)
                 if a is not None and r["n_lora_restarts"] > a["n_lora_restarts"]]
    resets_at = [r["update_step"] for a, r in zip([None] + records, records)
                 if a is not None and r["n_optimizer_resets"] > a["n_optimizer_resets"]]
    steady = sorted(r["update_seconds"] for r in records[1:])
    ms = steady[len(steady) // 2] * 1e3
    line = {
        label: "llama_250m", "updates": len(records), "ms_per_update": ms,
        "tokens_per_s": 16 * 512 / (ms / 1e3), "first_loss": losses[0], "last_loss": losses[-1],
        "final_eval_loss": result.get("final_eval_loss"), "merges_at": merges_at,
        "resets_at": resets_at, "eval_batches": result["eval_batches"], "launches": launches,
        "fit_seconds": result["fit_seconds"],
    }
    if int8:
        line["int8_merges"] = watch.merges
    print(json.dumps(line))
    if len(records) != TRAIN_UPDATES or not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"{label}: expected {TRAIN_UPDATES} finite losses, got {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall ({losses[0]} -> {losses[-1]})")
    if merges_at != [4, 7] or resets_at != [4, 7] or result["n_lora_restarts"] != 2:
        raise AssertionError(f"{label}: merges at {merges_at}, resets at {resets_at}, expected [4, 7]")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    if int8 and not (len(watch.merges) == 2 and all(
            m["modules"] == 7 * layers and m["nonzero_before"] > 0 and m["int8_after"]
            and m["moved"] > 0 for m in watch.merges)):
        raise AssertionError(f"{label}: int8 merges {watch.merges}: expected 2 merges over the "
                             f"nonzero int8 codes of {7 * layers} projections, moving them")
    return launches


def f32_train(torch, device):
    """Phase f32-train: one update through the flash arm and the naive arm
    from the same weights and batch, then a merge against an f64 oracle."""
    import dataclasses

    import numpy as np

    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.core import optim, relora
    from relora_tpu_torch.models.llama import LlamaForCausalLM
    from relora_tpu_torch.models.params_util import init_params
    from relora_tpu_torch.ops import flash_attention as FA
    from relora_tpu_torch.train.step import TrainState, make_train_step

    cfg = dataclasses.replace(load_model_config("llama_250m"), num_hidden_layers=2)
    spec = relora.LoraSpec(r=128, alpha=32.0, dropout=0.0)
    rng = np.random.default_rng(5)
    batch = torch.as_tensor((rng.zipf(1.2, (2, 4, 512)) - 1) % cfg.vocab_size, device=device)
    state_dict, out = None, {}
    n0 = FA.flash_attention_bwd_dq.launches
    for arm in ("flash", "naive"):
        with torch.device(device):
            model = LlamaForCausalLM(cfg, dtype=torch.float32, attention_arm=arm, lora=spec)
        if state_dict is None:
            init_params(model, torch.Generator(device=device).manual_seed(3))
            state_dict = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(state_dict)
        relora.set_trainable(model)
        opt = optim.build_optimizer(p for p in model.parameters() if p.requires_grad)
        step = make_train_step(model, opt, clip_grad_norm=1.0, schedule=lambda s: 1e-3)
        out[arm] = (step(TrainState(), batch), model)
    if FA.flash_attention_bwd_dq.launches == n0:
        raise AssertionError("f32-train: the flash arm did not reach the kernels")
    (mf, model), (mn, _) = out["flash"], out["naive"]
    errs = {k: abs(mf[k] - mn[k]) / abs(mn[k]) for k in ("loss", "grad_norm")}

    module = model.layers[0].self_attn.q_proj
    oracle = module.weight.double() + (
        module.lora_a.double() @ module.lora_b.double() * spec.scale).t()
    relora.merge_and_reinit(model, torch.Generator(device=device).manual_seed(4), spec)
    errs["merge"] = ((module.weight.double() - oracle).abs().max() / oracle.abs().max()).item()
    for key, err in errs.items():
        ok = err <= F32_TRAIN_TOL[key]
        print(f"f32-train {key} flash={mf.get(key)} naive={mn.get(key)} rel_err={err:.3e} "
              f"tol={F32_TRAIN_TOL[key]:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f32-train: {key} off by {err:.3e}")


# kernels 4, 6, 7: llama_250m's projections at the train phase's M = 8 x 512
# and r = 128, (K, N) per shape and how many of each one decoder layer runs
LORA_M, LORA_R = 8 * 512, 128
LORA_SHAPES = ((768, 768, 4), (768, 2560, 2), (2560, 768, 1))  # q/k/v/o, gate/up, down
# error relative to max(1, max|twin|): f32 sums K = 2560 terms in another
# order; bf16 outputs round once to bf16 (2^-8 relative)
LORA_TOL = {"f32": 1e-4, "bf16": 1e-2}
LORA_LINES = {"fused_lora_forward": 102, "fused_lora_bwd_dx": 317, "fused_lora_bwd_dab": 343}


def make_lora_case(torch, device, M, K, N, r, dtype, seed, transposed=True):
    """x, W (K, N), A, B and a cotangent g, drawn like a layer's: W as the
    (N, K) weight's transposed view (or a contiguous (K, N) copy), A
    kaiming-uniform, B small."""
    g = torch.Generator(device=device).manual_seed(seed)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = torch.randn((M, K), generator=g, device=device).to(dt)
    w_nk = (torch.randn((N, K), generator=g, device=device) * 0.02).to(dt)
    a = ((torch.rand((K, r), generator=g, device=device) * 2 - 1) / K**0.5).to(dt)
    b = (torch.randn((r, N), generator=g, device=device) * 0.02).to(dt)
    gy = torch.randn((M, N), generator=g, device=device).to(dt)
    return x, (w_nk.t() if transposed else w_nk.t().contiguous()), a, b, gy


def _rel_err(pairs):
    """(max abs error, error relative to max(1, max|twin|), all finite)."""
    err = rel = 0.0
    finite = True
    for got, want in pairs:
        got, want = got.float(), want.float()
        finite = finite and bool(got.isfinite().all() and want.isfinite().all())
        diff = (got - want).abs().max().item()
        err = max(err, diff)
        rel = max(rel, diff / max(1.0, want.abs().max().item()))
    return err, rel, finite


def lora_bound(M, K, N, r, e, kernel):
    """The two terms of the least time on an H100 SXM, in ms: each input
    read once and each output written once (e bytes per element, f32 for z,
    u, dA, dB) over 3.35 TB/s, and the matmul work over the bf16
    tensor-core peak.  dA/dB as the main path calls it, with u from dx."""
    bytes_, flops = {
        "fused_lora_forward": (e * (M * K + K * N + K * r + r * N + M * N) + 4 * M * r,
                               2 * M * (K * N + K * r + r * N)),
        "fused_lora_bwd_dx": (e * (M * N + K * N + K * r + r * N + M * K) + 4 * M * r,
                              2 * M * (N * K + N * r + r * K)),
        "fused_lora_bwd_dab": (e * (M * N + M * K) + 4 * (2 * M * r + K * r + r * N),
                               2 * M * r * (K + N)),
    }[kernel]
    return bytes_ / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3


def check_lora_kernels(torch, device):
    """Phase kernels-4: kernels 4, 6, 7 against their twins on the card,
    then timings per llama_250m shape beside the twin, the ordered cuBLAS
    chain of the default path and the bound."""
    import torch.nn.functional as F

    from relora_tpu_torch.core.relora import full_f32_matmul
    from relora_tpu_torch.ops import lora_matmul as LM

    worst = dict.fromkeys(LORA_NAMES, 0.0)
    cases = [(LORA_M, K, N, LORA_R, dt, True) for K, N, _ in LORA_SHAPES
             for dt in ("bf16", "f32")]
    cases += [(LORA_M, 768, 768, LORA_R, dt, False) for dt in ("bf16", "f32")]
    cases += [(200, 72, 100, 8, dt, True) for dt in ("bf16", "f32")]
    cases += [(1024, 768, 768, 320, dt, True) for dt in ("bf16", "f32")]  # a rank past 256
    with full_f32_matmul():
        for i, (M, K, N, r, dtype, transposed) in enumerate(cases):
            x, w, a, b, gy = make_lora_case(torch, device, M, K, N, r, dtype, seed=21 + i,
                                            transposed=transposed)
            s = 0.25
            y0, z0 = LM.fused_lora_forward_plain(x, w, a, b, s)
            dx0, u0 = LM.fused_lora_bwd_dx_plain(gy, w, a, b, s)
            dab0 = LM.fused_lora_bwd_dab_plain(gy, x, z0, b, s, u0)
            pairs = {
                "fused_lora_forward": list(zip(LM.fused_lora_forward(x, w, a, b, s), (y0, z0))),
                "fused_lora_bwd_dx": list(zip(LM.fused_lora_bwd_dx(gy, w, a, b, s), (dx0, u0))),
                "fused_lora_bwd_dab": list(zip(LM.fused_lora_bwd_dab(gy, x, z0, b, s, u0), dab0))
                + list(zip(LM.fused_lora_bwd_dab(gy, x, z0, b, s), dab0)),
            }
            torch.cuda.synchronize()
            for name, outs in pairs.items():
                err, rel, finite = _rel_err(outs)
                ok = finite and rel <= LORA_TOL[dtype]
                print(f"kernel-check {name} M={M} K={K} N={N} r={r} {dtype} "
                      f"W={'(N,K).t()' if transposed else '(K,N)'} max_abs_err={err:.3e} "
                      f"rel_err={rel:.3e} tol={LORA_TOL[dtype]:g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain twin ({M, K, N, r, dtype})")
                if dtype == "bf16" and M == LORA_M and transposed:
                    worst[name] = max(worst[name], err)

        # a tensor scale through the autograd Function against autograd of
        # the plain composite, ds included
        x, w, a, b, gy = make_lora_case(torch, device, LORA_M, 768, 768, LORA_R, "f32", seed=40)
        s = torch.tensor([0.7], device=device)
        got_in = [t.clone().requires_grad_() for t in (x, a, b, s)]
        want_in = [t.clone().requires_grad_() for t in (x, a, b, s)]
        got = LM.fused_lora_matmul(got_in[0], w, *got_in[1:])
        xw, aw, bw, sw = want_in
        want = xw @ w + ((xw @ aw) @ bw) * sw
        got.backward(gy)
        want.backward(gy)
        torch.cuda.synchronize()
        grads = [(p.grad, q.grad) for p, q in zip(got_in, want_in)]
        for name, pair in zip(("y", "dx", "dA", "dB", "ds"), [(got, want)] + grads):
            err, rel, finite = _rel_err([pair])
            ok = finite and rel <= LORA_TOL["f32"]
            print(f"kernel-check FusedLoRAMatmul tensor-s {name} M={LORA_M} K=768 N=768 "
                  f"r={LORA_R} f32 max_abs_err={err:.3e} rel_err={rel:.3e} "
                  f"tol={LORA_TOL['f32']:g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"FusedLoRAMatmul with a tensor scale: {name} disagrees")

    # per layer: ms, plain_ms, library_ms (the chain), bound_ms and its two terms
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")
    rows = {name: dict.fromkeys(keys, 0.0) for name in LORA_NAMES}
    per_shape = []
    for K, N, count in LORA_SHAPES:
        x, w, a, b, gy = make_lora_case(torch, device, LORA_M, K, N, LORA_R, "bf16", seed=99)
        w_nk, s = w.t(), 0.25
        y, z = LM.fused_lora_forward(x, w, a, b, s)
        _, u = LM.fused_lora_bwd_dx(gy, w, a, b, s)
        gs = gy * s
        dz = gs @ b.t()
        zb = z.to(x.dtype)
        calls = {
            "fused_lora_forward": (lambda: LM.fused_lora_forward(x, w, a, b, s),
                                   lambda: LM.fused_lora_forward_plain(x, w, a, b, s),
                                   lambda: F.linear(x, w_nk) + ((x @ a) @ b) * s),
            "fused_lora_bwd_dx": (lambda: LM.fused_lora_bwd_dx(gy, w, a, b, s),
                                  lambda: LM.fused_lora_bwd_dx_plain(gy, w, a, b, s),
                                  lambda: gy @ w_nk + ((gy * s) @ b.t()) @ a.t()),
            "fused_lora_bwd_dab": (lambda: LM.fused_lora_bwd_dab(gy, x, z, b, s, u),
                                   lambda: LM.fused_lora_bwd_dab_plain(gy, x, z, b, s, u),
                                   lambda: (x.t() @ dz, zb.t() @ gs)),
        }
        shape = {"K": K, "N": N, "M": LORA_M, "r": LORA_R, "per_layer": count}
        for name, (fn, plain, chain) in calls.items():
            t_bytes, t_ops = lora_bound(LORA_M, K, N, LORA_R, 2, name)
            ms, plain_ms, chain_ms = time_ms(torch, fn), time_ms(torch, plain), time_ms(torch, chain)
            shape[name] = {"ms": ms, "plain_ms": plain_ms, "chain_ms": chain_ms,
                           "bound_ms": max(t_bytes, t_ops),
                           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            for key, v in zip(keys, (ms, plain_ms, chain_ms, max(t_bytes, t_ops), t_bytes, t_ops)):
                rows[name][key] += count * v
        per_shape.append(shape)
    print(json.dumps({"lora_timings": "bf16, ms per call; chain = the default path's ordered "
                      "cuBLAS matmuls, timed only", "shapes": per_shape}))
    # one decoder layer's seven projections (4 x 768->768, 2 x 768->2560,
    # 1 x 2560->768) summed; no single PyTorch call computes any of the three
    # functions, so library_ms is the ordered chain
    return [{
        "name": name,
        "route": "cuda",
        "source": "relora_tpu_torch/csrc/lora_matmul.cu",
        "replaces": f"relora_tpu/ops/pallas_lora_matmul.py:{LORA_LINES[name]}",
        "launches": 0,
        "max_abs_err": worst[name],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes" if row["t_bytes"] >= row["t_ops"] else "operations",
        "library_ms": row["library_ms"],
    } for name, row in rows.items()]


def f32_fused(torch, device):
    """Phase f32-fused: one update with lora_fused true and false from the
    same weights (B drawn nonzero) and batch, at f32 with TF32 off."""
    import dataclasses

    import numpy as np

    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.core import optim, relora
    from relora_tpu_torch.models.llama import LlamaForCausalLM
    from relora_tpu_torch.models.params_util import init_params
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.train.step import TrainState, make_train_step

    cfg = dataclasses.replace(load_model_config("llama_250m"), num_hidden_layers=2)
    rng = np.random.default_rng(6)
    batch = torch.as_tensor((rng.zipf(1.2, (2, 4, 512)) - 1) % cfg.vocab_size, device=device)
    state_dict, out = None, {}
    n0 = LM.fused_lora_bwd_dab.launches
    with relora.full_f32_matmul():
        for fused in (True, False):
            spec = relora.LoraSpec(r=128, alpha=32.0, dropout=0.0, fused=fused)
            with torch.device(device):
                model = LlamaForCausalLM(cfg, dtype=torch.float32, attention_arm="flash", lora=spec)
            if state_dict is None:
                gen = torch.Generator(device=device).manual_seed(3)
                init_params(model, gen)
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        if name.endswith("lora_b"):
                            p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
                state_dict = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(state_dict)
            relora.set_trainable(model)
            opt = optim.build_optimizer(p for p in model.parameters() if p.requires_grad)
            step = make_train_step(model, opt, clip_grad_norm=1.0, schedule=lambda s: 1e-3)
            out[fused] = step(TrainState(), batch)
    if LM.fused_lora_bwd_dab.launches == n0:
        raise AssertionError("f32-fused: the fused arm did not reach the kernels")
    for key in ("loss", "grad_norm"):
        err = abs(out[True][key] - out[False][key]) / abs(out[False][key])
        ok = err <= F32_TRAIN_TOL[key]
        print(f"f32-fused {key} fused={out[True][key]} unfused={out[False][key]} rel_err={err:.3e} "
              f"tol={F32_TRAIN_TOL[key]:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f32-fused: {key} off by {err:.3e}")


# kernel 8 and the int8 variants of 4 and 6, at kernels-4's shapes
INT8_LINES = {"dequant_matmul": "pallas_quant_matmul.py:46",
              "fused_lora_int8_forward": "pallas_lora_matmul.py:88",
              "fused_lora_int8_bwd_dx": "pallas_lora_matmul.py:279"}


def make_int8_case(torch, device, M, K, N, r, dtype, seed, transposed=True):
    """x, the int8 base (q (K, N), qscale (1, N)) quantized from a layer-like
    (N, K) weight, A, B and a cotangent g.  q is the (N, K) codes'
    transposed view, as the model passes it, or a contiguous (K, N) copy."""
    from relora_tpu_torch.ops.quant import quantize_int8

    x, w, a, b, gy = make_lora_case(torch, device, M, K, N, r, dtype, seed)
    q_nk, qscale = quantize_int8(w.t())
    return x, (q_nk.t() if transposed else q_nk.t().contiguous()), qscale, a, b, gy


def int8_bound(M, K, N, r, e, kernel):
    """The two terms of the least time on an H100 SXM, in ms: each input
    read once and each output written once (e bytes per activation element,
    1 per code, f32 scales, z and u) over 3.35 TB/s, and the matmul work over
    the bf16 tensor-core peak."""
    base = K * N + 4 * N
    bytes_, flops = {
        "dequant_matmul": (e * (M * K + M * N) + base, 2 * M * K * N),
        "fused_lora_int8_forward": (e * (M * K + K * r + r * N + M * N) + base + 4 * M * r,
                                    2 * M * (K * N + K * r + r * N)),
        "fused_lora_int8_bwd_dx": (e * (M * N + K * r + r * N + M * K) + base + 4 * M * r,
                                   2 * M * (N * K + N * r + r * K)),
    }[kernel]
    return bytes_ / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3


def check_int8_kernels(torch, device):
    """Phase kernels-8: kernel 8 and the int8 fused forward and dx against
    their twins on the card, then timings per llama_250m shape beside the
    twin, the JAX default path's dequantize + cuBLAS chain and the bound."""
    import torch.nn.functional as F

    from relora_tpu_torch.core.relora import full_f32_matmul
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.ops import quant_matmul as QM

    worst = dict.fromkeys(INT8_NAMES, 0.0)
    cases = [(LORA_M, K, N, LORA_R, dt, True) for K, N, _ in LORA_SHAPES
             for dt in ("bf16", "f32")]
    cases += [(LORA_M, 768, 768, LORA_R, dt, False) for dt in ("bf16", "f32")]
    cases += [(200, 72, 100, 8, dt, True) for dt in ("bf16", "f32")]
    cases += [(1024, 768, 768, 320, dt, True) for dt in ("bf16", "f32")]  # a rank past 256
    with full_f32_matmul(), torch.no_grad():
        for i, (M, K, N, r, dtype, transposed) in enumerate(cases):
            x, q, qs, a, b, gy = make_int8_case(torch, device, M, K, N, r, dtype, seed=51 + i,
                                                transposed=transposed)
            s = 0.25
            pairs = {
                "dequant_matmul": [(QM.dequant_matmul(x, q, qs), QM.dequant_matmul_plain(x, q, qs))],
                "fused_lora_int8_forward": list(zip(LM.fused_lora_int8_forward(x, q, qs, a, b, s),
                                                    LM.fused_lora_int8_forward_plain(x, q, qs, a, b, s))),
                "fused_lora_int8_bwd_dx": list(zip(LM.fused_lora_int8_bwd_dx(gy, q, qs, a, b, s),
                                                   LM.fused_lora_int8_bwd_dx_plain(gy, q, qs, a, b, s))),
            }
            torch.cuda.synchronize()
            for name, outs in pairs.items():
                err, rel, finite = _rel_err(outs)
                ok = finite and rel <= LORA_TOL[dtype]
                print(f"kernel-check {name} M={M} K={K} N={N} r={r} {dtype} "
                      f"q={'(N,K).t()' if transposed else '(K,N)'} max_abs_err={err:.3e} "
                      f"rel_err={rel:.3e} tol={LORA_TOL[dtype]:g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain twin ({M, K, N, r, dtype})")
                if dtype == "bf16" and M == LORA_M and transposed:
                    worst[name] = max(worst[name], err)

    # a tensor scale (and a qscale that asks for its gradient) through both
    # Functions against autograd of the plain composite
    with full_f32_matmul():
        x, q, qs, a, b, gy = make_int8_case(torch, device, LORA_M, 768, 768, LORA_R, "f32", seed=60)
        s = torch.tensor([0.7], device=device)
        checks = []
        got_in = [t.clone().requires_grad_() for t in (x, qs, a, b, s)]
        want_in = [t.clone().requires_grad_() for t in (x, qs, a, b, s)]
        got = LM.fused_lora_matmul_int8(got_in[0], q, *got_in[1:])
        xw, qw, aw, bw, sw = want_in
        want = xw @ LM.dequantize_kn(q, qw) + ((xw @ aw) @ bw) * sw
        got.backward(gy)
        want.backward(gy)
        checks += [("FusedLoRAMatmulInt8", n, pair) for n, pair in zip(
            ("y", "dx", "dqscale", "dA", "dB", "ds"),
            [(got, want)] + [(p.grad, r.grad) for p, r in zip(got_in, want_in)])]
        got_in = [t.clone().requires_grad_() for t in (x, qs)]
        want_in = [t.clone().requires_grad_() for t in (x, qs)]
        got = QM.dequant_matmul(got_in[0], q, got_in[1])
        want = want_in[0] @ LM.dequantize_kn(q, want_in[1])
        got.backward(gy)
        want.backward(gy)
        checks += [("DequantMatmul", n, pair) for n, pair in zip(
            ("y", "dx", "dscale"), [(got, want)] + [(p.grad, r.grad) for p, r in zip(got_in, want_in)])]
        torch.cuda.synchronize()
        for fn_name, name, pair in checks:
            err, rel, finite = _rel_err([pair])
            ok = finite and rel <= LORA_TOL["f32"]
            print(f"kernel-check {fn_name} tensor-s {name} M={LORA_M} K=768 N=768 r={LORA_R} f32 "
                  f"max_abs_err={err:.3e} rel_err={rel:.3e} tol={LORA_TOL['f32']:g} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{fn_name} with a tensor scale: {name} disagrees")

    from relora_tpu_torch.ops.quant import dequantize_int8

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")
    rows = {name: dict.fromkeys(keys, 0.0) for name in INT8_NAMES}
    per_shape = []
    with torch.no_grad():
        for K, N, count in LORA_SHAPES:
            x, q, qs, a, b, gy = make_int8_case(torch, device, LORA_M, K, N, LORA_R, "bf16", seed=99)
            q_nk, s = q.t(), 0.25

            def deq():
                return dequantize_int8(q_nk, qs, x.dtype)

            calls = {
                "dequant_matmul": (lambda: QM.dequant_matmul(x, q, qs),
                                   lambda: QM.dequant_matmul_plain(x, q, qs),
                                   lambda: F.linear(x, deq())),
                "fused_lora_int8_forward": (lambda: LM.fused_lora_int8_forward(x, q, qs, a, b, s),
                                            lambda: LM.fused_lora_int8_forward_plain(x, q, qs, a, b, s),
                                            lambda: F.linear(x, deq()) + ((x @ a) @ b) * s),
                "fused_lora_int8_bwd_dx": (lambda: LM.fused_lora_int8_bwd_dx(gy, q, qs, a, b, s),
                                           lambda: LM.fused_lora_int8_bwd_dx_plain(gy, q, qs, a, b, s),
                                           lambda: gy @ deq() + ((gy * s) @ b.t()) @ a.t()),
            }
            shape = {"K": K, "N": N, "M": LORA_M, "r": LORA_R, "per_layer": count}
            for name, (fn, plain, chain) in calls.items():
                t_bytes, t_ops = int8_bound(LORA_M, K, N, LORA_R, 2, name)
                ms, plain_ms, chain_ms = time_ms(torch, fn), time_ms(torch, plain), time_ms(torch, chain)
                shape[name] = {"ms": ms, "plain_ms": plain_ms, "chain_ms": chain_ms,
                               "bound_ms": max(t_bytes, t_ops),
                               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
                for key, v in zip(keys, (ms, plain_ms, chain_ms, max(t_bytes, t_ops), t_bytes, t_ops)):
                    rows[name][key] += count * v
            per_shape.append(shape)
    print(json.dumps({"int8_timings": "bf16 activations, int8 base, ms per call; chain = the JAX "
                      "default path's dequantize + cuBLAS matmuls, timed only", "shapes": per_shape}))
    # one decoder layer's seven projections summed, as kernels-4; no single
    # PyTorch call computes any of the three, so library_ms is the chain
    return [{
        "name": name,
        "route": "cuda",
        "source": "relora_tpu_torch/csrc/lora_matmul.cu",
        "replaces": f"relora_tpu/ops/{INT8_LINES[name]}",
        "launches": 0,
        "max_abs_err": worst[name],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes" if row["t_bytes"] >= row["t_ops"] else "operations",
        "library_ms": row["library_ms"],
    } for name, row in rows.items()]


def write_warm_start(torch, path, device, seed=11, model_config="llama_250m"):
    """A full-rank ``model_config`` with seeded random weights, saved as an f32
    HF-named ``path/pytorch_model.bin`` (``model.`` prefix, ``lm_head``
    without it) for ``--warmed_up_model path``; returns ``path``."""
    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.models.llama import LlamaForCausalLM
    from relora_tpu_torch.models.params_util import init_params

    os.makedirs(path, exist_ok=True)
    with torch.device(device):
        model = LlamaForCausalLM(load_model_config(model_config))
    init_params(model, torch.Generator(device=device).manual_seed(seed))
    torch.save({(k if k == "lm_head.weight" else f"model.{k}"): v.cpu()
                for k, v in model.state_dict().items()}, os.path.join(path, "pytorch_model.bin"))
    return path


# f32-int8: the merge against an f64 oracle, to the requant rule
INT8_MERGE_MIN_EQUAL = 0.999


def f32_int8(torch, device, warm):
    """Phase f32-int8: one update with the fused-int8 and the unfused
    kernel-8 arms from the same warm-started weights (B drawn nonzero) and
    batch at f32 with TF32 off, then one int8 merge against an f64 oracle."""
    import dataclasses

    import numpy as np

    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.core import optim, relora
    from relora_tpu_torch.models.llama import LlamaForCausalLM
    from relora_tpu_torch.models.params_util import init_params
    from relora_tpu_torch.models.warm_start import graft_base_weights
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.ops import quant_matmul as QM
    from relora_tpu_torch.train.step import TrainState, make_train_step

    cfg = dataclasses.replace(load_model_config("llama_250m"), num_hidden_layers=2)
    source = torch.load(os.path.join(warm, "pytorch_model.bin"), map_location="cpu", weights_only=True)
    source = {k: v for k, v in source.items() if not k.startswith("model.layers.")
              or int(k.split(".")[2]) < 2}
    rng = np.random.default_rng(7)
    batch = torch.as_tensor((rng.zipf(1.2, (2, 4, 512)) - 1) % cfg.vocab_size, device=device)
    state_dict, out = None, {}
    n_deq, n_dx = QM.dequant_matmul.launches, LM.fused_lora_int8_bwd_dx.launches
    with relora.full_f32_matmul():
        for fused in (True, False):
            spec = relora.LoraSpec(r=128, alpha=32.0, dropout=0.0, quantize="int8", fused=fused)
            with torch.device(device):
                model = LlamaForCausalLM(cfg, dtype=torch.float32, attention_arm="flash", lora=spec)
            if state_dict is None:
                gen = torch.Generator(device=device).manual_seed(3)
                init_params(model, gen)
                graft_base_weights(model, source)
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        if name.endswith("lora_b"):
                            p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
                state_dict = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(state_dict)
            relora.set_trainable(model)
            opt = optim.build_optimizer(p for p in model.parameters() if p.requires_grad)
            step = make_train_step(model, opt, clip_grad_norm=1.0, schedule=lambda s: 1e-3)
            out[fused] = step(TrainState(), batch)
        if QM.dequant_matmul.launches == n_deq or LM.fused_lora_int8_bwd_dx.launches == n_dx:
            raise AssertionError("f32-int8: an arm did not reach its kernels")
        errs = {k: abs(out[True][k] - out[False][k]) / abs(out[False][k]) for k in ("loss", "grad_norm")}
        for key, err in errs.items():
            ok = err <= F32_TRAIN_TOL[key]
            print(f"f32-int8 {key} fused={out[True][key]} unfused={out[False][key]} rel_err={err:.3e} "
                  f"tol={F32_TRAIN_TOL[key]:g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"f32-int8: {key} off by {err:.3e}")

        # the merge on the card against dequantize + delta + requantize in
        # f64; every fifth output column's delta is zero (B's column zeroed)
        module = model.layers[0].self_attn.q_proj
        with torch.no_grad():
            module.lora_b[:, ::5] = 0.0
        q0, s0 = module.weight_q.clone(), module.weight_scale.clone()
        w64 = q0.double() * s0.double().t() + (
            module.lora_a.double() @ module.lora_b.double() * spec.scale).t()
        scale64 = torch.clamp(w64.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
        q64 = torch.clamp(torch.round(w64 / scale64), -127, 127)
        relora.merge_and_reinit(model, torch.Generator(device=device).manual_seed(4), spec)
        q, s = module.weight_q, module.weight_scale
        step_err = ((q.double() * s.double().t() - q64 * scale64).abs()
                    / torch.maximum(s.double().t(), scale64)).max().item()
        equal = (q.double() == q64).double().mean().item()
        fixed = bool(torch.equal(q[::5], q0[::5]) and torch.equal(s[:, ::5], s0[:, ::5]))
    ok = q.dtype == torch.int8 and step_err <= 1.0 + 1e-6 and equal >= INT8_MERGE_MIN_EQUAL and fixed
    print(f"f32-int8 merge max_err_in_steps={step_err:.3e} (tol 1) codes_equal={equal:.6f} "
          f"(min {INT8_MERGE_MIN_EQUAL}) zero_delta_fixed={fixed} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("f32-int8: the int8 merge breaks the requant rule against f64")


# kernel 5 at the adapter drains' shapes: M rows per call (decode rows, a
# prefill chunk, a packed step), llama_250m's projections, r and slots as
# served
GROUPED_MS = (BATCH, 64, BATCH + 64)
ADAPTER_R, ADAPTER_SLOTS = 128, 4
TENANT_ALPHAS = {"tA": 32.0, "tB": 64.0, "tC": 16.0}


def make_grouped_case(torch, device, M, K, N, r, S, dtype, seed):
    """x, W (the (N, K) weight's transposed view), stacked A and B with slot
    0 the zero identity adapter, per-slot scales and a mixed idx."""
    g = torch.Generator(device=device).manual_seed(seed)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = torch.randn((M, K), generator=g, device=device).to(dt)
    w_nk = (torch.randn((N, K), generator=g, device=device) * 0.02).to(dt)
    a = ((torch.rand((S, K, r), generator=g, device=device) * 2 - 1) / K**0.5).to(dt)
    b = (torch.randn((S, r, N), generator=g, device=device) * 0.05).to(dt)
    a[0], b[0] = 0, 0
    s = torch.tensor([0.25 * (i + 1) for i in range(S)], device=device)
    idx = (torch.arange(M, device=device) * 5 % S).to(torch.int32)
    return x, w_nk.t(), a, b, s, idx


def grouped_bound(M, K, N, r, used, e):
    """The two terms of the least time on an H100 SXM, in ms: x, W, the
    A and B of each slot the rows use, idx and y, each once, over 3.35 TB/s,
    and 2M(KN + Kr + rN) over the bf16 tensor-core peak."""
    bytes_ = e * (M * K + K * N + used * (K * r + r * N) + M * N) + 4 * M + 4 * used
    return bytes_ / HBM_BYTES_PER_S * 1e3, 2 * M * (K * N + K * r + r * N) / BF16_FLOPS_PER_S * 1e3


def check_grouped_kernels(torch, device):
    """Phase kernels-5: kernel 5 against its twin on the card, then timings
    per M and llama_250m shape beside the twin, the gathered chain and the
    bound."""
    from relora_tpu_torch.core.relora import full_f32_matmul
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.ops.lora_dispatch import lora_matmul_grouped

    worst = 0.0
    cases = [(M, K, N, ADAPTER_R, ADAPTER_SLOTS, dt) for M in GROUPED_MS for K, N, _ in LORA_SHAPES
             for dt in ("bf16", "f32")]
    cases += [(5, 72, 100, 8, 3, dt) for dt in ("bf16", "f32")]
    cases += [(BATCH + 64, 768, 768, 320, ADAPTER_SLOTS, dt) for dt in ("bf16", "f32")]  # r > 256
    with full_f32_matmul(), torch.no_grad():
        for i, (M, K, N, r, S, dtype) in enumerate(cases):
            x, w, a, b, s, idx = make_grouped_case(torch, device, M, K, N, r, S, dtype, seed=71 + i)
            got = LM.grouped_lora_matmul(x, w, a, b, s, idx)
            want = LM.grouped_lora_matmul_plain(x, w, a, b, s, idx)
            torch.cuda.synchronize()
            err, rel, finite = _rel_err([(got, want)])
            ok = finite and rel <= LORA_TOL[dtype]
            print(f"kernel-check grouped_lora_matmul M={M} K={K} N={N} r={r} S={S} {dtype} "
                  f"max_abs_err={err:.3e} rel_err={rel:.3e} tol={LORA_TOL[dtype]:g} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"grouped_lora_matmul disagrees with its twin ({M, K, N, r, S, dtype})")
            if dtype == "bf16" and r == ADAPTER_R:
                worst = max(worst, err)

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")
    per_layer = {M: dict.fromkeys(keys, 0.0) for M in GROUPED_MS}
    per_shape = []
    with torch.no_grad():
        for M in GROUPED_MS:
            for K, N, count in LORA_SHAPES:
                args = make_grouped_case(torch, device, M, K, N, ADAPTER_R, ADAPTER_SLOTS, "bf16", seed=99)
                used = len(set(args[-1].tolist()))
                t_bytes, t_ops = grouped_bound(M, K, N, ADAPTER_R, used, 2)
                times = (time_ms(torch, lambda: LM.grouped_lora_matmul(*args)),
                         time_ms(torch, lambda: LM.grouped_lora_matmul_plain(*args)),
                         time_ms(torch, lambda: lora_matmul_grouped(*args, arm="gathered")))
                per_shape.append({"M": M, "K": K, "N": N, "r": ADAPTER_R, "slots_used": used,
                                  "per_layer": count, "ms": times[0], "plain_ms": times[1],
                                  "chain_ms": times[2], "bound_ms": max(t_bytes, t_ops),
                                  "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
                for key, v in zip(keys, times + (max(t_bytes, t_ops), t_bytes, t_ops)):
                    per_layer[M][key] += count * v
    print(json.dumps({"grouped_timings": "bf16, ms per call; chain = cuBLAS x @ W plus the "
                      "gathered bmm composite (the gathered arm), timed only",
                      "shapes": per_shape,
                      "per_layer": {str(M): row for M, row in per_layer.items()}}))
    # the row: one decoder layer's seven projections at the decode shape
    # (M = 8 rows, most of the drains' calls); no single PyTorch call computes
    # the function, so library_ms is the gathered chain
    row = per_layer[BATCH]
    return [{
        "name": "grouped_lora_matmul",
        "route": "cuda",
        "source": "relora_tpu_torch/csrc/lora_matmul.cu",
        "replaces": "relora_tpu/ops/pallas_lora_matmul.py:161",
        "launches": 0,
        "max_abs_err": worst,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes" if row["t_bytes"] >= row["t_ops"] else "operations",
        "library_ms": row["library_ms"],
    }]


def write_adapter_checkpoints(torch, work, device, model_config="llama_250m"):
    """A seeded ``model_config`` base with LoRA r=128 (f32, B = 0, as a
    ReLoRA checkpoint right after a merge) and three seeded tenant adapters
    (their factors only, alpha per TENANT_ALPHAS), each written by
    ``train/checkpoint.save_checkpoint``; returns (base dir, adapter dir)."""
    import shutil

    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.core.relora import LoraSpec, kaiming_uniform
    from relora_tpu_torch.models.llama import LlamaForCausalLM
    from relora_tpu_torch.models.params_util import init_params
    from relora_tpu_torch.serve.adapters import extract_lora_factors
    from relora_tpu_torch.train.checkpoint import save_checkpoint

    root = os.path.join(work, f"adapters_{model_config}")
    shutil.rmtree(root, ignore_errors=True)
    spec = LoraSpec(r=ADAPTER_R, alpha=32.0)
    with torch.device(device):
        model = LlamaForCausalLM(load_model_config(model_config), lora=spec)
    gen = torch.Generator(device=device).manual_seed(21)
    init_params(model, gen)
    base = save_checkpoint(os.path.join(root, "base"), 0, model.state_dict(), {"update_step": 0},
                           lora_spec=spec)
    tenants = os.path.join(root, "tenants")
    for i, (name, alpha) in enumerate(TENANT_ALPHAS.items()):
        factors = {}
        for key, p in extract_lora_factors(model.state_dict()).items():
            if key.endswith("lora_a"):
                factors[key] = kaiming_uniform(p.shape, gen, device)
            else:
                factors[key] = torch.randn(p.shape, generator=gen, device=device) * 0.05
        path = save_checkpoint(tenants, i, factors, {"update_step": 0},
                               lora_spec=LoraSpec(r=ADAPTER_R, alpha=alpha))
        os.rename(path, os.path.join(tenants, name))
    del model
    return base, tenants


def read_prompts(path):
    with open(path) as f:
        return [[int(t) for t in line.split()] for line in f if line.strip()]


def tenant_engine(torch, base, slots, device, dtype="bf16"):
    """The serving engine of the adapter drains: llama_250m from the base
    checkpoint, unmerged, with ``slots`` adapter slots, the CLI's pool."""
    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.serve.engine import InferenceEngine, compute_dtype
    from relora_tpu_torch.train.checkpoint import load_lora_spec, restore_params_host

    cfg = load_model_config("llama_250m")
    cache = cfg.max_sequence_length
    return InferenceEngine(cfg, restore_params_host(base), cache_size=cache, dtype=compute_dtype(dtype),
                           page_size=PAGE, num_pages=BATCH * (cache // PAGE) + 1, chunk_size=64,
                           token_budget=BATCH + 64, device=device, lora=load_lora_spec(base),
                           adapter_slots=slots)


def tenant_drain(torch, engine, registry, requests, packed=False, max_batch=BATCH):
    """Drain ``requests`` through the scheduler API; returns (completions,
    seconds ending in a device synchronize)."""
    from relora_tpu_torch.serve.scheduler import PagedContinuousBatchingScheduler

    sched = PagedContinuousBatchingScheduler(
        engine, max_batch=max_batch, eos_id=engine.config.eos_token_id, seed=0, packed=packed,
        adapter_registry=registry,
    )
    t0 = time.perf_counter()
    completions = sched.run(requests)
    torch.cuda.synchronize()
    return completions, time.perf_counter() - t0, sched


def tenant_requests(prompts, names, max_new=64):
    from relora_tpu_torch.serve.scheduler import Request

    return [Request(uid=i, prompt=p, max_new_tokens=max_new, adapter=names[i % len(names)])
            for i, p in enumerate(prompts)]


class ForwardCount:
    """Counts the serving engine's model forwards while it is entered."""

    def __enter__(self):
        from relora_tpu_torch.serve.engine import InferenceEngine

        self.cls, self.real, self.n = InferenceEngine, InferenceEngine._forward, 0

        def counted(engine, *args, **kwargs):
            self.n += 1
            return self.real(engine, *args, **kwargs)

        InferenceEngine._forward = counted
        return self

    def __exit__(self, *exc):
        self.cls._forward = self.real


def adapter_drains(torch, device, prompts_path, base, tenants):
    """Phase adapters: the CLI drain, the mixed-tenant drains (sequential,
    packed, under slot contention), the tenant and prefix-isolation probes;
    returns kernel 5's launches over the drains."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.serve.adapters import AdapterRegistry

    layers = load_model_config("llama_250m").num_hidden_layers
    prompts = read_prompts(prompts_path)
    mix = [None] + list(TENANT_ALPHAS)
    total = 0

    def drained(label, run, **extra):
        nonlocal total
        LM.grouped_lora_matmul.launches = 0
        with ForwardCount() as forwards:
            completions, seconds = run()[:2]
        launches = LM.grouped_lora_matmul.launches
        tokens = [c.tokens for c in completions.values()]
        n = sum(len(t) for t in tokens)
        line = {"drain": label, "requests": len(tokens), "tokens": n, "seconds": seconds,
                "tokens_per_s": n / seconds, "forwards": forwards.n,
                "launches": {"grouped_lora_matmul": launches}, **extra}
        print(json.dumps(line))
        if len(tokens) != len(prompts) or not all(1 <= len(t) <= 64 for t in tokens):
            raise AssertionError(f"drain {label}: malformed completions")
        if not all(0 <= tok < 32100 for t in tokens for tok in t):
            raise AssertionError(f"drain {label}: token id out of the vocabulary")
        if forwards.n == 0 or launches != 7 * layers * forwards.n:
            raise AssertionError(f"drain {label}: kernel 5 launched {launches} times over "
                                 f"{forwards.n} forwards, expected 7 x {layers} per forward")
        total += launches

    drained("adapters_cli", lambda: serve_cli.run([
        "--model_config", "llama_250m", "--checkpoint", base, "--no-merge", "--adapter-dir",
        tenants, "--adapters", "tA,tB", "--paged", "--dtype", "bf16", "--max-batch", str(BATCH),
        "--max-new-tokens", "64", "--input-file", prompts_path]))

    engine = tenant_engine(torch, base, ADAPTER_SLOTS, device)
    registry = AdapterRegistry(tenants, ADAPTER_SLOTS, expected_r=ADAPTER_R, writer=engine.adapter_writer())
    requests = tenant_requests(prompts, mix)
    for packed in (False, True):
        drained("tenants_packed" if packed else "tenants",
                lambda: tenant_drain(torch, engine, registry, requests, packed), adapters=mix)

    # every tenant steers: its row differs from the base row on one prompt
    probe = tenant_requests([prompts[0]] * len(mix), mix, max_new=16)
    done = tenant_drain(torch, engine, registry, probe)[0]
    steered = {name: done[i].tokens != done[0].tokens for i, name in enumerate(mix) if name}
    # tB after tA on one prompt equals tB alone: tA's prefix pages are not
    # tB's; a tenant's own repeat does hit them
    def alone(names):
        got = tenant_drain(torch, engine, registry, tenant_requests([prompts[1]] * len(names), names,
                                                                    max_new=16), max_batch=1)
        return [got[0][i].tokens for i in range(len(names))], got[2].prefix_cache.hits

    (_, b_after), hits_ab = alone(["tA", "tB"])
    (b_alone,), _ = alone(["tB"])
    _, hits_aa = alone(["tA", "tA"])
    probe_line = {"tenant_probe": steered, "prompt_tokens": len(prompts[1]),
                  "tB_after_tA_equals_tB_alone": b_after == b_alone, "prefix_hits_tA_tB": hits_ab,
                  "prefix_hits_tA_tA": hits_aa}
    print(json.dumps(probe_line))
    if not all(steered.values()):
        raise AssertionError(f"adapters: a tenant decoded the base's tokens: {steered}")
    if b_after != b_alone or hits_ab != 0 or hits_aa != 1:
        raise AssertionError(f"adapters: prefix isolation failed: {probe_line}")
    del engine, registry
    torch.cuda.empty_cache()

    engine = tenant_engine(torch, base, 3, device)
    registry = AdapterRegistry(tenants, 3, expected_r=ADAPTER_R, writer=engine.adapter_writer())
    drained("tenants_contention", lambda: tenant_drain(torch, engine, registry, requests),
            adapters=mix, slots=3)
    stats = registry.stats()
    print(json.dumps({"contention_registry": stats}))
    if stats["evictions_total"] < 1 or stats["loads_total"] <= len(TENANT_ALPHAS):
        raise AssertionError(f"contention drain: expected loads and evictions mid-traffic, got {stats}")
    return total


def f32_adapters(torch, device, tenants):
    """Phase f32-adapters: decode_paged and step_paged of a slotted
    llama_250m at f32, the kernel arm against the plain arm from identical
    pools, rows on mixed adapter slots; logits compared."""
    import numpy as np

    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.core.relora import LoraSpec
    from relora_tpu_torch.models.llama import LlamaForCausalLM
    from relora_tpu_torch.models.lora import LoRALinear
    from relora_tpu_torch.models.params_util import init_params
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.serve.adapters import default_loader
    from relora_tpu_torch.serve.engine import InferenceEngine

    cfg = load_model_config("llama_250m")
    spec = LoraSpec(r=ADAPTER_R, alpha=32.0)
    with torch.device(device):
        model = LlamaForCausalLM(cfg, lora=spec)
    init_params(model, torch.Generator(device=device).manual_seed(1))
    W = cfg.max_sequence_length // PAGE
    engine = InferenceEngine(cfg, model.state_dict(), cache_size=cfg.max_sequence_length,
                             page_size=PAGE, num_pages=(BATCH + 1) * W + 1, chunk_size=64,
                             token_budget=BATCH + 64, device=device, lora=spec,
                             adapter_slots=ADAPTER_SLOTS)
    del model
    for slot, name in enumerate(TENANT_ALPHAS, 1):
        engine.write_adapter_slot(slot, *default_loader(os.path.join(tenants, name), ADAPTER_R))
    modules = [m for m in engine.model.modules() if isinstance(m, LoRALinear) and m.lora is not None]
    rng = np.random.default_rng(4)
    lengths = rng.integers(32, 513, BATCH)
    slots = (np.arange(BATCH) % ADAPTER_SLOTS).astype(np.int32)
    tables = (np.arange(BATCH * W).reshape(BATCH, W) + 1).astype(np.int32)
    pool = engine.init_pool()
    for row, L in enumerate(lengths):
        prompt = rng.integers(2, cfg.vocab_size, L)
        for start in range(0, L, 64):
            ids = np.zeros((1, 64), np.int32)
            part = prompt[start : start + 64]
            ids[0, : len(part)] = part
            _, pool = engine.prefill_chunk(ids, start, pool, tables[row : row + 1],
                                           adapter_idx=[slots[row]])

    def both(step):
        out = {}
        for arm, attention, grouped in (("kernel", "auto", "auto"), ("plain", "naive", "gathered")):
            engine.model.attention_arm = attention
            for m in modules:
                m.grouped_arm = grouped
            pool_copy = [{k: t.clone() for k, t in layer.items()} for layer in pool]
            n0 = LM.grouped_lora_matmul.launches
            out[arm] = step(pool_copy).float()
            if (LM.grouped_lora_matmul.launches > n0) != (arm == "kernel"):
                raise AssertionError(f"f32-adapters: the {arm} arm took the wrong grouped path")
        engine.model.attention_arm = "auto"
        for m in modules:
            m.grouped_arm = "auto"
        torch.cuda.synchronize()
        return (out["kernel"] - out["plain"]).abs().max().item(), out["kernel"]

    token = rng.integers(2, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
    err_d, logits = both(lambda p: engine.decode_paged(p, token, lengths[:, None], tables, adapter_idx=slots)[0])
    ptables = np.zeros((BATCH + 2, W + 1), np.int32)
    ptables[:BATCH, :W] = tables
    ptables[BATCH, :W] = np.arange(W) + 1 + BATCH * W
    n_new = 64 - 8
    ids = np.concatenate([token[:, 0], rng.integers(2, cfg.vocab_size, n_new), np.zeros(8, int)])
    positions = np.concatenate([lengths, np.arange(n_new), np.full(8, cfg.max_sequence_length)])
    row_map = np.array(list(range(BATCH)) + [BATCH] * n_new + [BATCH + 1] * 8, np.int32)
    adapter_idx = np.concatenate([slots, np.full(n_new, 2), np.zeros(8)]).astype(np.int32)
    err_p, plogits = both(lambda p: engine.step_paged(
        p, ids[None].astype(np.int32), positions[None].astype(np.int32), ptables, row_map,
        adapter_idx=adapter_idx)[0])
    for name, err, out in (("decode_paged", err_d, logits), ("step_paged", err_p, plogits)):
        ok = bool(torch.isfinite(out).all()) and err <= LOGIT_TOL
        print(f"f32-adapters {name} shape={tuple(out.shape)} slots={slots.tolist()} "
              f"max_abs_err={err:.3e} tol={LOGIT_TOL:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f32-adapters {name}: kernel arm and plain arm disagree")


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
    count_hmma(libs["flash_attention"])

    rows = check_kernels(torch, device)
    flash_rows = check_flash_kernels(torch, device)
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    prompts = os.path.join(work, "prompts.txt")
    write_prompts(prompts, 32100)
    launches, _ = drains(torch, prompts)
    for row in rows:
        row["launches"] = launches[row["name"]]
    f32_comparison(torch, device)
    torch.cuda.empty_cache()
    launches = train(torch, write_corpus(work))
    for row in flash_rows:
        row["launches"] = launches[row["name"]]
    rows += flash_rows
    torch.cuda.empty_cache()
    f32_train(torch, device)
    torch.cuda.empty_cache()
    lora_rows = check_lora_kernels(torch, device)
    torch.cuda.empty_cache()
    launches = train(torch, write_corpus(work), "fused_train",
                     ["--lora_fused", "true", "--lora_dropout", "0"])
    for row in lora_rows:
        row["launches"] = launches[row["name"]]
    rows += lora_rows
    torch.cuda.empty_cache()
    f32_fused(torch, device)
    torch.cuda.empty_cache()
    int8_rows = check_int8_kernels(torch, device)
    torch.cuda.empty_cache()
    warm = write_warm_start(torch, os.path.join(work, "warm_llama_250m"), device)
    int8 = ["--quantize", "int8", "--warmed_up_model", warm]
    launches = train(torch, write_corpus(work), "int8_train", int8)
    int8_rows[0]["launches"] = launches["dequant_matmul"]
    torch.cuda.empty_cache()
    launches = train(torch, write_corpus(work), "int8_fused_train",
                     int8 + ["--lora_fused", "true", "--lora_dropout", "0"])
    for row in int8_rows[1:]:
        row["launches"] = launches[row["name"]]
    rows += int8_rows
    torch.cuda.empty_cache()
    f32_int8(torch, device, warm)
    torch.cuda.empty_cache()
    grouped_rows = check_grouped_kernels(torch, device)
    torch.cuda.empty_cache()
    base, tenants = write_adapter_checkpoints(torch, work, device)
    torch.cuda.empty_cache()
    grouped_rows[0]["launches"] = adapter_drains(torch, device, prompts, base, tenants)
    rows += grouped_rows
    torch.cuda.empty_cache()
    f32_adapters(torch, device, tenants)

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


def ab(argv) -> int:
    """``python3 chip_smoke.py --ab DIR [--train [FLAGS...]]``: one JSON line
    of the times of the package in the checkout at DIR (another tree, such
    as the parent unpacked with ``git archive``) by this script's timer and
    shapes, so two trees compare on one card when run in turns in one call
    (parent, change, change, parent).  Without ``--train``: kernel 3 at the
    train phase's shape, bf16 (forward, dK/dV, dQ, the backward pair, and
    forward+backward through autograd), 100 launches each.  With it: the
    train phase (plus FLAGS) run twice, each run's median ms per update of
    updates 2-9."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to time", file=sys.stderr)
        return 2
    tree = os.path.abspath(argv[1])
    sys.path.insert(0, tree)
    import relora_tpu_torch

    if not os.path.abspath(relora_tpu_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {relora_tpu_torch.__file__}, not the package in {tree}")
    out = {"tree": argv[1], "card": torch.cuda.get_device_name(0)}
    if argv[2:3] == ["--train"]:
        from relora_tpu_torch import main as train_main

        work = os.path.join(REPO, "build", "chip_smoke")
        os.makedirs(work, exist_ok=True)
        args = TRAIN_ARGS + argv[3:] + ["--megatron_dataset_config", write_corpus(work)]
        out["flags"] = argv[3:]
        for key in ("warm_ms_per_update", "ms_per_update"):
            steady = sorted(r["update_seconds"] for r in train_main.main(args)["records"][1:])
            out[key] = steady[len(steady) // 2] * 1e3
    else:
        from relora_tpu_torch.ops import flash_attention as FA

        B, S, N, n_kv, H, dtype = FLASH_CASES[0]
        q, k, v, dout = make_flash_case(torch, torch.device("cuda"), B, S, N, n_kv, H, dtype, seed=99)
        scale = H**-0.5
        o, lse = FA.flash_attention_forward(q, k, v, scale)
        bwd = (q, k, v, dout, lse, FA.flash_attention_delta(o, dout), scale)

        def fwd_bwd():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            return torch.autograd.grad(FA.flash_attention(*leaves), leaves, dout)

        for key, fn in (
            ("forward_ms", lambda: FA.flash_attention_forward(q, k, v, scale)),
            ("dkdv_ms", lambda: FA.flash_attention_bwd_dkdv(*bwd)),
            ("dq_ms", lambda: FA.flash_attention_bwd_dq(*bwd)),
            ("backward_ms", lambda: (FA.flash_attention_bwd_dkdv(*bwd), FA.flash_attention_bwd_dq(*bwd))),
            ("fwd_bwd_ms", fwd_bwd),
        ):
            out[key] = time_ms(torch, fn, iters=100)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(ab(sys.argv[1:]) if sys.argv[1:2] == ["--ab"] else main())
