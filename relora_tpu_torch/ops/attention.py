"""Causal attention for training, cached and paged attention for serving.

PyTorch counterpart of ``relora_tpu/ops/attention.py``.  Training's causal
self-attention is :func:`dot_product_attention` over two arms: ``naive``
(:func:`naive_attention`, plain f32) and ``flash`` (the CUDA kernels of
``ops/flash_attention.py``).  For what the paged serving path runs:

- the plain arm: :func:`cached_attention`, :func:`gather_kv_pages`,
  :func:`dequantize_gathered_pages` and :func:`paged_cached_attention`
  (gather the pages, then masked einsum softmax einsum, all f32).  Chunked
  prefill takes it on every device.
- two kernel wrappers, :func:`paged_decode_attention` and
  :func:`packed_paged_attention`, each with a plain twin in this module
  (:func:`paged_decode_attention_plain`, :func:`packed_paged_attention_plain`).
  A wrapper given a CPU tensor runs its plain twin; given any other tensor it
  launches the CUDA kernel of ``csrc/paged_attention.cu`` or raises.  Each
  wrapper counts its kernel launches in ``.launches``.

All functions take and return ``(batch, seq, heads, head_dim)`` tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: masked logit of the fused kernels (the TPU kernels use the same value)
_MASKED = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def naive_attention(q, k, v, *, causal: bool, scale: float) -> torch.Tensor:
    """softmax(QKᵀ)V in f32 over ``(B, S, N, H)`` q and ``(B, S, n_kv, H)``
    k/v (grouped heads attend without expanding K/V): the JAX package's
    ``naive`` arm, masked logits at the f32 minimum."""
    B, S, N, H = q.shape
    n_kv = k.shape[2]
    if N % n_kv:
        raise ValueError(f"num_heads={N} must divide by kv_heads={n_kv}")
    qg = q.float().reshape(B, S, n_kv, N // n_kv, H)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    if causal:
        mask = torch.ones((S, k.shape[1]), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, S, N, H).to(q.dtype)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    impl: str = "auto",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Training self-attention over ``(B, S, N, H)`` tensors.

    ``impl="auto"`` resolves through
    :func:`relora_tpu_torch.ops.attention_dispatch.choose_training_arm`;
    ``"flash"`` is the causal CUDA kernel pair (its plain twins for CPU
    tensors), ``"naive"`` the plain f32 arm.  Both arms compute the same
    function; forcing one is how tests and ``chip_smoke.py`` compare them."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "auto":
        from relora_tpu_torch.ops.attention_dispatch import choose_training_arm

        impl = choose_training_arm(q)
    if impl == "flash":
        if not causal:
            raise ValueError("the flash arm computes causal attention only")
        from relora_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, scale)
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}; expected auto|naive|flash")


def cached_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked attention of ``q`` ``(B, T, N, H)`` at absolute ``positions``
    ``(B|1, T)`` against a cache ``(B, C, n_kv, H)``: entry ``j`` is visible
    to a query at position ``p`` iff ``j <= p``.  Math in f32; grouped K/V
    heads attend without materializing the head expansion."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, T, N, H = q.shape
    C, n_kv = k.shape[1], k.shape[2]
    if N % n_kv:
        raise ValueError(f"num_heads={N} must divide by kv_heads={n_kv}")
    qg = q.float().reshape(B, T, n_kv, N // n_kv, H)
    logits = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) * scale
    visible = torch.arange(C, device=q.device)[None, None, :] <= positions[..., None]
    logits = torch.where(
        visible[:, None, None, :, :], logits, torch.finfo(torch.float32).min
    )
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.float())
    return out.reshape(B, T, N, H).to(q.dtype)


def dequantize_gathered_pages(
    kv: torch.Tensor, scales: torch.Tensor, block_tables: torch.Tensor
) -> torch.Tensor:
    """Dequantize a :func:`gather_kv_pages` view of int8 codes
    ``(B, W*ps, n_kv, H)`` to f32 with the per-``(page, kv_head)`` scales
    ``(num_pages, n_kv)``, gathered through the same ``block_tables``."""
    B, S, n_kv, H = kv.shape
    W = block_tables.shape[1]
    ps = S // W
    s = scales[block_tables.long()]  # (B, W, n_kv)
    s = s[:, :, None, :].expand(B, W, ps, n_kv).reshape(B, S, n_kv)
    return kv.float() * s[..., None]


def gather_kv_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Per-row contiguous K/V view ``(B, W*ps, n_kv, H)`` of a shared page
    pool ``(num_pages, ps, n_kv, H)`` through ``block_tables`` ``(B, W)``."""
    pages = pool[block_tables.long()]  # (B, W, ps, n_kv, H)
    B, W, ps = pages.shape[:3]
    return pages.reshape(B, W * ps, pages.shape[3], pages.shape[4])


def paged_cached_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`cached_attention` against a paged pool: gather each row's
    logical cache at full table width, dequantize int8 pages when scales are
    given, attend.  The plain arm of the dispatcher."""
    k = gather_kv_pages(pool_k, block_tables)
    v = gather_kv_pages(pool_v, block_tables)
    if k_scale is not None:
        k = dequantize_gathered_pages(k, k_scale, block_tables)
    if v_scale is not None:
        v = dequantize_gathered_pages(v, v_scale, block_tables)
    return cached_attention(q, k, v, positions, scale=scale)


# ---------------------------------------------------------------------------
# The fused kernels' plain twins: the kernel's arithmetic, vectorized
# ---------------------------------------------------------------------------


def _check_scales(k_scale, v_scale) -> bool:
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be given together")
    return quantized


def _query_positions(positions: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """``(B,)``/``(B, 1)`` positions broadcast over the S query tokens;
    ``(B, S)`` stay per token."""
    if positions.numel() == B:
        return positions.reshape(B, 1)[:, :1].expand(B, S).to(torch.int32)
    return positions.reshape(B, S).to(torch.int32)


def _attend_pages_plain(q, pool_k, pool_v, tables, pos, k_scale, v_scale, scale):
    """The fused kernels' math for ``q`` ``(R, S, N, H)``, per-row tables
    ``(R, W)`` and positions ``(R, S)``: -1e30 masked logits, masked p,
    division guarded by max(l, 1e-30), f32 throughout."""
    R, S, N, H = q.shape
    n_kv = pool_k.shape[2]
    k = gather_kv_pages(pool_k, tables)
    v = gather_kv_pages(pool_v, tables)
    if k_scale is not None:
        k = dequantize_gathered_pages(k, k_scale, tables)
        v = dequantize_gathered_pages(v, v_scale, tables)
    qg = q.float().reshape(R, S, n_kv, N // n_kv, H)
    s = torch.einsum("rtkgh,rskh->rkgts", qg, k.float()) * scale
    visible = (
        torch.arange(k.shape[1], device=q.device)[None, None, :] <= pos[..., None]
    )[:, None, None]  # (R, 1, 1, S, C)
    s = torch.where(visible, s, _MASKED)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("rkgts,rskh->rtkgh", p / torch.clamp(l, min=1e-30), v.float())
    return out.reshape(R, S, N, H).to(q.dtype)


def paged_decode_attention_plain(
    q, pool_k, pool_v, block_tables, positions, *, k_scale=None, v_scale=None, scale=None
) -> torch.Tensor:
    """Plain twin of :func:`paged_decode_attention` (same arguments)."""
    B, S, N, H = q.shape
    _check_scales(k_scale, v_scale)
    if scale is None:
        scale = H**-0.5
    pos = _query_positions(positions, B, S)
    return _attend_pages_plain(q, pool_k, pool_v, block_tables, pos, k_scale, v_scale, scale)


def packed_paged_attention_plain(
    q, pool_k, pool_v, block_tables, row_map, positions, *, k_scale=None, v_scale=None,
    scale=None,
) -> torch.Tensor:
    """Plain twin of :func:`packed_paged_attention` (same arguments)."""
    _, T, N, H = q.shape
    _check_scales(k_scale, v_scale)
    if scale is None:
        scale = H**-0.5
    tables = block_tables[row_map.reshape(T).long()]
    out = _attend_pages_plain(
        q.reshape(T, 1, N, H), pool_k, pool_v, tables,
        positions.reshape(T, 1).to(torch.int32), k_scale, v_scale, scale,
    )
    return out.reshape(1, T, N, H)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _kernel_library():
    from relora_tpu_torch.ops import _build

    lib = _build.library("paged_attention")
    if not getattr(lib, "_relora_typed", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_decode_attention_launch.argtypes = (
            [vp] * 8 + [i32] * 7 + [f32, i32, i32, vp]
        )
        lib.paged_decode_attention_launch.restype = i32
        lib.packed_paged_attention_launch.argtypes = (
            [vp] * 9 + [i32] * 6 + [f32, i32, i32, vp]
        )
        lib.packed_paged_attention_launch.restype = i32
        lib.paged_attention_smem_bytes.argtypes = [i32, i32, i32]
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paged_attention_error_string.argtypes = [i32]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib._relora_typed = True
    return lib


#: dynamic shared memory a block may use on Hopper (227 KB)
_MAX_SMEM = 232448


def _validate_kernel_inputs(q, pool_k, pool_v, k_scale, v_scale, G, *index_tensors):
    """Everything the kernel assumes, checked before any pointer is passed."""
    if q.device.type != "cuda":
        raise ValueError(
            f"the paged attention kernel runs on CUDA tensors; got {q.device} "
            "(CPU tensors take the plain version)"
        )
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if pool_k.dtype not in _DTYPE_CODE or pool_v.dtype != pool_k.dtype:
        raise ValueError(f"pools must share a dtype in f32/bf16/int8, got {pool_k.dtype}/{pool_v.dtype}")
    if (pool_k.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("int8 pools need k_scale/v_scale, float pools take none")
    if pool_k.shape != pool_v.shape or pool_k.ndim != 4:
        raise ValueError(f"pool shapes {tuple(pool_k.shape)} / {tuple(pool_v.shape)}")
    num_pages, ps, n_kv, H = pool_k.shape
    if q.shape[-1] != H or H > 256:
        raise ValueError(f"head_dim {q.shape[-1]} must equal the pool's {H} and be <= 256")
    if k_scale is not None and (
        k_scale.shape != (num_pages, n_kv) or v_scale.shape != (num_pages, n_kv)
    ):
        raise ValueError(f"scales must be ({num_pages}, {n_kv})")
    for t in (q, pool_k, pool_v, k_scale, v_scale, *index_tensors):
        if t is not None and (t.device != q.device or not t.is_contiguous()):
            raise ValueError("all kernel operands must be contiguous and on q's device")
    lib = _kernel_library()
    smem = lib.paged_attention_smem_bytes(G, H, ps)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"{G} queries per kv head x head_dim {H} x page {ps} needs {smem} B "
            f"of shared memory (> {_MAX_SMEM})"
        )
    return lib


def _raise_on_error(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: {lib.paged_attention_error_string(err).decode()} ({err})")


def paged_decode_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused small-S decode/verify attention straight out of the page pool.

    ``q`` ``(B, S, N, H)`` (S <= 16 in the serving path), pools
    ``(num_pages, ps, n_kv, H)`` in f32, bf16 or int8 (int8 with
    ``k_scale``/``v_scale`` ``(num_pages, n_kv)``), ``block_tables``
    ``(B, W)``, ``positions`` ``(B,)``/``(B, 1)`` (broadcast over S) or
    ``(B, S)``.  Returns ``(B, S, N, H)`` in ``q.dtype``; math is f32.

    A CPU ``q`` runs :func:`paged_decode_attention_plain`; any other device
    launches ``paged_decode_kernel`` (csrc/paged_attention.cu) or raises.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, pool_k, pool_v, block_tables, positions,
            k_scale=k_scale, v_scale=v_scale, scale=scale,
        )
    B, S, N, H = q.shape
    n_kv = pool_k.shape[2]
    if N % n_kv:
        raise ValueError(f"num_heads={N} must divide by kv_heads={n_kv}")
    _check_scales(k_scale, v_scale)
    if scale is None:
        scale = H**-0.5
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    pos = _query_positions(positions, B, S).contiguous()
    if bt.shape[0] != B:
        raise ValueError(f"block_tables has {bt.shape[0]} rows for batch {B}")
    lib = _validate_kernel_inputs(
        q, pool_k, pool_v, k_scale, v_scale, (N // n_kv) * S, bt, pos
    )
    out = torch.empty_like(q)
    err = lib.paged_decode_attention_launch(
        _ptr(q), _ptr(pool_k), _ptr(pool_v), _ptr(bt), _ptr(pos),
        _ptr(k_scale), _ptr(v_scale), _ptr(out),
        B, S, N, n_kv, H, bt.shape[1], pool_k.shape[1], float(scale),
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[pool_k.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _raise_on_error(lib, err, "paged_decode_kernel")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def packed_paged_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    block_tables: torch.Tensor,
    row_map: torch.Tensor,
    positions: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused attention for a packed mixed batch straight out of the pool.

    ``q`` ``(1, T, N, H)`` token-major; ``row_map`` ``(T,)`` picks each
    token's row of ``block_tables`` ``(R, W)`` and ``positions`` ``(T,)``
    is its absolute position.  Pad tokens point at an all-null table row and
    sit at the null position; their output is finite and never read.
    Returns ``(1, T, N, H)`` in ``q.dtype``; math is f32.

    A CPU ``q`` runs :func:`packed_paged_attention_plain`; any other device
    launches ``packed_paged_kernel`` (csrc/paged_attention.cu) or raises.
    """
    B, T, N, H = q.shape
    if B != 1:
        raise ValueError(f"packed attention is token-major: expected B=1, got {B}")
    if q.device.type == "cpu":
        return packed_paged_attention_plain(
            q, pool_k, pool_v, block_tables, row_map, positions,
            k_scale=k_scale, v_scale=v_scale, scale=scale,
        )
    n_kv = pool_k.shape[2]
    if N % n_kv:
        raise ValueError(f"num_heads={N} must divide by kv_heads={n_kv}")
    _check_scales(k_scale, v_scale)
    if scale is None:
        scale = H**-0.5
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    rm = row_map.reshape(T).to(torch.int32).contiguous()
    pos = positions.reshape(T).to(torch.int32).contiguous()
    lib = _validate_kernel_inputs(q, pool_k, pool_v, k_scale, v_scale, N // n_kv, bt, rm, pos)
    out = torch.empty_like(q)
    err = lib.packed_paged_attention_launch(
        _ptr(q), _ptr(pool_k), _ptr(pool_v), _ptr(bt), _ptr(rm), _ptr(pos),
        _ptr(k_scale), _ptr(v_scale), _ptr(out),
        T, N, n_kv, H, bt.shape[1], pool_k.shape[1], float(scale),
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[pool_k.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _raise_on_error(lib, err, "packed_paged_kernel")
    packed_paged_attention.launches += 1
    return out


packed_paged_attention.launches = 0
