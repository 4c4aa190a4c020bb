"""The fused LoRA composite ``y = x @ W + ((x @ A) @ B) * s``: CUDA kernels
and their plain twins, for a dense and for an int8 base, and its grouped
multi-tenant forward.

Replaces the TPU kernels of ``relora_tpu/ops/pallas_lora_matmul.py``:
``_forward`` (kernel 4, ``:102``; int8 base ``_fused_lora_int8_kernel``
``:88``), ``_backward_dx`` (kernel 6, ``:317``; int8 base
``_bwd_dx_int8_kernel`` ``:279``), ``_backward_dab`` (kernel 7, ``:343``,
which never reads the base) and ``_grouped_forward`` (kernel 5, ``:161``).
``csrc/lora_matmul.cu`` holds the Hopper kernels; its header note gives the
design and the bound.  Here:

- :func:`fused_lora_forward` ``(x, w, a, b, s) -> (y, z)``,
  :func:`fused_lora_bwd_dx` ``(g, w, a, b, s) -> (dx, u)``,
  :func:`fused_lora_bwd_dab` ``(g, x, z, b, s, u=None) -> (da, db)``,
  :func:`fused_lora_int8_forward` ``(x, q, qscale, a, b, s) -> (y, z)`` and
  :func:`fused_lora_int8_bwd_dx` ``(g, q, qscale, a, b, s) -> (dx, u)``: one
  wrapper per kernel.  A CPU tensor runs the plain twin of the same name with
  ``_plain``; a CUDA tensor launches the kernel or raises.  Each wrapper
  counts its launches in ``.launches``.  The two forwards and the two dx
  wrappers choose between two hand-written kernels by :func:`forward_path`,
  dA/dB by :func:`dab_path` (the same rule with no base): bf16 tensor cores
  for the model's layout, f32 FMAs for the rest; ``.tc_launches`` counts the
  first.
- :class:`FusedLoRAMatmul` and :class:`FusedLoRAMatmulInt8`, the autograd
  Functions over them (the JAX package's ``custom_vjp`` pair, ``:375-427``),
  and :func:`fused_lora_matmul` / :func:`fused_lora_matmul_int8`, their
  entry points (``:467-524``).
- :func:`grouped_lora_matmul` ``(x, w, a_stack, b_stack, s_stack, idx) ->
  y``, kernel 5's wrapper, and :func:`grouped_lora_matmul_plain`, its twin
  (``grouped_lora_reference``, ``:188-204``): every row ``m`` takes the
  adapter of slot ``idx[m]``.  Inference only: there is no autograd Function.

Layouts follow the JAX package: ``x`` ``(M, K)``, ``w`` ``(K, N)``, ``a``
``(K, r)``, ``b`` ``(r, N)``; ``z = x @ A`` and ``u = g @ Bᵀ`` are ``(M, r)``
f32.  ``w`` may be contiguous or the transpose of a contiguous ``(N, K)``
tensor (the port's ``(out, in)`` weight ``.t()``), read in place.  An int8
base is ``q`` ``(K, N)`` int8 codes, laid out like ``w``, and ``qscale``
``(1, N)`` f32 per output column; the kernels dequantize each code as they
stage it, so no dequantized copy of the base is ever written.  ``s`` is a
Python float or a one-element tensor (the trainable ``tanh(lora_s)``), which
the kernels read on the device: no call syncs with the host.  Math is f32;
``y`` and ``dx`` take the inputs' dtype, ``da``/``db`` are f32.  The frozen
base gets no gradient (the JAX package's ``stop_gradient`` contract).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from relora_tpu_torch.ops._build import library, ptr_arg, stream_arg

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

Scale = Union[float, torch.Tensor]


# ---------------------------------------------------------------------------
# Plain twins: the kernels' arithmetic in f32
# ---------------------------------------------------------------------------


def _scale_f32(s: Scale):
    return s.float().reshape(()) if isinstance(s, torch.Tensor) else float(s)


def fused_lora_forward_plain(x, w, a, b, s: Scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`fused_lora_forward`."""
    x32 = x.float()
    z = x32 @ a.float()
    y = x32 @ w.float() + (z @ b.float()) * _scale_f32(s)
    return y.to(x.dtype), z


def fused_lora_bwd_dx_plain(g, w, a, b, s: Scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`fused_lora_bwd_dx`."""
    g32 = g.float()
    u = g32 @ b.float().t()
    dx = g32 @ w.float().t() + (u @ a.float().t()) * _scale_f32(s)
    return dx.to(g.dtype), u


def fused_lora_bwd_dab_plain(g, x, z, b, s: Scale, u=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`fused_lora_bwd_dab`."""
    g32 = g.float()
    if u is None:
        u = g32 @ b.float().t()
    s32 = _scale_f32(s)
    return (x.float().t() @ u) * s32, (z.t() @ g32) * s32


def grouped_lora_matmul_plain(x, w, a_stack, b_stack, s_stack, idx) -> torch.Tensor:
    """Plain twin of :func:`grouped_lora_matmul` (``grouped_lora_reference``):
    gathers ``A[idx]`` and ``B[idx]`` per row in f32, then contracts; ``y`` in
    x's dtype, shaped ``(..., N)`` like x."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K).float()
    idx = idx.reshape(-1).long()
    a = a_stack.float()[idx]  # (M, K, r)
    b = b_stack.float()[idx]  # (M, r, N)
    s = s_stack.reshape(-1).float()[idx]  # (M,)
    z = torch.einsum("mk,mkr->mr", x2, a)
    y = x2 @ w.float() + torch.einsum("mr,mrn->mn", z, b) * s[:, None]
    return y.to(x.dtype).reshape(*lead, w.shape[1])


def dequantize_kn(q: torch.Tensor, qscale: torch.Tensor) -> torch.Tensor:
    """The f32 base ``q * qscale`` of logical ``(K, N)`` codes and ``(1, N)``
    scales, the value the kernels form as they stage each tile."""
    return q.float() * qscale.float().reshape(1, -1)


def fused_lora_int8_forward_plain(x, q, qscale, a, b, s: Scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`fused_lora_int8_forward`."""
    return fused_lora_forward_plain(x, dequantize_kn(q, qscale), a, b, s)


def fused_lora_int8_bwd_dx_plain(g, q, qscale, a, b, s: Scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`fused_lora_int8_bwd_dx`."""
    return fused_lora_bwd_dx_plain(g, dequantize_kn(q, qscale), a, b, s)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_library():
    lib = library("lora_matmul")
    if not getattr(lib, "_relora_typed", False):
        vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        product = [vp, vp, i64, i64, vp, vp, vp, f32, vp, vp] + [i32] * 5
        int8_product = [vp, vp, i64, i64, vp, vp, vp, vp, f32, vp, vp] + [i32] * 5
        lib.fused_lora_forward_launch.argtypes = product + [i32, vp]  # ..., dtype, tc, stream
        lib.fused_lora_bwd_dx_launch.argtypes = product + [i32, vp]
        lib.fused_lora_int8_forward_launch.argtypes = int8_product + [i32, vp]
        lib.fused_lora_int8_bwd_dx_launch.argtypes = int8_product + [i32, vp]
        lib.fused_lora_bwd_dab_launch.argtypes = (
            [vp, vp, vp, vp, i32, vp, vp, f32, vp, vp, vp, vp] + [i32] * 6 + [vp]
        )
        lib.dequant_matmul_launch.argtypes = [vp, vp, i64, i64, vp, vp] + [i32] * 5 + [vp]
        lib.grouped_lora_forward_launch.argtypes = (
            [vp, vp, i64, i64, vp, vp, vp, vp, vp, vp] + [i32] * 8 + [vp]
        )
        for fn in ("fused_lora_forward", "fused_lora_bwd_dx", "fused_lora_bwd_dab",
                   "fused_lora_int8_forward", "fused_lora_int8_bwd_dx", "dequant_matmul",
                   "grouped_lora_forward"):
            getattr(lib, f"{fn}_launch").restype = i32
        lib.lora_matmul_dab_chunk.restype = i32
        lib.lora_matmul_error_string.argtypes = [i32]
        lib.lora_matmul_error_string.restype = ctypes.c_char_p
        lib._relora_typed = True
    return lib


def _on_cuda(*tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(
                f"the fused LoRA kernels run on CUDA tensors; got {t.device} "
                "(CPU tensors take the plain version)"
            )
        if t.device != tensors[0].device:
            raise ValueError("all kernel operands must be on one device")


def _dtype_code(*tensors) -> int:
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODE or any(t.dtype != dtype for t in tensors):
        raise ValueError(
            f"operands must share float32 or bfloat16, got {[str(t.dtype) for t in tensors]}"
        )
    return _DTYPE_CODE[dtype]


def _rows(t: torch.Tensor, shape, what: str, dtype=None) -> torch.Tensor:
    """``t`` as a contiguous tensor of ``shape`` (and ``dtype``), or raise."""
    if tuple(t.shape) != tuple(shape) or (dtype is not None and t.dtype != dtype):
        raise ValueError(f"{what}: expected {tuple(shape)} {dtype or ''}, got {tuple(t.shape)} {t.dtype}")
    return t.contiguous()


def _base_strides(w: torch.Tensor) -> Tuple[int, int]:
    """Element strides of the logical ``(K, N)`` base: a contiguous ``w`` or
    the transpose of a contiguous one; anything else raises."""
    if w.ndim != 2 or not (w.is_contiguous() or w.t().is_contiguous()):
        raise ValueError(
            f"the base W must be a contiguous (K, N) tensor or the transpose of a "
            f"contiguous (N, K) one; got shape {tuple(w.shape)}, strides {w.stride()}"
        )
    return w.stride(0), w.stride(1)


def int8_base(q: torch.Tensor, qscale: torch.Tensor):
    """``(q strides, contiguous (1, N) f32 qscale)`` of an int8 base: ``q``
    int8 laid out as :func:`_base_strides` takes, ``qscale`` f32 with one
    element per column of ``q``; anything else raises."""
    if q.dtype != torch.int8:
        raise ValueError(f"the int8 base codes must be int8, got {q.dtype}")
    if qscale.dtype != torch.float32 or qscale.numel() != q.shape[-1] or qscale.device != q.device:
        raise ValueError(
            f"qscale must be float32 with one element per column of q {tuple(q.shape)} on "
            f"{q.device}; got {qscale.dtype} {tuple(qscale.shape)} on {qscale.device}"
        )
    return _base_strides(q), qscale.detach().reshape(1, -1).contiguous()


def _factor_shapes(w, a, b) -> Tuple[int, int, int]:
    if w.ndim != 2 or a.ndim != 2 or b.ndim != 2:
        raise ValueError("W, A and B must be 2-D")
    K, N = w.shape
    r = a.shape[1]
    if a.shape[0] != K or tuple(b.shape) != (r, N):
        raise ValueError(f"LoRA factor shapes {tuple(a.shape)} x {tuple(b.shape)} do not match base ({K}, {N})")
    return K, N, r


def _scale_arg(s: Scale, like: torch.Tensor):
    """``(device pointer or None, value, keep-alive tensor)`` for the kernels'
    ``s``: a tensor is read on the device, a float passed by value."""
    if isinstance(s, torch.Tensor):
        if s.numel() != 1:
            raise ValueError(f"scale must have one element, got shape {tuple(s.shape)}")
        s32 = s.detach().to(device=like.device, dtype=torch.float32).reshape(1).contiguous()
        return ptr_arg(s32), 0.0, s32
    return None, float(s), None


def forward_path(dtype: torch.dtype, base_strides: Tuple[int, int], K: int, N: int,
                 r: Optional[int], aligned: bool = True) -> str:
    """Which kernel a CUDA forward or dx (dense or int8 base), or kernel 8,
    launches: ``"tc"``, the bf16 tensor-core kernels, for bf16 operands with
    the base's k contiguous (``base_strides[0] == 1``: the transposed view
    of the ``(N, K)`` storage the model passes) at a row stride, K, N and r
    all multiples of 8, and every pointer 16-byte ``aligned``; else
    ``"fma"``, the f32 ``lora_gemm_kernel``, exact to summation order.
    ``base_strides`` are the logical ``(K, N)`` base's for both: dx reads
    the same storage by its rows.  Kernel 8 has no LoRA factor: it passes
    ``r=None`` and the rank test drops out.  Both are hand-written kernels:
    the plain twin is never taken for a CUDA tensor."""
    s0, s1 = base_strides
    tc = (dtype == torch.bfloat16 and s0 == 1 and s1 % 8 == 0 and K % 8 == 0 and N % 8 == 0
          and (r is None or r % 8 == 0) and aligned)
    return "tc" if tc else "fma"


#: rows of M per dA/dB partial, both paths (``lora_matmul_dab_chunk()`` in the library)
DAB_CHUNK = 512


def dab_chunks(M: int):
    """The M-chunk schedule of dA/dB: ``[(first row, end row)]`` of every
    partial, ``DAB_CHUNK`` rows apiece, the last cut at M.  It depends on M
    alone (never on the card), and the reduce sums the partials in this
    order, so the result is the same bits on every run."""
    return [(m0, min(M, m0 + DAB_CHUNK)) for m0 in range(0, M, DAB_CHUNK)]


def dab_path(dtype: torch.dtype, K: int, N: int, r: int, aligned: bool = True) -> str:
    """Which kernel a CUDA dA/dB (kernel 7) launches: :func:`forward_path`'s
    rule with no base to test (kernel 7 never reads it): ``"tc"`` for bf16
    operands with K, N and r multiples of 8 and every pointer 16-byte
    ``aligned``, else ``"fma"``."""
    return forward_path(dtype, (1, K), K, N, r, aligned)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _raise_on_error(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: {lib.lora_matmul_error_string(err).decode()} ({err})")


def fused_lora_forward(x, w, a, b, s: Scale = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``y = x @ W + ((x @ A) @ B) * s`` ``(M, N)`` in x's dtype and ``z = x
    @ A`` ``(M, r)`` f32, the residual the backward reads.

    A CPU ``x`` runs :func:`fused_lora_forward_plain`; any other device
    launches the forward of ``csrc/lora_matmul.cu`` on the path
    :func:`forward_path` picks, or raises.  ``.launches`` counts every
    launch, ``.tc_launches`` those of the tensor-core path."""
    if x.device.type == "cpu":
        return fused_lora_forward_plain(x, w, a, b, s)
    _on_cuda(x, w, a, b)
    K, N, r = _factor_shapes(w, a, b)
    M = x.shape[0]
    x, a, b = _rows(x, (M, K), "x"), a.contiguous(), b.contiguous()
    code = _dtype_code(x, w, a, b)
    ws0, ws1 = _base_strides(w)
    lib = _kernel_library()
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    z = torch.empty((M, r), dtype=torch.float32, device=x.device)
    tc = forward_path(x.dtype, (ws0, ws1), K, N, r, _aligned(x, w, a, b)) == "tc"
    s_ptr, s_val, _keep = _scale_arg(s, x)
    err = lib.fused_lora_forward_launch(
        ptr_arg(x), ptr_arg(w), ws0, ws1, ptr_arg(a), ptr_arg(b), s_ptr, s_val,
        ptr_arg(y), ptr_arg(z), M, K, N, r, code, int(tc), stream_arg(x),
    )
    _raise_on_error(lib, err, "fused_lora_forward")
    fused_lora_forward.launches += 1
    fused_lora_forward.tc_launches += tc
    return y, z


fused_lora_forward.launches = 0
fused_lora_forward.tc_launches = 0


def fused_lora_bwd_dx(g, w, a, b, s: Scale = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dx = g @ Wᵀ + s * (g @ Bᵀ) @ Aᵀ`` ``(M, K)`` in g's dtype, and ``u =
    g @ Bᵀ`` ``(M, r)`` f32, which :func:`fused_lora_bwd_dab` reuses.

    A CPU ``g`` runs :func:`fused_lora_bwd_dx_plain`; any other device
    launches the dx of ``csrc/lora_matmul.cu`` on the path
    :func:`forward_path` picks, or raises; counted as
    :func:`fused_lora_forward` counts."""
    if g.device.type == "cpu":
        return fused_lora_bwd_dx_plain(g, w, a, b, s)
    _on_cuda(g, w, a, b)
    K, N, r = _factor_shapes(w, a, b)
    M = g.shape[0]
    g, a, b = _rows(g, (M, N), "g"), a.contiguous(), b.contiguous()
    code = _dtype_code(g, w, a, b)
    ws0, ws1 = _base_strides(w)
    lib = _kernel_library()
    dx = torch.empty((M, K), dtype=g.dtype, device=g.device)
    u = torch.empty((M, r), dtype=torch.float32, device=g.device)
    tc = forward_path(g.dtype, (ws0, ws1), K, N, r, _aligned(g, w, a, b)) == "tc"
    s_ptr, s_val, _keep = _scale_arg(s, g)
    err = lib.fused_lora_bwd_dx_launch(
        ptr_arg(g), ptr_arg(w), ws0, ws1, ptr_arg(a), ptr_arg(b), s_ptr, s_val,
        ptr_arg(dx), ptr_arg(u), M, K, N, r, code, int(tc), stream_arg(g),
    )
    _raise_on_error(lib, err, "fused_lora_bwd_dx")
    fused_lora_bwd_dx.launches += 1
    fused_lora_bwd_dx.tc_launches += tc
    return dx, u


fused_lora_bwd_dx.launches = 0
fused_lora_bwd_dx.tc_launches = 0


def fused_lora_bwd_dab(g, x, z, b, s: Scale = 1.0, u=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dA = s * xᵀ (g @ Bᵀ)`` ``(K, r)`` and ``dB = s * zᵀ g`` ``(r, N)``,
    both f32, summed over the M rows; ``u = g @ Bᵀ`` from
    :func:`fused_lora_bwd_dx` saves recomputing it.

    A CPU ``g`` runs :func:`fused_lora_bwd_dab_plain`; any other device
    launches the dA/dB kernels on the path :func:`dab_path` picks (partials
    over 512-row chunks of M, then a reduce pass in chunk order; the bf16
    path on the tensor cores after splitting u and z into bf16 halves) or
    raises.  ``.launches`` counts every launch, ``.tc_launches`` those of
    the tensor-core path."""
    if g.device.type == "cpu":
        return fused_lora_bwd_dab_plain(g, x, z, b, s, u)
    _on_cuda(g, x, z, b, *(() if u is None else (u,)))
    M, N = g.shape
    K = x.shape[1]
    r = b.shape[0]
    g, x, b = _rows(g, (M, N), "g"), _rows(x, (M, K), "x"), _rows(b, (r, N), "B")
    z = _rows(z, (M, r), "z", torch.float32)
    code = _dtype_code(g, x, b)
    lib = _kernel_library()
    have_u = u is not None
    if have_u:
        u = _rows(u, (M, r), "u", torch.float32)
    else:
        u = torch.empty((M, r), dtype=torch.float32, device=g.device)
    if lib.lora_matmul_dab_chunk() != DAB_CHUNK:
        raise RuntimeError("the library's dA/dB chunk differs from DAB_CHUNK")
    chunks = max(1, len(dab_chunks(M)))
    part = torch.empty((chunks, K * r + r * N), dtype=torch.float32, device=g.device)
    da = torch.empty((K, r), dtype=torch.float32, device=g.device)
    db = torch.empty((r, N), dtype=torch.float32, device=g.device)
    tc = dab_path(g.dtype, K, N, r, _aligned(g, x, z, u, part)) == "tc"
    # the tensor-core path's hi and lo bf16 halves of u and z
    split = torch.empty((4, M, r) if tc else (0,), dtype=torch.bfloat16, device=g.device)
    s_ptr, s_val, _keep = _scale_arg(s, g)
    err = lib.fused_lora_bwd_dab_launch(
        ptr_arg(g), ptr_arg(x), ptr_arg(z), ptr_arg(u), int(have_u), ptr_arg(b), s_ptr, s_val,
        ptr_arg(part), ptr_arg(split), ptr_arg(da), ptr_arg(db), M, K, N, r, code, int(tc),
        stream_arg(g),
    )
    _raise_on_error(lib, err, "fused_lora_bwd_dab")
    fused_lora_bwd_dab.launches += 1
    fused_lora_bwd_dab.tc_launches += tc
    return da, db


fused_lora_bwd_dab.launches = 0
fused_lora_bwd_dab.tc_launches = 0


def fused_lora_int8_forward(x, q, qscale, a, b, s: Scale = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_lora_forward` over the int8 base ``q * qscale``.

    A CPU ``x`` runs :func:`fused_lora_int8_forward_plain`; any other device
    launches the int8 forward of ``csrc/lora_matmul.cu`` on the path
    :func:`forward_path` picks (``q``'s strides as the base's), or raises;
    counted as :func:`fused_lora_forward` counts."""
    if x.device.type == "cpu":
        return fused_lora_int8_forward_plain(x, q, qscale, a, b, s)
    _on_cuda(x, q, a, b)
    K, N, r = _factor_shapes(q, a, b)
    M = x.shape[0]
    x, a, b = _rows(x, (M, K), "x"), a.contiguous(), b.contiguous()
    code = _dtype_code(x, a, b)
    (qs0, qs1), qscale = int8_base(q, qscale)
    lib = _kernel_library()
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    z = torch.empty((M, r), dtype=torch.float32, device=x.device)
    tc = forward_path(x.dtype, (qs0, qs1), K, N, r, _aligned(x, q, a, b)) == "tc"
    s_ptr, s_val, _keep = _scale_arg(s, x)
    err = lib.fused_lora_int8_forward_launch(
        ptr_arg(x), ptr_arg(q), qs0, qs1, ptr_arg(qscale), ptr_arg(a), ptr_arg(b), s_ptr, s_val,
        ptr_arg(y), ptr_arg(z), M, K, N, r, code, int(tc), stream_arg(x),
    )
    _raise_on_error(lib, err, "fused_lora_int8_forward")
    fused_lora_int8_forward.launches += 1
    fused_lora_int8_forward.tc_launches += tc
    return y, z


fused_lora_int8_forward.launches = 0
fused_lora_int8_forward.tc_launches = 0


def fused_lora_int8_bwd_dx(g, q, qscale, a, b, s: Scale = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_lora_bwd_dx` over the int8 base ``q * qscale``.

    A CPU ``g`` runs :func:`fused_lora_int8_bwd_dx_plain`; any other device
    launches the int8 dx of ``csrc/lora_matmul.cu`` on the path
    :func:`forward_path` picks (``q``'s strides as the base's), or raises;
    counted as :func:`fused_lora_forward` counts."""
    if g.device.type == "cpu":
        return fused_lora_int8_bwd_dx_plain(g, q, qscale, a, b, s)
    _on_cuda(g, q, a, b)
    K, N, r = _factor_shapes(q, a, b)
    M = g.shape[0]
    g, a, b = _rows(g, (M, N), "g"), a.contiguous(), b.contiguous()
    code = _dtype_code(g, a, b)
    (qs0, qs1), qscale = int8_base(q, qscale)
    lib = _kernel_library()
    dx = torch.empty((M, K), dtype=g.dtype, device=g.device)
    u = torch.empty((M, r), dtype=torch.float32, device=g.device)
    tc = forward_path(g.dtype, (qs0, qs1), K, N, r, _aligned(g, q, a, b)) == "tc"
    s_ptr, s_val, _keep = _scale_arg(s, g)
    err = lib.fused_lora_int8_bwd_dx_launch(
        ptr_arg(g), ptr_arg(q), qs0, qs1, ptr_arg(qscale), ptr_arg(a), ptr_arg(b), s_ptr, s_val,
        ptr_arg(dx), ptr_arg(u), M, K, N, r, code, int(tc), stream_arg(g),
    )
    _raise_on_error(lib, err, "fused_lora_int8_bwd_dx")
    fused_lora_int8_bwd_dx.launches += 1
    fused_lora_int8_bwd_dx.tc_launches += tc
    return dx, u


fused_lora_int8_bwd_dx.launches = 0
fused_lora_int8_bwd_dx.tc_launches = 0


def grouped_shapes(x, w, a_stack, b_stack, idx) -> Tuple[int, int, int, int, int]:
    """``(M, K, N, r, S)`` of a grouped call, checked as the JAX entry point
    checks them (``pallas_lora_matmul.py:236-252``); anything else raises."""
    K = x.shape[-1]
    if w.ndim != 2 or a_stack.ndim != 3 or b_stack.ndim != 3:
        raise ValueError("the base must be 2-D and the A and B stacks 3-D")
    N = w.shape[1]
    S, Ka, r = a_stack.shape
    if Ka != K or w.shape[0] != K:
        raise ValueError(
            f"contraction mismatch: x K={K}, base {tuple(w.shape)}, A {tuple(a_stack.shape)}"
        )
    if tuple(b_stack.shape) != (S, r, N):
        raise ValueError(
            f"B stack {tuple(b_stack.shape)} does not match A stack {tuple(a_stack.shape)} / base N={N}"
        )
    M = x.numel() // K
    if idx.numel() != M:
        raise ValueError(
            f"adapter_idx has {idx.numel()} rows but x flattens to M={M} "
            "(expand per-batch indices to per-row before the kernel)"
        )
    return M, K, N, r, S


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


#: kernel 5's split schedule: a base block owns 16 rows of N and one K chunk
#: of a multiple of 32 rows; chunks are chosen so that a call launches at least
#: two base blocks per SM of the H100 (132 SMs)
GROUPED_ROWS, GROUPED_K_GROUP, GROUPED_TARGET_BLOCKS = 16, 32, 2 * 132
#: rows of K per shrink partial (``kG5ZChunk`` in ``csrc/lora_matmul.cu``)
GROUPED_Z_CHUNK = 256


def grouped_split_schedule(K: int, N: int) -> Tuple[int, int]:
    """``(splits, kc)``: kernel 5 contracts ``x @ W`` in ``splits`` chunks of
    ``kc`` rows of K (the last one ragged), each a block per 16 rows of N,
    summed in chunk order.  It depends on K and N alone, never on M or the
    slots, so that a row's result does not depend on the rest of its batch."""
    want = _cdiv(GROUPED_TARGET_BLOCKS, _cdiv(N, GROUPED_ROWS))  # splits for the target
    kc = _cdiv(_cdiv(K, want), GROUPED_K_GROUP) * GROUPED_K_GROUP
    return _cdiv(K, kc), kc


def grouped_scratch_floats(M: int, K: int, N: int, r: int) -> int:
    """f32 elements of kernel 5's scratch: the base partials ``(splits, M,
    N)`` and the shrink partials ``(ceil(K / 256), M, r)``."""
    splits, _ = grouped_split_schedule(K, N)
    return M * (splits * N + _cdiv(K, GROUPED_Z_CHUNK) * r)


def grouped_lora_matmul(x, w, a_stack, b_stack, s_stack, idx) -> torch.Tensor:
    """``y[m] = x[m] @ W + ((x[m] @ A[idx[m]]) @ B[idx[m]]) * s[idx[m]]`` for
    a mixed-tenant batch (kernel 5).

    ``x``: ``(..., K)``, flattening to M rows; ``w``: ``(K, N)`` shared base,
    contiguous or the ``(N, K)`` weight's transposed view; ``a_stack``:
    ``(S, K, r)``; ``b_stack``: ``(S, r, N)``; ``s_stack``: ``(S,)`` f32;
    ``idx``: ``(M,)`` the slot of each row, read on the device (no host
    sync).  x, w and the stacks share f32 or bf16; ``y`` takes their dtype and
    x's leading shape.  A CPU ``x`` runs :func:`grouped_lora_matmul_plain`;
    any other device launches both passes of kernel 5 (counted as one call
    in ``.launches``) or raises."""
    M, K, N, r, S = grouped_shapes(x, w, a_stack, b_stack, idx)
    if x.device.type == "cpu":
        return grouped_lora_matmul_plain(x, w, a_stack, b_stack, s_stack, idx)
    _on_cuda(x, w, a_stack, b_stack, s_stack, idx)
    lead = x.shape[:-1]
    x2 = x.reshape(M, K).contiguous()
    a_stack, b_stack = a_stack.contiguous(), b_stack.contiguous()
    code = _dtype_code(x2, w, a_stack, b_stack)
    ws0, ws1 = _base_strides(w)
    s32 = _rows(s_stack.reshape(-1), (S,), "s_stack", torch.float32)
    idx32 = _rows(idx.reshape(-1), (M,), "adapter_idx", torch.int32)
    lib = _kernel_library()
    splits, kc = grouped_split_schedule(K, N)
    scratch = torch.empty(grouped_scratch_floats(M, K, N, r), dtype=torch.float32, device=x.device)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = lib.grouped_lora_forward_launch(
        ptr_arg(x2), ptr_arg(w), ws0, ws1, ptr_arg(a_stack), ptr_arg(b_stack), ptr_arg(s32),
        ptr_arg(idx32), ptr_arg(scratch), ptr_arg(y), M, K, N, r, S, splits, kc, code,
        stream_arg(x2),
    )
    _raise_on_error(lib, err, "grouped_lora_matmul")
    grouped_lora_matmul.launches += 1
    return y.reshape(*lead, N)


grouped_lora_matmul.launches = 0


class FusedLoRAMatmul(torch.autograd.Function):
    """``x2 @ W + ((x2 @ A) @ B) * s`` over ``(M, K)`` rows, whose forward
    and backward are the three wrappers above (kernels for CUDA tensors,
    twins for CPU tensors).  ``z`` is saved from the forward; dx hands ``u``
    to dA/dB; ``ds = sum(g * (z @ B))`` is plain PyTorch, computed only when
    ``s`` is a tensor that needs it; W gets no gradient."""

    @staticmethod
    def forward(ctx, x2, w, a, b, s):
        y, z = fused_lora_forward(x2, w, a, b, s)
        ctx.s = None if isinstance(s, torch.Tensor) else s
        ctx.save_for_backward(x2, w, a, b, z, *((s,) if ctx.s is None else ()))
        return y

    @staticmethod
    def backward(ctx, g):
        x2, w, a, b, z, *rest = ctx.saved_tensors
        s = rest[0] if rest else ctx.s
        need_x, _, need_a, need_b, need_s = ctx.needs_input_grad
        g = g.contiguous()
        dx = da = db = ds = u = None
        if need_x:
            dx, u = fused_lora_bwd_dx(g, w, a, b, s)
            dx = dx.to(x2.dtype)
        if need_a or need_b:
            da, db = fused_lora_bwd_dab(g, x2, z, b, s, u)
            da, db = da.to(a.dtype), db.to(b.dtype)
        if need_s:
            ds = (g.float() * (z @ b.float())).sum().reshape(s.shape).to(s.dtype)
        return dx, None, da, db, ds


class FusedLoRAMatmulInt8(torch.autograd.Function):
    """``x2 @ (q * qscale) + ((x2 @ A) @ B) * s``: :class:`FusedLoRAMatmul`
    over an int8 base (``_fused_int8_vjp``, ``pallas_lora_matmul.py:403-427``).
    The forward and dx are the int8 wrappers; dA/dB reuse kernel 7, which
    never reads the base; ``ds`` is the dense arm's.  ``dqscale = Σ_m g ⊙ (x
    @ q)`` is plain PyTorch, computed only when asked for; ``q`` gets none."""

    @staticmethod
    def forward(ctx, x2, q, qscale, a, b, s):
        y, z = fused_lora_int8_forward(x2, q, qscale, a, b, s)
        ctx.s = None if isinstance(s, torch.Tensor) else s
        ctx.save_for_backward(x2, q, qscale, a, b, z, *((s,) if ctx.s is None else ()))
        return y

    @staticmethod
    def backward(ctx, g):
        x2, q, qscale, a, b, z, *rest = ctx.saved_tensors
        s = rest[0] if rest else ctx.s
        need_x, _, need_qscale, need_a, need_b, need_s = ctx.needs_input_grad
        g = g.contiguous()
        dx = dqscale = da = db = ds = u = None
        if need_x:
            dx, u = fused_lora_int8_bwd_dx(g, q, qscale, a, b, s)
            dx = dx.to(x2.dtype)
        if need_a or need_b:
            da, db = fused_lora_bwd_dab(g, x2, z, b, s, u)
            da, db = da.to(a.dtype), db.to(b.dtype)
        if need_s:
            ds = (g.float() * (z @ b.float())).sum().reshape(s.shape).to(s.dtype)
        if need_qscale:
            xq = torch.matmul(x2.float(), q.float())
            dqscale = (g.float() * xq).sum(0).reshape(qscale.shape).to(qscale.dtype)
        return dx, None, dqscale, da, db, ds


def _check_composite(K: int, base: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> int:
    """N of the composite over the logical ``(K, N)`` base, or raise."""
    if base.ndim != 2 or K != base.shape[0]:
        raise ValueError(f"contraction mismatch: x K={K} vs base {tuple(base.shape)}")
    N = base.shape[1]
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != K or b.shape[0] != a.shape[1] or b.shape[1] != N:
        raise ValueError(
            f"LoRA factor shapes {tuple(a.shape)} x {tuple(b.shape)} do not match base ({K}, {N})"
        )
    return N


def fused_lora_matmul(
    x: torch.Tensor, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: Scale = 1.0
) -> torch.Tensor:
    """``x @ W + ((x @ A) @ B) * scale`` through :class:`FusedLoRAMatmul`.

    ``x``: ``(..., K)``; ``w``: ``(K, N)`` frozen base (contiguous or a
    transposed view); ``a``: ``(K, r)``; ``b``: ``(r, N)``; ``scale``: a
    float or a one-element tensor.  Differentiable in x, a, b and a tensor
    scale; ``w`` is detached, so it gets no gradient.  Any M, K, N and rank,
    as the JAX package's fused kernel: there is no tiling condition and no
    unfused fallback."""
    K = x.shape[-1]
    N = _check_composite(K, w, a, b)
    lead = x.shape[:-1]
    scale = scale if isinstance(scale, torch.Tensor) else float(scale)
    y = FusedLoRAMatmul.apply(x.reshape(-1, K), w.detach(), a, b, scale)
    return y.reshape(*lead, N)


def fused_lora_matmul_int8(
    x: torch.Tensor,
    q: torch.Tensor,
    qscale: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    scale: Scale = 1.0,
) -> torch.Tensor:
    """``x @ (q * qscale) + ((x @ A) @ B) * scale`` through
    :class:`FusedLoRAMatmulInt8` (``fused_lora_matmul_int8``,
    ``pallas_lora_matmul.py:497-524``).

    ``q``: ``(K, N)`` int8 codes (contiguous or a transposed view);
    ``qscale``: ``(1, N)`` f32.  Differentiable in x, a, b, a tensor scale
    and ``qscale`` (its true gradient, as the JAX package gives it); ``q``
    gets none.  Shapes as :func:`fused_lora_matmul`."""
    K = x.shape[-1]
    N = _check_composite(K, q, a, b)
    lead = x.shape[:-1]
    scale = scale if isinstance(scale, torch.Tensor) else float(scale)
    y = FusedLoRAMatmulInt8.apply(x.reshape(-1, K), q, qscale, a, b, scale)
    return y.reshape(*lead, N)
