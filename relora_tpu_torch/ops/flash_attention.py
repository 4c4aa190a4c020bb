"""Causal flash attention for training: three CUDA kernels and their plain twins.

Replaces the TPU flash kernel that ``relora_tpu/ops/attention.py:84``
(``_pallas_attention``) reaches through JAX's Pallas library (forward, dK/dV
and dQ ``pallas_call``\\ s).  ``csrc/flash_attention.cu`` holds the Hopper
kernels; its header note gives the design and the bound.  The dtype alone
picks the kernels: bf16 tensors always launch the tensor-core kernels
(``mma.sync`` bf16 products, f32 accumulation), f32 tensors always launch the
f32 FMA kernels, which are exact to summation order.  A bf16 call those
kernels cannot take raises; it never drops to the f32 kernels.  Here:

- :func:`flash_attention_forward` ``(q, k, v) -> (out, lse)``,
  :func:`flash_attention_bwd_dkdv` ``-> (dk, dv)`` and
  :func:`flash_attention_bwd_dq` ``-> dq``: one wrapper per kernel.  A CPU
  tensor runs the plain twin of the same name with ``_plain``; a CUDA tensor
  launches the kernel or raises.  Each wrapper counts its launches in
  ``.launches``, and in ``.wide_launches`` those the launcher reports on a
  wide kernel (head_dim past 128).
- :func:`flash_attention_delta` ``rowsum(dO * O)``, plain PyTorch on every
  device: both backward kernels read it instead of the forward's output.
- :class:`FlashAttention`, the ``torch.autograd.Function`` over the three,
  and :func:`flash_attention`, its entry point.

Layouts follow the JAX package: ``q`` ``(B, S, N, H)``, ``k``/``v`` ``(B, S,
n_kv, H)`` with ``N % n_kv == 0`` (query head ``h`` reads kv head ``h //
(N // n_kv)``), ``lse`` and ``delta`` ``(B, N, S)`` f32.  Key ``j`` is visible
to query ``i`` iff ``j <= i``.  Sums and the softmax are f32 (bf16: the
tensor-core products take bf16 operands, P and dS rounded to bf16 in
registers); outputs take the input dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from relora_tpu_torch.ops._build import ptr_arg, stream_arg

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: largest head_dim the kernels take (it must also be even)
MAX_HEAD_DIM = 256
#: dynamic shared memory a block may use on Hopper (227 KB)
_MAX_SMEM = 232448
_KERNELS = {"forward": 0, "dkdv": 1, "dq": 2}


# ---------------------------------------------------------------------------
# Plain twins: the kernels' arithmetic, vectorized
# ---------------------------------------------------------------------------


def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """``(B, S, N, H)`` -> f32 ``(B, n_kv, g, S, H)``."""
    B, S, N, H = q.shape
    return q.float().reshape(B, S, n_kv, N // n_kv, H).permute(0, 2, 3, 1, 4)


def _ungroup(x: torch.Tensor, dtype) -> torch.Tensor:
    """f32 ``(B, n_kv, g, S, H)`` -> ``(B, S, N, H)`` in ``dtype``."""
    B, n_kv, g, S, H = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, S, n_kv * g, H).to(dtype)


def _kv(t: torch.Tensor) -> torch.Tensor:
    """``(B, S, n_kv, H)`` -> f32 ``(B, n_kv, 1, S, H)``."""
    return t.float().permute(0, 2, 1, 3)[:, :, None]


def _causal(S: int, device) -> torch.Tensor:
    idx = torch.arange(S, device=device)
    return idx[None, :] <= idx[:, None]  # (query, key)


def _probs(q, k, lse, scale):
    """P ``(B, n_kv, g, S, S)`` recomputed from the saved ``lse``."""
    n_kv = k.shape[2]
    s = torch.matmul(_grouped(q, n_kv), _kv(k).transpose(-1, -2)) * scale
    lse_g = lse.reshape(lse.shape[0], n_kv, -1, lse.shape[2])[..., None]
    p = torch.exp(s - lse_g)
    return torch.where(_causal(q.shape[1], q.device), p, 0.0)


def flash_attention_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`flash_attention_forward`."""
    B, S, N, H = q.shape
    n_kv = k.shape[2]
    s = torch.matmul(_grouped(q, n_kv), _kv(k).transpose(-1, -2)) * scale
    s = torch.where(_causal(S, q.device), s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, _kv(v)) / l
    lse = (m + torch.log(l))[..., 0].reshape(B, N, S)
    return _ungroup(out, q.dtype), lse


def flash_attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` ``(B, N, S)`` f32, the softmax backward's row term."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _grad_probs(q, k, v, dout, lse, delta, scale):
    """P and dS = P * (dP - delta), both ``(B, n_kv, g, S, S)``."""
    n_kv = k.shape[2]
    p = _probs(q, k, lse, scale)
    dp = torch.matmul(_grouped(dout, n_kv), _kv(v).transpose(-1, -2))
    d = delta.reshape(delta.shape[0], n_kv, -1, delta.shape[2])[..., None]
    return p, p * (dp - d)


def flash_attention_bwd_dkdv_plain(q, k, v, dout, lse, delta, scale):
    """Plain twin of :func:`flash_attention_bwd_dkdv`: dK and dV summed over
    the query heads of each kv head's group."""
    n_kv = k.shape[2]
    p, ds = _grad_probs(q, k, v, dout, lse, delta, scale)
    dv = torch.matmul(p.transpose(-1, -2), _grouped(dout, n_kv)).sum(dim=2)
    dk = torch.matmul(ds.transpose(-1, -2), _grouped(q, n_kv)).sum(dim=2) * scale
    return dk.permute(0, 2, 1, 3).to(k.dtype), dv.permute(0, 2, 1, 3).to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, scale):
    """Plain twin of :func:`flash_attention_bwd_dq`."""
    _, ds = _grad_probs(q, k, v, dout, lse, delta, scale)
    return _ungroup(torch.matmul(ds, _kv(k)) * scale, q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_library():
    from relora_tpu_torch.ops import _build

    lib = _build.library("flash_attention")
    if not getattr(lib, "_relora_typed", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [f32, i32, vp, ctypes.POINTER(i32)]  # scale, dtype, stream, launched_wide
        lib.flash_attention_forward_launch.argtypes = [vp] * 5 + [i32] * 5 + tail
        lib.flash_attention_bwd_dkdv_launch.argtypes = [vp] * 8 + [i32] * 5 + tail
        lib.flash_attention_bwd_dq_launch.argtypes = [vp] * 7 + [i32] * 5 + tail
        for fn in ("forward", "bwd_dkdv", "bwd_dq"):
            getattr(lib, f"flash_attention_{fn}_launch").restype = i32
        lib.flash_attention_smem_bytes.argtypes = [i32, i32, i32]
        lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._relora_typed = True
    return lib


def check_head_dim(H: int) -> None:
    """Raise unless the kernels take head_dim ``H``: even and at most
    :data:`MAX_HEAD_DIM` (bf16 pads it to a multiple of 16 in shared memory;
    past 128 both dtypes switch to their wide kernels)."""
    if H < 2 or H % 2 or H > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {H} must be even and <= {MAX_HEAD_DIM}")


def _check(kernel: str, q, k, v, *others):
    """Everything the kernels assume, checked before a pointer is passed;
    returns ``(library, (B, S, N, n_kv, H), dtype code)``."""
    for t in (q, k, v, *others):
        if t.device.type != "cuda":
            raise ValueError(
                f"the flash attention kernels run on CUDA tensors; got {t.device} "
                "(CPU tensors take the plain version)"
            )
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all kernel operands must be contiguous and on q's device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, N, H = q.shape
    n_kv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != H:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} (causal self-attention)")
    if N % n_kv:
        raise ValueError(f"num_heads={N} must divide by kv_heads={n_kv}")
    check_head_dim(H)
    lib = _kernel_library()
    code = _DTYPE_CODE[q.dtype]
    smem = lib.flash_attention_smem_bytes(_KERNELS[kernel], H, code)
    if smem > _MAX_SMEM:
        raise ValueError(f"head_dim {H} needs {smem} B of shared memory (> {_MAX_SMEM})")
    return lib, (B, S, N, n_kv, H), code


def _raise_on_error(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: {lib.flash_attention_error_string(err).decode()} ({err})")


def _f32_rows(t: torch.Tensor, shape) -> torch.Tensor:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected f32 {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention ``out`` ``(B, S, N, H)`` in q's dtype and the per-row
    log-sum-exp ``lse`` ``(B, N, S)`` f32 the backward needs.

    A CPU ``q`` runs :func:`flash_attention_forward_plain`; any other device
    launches the forward kernel of ``csrc/flash_attention.cu`` (bf16:
    ``flash_fwd_tc_kernel`` on the tensor cores; f32: ``flash_fwd_kernel``)
    or raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_forward_plain(q, k, v, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lib, (B, S, N, n_kv, H), code = _check("forward", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, N, S), dtype=torch.float32, device=q.device)
    wide = ctypes.c_int(0)
    err = lib.flash_attention_forward_launch(
        ptr_arg(q), ptr_arg(k), ptr_arg(v), ptr_arg(out), ptr_arg(lse),
        B, S, N, n_kv, H, float(scale), code, stream_arg(q), ctypes.byref(wide),
    )
    _raise_on_error(lib, err, "flash_fwd_kernel")
    flash_attention_forward.launches += 1
    flash_attention_forward.wide_launches += wide.value
    return out, lse


flash_attention_forward.launches = 0
flash_attention_forward.wide_launches = 0


def flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, scale: Optional[float] = None):
    """dK, dV ``(B, S, n_kv, H)`` in k's dtype, from the forward's ``lse``
    and :func:`flash_attention_delta`.

    A CPU ``q`` runs :func:`flash_attention_bwd_dkdv_plain`; any other device
    launches the dK/dV kernel (bf16: ``flash_bwd_dkdv_tc_kernel``; f32:
    ``flash_bwd_dkdv_kernel``) or raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_dkdv_plain(q, k, v, dout, lse, delta, scale)
    q, k, v, dout = q.contiguous(), k.contiguous(), v.contiguous(), dout.contiguous()
    B, S, N, _ = q.shape
    lse, delta = _f32_rows(lse, (B, N, S)), _f32_rows(delta, (B, N, S))
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {dout.dtype} {tuple(dout.shape)} must match q")
    lib, (B, S, N, n_kv, H), code = _check("dkdv", q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    wide = ctypes.c_int(0)
    err = lib.flash_attention_bwd_dkdv_launch(
        ptr_arg(q), ptr_arg(k), ptr_arg(v), ptr_arg(dout), ptr_arg(lse), ptr_arg(delta),
        ptr_arg(dk), ptr_arg(dv), B, S, N, n_kv, H, float(scale), code, stream_arg(q),
        ctypes.byref(wide),
    )
    _raise_on_error(lib, err, "flash_bwd_dkdv_kernel")
    flash_attention_bwd_dkdv.launches += 1
    flash_attention_bwd_dkdv.wide_launches += wide.value
    return dk, dv


flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dkdv.wide_launches = 0


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale: Optional[float] = None):
    """dQ ``(B, S, N, H)`` in q's dtype, from the forward's ``lse`` and
    :func:`flash_attention_delta`.

    A CPU ``q`` runs :func:`flash_attention_bwd_dq_plain`; any other device
    launches the dQ kernel (bf16: ``flash_bwd_dq_tc_kernel``; f32:
    ``flash_bwd_dq_kernel``) or raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, scale)
    q, k, v, dout = q.contiguous(), k.contiguous(), v.contiguous(), dout.contiguous()
    B, S, N, _ = q.shape
    lse, delta = _f32_rows(lse, (B, N, S)), _f32_rows(delta, (B, N, S))
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {dout.dtype} {tuple(dout.shape)} must match q")
    lib, (B, S, N, n_kv, H), code = _check("dq", q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    wide = ctypes.c_int(0)
    err = lib.flash_attention_bwd_dq_launch(
        ptr_arg(q), ptr_arg(k), ptr_arg(v), ptr_arg(dout), ptr_arg(lse), ptr_arg(delta), ptr_arg(dq),
        B, S, N, n_kv, H, float(scale), code, stream_arg(q), ctypes.byref(wide),
    )
    _raise_on_error(lib, err, "flash_bwd_dq_kernel")
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.wide_launches += wide.value
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.wide_launches = 0


class FlashAttention(torch.autograd.Function):
    """Causal attention whose forward and backward are the three wrappers
    above (kernels for CUDA tensors, twins for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_attention_delta(out, dout)
        dk, dv = flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Differentiable causal attention over ``(B, S, N, H)`` q and ``(B, S,
    n_kv, H)`` k/v through :class:`FlashAttention`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, float(scale))
