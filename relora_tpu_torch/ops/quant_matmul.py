"""``y = x @ (q * scale)`` against an int8 frozen base: kernel 8 and its twin.

Replaces the TPU kernel of ``relora_tpu/ops/pallas_quant_matmul.py``:
``_pallas_forward`` (``:46``) -> ``pallas_call`` ``:49``
(``_dequant_matmul_kernel`` ``:35``).  The Hopper kernel is
``dequant_matmul_launch`` of ``csrc/lora_matmul.cu``: the fused LoRA GEMM
with one contraction segment and the int8 operand, each code widened and
multiplied by its column's f32 scale as the tile is staged, so the weight
stays int8 in device memory and no dequantized copy is written.  Its header
note gives the design and the bound.

- :func:`dequant_matmul` ``(x, q, scale) -> y`` through
  :class:`DequantMatmul`, the port of ``_dequant_matmul_vjp``
  (``:69-102``).  Its forward is the kernel for a CUDA tensor (counted in
  ``dequant_matmul.launches``) and :func:`dequant_matmul_plain` for a CPU
  tensor; nothing else.  Its backward is the JAX package's plain
  dequantize-then-matmul (``:78-99``): ``dx = g @ (q·scale)ᵀ`` with
  ``torch.matmul`` in f32, ``dscale = Σ_m g ⊙ (x @ q)`` only when asked for,
  and nothing for ``q``.

``x`` is ``(..., K)`` f32 or bf16, ``q`` the logical ``(K, N)`` int8 codes
(contiguous, or the transpose of the port's ``(out, in)`` codes), ``scale``
``(1, N)`` f32; ``y`` takes x's dtype, accumulated in f32.
"""

from __future__ import annotations

import torch

from relora_tpu_torch.ops._build import ptr_arg, stream_arg
from relora_tpu_torch.ops.lora_matmul import (
    _dtype_code,
    _kernel_library,
    _on_cuda,
    _raise_on_error,
    _rows,
    dequantize_kn,
    int8_base,
)


def dequant_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`dequant_matmul`: the kernel's f32 arithmetic."""
    return (x.float() @ dequantize_kn(q, scale)).to(x.dtype)


def _forward(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x2 (M, K) @ (q * scale)``: the twin for a CPU ``x2``, else kernel 8
    or raise."""
    if x2.device.type == "cpu":
        return dequant_matmul_plain(x2, q, scale)
    _on_cuda(x2, q)
    K, N = q.shape
    M = x2.shape[0]
    x2 = _rows(x2, (M, K), "x")
    code = _dtype_code(x2)
    (qs0, qs1), scale = int8_base(q, scale)
    lib = _kernel_library()
    y = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    err = lib.dequant_matmul_launch(
        ptr_arg(x2), ptr_arg(q), qs0, qs1, ptr_arg(scale), ptr_arg(y), M, K, N, code,
        stream_arg(x2),
    )
    _raise_on_error(lib, err, "dequant_matmul")
    dequant_matmul.launches += 1
    return y


class DequantMatmul(torch.autograd.Function):
    """``x2 @ (q * scale)`` over ``(M, K)`` rows: kernel 8 forward, plain
    backward (``relora_tpu/ops/pallas_quant_matmul.py:69-102``)."""

    @staticmethod
    def forward(ctx, x2, q, scale):
        ctx.save_for_backward(x2, q, scale)
        return _forward(x2, q, scale)

    @staticmethod
    def backward(ctx, g):
        x2, q, scale = ctx.saved_tensors
        need_x, _, need_scale = ctx.needs_input_grad
        g32 = g.float()
        dx = dscale = None
        if need_x:
            dx = torch.matmul(g32, dequantize_kn(q, scale).t()).to(x2.dtype)
        if need_scale:
            xq = torch.matmul(x2.float(), q.float())
            dscale = (g32 * xq).sum(0).reshape(scale.shape).to(scale.dtype)
        return dx, None, dscale


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ (q * scale)`` for ``x`` ``(..., K)``, ``q`` ``(K, N)`` int8 and
    ``scale`` ``(1, N)`` f32, through :class:`DequantMatmul`.  Any M, K and
    N: there is no tiling condition."""
    K = x.shape[-1]
    if q.ndim != 2 or q.shape[0] != K:
        raise ValueError(f"contraction mismatch: x K={K} vs q {tuple(q.shape)}")
    y = DequantMatmul.apply(x.reshape(-1, K), q, scale)
    return y.reshape(*x.shape[:-1], q.shape[1])


dequant_matmul.launches = 0
