"""Execution arms of the LoRA composite ``x @ W + ((x @ A) @ B) * s``.

Counterpart of ``relora_tpu/ops/lora_dispatch.py:271-349`` ``lora_matmul``:

- **fused**: :func:`relora_tpu_torch.ops.lora_matmul.fused_lora_matmul`, the
  hand-written kernels on CUDA (their plain twins on the CPU), for every
  shape (the JAX package's quiet ``plan_blocks`` fallback to ordered has no
  counterpart: the kernels mask ragged tiles);
- **ordered**: ``x@W + ((x@A)@B)*s``, plain PyTorch in the compute dtype
  (``:347-349``);
- **merged**: ``x @ (W + s*(A@B))``, plain PyTorch (``:344-346``).

The base is a dense ``(K, N)`` ``W`` or an int8 pair ``(q, qscale)``
(``q`` ``(K, N)`` int8, ``qscale`` ``(1, N)`` f32, ``:300-349``): the fused arm
then takes :func:`~relora_tpu_torch.ops.lora_matmul.fused_lora_matmul_int8`
(the int8 kernels), and ordered and merged dequantize in plain PyTorch and use
``torch.matmul``, as the JAX arms do outside any kernel.

``arm="auto"`` raises ``NotImplementedError``: its cost model
(``choose_arm``, ``estimate_arm_times``) carries TPU v5e constants
(``:73-78``) and is ported once they are re-derived for the H100.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from relora_tpu_torch.ops.lora_matmul import (
    Scale,
    dequantize_kn,
    fused_lora_matmul,
    fused_lora_matmul_int8,
)

ARMS: Tuple[str, ...] = ("fused", "ordered", "merged")


def lora_matmul(
    x: torch.Tensor,
    base: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    a: torch.Tensor,
    b: torch.Tensor,
    scale: Scale = 1.0,
    *,
    arm: str = "auto",
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``x @ W + ((x @ A) @ B) * scale`` through ``arm``, with ``x``, the
    ``(K, N)`` base ``W`` (dequantized first for an int8 ``(q, qscale)``
    base, outside the fused arm) and the factors cast to ``dtype`` (default
    x's).  The fused arm gives a dense base no gradient; pass a detached base
    to every arm so they agree."""
    if arm not in ARMS and arm != "auto":
        raise ValueError(f"unknown arm {arm!r}; expected one of {ARMS + ('auto',)}")
    if arm == "auto":
        raise NotImplementedError(
            "lora_matmul(arm='auto'): the cost model carries TPU v5e constants and is "
            "not ported until they are re-derived for the H100 (see ROADMAP)"
        )
    dtype = dtype or x.dtype
    xd, ad, bd = (t.to(dtype) for t in (x, a, b))
    if isinstance(base, tuple):
        q, qscale = base
        if arm == "fused":
            return fused_lora_matmul_int8(xd, q, qscale, ad, bd, scale)
        w = dequantize_kn(q, qscale).to(dtype)
    else:
        w = base.to(dtype)
        if arm == "fused":
            return fused_lora_matmul(xd, w, ad, bd, scale)
    if arm == "merged":
        delta = torch.matmul(ad, bd) * scale
        return torch.matmul(xd, w + delta.to(dtype))
    z = torch.matmul(torch.matmul(xd, ad), bd)
    return torch.matmul(xd, w) + z * scale
