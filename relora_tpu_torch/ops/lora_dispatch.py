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

:func:`lora_matmul_grouped` is the multi-tenant composite
(``:352-417``), with its own arms, :data:`GROUPED_ARMS`:

- **grouped** and **looped**:
  :func:`relora_tpu_torch.ops.lora_matmul.grouped_lora_matmul`, kernel 5 on
  CUDA (its plain twin on the CPU); the JAX package's ``looped`` also runs
  the grouped kernel (``:403-412``);
- **gathered**: ``A[idx]``, ``B[idx]`` gathered per row and contracted with
  ``bmm``, plain PyTorch in the compute dtype on any device.

``auto`` follows a structural rule, as the port's attention dispatcher does:
it is ``grouped`` (the kernel on CUDA, the twin on the CPU).  The JAX
package's grouped cost model (``choose_grouped_arm``, v5e constants) is not
ported.  An int8 base raises: the spec forbids adapter slots over a
quantized base.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from relora_tpu_torch.ops.lora_matmul import (
    Scale,
    dequantize_kn,
    fused_lora_matmul,
    fused_lora_matmul_int8,
    grouped_lora_matmul,
    grouped_shapes,
)

ARMS: Tuple[str, ...] = ("fused", "ordered", "merged")
#: arms of the multi-tenant composite, disjoint from :data:`ARMS`
GROUPED_ARMS: Tuple[str, ...] = ("grouped", "gathered", "looped")


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


def lora_matmul_grouped(
    x: torch.Tensor,
    base: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    a_stack: torch.Tensor,
    b_stack: torch.Tensor,
    scale_stack: torch.Tensor,
    adapter_idx: torch.Tensor,
    *,
    arm: str = "auto",
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``y[m] = x[m] @ W + ((x[m] @ A[idx[m]]) @ B[idx[m]]) * s[idx[m]]``
    through ``arm``, with x, the ``(K, N)`` base and the ``(S, K, r)`` /
    ``(S, r, N)`` stacks cast to ``dtype`` (default x's); ``scale_stack``
    ``(S,)`` f32, ``adapter_idx`` ``(M,)`` int32.  Inference only."""
    if arm not in GROUPED_ARMS and arm != "auto":
        raise ValueError(f"unknown grouped arm {arm!r}; expected one of {GROUPED_ARMS + ('auto',)}")
    if isinstance(base, tuple):
        raise ValueError(
            "lora_matmul_grouped needs a dense base: adapter slots over a quantized base "
            "are refused by LoraSpec (num_slots with quantize)"
        )
    dtype = dtype or x.dtype
    xd, w, ad, bd = (t.to(dtype) for t in (x, base, a_stack, b_stack))
    if arm != "gathered":
        return grouped_lora_matmul(xd, w, ad, bd, scale_stack, adapter_idx)
    M, K, N, _, _ = grouped_shapes(xd, w, ad, bd, adapter_idx)
    idx = adapter_idx.reshape(-1).long()
    x2 = xd.reshape(M, 1, K)
    z = torch.bmm(torch.bmm(x2, ad[idx]), bd[idx]).reshape(M, N)
    s = scale_stack.reshape(-1)[idx].to(dtype)
    y = torch.matmul(x2.reshape(M, K), w) + z * s[:, None]
    return y.reshape(*x.shape[:-1], N)
