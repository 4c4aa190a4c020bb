"""LoRA-factored linear layer: the PyTorch counterpart of
``relora_tpu/models/lora.py::LoRALinear``.

Forward (the reference's ``ReLoRaLinear``)::

    y = x @ Wᵀ  +  ((dropout(x) @ A) @ B) * scale

``weight`` is the frozen base in the HF ``(out, in)`` layout (so a model
without LoRA keeps the serving state-dict names), ``lora_a`` ``(in, r)`` and
``lora_b`` ``(r, out)`` keep the JAX package's layouts, ``lora_s`` ``(1,)``
is the trainable scaling (``scale = tanh(lora_s)``).  Parameters are stored
in ``param_dtype`` (the base in bf16 under ``base_dtype="bf16"``); every
matmul runs in the compute ``dtype``, cast exactly where the JAX module casts.

Dropout draws its mask from a generator seeded by the caller's
``dropout_seed``: the same seed draws the same mask, so a layer recomputed
under activation checkpointing reuses its forward's masks.  No seed means
deterministic (eval), like the JAX module's ``deterministic=True``.

``LoraSpec(fused=True)`` routes the whole composite through
``ops/lora_dispatch.lora_matmul(arm="fused")`` (the fused CUDA kernels), by
the JAX module's rule (``relora_tpu/models/lora.py:117-126``): not for a
``lora_only`` layer (branch only), and not while dropout is active (a seed
and ``dropout > 0``: the branch input then differs from the base input), so
training with dropout keeps the historical path and eval takes the kernels.

``LoraSpec(quantize="int8")`` stores the frozen base as ``weight_q`` ``(out,
in)`` int8 codes and ``weight_scale`` ``(1, out)`` f32 per-output scales
(the JAX module's ``kernel_q``/``kernel_scale``, ``:165-190``), both
parameters that never train.  A fresh init is codes 0 and scales 1, W = 0:
an int8 base means something only after a warm start
(``models/warm_start.py``), which quantizes real weights into it.  Forward
(``:91-142``): the fused arm over ``(weight_q.t(), weight_scale)`` where the
dense base would take it, else the base product through
``ops/quant_matmul.dequant_matmul`` (kernel 8 for CUDA tensors) plus the LoRA
branch.  The codes and scales are never cast to the compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from relora_tpu_torch.core.relora import LoraSpec
from relora_tpu_torch.ops.quant_matmul import dequant_matmul


def dropout_mask(shape, p: float, seed: int, device) -> torch.Tensor:
    """Boolean keep-mask (True with probability ``1 - p``) drawn from a
    generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand(shape, generator=gen, device=device) < 1.0 - p


class LoRALinear(nn.Module):
    """``in_features -> out_features`` linear without bias, with LoRA factors
    when ``lora`` is given."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        lora: Optional[LoraSpec] = None,
        dtype=torch.float32,
        param_dtype=None,
    ):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.lora = lora
        self.dtype = dtype
        if lora is not None:
            if lora.quantize not in (None, "int8"):
                raise NotImplementedError(
                    f"a {lora.quantize} frozen base is not ported yet: see ROADMAP"
                )
            if lora.fused == "auto":
                raise NotImplementedError(
                    "fused='auto' (--lora_fused auto) needs the LoRA cost model, not ported yet: see ROADMAP"
                )
            if lora.num_slots:
                raise NotImplementedError("multi-tenant adapter slots are not ported yet: see ROADMAP")
        if lora is not None and lora.lora_only:
            self.register_parameter("weight", None)
        elif lora is not None and lora.quantize == "int8":
            self.register_parameter("weight", None)
            self.weight_q = nn.Parameter(
                torch.zeros(out_features, in_features, dtype=torch.int8), requires_grad=False
            )
            self.weight_scale = nn.Parameter(
                torch.ones(1, out_features, dtype=torch.float32), requires_grad=False
            )
        else:
            base_dtype = torch.bfloat16 if lora is not None and lora.base_dtype == "bf16" else param_dtype
            self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=base_dtype))
        if lora is not None:
            self.lora_a = nn.Parameter(torch.empty(in_features, lora.r, dtype=param_dtype))
            self.lora_b = nn.Parameter(torch.empty(lora.r, out_features, dtype=param_dtype))
            if lora.trainable_scaling:
                self.lora_s = nn.Parameter(torch.empty(1, dtype=param_dtype))

    def forward(self, x: torch.Tensor, dropout_seed: Optional[int] = None) -> torch.Tensor:
        spec = self.lora
        if spec is not None and spec.lora_only:
            return self._lora_branch(x, dropout_seed)
        dropout_active = spec is not None and spec.dropout > 0.0 and dropout_seed is not None
        if spec is not None and spec.fused is True and not dropout_active:
            return self._fused(x)
        if spec is not None and spec.quantize == "int8":
            y = dequant_matmul(x.to(self.dtype), self.weight_q.t(), self.weight_scale)
        else:
            y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if spec is not None:
            y = y + self._lora_branch(x, dropout_seed)
        return y

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        """The composite through the fused arm (``relora_tpu/models/lora.py:200-232``):
        every operand in the compute dtype, the frozen base detached and
        passed as the ``(in, out)`` view of its ``(out, in)`` storage; an
        int8 base as the ``(in, out)`` view of its codes and its f32 scales."""
        from relora_tpu_torch.ops.lora_dispatch import lora_matmul

        spec = self.lora
        scale = torch.tanh(self.lora_s.to(self.dtype)) if spec.trainable_scaling else spec.scale
        if spec.quantize == "int8":
            base = (self.weight_q.t(), self.weight_scale)
        else:
            base = self.weight.detach().to(self.dtype).t()
        return lora_matmul(
            x.to(self.dtype),
            base,
            self.lora_a.to(self.dtype),
            self.lora_b.to(self.dtype),
            scale,
            arm="fused",
            dtype=self.dtype,
        )

    def _lora_branch(self, x: torch.Tensor, dropout_seed: Optional[int]) -> torch.Tensor:
        """``((dropout(x) @ A) @ B) * scale`` (``relora_tpu/models/lora.py:414-423``)."""
        spec = self.lora
        h = x
        if spec.dropout > 0.0 and dropout_seed is not None:
            keep = dropout_mask(x.shape, spec.dropout, dropout_seed, x.device)
            h = torch.where(keep, x / (1.0 - spec.dropout), torch.zeros((), dtype=x.dtype, device=x.device))
        z = torch.matmul(h.to(self.dtype), self.lora_a.to(self.dtype))
        z = torch.matmul(z, self.lora_b.to(self.dtype))
        if spec.trainable_scaling:
            return z * torch.tanh(self.lora_s.to(self.dtype))
        return z * spec.scale

