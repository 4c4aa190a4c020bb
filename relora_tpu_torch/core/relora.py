"""ReLoRA core: the LoRA spec, trainable/frozen split and merge-and-reinit.

PyTorch counterpart of ``relora_tpu/core/relora.py``.  A LoRA-wrapped linear
(:class:`relora_tpu_torch.models.lora.LoRALinear`) owns ``weight`` (the
frozen base, ``(out, in)``), ``lora_a`` ``(in, r)``, ``lora_b`` ``(r, out)``
and optionally ``lora_s`` ``(1,)``: the factor layouts of the JAX package, so
``params_from_jax`` copies them unchanged.  An int8 base (``LoraSpec(quantize=
"int8")``) is ``weight_q`` ``(out, in)`` int8 codes and ``weight_scale`` ``(1,
out)`` f32 scales in place of ``weight``.  Trainability is ``requires_grad``:
every parameter trains except the frozen bases and the int8 codes and scales
(with ``lora_only`` only the factors), the JAX package's
``trainable_param_mask``.

:func:`merge_and_reinit` folds ``A @ B * scale`` into each base in f32 with
TF32 off (the JAX package merges at ``Precision.HIGHEST``: merge error would
otherwise compound over every cycle), an int8 base by dequantize, add,
requantize; then re-draws A from the kaiming-uniform bound and zeroes B (and
``lora_s``), in place.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple, Union

import torch
from torch import nn

from relora_tpu_torch.ops.quant import dequantize_int8, quantize_int8

LORA_PREFIX = "lora_"
#: the int8 base's leaves, never trainable (``frozen_param_mask``, ``:149-168``)
INT8_LEAVES = ("weight_q", "weight_scale")


@dataclass(frozen=True)
class LoraSpec:
    """Static LoRA hyperparameters (``relora_tpu/core/relora.py:35``), with
    the same fields, so a ``relora_config.json`` sidecar written by either
    package loads into either.

    ``quantize="nf4"`` and ``fused="auto"`` are accepted for parity and
    raise where a module would use them: those paths are not ported yet.
    ``quantize="int8"`` stores each frozen base as int8 codes and scales;
    ``fused=True`` routes each projection through the fused LoRA kernels;
    ``num_slots > 0`` stacks the factors as multi-tenant adapter slots
    served through the grouped kernel.  ``use_double_quant`` (nf4 only) is
    carried for the sidecar; ``weights_static`` is the serving hint the
    decode model sets."""

    r: int
    alpha: float = 32.0
    dropout: float = 0.1
    trainable_scaling: bool = False
    quantize: Optional[str] = None
    base_dtype: Optional[str] = None  # None (f32 master) | "bf16"
    use_double_quant: bool = True
    lora_only: bool = False
    fused: Union[bool, str] = False
    weights_static: bool = False
    num_slots: int = 0

    def __post_init__(self):
        if self.quantize not in (None, "int8", "nf4"):
            raise ValueError(f"quantize must be None, 'int8' or 'nf4', got {self.quantize!r}")
        if self.base_dtype not in (None, "bf16"):
            raise ValueError(f"base_dtype must be None or 'bf16', got {self.base_dtype!r}")
        if self.base_dtype and self.quantize:
            raise ValueError("base_dtype applies to the unquantized base; drop it or quantize")
        if self.fused not in (True, False, "auto"):
            raise ValueError(f"fused must be True, False or 'auto', got {self.fused!r}")
        if self.num_slots < 0:
            raise ValueError(f"num_slots must be >= 0, got {self.num_slots}")
        if self.num_slots > 0 and self.trainable_scaling:
            raise ValueError(
                "num_slots > 0 is a serving-only layout; trainable_scaling has no "
                "stacked equivalent (per-slot scales come from each adapter's sidecar)"
            )
        if self.num_slots > 0 and self.quantize:
            raise ValueError(
                "num_slots > 0 requires a dense base (the grouped kernel does not "
                "read quantized bases); drop quantize for multi-tenant serving"
            )

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def kaiming_uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """torch's kaiming_uniform_(a=sqrt(5)) for an ``(in, r)`` factor,
    U(±1/sqrt(fan_in)) with ``fan_in = shape[-2]`` (``:113-122``), in f32,
    drawn from ``generator`` on ``device``."""
    bound = 1.0 / math.sqrt(shape[-2])
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.uniform_(-bound, bound, generator=generator)


def is_lora_name(name: str) -> bool:
    """True for a LoRA factor parameter (the last name component starts with
    ``lora_``, the reference's name match)."""
    return name.rsplit(".", 1)[-1].startswith(LORA_PREFIX)


def lora_modules(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """``(name, module)`` of every LoRA-wrapped linear, in module order."""
    for name, module in model.named_modules():
        if getattr(module, "lora", None) is not None and hasattr(module, "lora_a"):
            yield name, module


def set_trainable(model: nn.Module, lora_only: bool = False) -> None:
    """``requires_grad`` per the JAX package's ``trainable_param_mask``:
    False for the base weight of every LoRA-wrapped linear and for every
    int8 code and scale, True elsewhere; with ``lora_only`` only the LoRA
    factors train."""
    frozen = {
        f"{name}.weight" if name else "weight"
        for name, module in lora_modules(model)
        if getattr(module, "weight", None) is not None
    }
    for name, p in model.named_parameters():
        if lora_only:
            trainable = is_lora_name(name)
        else:
            trainable = name not in frozen and name.rsplit(".", 1)[-1] not in INT8_LEAVES
        p.requires_grad_(trainable)


def split_param_counts(model: nn.Module) -> Dict[str, int]:
    """Parameter accounting for logging (``:184-202``)."""
    total = trainable = lora = 0
    for name, p in model.named_parameters():
        total += p.numel()
        if is_lora_name(name):
            lora += p.numel()
        if p.requires_grad:
            trainable += p.numel()
    return {
        "total_params": total,
        "trainable_params": trainable,
        "lora_params": lora,
        "equivalent_params": total - lora,
    }


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matmuls in full f32: TF32 off on CUDA for the block's duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def effective_scale(module: nn.Module, spec: LoraSpec):
    """``tanh(lora_s)`` under trainable scaling, else ``alpha / r``."""
    if spec.trainable_scaling and getattr(module, "lora_s", None) is not None:
        return torch.tanh(module.lora_s.detach().float())
    return spec.scale


@torch.no_grad()
def lora_delta(module: nn.Module, spec: LoraSpec) -> torch.Tensor:
    """``(lora_a @ lora_b * scale)ᵀ``, shaped like the ``(out, in)`` base:
    the full-rank update the factors represent, in full f32 (``:215-229``)."""
    with full_f32_matmul():
        delta = torch.matmul(module.lora_a.float(), module.lora_b.float())
    return (delta * effective_scale(module, spec)).t()


@torch.no_grad()
def merge_and_reinit(
    model: nn.Module,
    generator: torch.Generator,
    spec: LoraSpec,
    *,
    a_init=None,
) -> nn.Module:
    """ReLoRA reset in place (``relora_tpu/core/relora.py:232-324``): for every
    LoRA-wrapped linear, ``W += (A @ B * scale)ᵀ`` computed in f32 and cast
    back to W's storage dtype (f32 master or ``base_dtype="bf16"``), or, for
    an int8 base, dequantized, added to and requantized in f32 (``:287-294``);
    then A re-drawn kaiming-uniform from ``generator``, B zeroed, and
    ``lora_s`` zeroed under trainable scaling.  ``lora_only`` modules (no
    base) are skipped, as in the reference."""
    if a_init is not None:
        raise NotImplementedError(
            "merge_and_reinit(a_init=...) (reset_init='magnitude') is not ported yet: see ROADMAP"
        )
    if spec.quantize == "nf4":
        raise NotImplementedError("merging an nf4 base is not ported yet: see ROADMAP")
    for _, module in lora_modules(model):
        if getattr(module, "weight_q", None) is not None:
            merged = dequantize_int8(module.weight_q, module.weight_scale) + lora_delta(module, spec)
            q, scale = quantize_int8(merged)
            module.weight_q.copy_(q)
            module.weight_scale.copy_(scale)
        elif getattr(module, "weight", None) is None:
            continue  # lora_only: nothing to merge into
        else:
            merged = module.weight.float() + lora_delta(module, spec)
            module.weight.copy_(merged.to(module.weight.dtype))
        fresh = kaiming_uniform(module.lora_a.shape, generator, module.lora_a.device)
        module.lora_a.copy_(fresh.to(module.lora_a.dtype))
        module.lora_b.zero_()
        if spec.trainable_scaling and getattr(module, "lora_s", None) is not None:
            module.lora_s.zero_()
    return model


@torch.no_grad()
def merged_params(params: Dict[str, torch.Tensor], spec: LoraSpec) -> Dict[str, torch.Tensor]:
    """Merge without reinit (``relora_tpu/core/relora.py:335-375``) over a
    flat state dict: every module with ``lora_a`` and ``lora_b`` gets
    ``weight + (A @ B * scale)ᵀ`` in f32 with TF32 off, cast back to the
    weight's dtype; an int8 base (``weight_q``, ``weight_scale``) becomes a
    dequantized f32 ``weight`` plus the delta.  LoRA leaves are dropped, so
    the result loads into a model without LoRA.  A state dict without
    factors (an already merged export that kept its sidecar) passes
    through."""
    out = {k: v for k, v in params.items() if not is_lora_name(k)}
    for key in params:
        if not key.endswith(".lora_a"):
            continue
        prefix = key[: -len("lora_a")]
        if prefix + "lora_b" not in params:
            continue
        a, b = params[key].float(), params[prefix + "lora_b"].float()
        with full_f32_matmul():
            delta = torch.matmul(a, b)
        if spec.trainable_scaling and prefix + "lora_s" in params:
            delta = delta * torch.tanh(params[prefix + "lora_s"].float())
        else:
            delta = delta * spec.scale
        if prefix + "weight_q" in params:
            out.pop(prefix + "weight_q")
            scale = out.pop(prefix + "weight_scale")
            out[prefix + "weight"] = dequantize_int8(params[prefix + "weight_q"], scale) + delta.t()
        else:
            weight = params[prefix + "weight"]
            out[prefix + "weight"] = (weight.float() + delta.t()).to(weight.dtype)
    return out
