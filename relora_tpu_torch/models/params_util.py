"""Parameter initialization and the activation-checkpointing policies of
the PyTorch models."""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from relora_tpu_torch.core.relora import QUANT_LEAVES, kaiming_uniform
from relora_tpu_torch.models.llama import RMSNorm
from relora_tpu_torch.models.lora import LoRALinear
from relora_tpu_torch.models.pythia import LayerNorm


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` in place, on the parameter's device,
    from ``generator`` (which must live on that device), with the
    initializers of ``relora_tpu``'s models: normal(0, ``initializer_range``)
    for linear weights and the embeddings, ones for norm weights (RMSNorm,
    LayerNorm), zeros for every bias (LayerNorm's and the linear ones),
    kaiming-uniform ``lora_a``, zero ``lora_b`` and ones ``lora_s``.  A
    quantized base keeps its construction values (int8 codes 0 and scales
    1, nf4 codes ``0x77``: W = 0, the JAX module's init): a quantized base is
    filled by a warm start, never by noise.  A slotted layout's stacked factors
    (``LoraSpec(num_slots)``) are zero and its scales ``alpha / r``, every
    slot the identity, as in the JAX module.  Torch and JAX draw different
    bits from the same seed; weights cross between the two packages through
    :func:`relora_tpu_torch.models.convert.params_from_jax`.
    """
    std = model.config.initializer_range
    # stacked factor -> its fill: 0 for lora_a / lora_b, alpha / r for lora_s
    slotted = {
        f"{name}.{leaf}": module.lora.scale if leaf == "lora_s" else 0.0
        for name, module in model.named_modules()
        if isinstance(module, LoRALinear) and module.lora is not None and module.lora.num_slots
        for leaf in ("lora_a", "lora_b", "lora_s")
    }
    norm_weights = {
        f"{name}.weight" for name, module in model.named_modules()
        if isinstance(module, (RMSNorm, LayerNorm))
    }
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in QUANT_LEAVES:
            continue
        if name in slotted:
            p.fill_(slotted[name])
            continue
        if name in norm_weights or leaf == "lora_s":
            p.fill_(1.0)
        elif leaf in ("lora_b", "bias"):
            p.zero_()
        elif leaf == "lora_a":
            p.copy_(kaiming_uniform(p.shape, generator, p.device))
        else:
            noise = torch.randn(
                p.shape, generator=generator, device=p.device, dtype=torch.float32
            )
            p.copy_(noise * std)
    return model


REMAT_POLICIES = ("full", "dots", "dots_narrow", "dots_all")
_aten = torch.ops.aten
#: matmuls without batch dimensions -> the position of their ``(K, N)`` operand
_DOTS = {_aten.mm.default: 1, _aten.addmm.default: 2}
#: batched matmuls (attention's products on the plain arm)
_BATCHED_DOTS = (_aten.bmm.default, _aten.baddbmm.default)


def remat_context_fn(name: str, max_save_width: int = 0) -> Callable:
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` that
    saves what the JAX package's ``remat_policy(name)`` saves
    (``relora_tpu/models/params_util.py:20-70``), as selective activation
    checkpointing over the aten ops a decoder layer runs:

    - ``"full"``: save nothing and recompute the whole layer (the plain
      checkpoint's ``noop_context_fn``);
    - ``"dots"``: save the output of every matmul without batch dimensions
      (``mm``, ``addmm``: the projections, the LoRA ``x @ A`` and ``z @ B``,
      which a 3-D ``F.linear`` or ``matmul`` becomes), recompute batched
      matmuls (``bmm``) and everything else;
    - ``"dots_narrow"``: as ``"dots"``, but recompute a matmul whose output
      is wider than ``max_save_width`` (the hidden size: gate/up, the fused
      QKV, ``dense_h_to_4h``);
    - ``"dots_all"``: save every matmul output, batched ones too.

    A hand-written kernel is not a matmul here, as a ``pallas_call`` is not
    a ``dot_general`` for JAX: the flash kernels (and the fused LoRA ones)
    are recomputed under every policy."""
    if name not in REMAT_POLICIES:
        raise ValueError(f"Unknown remat policy {name!r} (use one of {REMAT_POLICIES})")
    if name == "full":
        return noop_context_fn
    if name == "dots_narrow" and max_save_width <= 0:
        raise ValueError("dots_narrow needs max_save_width (the hidden size)")

    def policy(ctx, op, *args, **kwargs):
        if op in _DOTS:
            save = name != "dots_narrow" or args[_DOTS[op]].shape[-1] <= max_save_width
        else:
            save = name == "dots_all" and op in _BATCHED_DOTS
        return CheckpointPolicy.MUST_SAVE if save else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)
