"""Parameter initialization for the PyTorch models."""

from __future__ import annotations

import torch
from torch import nn

from relora_tpu_torch.core.relora import INT8_LEAVES, kaiming_uniform
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
    kaiming-uniform ``lora_a``, zero ``lora_b`` and ones ``lora_s``.  An
    int8 base's codes and scales keep their construction values (0 and 1,
    the JAX module's init): a quantized base is filled by a warm start,
    never by noise.  A slotted layout's stacked factors
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
        if leaf in INT8_LEAVES:
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
