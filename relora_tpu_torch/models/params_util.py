"""Parameter initialization for the PyTorch models."""

from __future__ import annotations

import torch
from torch import nn

from relora_tpu_torch.core.relora import INT8_LEAVES, kaiming_uniform


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` in place, on the parameter's device,
    from ``generator`` (which must live on that device): normal(0,
    ``initializer_range``) for linear weights and the embedding, ones for
    norm weights, kaiming-uniform ``lora_a``, zero ``lora_b`` and ones
    ``lora_s`` — the initializers of ``relora_tpu``'s Llama.  An int8
    base's codes and scales keep their construction values (0 and 1, the
    JAX module's init): a quantized base is filled by a warm start, never by
    noise.  Torch and JAX draw different bits from the same seed; weights
    cross between the two packages through
    :func:`relora_tpu_torch.models.convert.params_from_jax`.
    """
    std = model.config.initializer_range
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in INT8_LEAVES:
            continue
        if name.endswith("layernorm.weight") or name == "norm.weight" or leaf == "lora_s":
            p.fill_(1.0)
        elif leaf == "lora_b":
            p.zero_()
        elif leaf == "lora_a":
            p.copy_(kaiming_uniform(p.shape, generator, p.device))
        else:
            noise = torch.randn(
                p.shape, generator=generator, device=p.device, dtype=torch.float32
            )
            p.copy_(noise * std)
    return model
