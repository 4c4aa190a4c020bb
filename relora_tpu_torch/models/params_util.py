"""Parameter initialization for the PyTorch models."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` in place, on the parameter's device,
    from ``generator`` (which must live on that device): normal(0,
    ``initializer_range``) for linear weights and the embedding, ones for
    norm weights — the initializers of ``relora_tpu``'s Llama.  Torch and JAX
    draw different bits from the same seed; weights cross between the two
    packages through :func:`relora_tpu_torch.models.convert.params_from_jax`.
    """
    std = model.config.initializer_range
    for name, p in model.named_parameters():
        if name.endswith("layernorm.weight") or name == "norm.weight":
            p.fill_(1.0)
        else:
            noise = torch.randn(
                p.shape, generator=generator, device=p.device, dtype=torch.float32
            )
            p.copy_(noise * std)
    return model
