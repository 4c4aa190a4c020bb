"""Optimizer construction, ReLoRA optimizer-state resets and gradient clipping.

PyTorch counterpart of ``relora_tpu/core/optim.py``.  The JAX optimizer is
the optax chain ``scale_by_adam -> add_decayed_weights(wd) -> -lr``:

    p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)

which is exactly ``torch.optim.AdamW`` (decoupled decay ``p *= 1 - lr*wd``
applied to the same pre-update ``p``, bias-corrected moments), so the port
uses it, over the trainable parameters only: frozen bases carry no state.
The learning rate is set per applied update from the schedule's count of
applied updates (:func:`set_lr`); an update the NaN gate skips never calls
``step()``, so moments, Adam's ``step`` and the count all stay.

:func:`reset_optimizer_state` zeroes or prunes the Adam moments of the LoRA
factors in place (``:139-197``), in the reference's three modes, and keeps
each parameter's ``step``, as the reference does.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
from torch import nn

from relora_tpu_torch.core.relora import is_lora_name

_MOMENTS = ("exp_avg", "exp_avg_sq")


def build_optimizer(
    params: Iterable[torch.nn.Parameter],
    *,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> torch.optim.AdamW:
    """AdamW over ``params`` (the trainable ones), one parameter group; the
    rate is set per update by :func:`set_lr`."""
    return torch.optim.AdamW(
        list(params), lr=0.0, betas=(beta1, beta2), eps=eps, weight_decay=weight_decay
    )


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def _prune_magnitude(t: torch.Tensor, ratio: float) -> torch.Tensor:
    """Zero entries with ``|t| <= quantile(|t|, ratio)`` (linear
    interpolation, f32, per tensor: ``jnp.quantile``'s default)."""
    mag = t.abs().float().reshape(-1)
    ordered = mag.sort().values
    pos = ratio * (ordered.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, ordered.numel() - 1)
    frac = torch.tensor(pos - lo, dtype=torch.float32, device=t.device)
    threshold = ordered[lo] + (ordered[hi] - ordered[lo]) * frac
    return t * (mag > threshold).reshape(t.shape).to(t.dtype)


@torch.no_grad()
def reset_optimizer_state(
    optimizer: torch.optim.Optimizer,
    model: nn.Module,
    *,
    mode: str,
    ratio: float,
    generator: Optional[torch.Generator] = None,
) -> None:
    """Zero (``"zero"``) or prune (``"random"``: keep each entry with
    probability ``1 - ratio``; ``"magnitude"``: drop entries at or below the
    ``ratio`` quantile of ``|x|``) the first and second Adam moments of every
    LoRA factor of ``model``, in place.  Other parameters keep their moments,
    and every parameter keeps its ``step``."""
    if mode not in ("zero", "random", "magnitude"):
        raise ValueError(f"Unknown optimizer reset mode {mode!r}")
    if mode == "random" and generator is None:
        raise ValueError("random pruning needs a generator")
    for name, p in model.named_parameters():
        state = optimizer.state.get(p)
        if not state or not is_lora_name(name):
            continue
        for key in _MOMENTS:
            t = state[key]
            if mode == "zero":
                t.zero_()
            elif mode == "random":
                keep = torch.rand(t.shape, generator=generator, device=t.device) > ratio
                t.mul_(keep.to(t.dtype))
            else:
                t.copy_(_prune_magnitude(t, ratio))


@torch.no_grad()
def zeroed_fraction(optimizer: torch.optim.Optimizer) -> float:
    """Fraction of zeros across all Adam moments (the reference's reset log)."""
    moments = [s[key] for s in optimizer.state.values() for key in _MOMENTS if key in s]
    if not moments:
        return 0.0
    zeros = sum((t == 0).sum() for t in moments)  # one device sum, one host read
    return float(zeros) / (1e-7 + sum(t.numel() for t in moments))


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """L2 norm over a list of tensors, accumulated in f32."""
    if not tensors:
        return torch.zeros(())
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to at most ``max_norm`` (factor
    ``min(1, max_norm / (norm + 1e-6))``); returns the pre-clip norm."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm

