"""The train and eval steps: gradient accumulation, clipping and the NaN gate.

PyTorch counterpart of ``relora_tpu/train/step.py:108-293``.  One update
takes a ``(grad_accum, microbatch, seq)`` batch: each microbatch's mean loss
is back-propagated (gradients sum over microbatches in ``.grad``), the sum is
divided by ``grad_accum``, clipped to ``clip_grad_norm`` over the trainable
parameters, and applied with AdamW at the schedule's rate.  The NaN gate:
when any microbatch loss is NaN or the gradient norm is not finite, the
update is skipped whole, so parameters, Adam moments, Adam's ``step`` and the
schedule's count of applied updates all stay as they were
(``relora_tpu/train/step.py:182-212``); the update step still advances.  The
gate reads one host value per update: the one place the step waits on the
device (with ``lora_scaling``'s read under trainable scaling), timed into
``TrainState.device_wait_s`` for the trainer's ``mfu_gap`` waterfall.  The
JAX step gates on the device (``jnp.where``) and never waits.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from relora_tpu_torch.core.optim import clip_by_global_norm, global_norm, set_lr
from relora_tpu_torch.train.losses import causal_lm_loss


@dataclass
class TrainState:
    """Counters of the update loop: ``step`` counts updates taken (skipped
    ones too), ``n_skipped`` those the NaN gate skipped, so the schedule's
    count of applied updates is ``step - n_skipped``."""

    step: int = 0
    n_skipped: int = 0


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    *,
    clip_grad_norm: float = 1.0,
    schedule: Optional[Callable[[int], float]] = None,
    loss_impl: str = "dense",
    log_per_layer_scaling: bool = False,
) -> Callable[[TrainState, torch.Tensor, Optional[Sequence[int]]], Dict[str, float]]:
    """Build ``train_step(state, batch, dropout_seeds) -> metrics``.

    ``batch``: token ids ``(grad_accum, microbatch, seq)`` on the model's
    device; ``dropout_seeds``: one LoRA dropout seed per microbatch, or None
    for no dropout.  Updates ``model``, ``optimizer`` and ``state`` in place
    and returns host floats: ``loss``, ``grad_norm``, ``skipped``,
    ``n_skipped``, ``lr`` (the rate of this update: the schedule at the count
    of previously applied updates), and ``lora_scaling`` under trainable
    scaling."""
    if loss_impl != "dense":
        raise NotImplementedError(
            f"loss_impl={loss_impl!r} (streamed vocab CE) is not ported yet: see ROADMAP"
        )
    params = [p for p in model.parameters() if p.requires_grad]
    scales = [(n, p) for n, p in model.named_parameters() if n.endswith("lora_s")]

    def train_step(state: TrainState, batch: torch.Tensor, dropout_seeds=None) -> Dict[str, float]:
        ga = batch.shape[0]
        for p in params:
            p.grad = None
        loss_sum = torch.zeros((), device=batch.device)
        nan_count = torch.zeros((), device=batch.device)
        for i in range(ga):
            seed = None if dropout_seeds is None else dropout_seeds[i]
            loss, _ = causal_lm_loss(model(batch[i], dropout_seed=seed), batch[i])
            loss.backward()
            loss_sum += loss.detach()
            nan_count += torch.isnan(loss.detach())
        for p in params:
            if p.grad is None:  # untouched by the loss: a zero gradient, as in JAX
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        for g in grads:
            g.div_(ga)
        if clip_grad_norm > 0:
            grad_norm = clip_by_global_norm(grads, clip_grad_norm)
        else:
            grad_norm = global_norm(grads)
        t0 = time.perf_counter()
        loss_mean, norm, nans = torch.stack(
            [loss_sum / ga, grad_norm.to(loss_sum.device), nan_count]
        ).tolist()
        state.device_wait_s = time.perf_counter() - t0
        skip = nans > 0 or not math.isfinite(norm)
        lr = schedule(state.step - state.n_skipped) if schedule is not None else None
        if not skip:
            if lr is not None:
                set_lr(optimizer, lr)
            optimizer.step()
        for p in params:
            p.grad = None
        state.step += 1
        state.n_skipped += int(skip)
        metrics = {
            "loss": loss_mean,
            "grad_norm": norm,
            "skipped": float(skip),
            "n_skipped": state.n_skipped,
        }
        if lr is not None:
            metrics["lr"] = lr
        if scales:
            # mean of the effective scales, tanh(lora_s), as the forward uses them
            with torch.no_grad():
                effective = [torch.tanh(p.float()).mean() for _, p in scales]
                t0 = time.perf_counter()
                metrics["lora_scaling"] = torch.stack(effective).mean().item()
                state.device_wait_s += time.perf_counter() - t0
                if log_per_layer_scaling:
                    for (name, _), eff in zip(scales, torch.stack(effective).tolist()):
                        metrics[f"lora_scaling/{name[: -len('.lora_s')]}"] = eff
        return metrics

    return train_step


@torch.no_grad()
def eval_step(model: nn.Module, tokens: torch.Tensor):
    """``(loss_sum, n_tokens)`` on the device for one ``(micro, seq)`` batch,
    deterministic (no dropout)."""
    loss, n = causal_lm_loss(model(tokens), tokens)
    return loss * n, n
