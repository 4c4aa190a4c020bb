"""Loss functions: a copy of ``relora_tpu/train/losses.py``'s dense causal LM
loss.  ``chunked_softmax_ce`` (``loss_impl="chunked"``) is not ported yet."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def causal_lm_loss(
    logits: torch.Tensor,
    input_ids: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shifted next-token cross-entropy in f32: position ``i`` predicts token
    ``i + 1``.  Returns ``(mean_loss, n_tokens)``; ``mask`` ``(B, S)``
    weights the targets."""
    vocab = logits.shape[-1]
    shift_logits = logits[:, :-1, :].float().reshape(-1, vocab)
    shift_labels = input_ids[:, 1:].reshape(-1).long()
    token_nll = F.cross_entropy(shift_logits, shift_labels, reduction="none")
    if mask is not None:
        shift_mask = mask[:, 1:].reshape(-1).float()
        n = torch.clamp(shift_mask.sum(), min=1.0)
        return (token_nll * shift_mask).sum() / n, n
    # filled on the device: a tensor built from a host value would be a
    # blocking copy, a wait on the device in every microbatch
    n = torch.full((), float(token_nll.numel()), device=logits.device)
    return token_nll.mean(), n
