"""Loss functions: the port of ``relora_tpu/train/losses.py``, the dense
causal LM loss and the streamed-vocab cross-entropy of ``loss_impl="chunked"``."""

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


def chunk_logits(hidden: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """One vocab chunk's logits ``(T, C)`` in f32: a matmul in ``hidden``'s
    dtype with the head rows ``(C, E)`` cast to it, as the dense head's
    product, read in f32."""
    return torch.matmul(hidden, rows.to(hidden.dtype).t()).float()


class _ChunkedCE(torch.autograd.Function):
    """The summed NLL of ``(T, E)`` hidden states against the ``(V, E)``
    head, one ``chunk``-row slice of the head at a time.  The forward keeps a
    running max and sum of exponentials and the target's logit; the backward
    recomputes each chunk's logits (the JAX package's ``jax.checkpoint`` on
    the scan body), so either pass holds one chunk's ``(T, chunk)`` logits
    at a time."""

    @staticmethod
    def forward(ctx, h, head, tgt, valid, chunk):
        T, V = h.shape[0], head.shape[0]
        m = torch.full((T,), float("-inf"), device=h.device)
        acc = torch.zeros(T, device=h.device)
        t_logit = torch.zeros(T, device=h.device)
        for start in range(0, V, chunk):
            logits = chunk_logits(h, head[start:start + chunk])
            m_new = torch.maximum(m, logits.amax(dim=-1))
            acc = acc * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            local = tgt - start
            in_chunk = (local >= 0) & (local < logits.shape[1])
            gathered = logits.gather(1, local.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
            t_logit = torch.where(in_chunk, gathered, t_logit)
        lse = torch.log(acc) + m
        ctx.save_for_backward(h, head, tgt, valid, lse)
        ctx.chunk = chunk
        return ((lse - t_logit) * valid).sum()

    @staticmethod
    def backward(ctx, grad):
        h, head, tgt, valid, lse = ctx.saved_tensors
        chunk = ctx.chunk
        scale = (grad * valid)[:, None]  # d(sum) / d(nll) per row
        dh = torch.zeros(h.shape, device=h.device)
        dhead = torch.empty(head.shape, device=head.device, dtype=head.dtype)
        for start in range(0, head.shape[0], chunk):
            rows = head[start:start + chunk]
            logits = chunk_logits(h, rows)
            dlogits = torch.exp(logits - lse[:, None])
            local = tgt - start
            in_chunk = (local >= 0) & (local < rows.shape[0])
            hit = torch.where(in_chunk, local, 0)[:, None]
            dlogits.scatter_add_(1, hit, -in_chunk.float()[:, None])
            dlogits = (dlogits * scale).to(h.dtype)
            dh += torch.matmul(dlogits, rows.to(h.dtype)).float()
            dhead[start:start + chunk] = torch.matmul(dlogits.t(), h).to(head.dtype)
        return dh.to(h.dtype), dhead, None, None, None


def chunked_softmax_ce(
    hidden: torch.Tensor,
    head_weight: torch.Tensor,
    targets: torch.Tensor,
    chunk_size: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy of ``hidden`` ``(B, S, E)`` through the head
    ``head_weight`` ``(V, E)`` (the port's ``(out, in)`` layout: a chunk is
    a slice of rows) against ``targets`` ``(B, S)``, ``-100`` ignored,
    without the ``(B, S, V)`` logits (``relora_tpu/train/losses.py:56-110``).
    Each chunk's logits are a matmul in ``hidden``'s dtype read in f32;
    the last chunk ends at ``V``, so it holds no padded lanes (the JAX
    package pads the head to whole chunks and sets those lanes to -inf,
    which adds nothing to the sum either).  Peak memory is O(B·S·chunk)
    in both passes.  Returns ``(mean loss, n_tokens)``."""
    B, S, E = hidden.shape
    flat = targets.reshape(B * S)
    valid = (flat >= 0).float()
    n = torch.clamp(valid.sum(), min=1.0)
    total = _ChunkedCE.apply(hidden.reshape(B * S, E), head_weight, flat.clamp(min=0).long(),
                             valid, chunk_size)
    return total / n, n


def shifted_targets(input_ids: torch.Tensor) -> torch.Tensor:
    """Next-token targets ``(B, S)``: position ``i`` predicts ``i + 1``, the
    last position ``-100`` (ignored)."""
    return torch.cat([input_ids[:, 1:], torch.full_like(input_ids[:, :1], -100)], dim=1).long()
