"""Token sampling for the decode loop.

Counterpart of ``relora_tpu/serve/sampling.py``: greedy, temperature, top-k
and top-p (nucleus), composed as top-k filter, then nucleus filter, then a
temperature-scaled categorical draw.  ``temperature`` and ``top_p`` may be
per-row; rows with ``temperature <= 0`` take the argmax.

Randomness: each sampled row draws one uniform from a CPU
``torch.Generator`` seeded from ``(seed, uid, token_index)``
(:func:`request_generator`) and inverts the filtered distribution's CDF
with it.  A request's stream therefore depends neither on its slot nor on
what else shares its batch, and a CPU and a CUDA run draw the same
uniforms.  Torch and JAX draw different bits, so across the two packages
only greedy decoding is token-identical; sampled rows agree in
distribution (:func:`filtered_probs`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

_NEG_INF = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy.  ``temperature=0`` is greedy."""

    temperature: float = 0.0
    top_k: int = 0  # 0 disables
    top_p: float = 1.0

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


def request_generator(seed: int, uid: int, token_index: int) -> torch.Generator:
    """The CPU generator of one draw, keyed by ``(seed, uid, token_index)``."""
    state = np.random.SeedSequence([seed, uid, token_index]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & 0x7FFF_FFFF_FFFF_FFFF)


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row, the float32 minimum elsewhere."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _NEG_INF, logits)


def top_p_mask(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filter: a token stays iff the probability mass strictly
    before it in descending order is < top_p (the argmax always stays).
    Descending order is the reverse of a stable ascending sort, as in the
    JAX package, so ties order the same way."""
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    sorted_logits = torch.gather(logits, -1, order)
    probs = torch.softmax(sorted_logits, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = mass_before < top_p.float()[..., None]
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(keep, logits, _NEG_INF)


def filtered_probs(
    logits: torch.Tensor, *, temperature=1.0, top_k: int = 0, top_p=1.0
) -> torch.Tensor:
    """The distribution a sampled row draws from: softmax of the top-k and
    top-p filtered logits over ``max(temperature, 1e-6)``, per row."""
    logits = logits.float()
    B = logits.shape[0]
    filtered = top_k_mask(logits, top_k)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
    filtered = top_p_mask(filtered, top_p.expand(B))
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device).expand(B)
    return torch.softmax(filtered / torch.clamp(temp, min=1e-6)[:, None], dim=-1)


def sample(
    logits: torch.Tensor,
    generators: Optional[Sequence[Optional[torch.Generator]]] = None,
    *,
    temperature=0.0,
    top_k: int = 0,
    top_p=1.0,
) -> torch.Tensor:
    """Next-token ids ``(B,)`` from logits ``(B, V)``.  ``generators`` holds
    one generator per row (None for a greedy row) and may be None when every
    row is greedy."""
    B = logits.shape[0]
    greedy = torch.argmax(logits.float(), dim=-1)
    temp = torch.as_tensor(temperature, dtype=torch.float32).expand(B)
    if not bool((temp > 0).any()):
        return greedy
    probs = filtered_probs(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    u = torch.zeros(B, dtype=torch.float32)
    for row in range(B):
        if temp[row] > 0:
            u[row] = torch.rand((), generator=generators[row])
    cdf = torch.cumsum(probs, dim=-1)
    target = u.to(probs.device)[:, None] * cdf[:, -1:]
    drawn = torch.searchsorted(cdf, target, right=True)[:, 0]
    drawn = torch.clamp(drawn, max=logits.shape[-1] - 1)
    return torch.where(temp.to(logits.device) <= 0, greedy, drawn)
