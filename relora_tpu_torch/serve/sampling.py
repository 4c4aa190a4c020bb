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

:func:`spec_verify_draws` is the speculative verify sampler
(``relora_tpu/serve/sampling.py:104-216``): over a verify window's ``(B, S,
V)`` logits it gives the accept bits and the token to commit where each
row's walk stops.  Its draws keep the reference's split of streams per
``(uid, token_index)``: the acceptance uniform from ``SeedSequence([seed,
uid, token_index, 1])``, the residual or bonus draw from ``[..., 2]``, and a
row that drafted nothing draws from the plain :func:`request_generator`,
so its stream is the non-speculative one.

``InferenceEngine.generate`` keys its draws by ``(seed, step)`` instead
(:func:`step_generator`), one stream a step for the whole batch, as the
reference folds the step into one batch key.
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


#: the last entry of a verify draw's key (``relora_tpu/serve/sampling.py:104-114``):
#: 1 the acceptance uniform, 2 the residual or bonus draw.  Each ``(uid,
#: token_index, kind)`` is used at most once over a request's life: a round
#: commits an index only through the draws of that round's walk.
_SPEC_ACCEPT = 1
_SPEC_ALT = 2


def _keyed_generator(*key: int) -> torch.Generator:
    state = np.random.SeedSequence(list(key)).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & 0x7FFF_FFFF_FFFF_FFFF)


def request_generator(seed: int, uid: int, token_index: int) -> torch.Generator:
    """The CPU generator of one draw, keyed by ``(seed, uid, token_index)``."""
    return _keyed_generator(seed, uid, token_index)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step of ``InferenceEngine.generate``, keyed
    by ``(seed, step)`` and shared by the batch's rows, which draw from it in
    row order (the reference's ``fold_in(key, step)``)."""
    return _keyed_generator(seed, step)


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
    drawn = _invert_cdf(probs, u)
    return torch.where(temp.to(logits.device) <= 0, greedy, drawn)


def _invert_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``probs`` ``(n, V)`` (unnormalized is fine) from
    the uniforms ``u`` ``(n,)``: the first index whose running mass exceeds
    ``u`` times the row's total."""
    cdf = torch.cumsum(probs, dim=-1)
    target = u.to(probs.device)[:, None] * cdf[:, -1:]
    drawn = torch.searchsorted(cdf, target, right=True)[:, 0]
    return torch.clamp(drawn, max=probs.shape[-1] - 1)


def spec_verify_draws(
    logits: torch.Tensor,
    draft,
    seed: int,
    uids,
    start_index,
    k_eff,
    *,
    temperature,
    top_k: int = 0,
    top_p=1.0,
):
    """What the speculative accept walk needs, as host arrays.

    ``logits`` ``(B, S, V)`` from the verify forward (window slot ``i``
    predicts generated-token index ``start_index + i``); ``draft`` ``(B,
    S-1)`` the drafted tokens (``draft[:, i]`` judged by slot ``i``);
    ``uids``, ``start_index``, ``k_eff`` ``(B,)`` the request ids, the index
    of the first token the window can commit, and how many leading draft
    entries are real.  ``temperature`` and ``top_p`` are per row like
    :func:`sample`'s.

    Returns ``(accept, alt)``, numpy ``(B, S-1)`` bool and ``(B, S)`` int:

    - greedy rows (``temperature <= 0``) accept iff the draft equals the
      slot's argmax, and ``alt`` is the argmax everywhere;
    - sampled rows accept draft ``i < k_eff`` with probability ``p(draft)``
      under the filtered target :func:`sample` draws from, and ``alt[i]``
      is a draw from that target with the draft removed (the residual) for
      ``i < k_eff``, a plain draw at ``i == k_eff`` (the bonus).  A row with
      ``k_eff == 0`` makes its one draw with the plain generator of
      ``(seed, uid, start_index)`` through :func:`sample` itself.  Entries
      past ``k_eff`` are never read by the walk.

    The walk: ``a`` = leading accepts among the first ``k_eff``; commit
    ``draft[:a]`` then ``alt[a]``.  Greedy rows draw nothing."""
    logits = logits.float()
    B, S, V = logits.shape
    draft = np.asarray(draft, np.int64).reshape(B, S - 1)
    k_eff = np.asarray(k_eff, np.int64).reshape(B)
    uids = np.asarray(uids, np.int64).reshape(B)
    starts = np.asarray(start_index, np.int64).reshape(B)
    temp = np.broadcast_to(np.asarray(temperature, np.float32), (B,))
    top_p = np.broadcast_to(np.asarray(top_p, np.float32), (B,))
    greedy = torch.argmax(logits, dim=-1).cpu().numpy()  # (B, S)
    accept = greedy[:, :-1] == draft
    alt = greedy.copy()
    for b in np.flatnonzero((temp > 0) & (k_eff == 0)):
        gen = [request_generator(seed, int(uids[b]), int(starts[b]))]
        alt[b, 0] = int(sample(logits[b, :1], gen, temperature=float(temp[b]), top_k=top_k,
                               top_p=float(top_p[b]))[0])
    rows = np.flatnonzero((temp > 0) & (k_eff > 0))
    if rows.size == 0:
        return accept, alt
    # the filtered target of every slot of the drafting sampled rows
    n = rows.size
    sel = torch.as_tensor(rows, device=logits.device)
    probs = filtered_probs(
        logits[sel].reshape(n * S, V), temperature=np.repeat(temp[rows], S),
        top_k=top_k, top_p=np.repeat(top_p[rows], S),
    ).reshape(n, S, V)
    d = torch.as_tensor(draft[rows], device=logits.device)  # (n, S-1)
    p_draft = torch.gather(probs[:, :-1], -1, d[..., None])[..., 0].cpu()
    # keyed uniforms: acceptance for slots < k_eff, alt for slots <= k_eff
    u_acc = torch.zeros(n, S - 1)
    u_alt = torch.zeros(n, S)
    for j, b in enumerate(rows):
        uid, start, k = int(uids[b]), int(starts[b]), int(k_eff[b])
        for i in range(k + 1):
            if i < k:
                u_acc[j, i] = torch.rand((), generator=_keyed_generator(
                    seed, uid, start + i, _SPEC_ACCEPT))
            u_alt[j, i] = torch.rand((), generator=_keyed_generator(
                seed, uid, start + i, _SPEC_ALT))
    slot = np.arange(S - 1)[None, :]
    has_draft = slot < k_eff[rows][:, None]  # (n, S-1)
    accept[rows] = has_draft & (u_acc < p_draft).numpy()
    # residual: the rejected draft's mass removed (the CDF inversion
    # renormalizes); the bonus slot keeps the full target
    residual = probs.clone()
    mask = torch.zeros(n, S, V, dtype=torch.bool, device=logits.device)
    mask[:, :-1].scatter_(-1, d[..., None], torch.as_tensor(has_draft, device=logits.device)[..., None])
    residual[mask] = 0.0
    drawn = _invert_cdf(residual.reshape(n * S, V), u_alt.reshape(n * S)).reshape(n, S)
    alt[rows] = drawn.cpu().numpy()
    return accept, alt
