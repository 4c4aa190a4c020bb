"""Choose the arm that attends a query against the paged KV pool.

PyTorch counterpart of ``relora_tpu/ops/attention_dispatch.py``'s serving
entries.  Two arms serve each entry:

- **naive** — :func:`relora_tpu_torch.ops.attention.paged_cached_attention`:
  gather, then masked einsum softmax einsum.  Any S; chunked prefill's arm.
- **paged_decode** / **packed** — the hand-written CUDA kernels
  (:func:`~relora_tpu_torch.ops.attention.paged_decode_attention`,
  :func:`~relora_tpu_torch.ops.attention.packed_paged_attention`).

``arm="auto"`` applies the structural rule of the JAX dispatcher's
``choose_arm``: the fused arm where the query lies on a CUDA device and, for
``paged_decode``, ``S <= PAGED_DECODE_MAX_S``; the naive arm otherwise.  (The
JAX package ranks applicable arms by a roofline table; for every shape this
path runs, that ranking picks the fused arm whenever it applies.)  An explicit
``arm=`` bypasses the rule, which is how tests and ``chip_smoke.py`` pin the
plain arm for comparison.
"""

from __future__ import annotations

from typing import Optional

import torch

from relora_tpu_torch.ops.attention import (
    packed_paged_attention,
    paged_cached_attention,
    paged_decode_attention,
)

__all__ = ["PAGED_DECODE_MAX_S", "paged_attention", "packed_attention"]

#: largest query length the fused paged kernel serves: plain decode (S=1)
#: and every speculative verify window (K+1 for K <= 15); chunked prefill at
#: the default chunk_size=64 keeps the naive arm
PAGED_DECODE_MAX_S = 16


def paged_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    arm: str = "auto",
) -> torch.Tensor:
    """Attend ``q`` ``(B, T, N, H)`` against the page pool through
    ``block_tables`` ``(B, W)`` at ``positions`` ``(B, T)``."""
    if arm not in ("auto", "naive", "paged_decode"):
        raise ValueError(
            f"unknown/unservable arm {arm!r}; expected auto|naive|paged_decode"
        )
    if arm == "auto":
        fused = q.is_cuda and q.shape[1] <= PAGED_DECODE_MAX_S
        arm = "paged_decode" if fused else "naive"
    if arm == "paged_decode":
        return paged_decode_attention(
            q, pool_k, pool_v, block_tables, positions,
            k_scale=k_scale, v_scale=v_scale, scale=scale,
        )
    return paged_cached_attention(
        q, pool_k, pool_v, block_tables, positions,
        k_scale=k_scale, v_scale=v_scale, scale=scale,
    )


def packed_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    block_tables: torch.Tensor,
    row_map: torch.Tensor,
    positions: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    arm: str = "auto",
) -> torch.Tensor:
    """Attend a token-major packed batch ``q`` ``(1, T, N, H)``: token ``t``
    reads through ``block_tables[row_map[t]]`` at ``positions[t]``.  The
    naive arm makes each token a batch row with its own gathered table."""
    if arm not in ("auto", "naive", "packed"):
        raise ValueError(f"unknown/unservable arm {arm!r}; expected auto|naive|packed")
    B, T, N, H = q.shape
    if B != 1:
        raise ValueError(f"packed attention is token-major: expected B=1, got {B}")
    rm = row_map.reshape(T)
    pos = positions.reshape(T)
    if arm == "auto":
        arm = "packed" if q.is_cuda else "naive"
    if arm == "packed":
        return packed_paged_attention(
            q, pool_k, pool_v, block_tables, rm, pos,
            k_scale=k_scale, v_scale=v_scale, scale=scale,
        )
    token_tables = block_tables[rm.long()]
    out = paged_cached_attention(
        q.reshape(T, 1, N, H), pool_k, pool_v, token_tables, pos.reshape(T, 1),
        k_scale=k_scale, v_scale=v_scale, scale=scale,
    )
    return out.reshape(1, T, N, H)
