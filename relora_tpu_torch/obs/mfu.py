"""Peak FLOPs of the card and the matrix FLOPs of one training update.

The port's counterpart of ``relora_tpu/obs/mfu.py``.  The trainer's live
MFU gauge is ``step_flops / update seconds / peak_flops``.

- :func:`peak_flops` looks the CUDA device's name up in
  :data:`PEAK_FLOPS_BY_KIND` (dense bf16 tensor-core rates, most specific
  name first); ``RELORA_TPU_PEAK_FLOPS`` overrides the table.  Where the
  JAX package falls back to one TPU v5e's 197e12 for a device it does not
  know (the CPU included), this copy returns ``None`` and the MFU fields are
  ``null``: a TPU's rate says nothing about the device that ran.
- :func:`step_flops` replaces ``step_flops_from_cost_analysis``: PyTorch has
  no XLA cost model, so the count is analytic, from the model config and
  the update's shapes.  It counts matrix products only (each ``M x K x N``
  product is ``2 M K N`` flops), the way ``torch.utils.flop_counter``
  counts; norms, activations, the softmax, the loss and AdamW are left out.

What one update of ``grad_accum`` microbatches of ``(B, S)`` tokens does:

- every LoRA projection ``(K, N)``: the frozen base forward and its dx
  (no dW: the base is frozen), the base absent under ``lora_only``; the
  factors ``x A`` and ``(x A) B`` forward, and backward ``g Bᵀ``, ``dB``,
  ``dA`` and ``(g Bᵀ) Aᵀ``, whichever arm (unfused, fused, ordered) or
  base (dense, int8 codes) computes them.  Without LoRA every projection
  trains: forward, dx and dW;
- the LM head ``(hidden, vocab)``: forward, dx and dW (it trains);
- the embeddings train too, but their forward is a gather and their
  gradient a scatter-add: no matrix product, nothing counted;
- attention, per query head, counted as the arm does the work.  The flash
  kernels (the CUDA path) visit only key tiles at or below the diagonal and
  mask inside the diagonal tiles: counted over the ``S (S + 1) / 2`` visible
  (query, key) pairs, ``2 H`` flops a pair and product, two products
  forward (``Q Kᵀ``, ``P V``), four in the dK/dV kernel (``K Qᵀ`` and
  ``V dOᵀ`` recomputed, ``Pᵀ dO``, ``dSᵀ Q``) and three in the dQ kernel
  (``Q Kᵀ``, ``dO Vᵀ``, ``dS K``).  The naive arm (the CPU path) forms all
  ``S²`` pairs: two products forward, four backward (autograd's two grads
  of each);
- ``remat`` recomputes each decoder layer's forward in the backward pass:
  the layers' forward products once more (not the LM head's).  The
  non-reentrant checkpoint stops recomputing after the last tensor the
  backward saved, which can spare a layer's last product: the count is
  high by at most that (0.3% at the tests' tiny widths).

The count is always available, so the JAX trainer's ``RELORA_TPU_LIVE_MFU=0``
fallback to ``6 N D`` (for when XLA offers no cost model) has no
counterpart.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

from relora_tpu_torch.ops.lora_dispatch import H100_PEAK_FLOPS

__all__ = ["PEAK_FLOPS_BY_KIND", "peak_flops", "step_flops"]

#: dense bf16 tensor-core FLOPs/s, keyed by a lowercase substring of
#: ``torch.cuda.get_device_name``; first match wins, so the PCIe and NVL
#: H100s come before the SXM part ("NVIDIA H100 80GB HBM3")
PEAK_FLOPS_BY_KIND: Tuple[Tuple[str, float], ...] = (
    ("h100 pcie", 756e12),
    ("h100 nvl", 835e12),
    ("h100", H100_PEAK_FLOPS),
    ("h200", H100_PEAK_FLOPS),  # the H100's tensor cores, more memory
    ("a100", 312e12),
)


def peak_flops(device: Any = None) -> Optional[float]:
    """Peak dense bf16 FLOPs/s of ``device`` (default: CUDA device 0), or
    ``None`` for the CPU and for a device the table does not know.
    ``RELORA_TPU_PEAK_FLOPS`` overrides everything."""
    env = os.environ.get("RELORA_TPU_PEAK_FLOPS")
    if env:
        return float(env)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for needle, flops in PEAK_FLOPS_BY_KIND:
        if needle in kind:
            return flops
    return None


def _projection_shapes(model_cfg) -> List[Tuple[int, int]]:
    """``(in, out)`` of one decoder layer's projections: Llama's q, k, v, o,
    gate, up, down; GPT-NeoX's query_key_value, dense, h_to_4h, 4h_to_h."""
    h, i = model_cfg.hidden_size, model_cfg.intermediate_size
    if model_cfg.family == "neox":
        return [(h, 3 * h), (h, h), (h, i), (i, h)]
    q = model_cfg.num_attention_heads * model_cfg.head_dim
    kv = model_cfg.kv_heads * model_cfg.head_dim
    return [(h, q), (h, kv), (h, kv), (q, h), (h, i), (h, i), (i, h)]


def step_flops(
    model_cfg,
    *,
    microbatch: int,
    seq: int,
    grad_accum: int = 1,
    lora_r: Optional[int] = None,
    lora_only: bool = False,
    remat: bool = False,
    attention: str = "flash",
) -> float:
    """Matrix FLOPs of one update (module docstring): ``grad_accum``
    microbatches of ``(microbatch, seq)`` tokens through ``model_cfg``,
    LoRA of rank ``lora_r`` on every projection (``None``: full-rank
    training), attention ``"flash"`` or ``"naive"``."""
    if attention not in ("flash", "naive"):
        raise ValueError(f"attention must be 'flash' or 'naive', got {attention!r}")
    T = microbatch * seq
    layer_fwd = layer_bwd = 0
    for K, N in _projection_shapes(model_cfg):
        base = 0 if lora_only and lora_r else 2 * T * K * N
        if lora_r:
            factors = 2 * T * lora_r * (K + N)
            layer_fwd += base + factors
            layer_bwd += base + 2 * factors
        else:
            layer_fwd += base
            layer_bwd += 2 * base
    heads, H = model_cfg.num_attention_heads, model_cfg.head_dim
    if attention == "flash":
        pairs, fwd_products, bwd_products = seq * (seq + 1) // 2, 2, 7
    else:
        pairs, fwd_products, bwd_products = seq * seq, 2, 4
    per_product = 2 * microbatch * heads * pairs * H
    layer_fwd += fwd_products * per_product
    layer_bwd += bwd_products * per_product
    layers = model_cfg.num_hidden_layers
    head = 2 * T * model_cfg.hidden_size * model_cfg.vocab_size
    micro = layers * (layer_fwd * (2 if remat else 1) + layer_bwd) + 3 * head
    return float(grad_accum * micro)
