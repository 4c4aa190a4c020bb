"""Int8 symmetric quantization of a frozen base weight.

The port's copy of ``relora_tpu/ops/quant.py:29-39`` (``quantize_int8``,
``dequantize_int8``), written in torch.  The JAX package quantizes an ``(in,
out)`` kernel per output channel; the port stores weights ``(out, in)``, so
the absmax reduces over the last (``in``) axis.  The scales keep the JAX
package's ``(1, out)`` layout, so they are the same array in both packages
and broadcast along the logical ``(in, out)`` view ``q.t()`` that the
kernels read.

- scale = max(absmax / 127, 1e-12) per output channel, f32;
- codes = clip(round(w / scale), -127, 127) as int8, ``torch.round`` being
  round-half-to-even like ``jnp.round``.

Both divisions are true divisions by a tensor on the data's device: on CUDA,
``t / 127.0`` (a Python number is a CPU scalar) multiplies by the rounded
reciprocal, which moves a scale by an ulp and flips codes at .5 ties.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, in)`` float -> (int8 codes ``(out, in)``, f32 scales ``(1, out)``)."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-1, keepdim=True)  # (out, 1)
    scale = torch.clamp(absmax / absmax.new_full((), 127.0), min=1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.transpose(-1, -2).contiguous()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: codes ``(out, in)`` x scales ``(1,
    out)`` -> ``(out, in)`` weight in ``dtype``, computed in f32."""
    return (q.float() * scale.float().transpose(-1, -2)).to(dtype)
