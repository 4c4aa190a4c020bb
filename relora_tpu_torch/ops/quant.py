"""Int8 and nf4 quantization of a frozen base weight.

The port's copy of ``relora_tpu/ops/quant.py:29-39`` (``quantize_int8``,
``dequantize_int8``) and ``:82-236`` (nf4), written in torch.  The JAX package quantizes an ``(in,
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

nf4 is the 4-bit NormalFloat of bitsandbytes' ``4bit`` base (the codebook
of 16 quantiles of N(0, 1) scaled to [-1, 1]): blockwise absmax scales along
``in``, each value the nearest code by the 15 midpoints, two codes a byte.
Under double quantization the block scales less their per-column mean are
stored as int8 over a per-column absmax / 127.  nf4 keeps the JAX package's
``(in, out)`` layout, unlike every other weight of the port: no kernel reads
it (the forward dequantizes it in plain torch, as the JAX module does in
``jnp``), and the leaves stay the same arrays in both packages, so
``params_from_jax`` copies them unchanged and tests compare codes bit for
bit.  The leaves:

- ``codes`` ``(in // 2, out)`` uint8, the low nibble the even ``in`` row;
- ``bscale_q`` ``(in // block, out)``, int8 under double quant, else the f32
  block scales;
- ``bscale_scale`` and ``bscale_offset`` ``(1, out)`` f32 (ones and zeros
  without double quant).

Every division here is by a tensor on the data's device, as for int8.  The
per-column mean of the block scales reduces in another order in torch and
in XLA, so ``bscale_q`` may differ from the JAX package's by one step.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
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


#: the bitsandbytes nf4 codebook: 16 quantiles of N(0, 1) normalized to [-1, 1]
NF4_CODEBOOK = np.asarray(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)
#: the 15 boundaries between neighbouring codes (halving is exact in f32)
NF4_MIDPOINTS = (NF4_CODEBOOK[1:] + NF4_CODEBOOK[:-1]) / np.float32(2.0)
NF4_BLOCK = 64  # bitsandbytes' 4-bit block size

#: the nf4 base's leaves: the port's parameter name -> ``quantize_nf4``'s
#: leaf name; the JAX module's parameter is ``"kernel_" + leaf``
NF4_LEAVES = {
    "weight_codes": "codes",
    "weight_bscale_q": "bscale_q",
    "weight_bscale_scale": "bscale_scale",
    "weight_bscale_offset": "bscale_offset",
}


def jax_nf4_name(param: str) -> str:
    """The JAX module's name of the port's nf4 parameter ``param``."""
    return "kernel_" + NF4_LEAVES[param]


def nf4_block_for(in_features: int, block: int = NF4_BLOCK) -> int:
    """The largest power of two <= ``block`` that divides ``in_features``;
    raises on an odd width, which cannot pack two codes a byte."""
    b = block
    while b > 1 and in_features % b:
        b //= 2
    if in_features % b or in_features % 2:
        raise ValueError(f"nf4 needs even in_features, got {in_features}")
    return b


def quantize_nf4(w: torch.Tensor, *, block: int = NF4_BLOCK, double_quant: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """``(in, out)`` float -> the nf4 leaves (module docstring), on ``w``'s
    device.  The port's ``(out, in)`` weights are quantized from their
    transpose."""
    in_f, out_f = w.shape
    block = nf4_block_for(in_f, block)
    blocks = w.float().contiguous().reshape(in_f // block, block, out_f)
    bscale = torch.clamp(blocks.abs().amax(dim=1), min=1e-12)  # (nb, out)
    normalized = blocks / bscale[:, None, :]
    mids = torch.as_tensor(NF4_MIDPOINTS, device=w.device)
    # bucketize counts the midpoints strictly below each value: the JAX
    # package's sum(x > mids)
    idx = torch.bucketize(normalized, mids).to(torch.uint8).reshape(in_f, out_f)
    codes = idx[0::2] | (idx[1::2] << 4)
    if double_quant:
        offset = bscale.mean(dim=0, keepdim=True)  # (1, out)
        resid = bscale - offset
        absmax = resid.abs().amax(dim=0, keepdim=True)
        s2 = torch.clamp(absmax / absmax.new_full((), 127.0), min=1e-12)
        bscale_q = torch.clamp(torch.round(resid / s2), -127, 127).to(torch.int8)
        return {"codes": codes, "bscale_q": bscale_q, "bscale_scale": s2, "bscale_offset": offset}
    return {
        "codes": codes,
        "bscale_q": bscale,
        "bscale_scale": torch.ones(1, out_f, device=w.device),
        "bscale_offset": torch.zeros(1, out_f, device=w.device),
    }


def dequantize_nf4(leaves: Mapping[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_nf4`: the ``(in, out)`` weight in
    ``dtype``, computed in f32."""
    codes = leaves["codes"]
    half, out_f = codes.shape
    codebook = torch.as_tensor(NF4_CODEBOOK, device=codes.device)
    idx = torch.stack([codes & 0xF, codes >> 4], dim=1).reshape(2 * half, out_f)
    vals = codebook[idx.long()]  # (in, out) in [-1, 1]
    bscale_q = leaves["bscale_q"]
    if bscale_q.dtype == torch.int8:
        bscale = bscale_q.float() * leaves["bscale_scale"] + leaves["bscale_offset"]
    else:
        bscale = bscale_q
    nb = bscale.shape[0]
    w = vals.reshape(nb, 2 * half // nb, out_f) * bscale[:, None, :]
    return w.reshape(2 * half, out_f).to(dtype)


def nf4_leaves_from_module(module) -> Dict[str, torch.Tensor]:
    """The nf4 leaves of a :class:`~relora_tpu_torch.models.lora.LoRALinear`."""
    return {leaf: getattr(module, param) for param, leaf in NF4_LEAVES.items()}


def quant_bytes_per_param(mode: str, in_f: int, out_f: int, block: int = NF4_BLOCK) -> float:
    """Stored bytes per weight element of an ``(in, out)`` base under
    ``mode`` (``int8``, ``nf4`` with double quant, ``nf4-f32scale``)."""
    n = in_f * out_f
    if mode == "int8":
        return (n + 4 * out_f) / n
    if mode == "nf4":
        return (n / 2 + (in_f // block) * out_f + 8 * out_f) / n
    if mode == "nf4-f32scale":
        return (n / 2 + 4 * (in_f // block) * out_f + 8 * out_f) / n
    raise ValueError(f"unknown mode {mode!r}")
