"""Magnitude-informed A re-initialization at ReLoRA resets.

The port's copy of ``relora_tpu/compress/resets.py`` ("The Primacy of
Magnitude in Low-Rank Adaptation", arXiv:2507.06558): the blind kaiming
re-draw at every reset ignores what the merged base already says, namely
that input rows of large weight magnitude are the rows whose updates
matter, so the fresh A puts its variance there.

The dial is ``reset_init``:

- ``"random"``: :func:`make_reinit_fn` gives None, ``merge_and_reinit``'s
  own kaiming draw, unchanged;
- ``"magnitude"``: the kaiming draw scaled per input row by the merged
  base's row RMS, normalized so the mean squared scale is 1.  B stays zero
  either way, so the delta starts at 0 and the loss is continuous across
  the reset.

An A-init is called ``a_init(shape, generator, device, merged)`` with the
lora_a shape ``(in, r)`` and the merged (under pruning, masked) f32 base in
the reference's ``(in, out)`` layout.  The draw comes from
``relora_tpu_torch.core.relora.kaiming_uniform``, looked up on the module
when called.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from relora_tpu_torch.core import relora as _relora

#: signature of a pluggable A-init: (a_shape, generator, device, merged (in, out)) -> tensor
AInitFn = Callable[..., torch.Tensor]

_EPS = 1e-8


def magnitude_a_init(shape, generator: torch.Generator, device,
                     merged: Optional[torch.Tensor]) -> torch.Tensor:
    """Weight-magnitude-aligned A: each input row of the kaiming draw times
    that row's RMS over the output axis, over the RMS of those row values
    (``resets.py:41-55``), so kaiming's overall energy lands on the rows of
    large magnitude and a row pruned away entirely gets none."""
    base = _relora.kaiming_uniform(shape, generator, device)
    if merged is None:
        return base
    row = torch.sqrt(torch.mean(torch.square(merged), dim=-1, keepdim=True))  # (in, 1)
    rms = torch.sqrt(torch.mean(torch.square(row), dim=-2, keepdim=True))
    return base * (row / torch.clamp(rms, min=_EPS))


def make_reinit_fn(reset_init: str) -> Optional[AInitFn]:
    """``reset_init`` -> the ``a_init`` argument of ``merge_and_reinit``:
    ``"random"`` -> None (the built-in kaiming path), ``"magnitude"`` ->
    :func:`magnitude_a_init`."""
    if reset_init == "random":
        return None
    if reset_init == "magnitude":
        return magnitude_a_init
    raise ValueError(f"reset_init must be 'random' or 'magnitude', got {reset_init!r}")
