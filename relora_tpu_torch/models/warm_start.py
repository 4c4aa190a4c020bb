"""Warm start: full-rank base weights from a ``pytorch_model.bin`` into a
(LoRA) model, the full-rank -> ReLoRA transition of ``--warmed_up_model``.

The port of ``relora_tpu/train/trainer.py:642-672`` (``_load_warm_start``,
``_warm_start_counters``) on its ``pytorch_model.bin`` branch, and of
``relora_tpu/models/hf_compat.py:162-214`` (``graft_base_weights``, reached
through ``hf_to_params`` ``:79-127``), for both families.  The HF names,
less an optional ``model.`` (Llama) or ``gpt_neox.`` (GPT-NeoX / Pythia, whose
``embed_out.weight`` sits at the root) prefix, are already the port's
parameter names, and both store linear weights ``(out, in)``, so the graft
copies by name:

- every base (non-LoRA) parameter of the model takes the source tensor of
  its name, cast to its storage dtype: weights, biases and norm parameters
  alike; an int8 base (``weight_q``, ``weight_scale``) takes the f32 source
  ``weight`` quantized on the fly
  (:func:`relora_tpu_torch.ops.quant.quantize_int8`), and only a ``weight``
  is ever quantized;
- ``lora_*`` leaves are skipped on both sides: the model's keep their fresh
  init, the source's are dropped with a warning;
- a base parameter missing from the source raises ``KeyError`` and a shape
  mismatch ``ValueError``; other source keys (rotary buffers) are ignored,
  as ``hf_to_params`` reads by name.

A directory holding ``state/`` (the JAX package's own checkpoint) raises
``NotImplementedError``: checkpoints are not ported yet.  The file is read
once, onto the CPU, and each tensor moves to its parameter's device.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from relora_tpu_torch.core.relora import INT8_LEAVES, is_lora_name
from relora_tpu_torch.ops.quant import quantize_int8

logger = logging.getLogger(__name__)

STATE_SUBDIR = "state"  # the JAX package's checkpoint layout
TRAINING_STATE_FILE = "training_state.json"
WEIGHTS_FILE = "pytorch_model.bin"


#: HF's model prefixes: Llama's ``model.``, GPT-NeoX's ``gpt_neox.``
HF_PREFIXES = ("model.", "gpt_neox.")


def strip_hf_prefix(key: str) -> str:
    """``key`` less its HF model prefix, if it has one."""
    for prefix in HF_PREFIXES:
        if key.startswith(prefix):
            return key[len(prefix):]
    return key


def graft_base_weights(model: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy the base weights of an HF-named ``state_dict`` into ``model`` in
    place; returns ``model``."""
    src: Dict[str, torch.Tensor] = {strip_hf_prefix(k): v for k, v in state_dict.items()}
    dropped = [k for k in src if is_lora_name(k)]
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in params.items():
            leaf = name.rsplit(".", 1)[-1]
            if is_lora_name(name) or leaf == "weight_scale":
                continue  # weight_scale is written with its weight_q
            key = name[: -len("_q")] if leaf == "weight_q" else name
            if key not in src:
                raise KeyError(f"warm start: the source has no {key!r} for the model's {name!r}")
            value = src[key]
            if leaf in INT8_LEAVES:
                q, scale = quantize_int8(value.to(device=p.device, dtype=torch.float32))
                if q.shape != p.shape:
                    raise ValueError(f"shape mismatch for {key}: {tuple(p.shape)} vs {tuple(q.shape)}")
                p.copy_(q)
                params[f"{name[: -len('_q')]}_scale"].copy_(scale)
                continue
            if value.shape != p.shape:
                raise ValueError(f"shape mismatch for {key}: {tuple(p.shape)} vs {tuple(value.shape)}")
            p.copy_(value.to(device=p.device, dtype=p.dtype))
    if dropped:
        logger.warning(
            f"warm start: dropped {len(dropped)} unmerged lora_* leaves of the source "
            f"(e.g. {dropped[0]}); their delta is not carried over"
        )
    return model


def load_warm_start(model: nn.Module, path: str) -> nn.Module:
    """Graft ``path/pytorch_model.bin`` into ``model``."""
    if os.path.isdir(os.path.join(path, STATE_SUBDIR)):
        raise NotImplementedError(
            f"warmed_up_model {path!r} is a checkpoint (state/): checkpoints are not ported "
            "to relora_tpu_torch yet (see ROADMAP)"
        )
    bin_path = os.path.join(path, WEIGHTS_FILE)
    if not os.path.exists(bin_path):
        raise ValueError(f"warmed_up_model {path!r} has neither state/ nor {WEIGHTS_FILE}")
    state_dict = torch.load(bin_path, map_location="cpu", weights_only=True)
    graft_base_weights(model, state_dict)
    logger.info(f"Warm-started base weights from {path}")
    return model


def warm_start_counters(path: str) -> Optional[dict]:
    """The counters of ``path/training_state.json`` (``update_step``,
    ``global_step``, ``tokens_seen``), or None without the file."""
    p = os.path.join(path, TRAINING_STATE_FILE)
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    logger.warning(f"No training state found in {path}; counters start from zero")
    return None
