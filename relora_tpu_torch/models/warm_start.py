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
  (:func:`relora_tpu_torch.ops.quant.quantize_int8`), an nf4 base (its four
  leaves) the transpose of that ``weight`` quantized by
  :func:`~relora_tpu_torch.ops.quant.quantize_nf4` in the target's
  double-quant layout (``relora_tpu/models/hf_compat.py:202-215``), and
  only a ``weight`` is ever quantized;
- ``lora_*`` leaves are skipped on both sides: the model's keep their fresh
  init, the source's are dropped with a warning;
- a base parameter missing from the source raises ``KeyError`` and a shape
  mismatch ``ValueError``; other source keys (rotary buffers) are ignored,
  as ``hf_to_params`` reads by name.

A port checkpoint directory (``params.pt``, ``train/checkpoint.py``) warm
starts by the same graft, verified against its manifest first, as the JAX
trainer warm-starts from a checkpoint's ``state/`` (``:642-663``): its names
are the model's, and an int8 or nf4 source's leaves go to a target of the
same kind as they are.  A directory holding ``state/`` (the JAX package's own
checkpoint) raises ``NotImplementedError``: the port reads only its own
format.  The file is read once, onto the CPU, and each tensor moves to its
parameter's device.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from relora_tpu_torch.core.relora import INT8_LEAVES, QUANT_LEAVES, is_lora_name
from relora_tpu_torch.ops.quant import NF4_LEAVES, quantize_int8, quantize_nf4
from relora_tpu_torch.train import checkpoint as ckpt

logger = logging.getLogger(__name__)

STATE_SUBDIR = "state"  # the JAX package's checkpoint layout
TRAINING_STATE_FILE = "training_state.json"
WEIGHTS_FILE = "pytorch_model.bin"
#: a quantized base's first leaf -> all its leaves, written together
QUANT_HEADS = {"weight_q": INT8_LEAVES, "weight_codes": tuple(NF4_LEAVES)}


#: HF's model prefix of each family, read both ways: stripped by the warm
#: start, added by :func:`params_to_hf`; each family's head sits at the root
HF_PREFIX = {"llama": "model.", "neox": "gpt_neox."}
HF_HEADS = {"llama": "lm_head.weight", "neox": "embed_out.weight"}
HF_PREFIXES = tuple(HF_PREFIX.values())


def strip_hf_prefix(key: str) -> str:
    """``key`` less its HF model prefix, if it has one."""
    for prefix in HF_PREFIXES:
        if key.startswith(prefix):
            return key[len(prefix):]
    return key


def params_to_hf(params: Mapping[str, torch.Tensor], config) -> Dict[str, torch.Tensor]:
    """The HF state dict of a merged (LoRA-free, dense) port state dict,
    for either family (``relora_tpu/models/hf_compat.py:130-159``): the
    reference's keys, each the port's name with the family's HF prefix, the
    head at the root; weights stay ``(out, in)``, HF's layout too."""
    from relora_tpu_torch.models.convert import _LAYER_MAPS, _TOP

    family = "llama" if config.family == "llama" else "neox"
    names = list(_TOP[family].values()) + [
        f"layers.{i}.{name}" for i in range(config.num_hidden_layers)
        for name in _LAYER_MAPS[family].values()
    ]
    missing = [n for n in names if n not in params]
    if missing:
        raise KeyError(f"params_to_hf: the state dict has no {missing[:3]} (merge the LoRA "
                       "factors and dequantize first: core.relora.merged_params)")
    return {(n if n == HF_HEADS[family] else HF_PREFIX[family] + n): params[n] for n in names}


def _quantized_leaves(module: str, head: str, value: torch.Tensor, params) -> Dict[str, torch.Tensor]:
    """The quantized leaves of ``module`` (an int8 base when ``head`` is
    ``weight_q``, else nf4) from the f32 ``(out, in)`` source ``value``; nf4
    quantizes the transpose in the layout of the target's ``bscale_q``."""
    if head == "weight_q":
        q, scale = quantize_int8(value)
        return {f"{module}weight_q": q, f"{module}weight_scale": scale}
    double_quant = params[f"{module}weight_bscale_q"].dtype == torch.int8
    leaves = quantize_nf4(value.t(), double_quant=double_quant)
    return {f"{module}{param}": leaves[leaf] for param, leaf in NF4_LEAVES.items()}


def graft_base_weights(model: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy the base weights of an HF-named ``state_dict`` into ``model`` in
    place; returns ``model``."""
    src: Dict[str, torch.Tensor] = {strip_hf_prefix(k): v for k, v in state_dict.items()}
    dropped = [k for k in src if is_lora_name(k)]
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in params.items():
            leaf = name.rsplit(".", 1)[-1]
            if is_lora_name(name) or (leaf in QUANT_LEAVES and leaf not in QUANT_HEADS):
                continue  # a quantized base's other leaves are written with its head
            if leaf in QUANT_HEADS:
                module = name[: -len(leaf)]
                key = f"{module}weight"
                if key not in src and name in src:
                    # a quantized source (a port checkpoint): its leaves as they are
                    new = {f"{module}{part}": src[f"{module}{part}"] for part in QUANT_HEADS[leaf]}
                else:
                    if key not in src:
                        raise KeyError(f"warm start: the source has no {key!r} for the model's {name!r}")
                    value = src[key].to(device=p.device, dtype=torch.float32)
                    if value.ndim != 2 or (leaf == "weight_codes" and value.shape[1] % 2):
                        raise ValueError(f"shape mismatch for {key}: {tuple(value.shape)}")
                    new = _quantized_leaves(module, leaf, value, params)
                for part, value in new.items():
                    if value.shape != params[part].shape:
                        raise ValueError(f"shape mismatch for {part}: {tuple(params[part].shape)} "
                                         f"vs {tuple(value.shape)}")
                    params[part].copy_(value.to(params[part].device))
                continue
            if name not in src:
                raise KeyError(f"warm start: the source has no {name!r}")
            value = src[name]
            if value.shape != p.shape:
                raise ValueError(f"shape mismatch for {name}: {tuple(p.shape)} vs {tuple(value.shape)}")
            p.copy_(value.to(device=p.device, dtype=p.dtype))
    if dropped:
        logger.warning(
            f"warm start: dropped {len(dropped)} unmerged lora_* leaves of the source "
            f"(e.g. {dropped[0]}); their delta is not carried over"
        )
    return model


def load_warm_start(model: nn.Module, path: str) -> nn.Module:
    """Graft the params of the port checkpoint at ``path``, else
    ``path/pytorch_model.bin``, into ``model``."""
    if os.path.exists(os.path.join(path, ckpt.PARAMS_FILE)):
        ok, reason = ckpt.verify_checkpoint(path)
        if not ok:
            raise ValueError(f"warmed_up_model {path!r} is a corrupt checkpoint: {reason}")
        state_dict = ckpt.restore_params_host(path)
    elif os.path.isdir(os.path.join(path, STATE_SUBDIR)):
        raise NotImplementedError(
            f"warmed_up_model {path!r} is a JAX checkpoint (state/), a format not ported: "
            f"relora_tpu_torch reads its own checkpoints ({ckpt.PARAMS_FILE}) and {WEIGHTS_FILE}"
        )
    else:
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
