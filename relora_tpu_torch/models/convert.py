"""Weights from the JAX package's parameter tree into the port's state dict.

The JAX Llama stores ``{"embed_tokens": {"embedding"}, "layers" | "layers_{i}":
{...}, "norm": {"scale"}, "lm_head": {"kernel"}}`` with ``(in, out)`` kernels;
the port uses the HF names of ``relora_tpu/models/hf_compat.py`` with
``(out, in)`` weights.  The tree arrives as nested dicts of numpy arrays, so
this module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# unrolled JAX path -> port state-dict key (hf_compat's layer map)
_LLAMA_LAYER_MAP = {
    "self_attn.q_proj.kernel": "self_attn.q_proj.weight",
    "self_attn.k_proj.kernel": "self_attn.k_proj.weight",
    "self_attn.v_proj.kernel": "self_attn.v_proj.weight",
    "self_attn.o_proj.kernel": "self_attn.o_proj.weight",
    "mlp.gate_proj.kernel": "mlp.gate_proj.weight",
    "mlp.up_proj.kernel": "mlp.up_proj.weight",
    "mlp.down_proj.kernel": "mlp.down_proj.weight",
    "input_layernorm.scale": "input_layernorm.weight",
    "post_attention_layernorm.scale": "post_attention_layernorm.weight",
}


def _leaf(tree: Mapping[str, Any], dotted: str) -> np.ndarray:
    node: Any = tree
    for part in dotted.split("."):
        if not isinstance(node, Mapping) or part not in node:
            raise KeyError(f"parameter tree has no leaf {dotted!r}")
        node = node[part]
    return np.asarray(node, dtype=np.float32)


def _weight(value: np.ndarray, src: str) -> torch.Tensor:
    if src.endswith(".kernel"):
        value = value.T  # (in, out) -> (out, in)
    return torch.tensor(value)  # a copy: the tree's arrays may be read-only


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of :class:`relora_tpu_torch.models.llama.LlamaForCausalLM`
    from a merged JAX Llama parameter tree, scanned (``layers`` with a
    leading axis L) or unrolled (``layers_0`` .. ``layers_{L-1}``).  LoRA
    leaves are not converted: serving takes merged weights."""
    if "layers" in tree:
        stacked = tree["layers"]
        n_layers = _leaf(stacked, "input_layernorm.scale").shape[0]
        layer = lambda i, path: _leaf(stacked, path)[i]
    else:
        n_layers = sum(1 for k in tree if k.startswith("layers_") and k[7:].isdigit())
        layer = lambda i, path: _leaf(tree[f"layers_{i}"], path)
    if n_layers == 0:
        raise KeyError("parameter tree has no decoder layers")
    out = {
        "embed_tokens.weight": _weight(_leaf(tree, "embed_tokens.embedding"), "embedding"),
        "norm.weight": _weight(_leaf(tree, "norm.scale"), "norm.scale"),
        "lm_head.weight": _weight(_leaf(tree, "lm_head.kernel"), "lm_head.kernel"),
    }
    for i in range(n_layers):
        for src, dst in _LLAMA_LAYER_MAP.items():
            out[f"layers.{i}.{dst}"] = _weight(layer(i, src), src)
    return out
