"""Weights from the JAX package's parameter tree into the port's state dict,
for both model families.

The JAX Llama stores ``{"embed_tokens": {"embedding"}, "layers" | "layers_{i}":
{...}, "norm": {"scale"}, "lm_head": {"kernel"}}``, the JAX GPT-NeoX
``{"embed_in": {"embedding"}, "layers" | "layers_{i}": {...},
"final_layer_norm": {"scale", "bias"}, "embed_out": {"kernel"}}``, both with
``(in, out)`` kernels; the port uses the HF names of
``relora_tpu/models/hf_compat.py`` (less HF NeoX's ``gpt_neox.`` prefix) with
``(out, in)`` weights.  Biases copy as they are.  The tree arrives as nested
dicts of numpy arrays, so this module imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from relora_tpu_torch.ops.quant import NF4_LEAVES, jax_nf4_name

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

# the same for GPT-NeoX (hf_compat's NeoX layer map); the fused QKV keeps
# HF's per-head interleave, so no reshuffle
_NEOX_LAYER_MAP = {
    "attention.query_key_value.kernel": "attention.query_key_value.weight",
    "attention.query_key_value.bias": "attention.query_key_value.bias",
    "attention.dense.kernel": "attention.dense.weight",
    "attention.dense.bias": "attention.dense.bias",
    "mlp.dense_h_to_4h.kernel": "mlp.dense_h_to_4h.weight",
    "mlp.dense_h_to_4h.bias": "mlp.dense_h_to_4h.bias",
    "mlp.dense_4h_to_h.kernel": "mlp.dense_4h_to_h.weight",
    "mlp.dense_4h_to_h.bias": "mlp.dense_4h_to_h.bias",
    "input_layernorm.scale": "input_layernorm.weight",
    "input_layernorm.bias": "input_layernorm.bias",
    "post_attention_layernorm.scale": "post_attention_layernorm.weight",
    "post_attention_layernorm.bias": "post_attention_layernorm.bias",
}

# top-level leaves: JAX path -> port key, per family
_TOP = {
    "llama": {
        "embed_tokens.embedding": "embed_tokens.weight",
        "norm.scale": "norm.weight",
        "lm_head.kernel": "lm_head.weight",
    },
    "neox": {
        "embed_in.embedding": "embed_in.weight",
        "final_layer_norm.scale": "final_layer_norm.weight",
        "final_layer_norm.bias": "final_layer_norm.bias",
        "embed_out.kernel": "embed_out.weight",
    },
}
_LAYER_MAPS = {"llama": _LLAMA_LAYER_MAP, "neox": _NEOX_LAYER_MAP}
#: the heads, absent from a backbone's tree (the classifier's ``model``)
_HEADS = ("lm_head.kernel", "embed_out.kernel")


#: LoRA leaves of a projection, copied in the JAX layouts: lora_a (in, r),
#: lora_b (r, out), lora_s (1,); a slotted tree's stacks (S, in, r),
#: (S, r, out) and (S,) likewise
_LORA_LEAVES = ("lora_a", "lora_b", "lora_s")


def _has(tree: Mapping[str, Any], dotted: str) -> bool:
    node: Any = tree
    for part in dotted.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return False
        node = node[part]
    return True


def _leaf(tree: Mapping[str, Any], dotted: str, dtype=np.float32) -> np.ndarray:
    if not _has(tree, dotted):
        raise KeyError(f"parameter tree has no leaf {dotted!r}")
    node: Any = tree
    for part in dotted.split("."):
        node = node[part]
    return np.asarray(node, dtype=dtype)


def _weight(value: np.ndarray, src: str) -> torch.Tensor:
    if src.endswith(".kernel"):
        value = value.T  # (in, out) -> (out, in)
    return torch.tensor(value)  # a copy: the tree's arrays may be read-only


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's model (:class:`~relora_tpu_torch.models.llama.LlamaForCausalLM`
    or :class:`~relora_tpu_torch.models.pythia.GPTNeoXForCausalLM`) from a
    JAX parameter tree, scanned (``layers`` with a leading axis L) or
    unrolled (``layers_0`` .. ``layers_{L-1}``).  The tree names its family:
    ``embed_in`` present means NeoX, else Llama.
    A LoRA tree's ``lora_a``/``lora_b``/``lora_s`` leaves keep their layouts
    (the port's ``LoRALinear`` stores them as the JAX module does), the
    stacked leaves of a multi-tenant tree (``num_slots``) too; a
    ``lora_only`` projection has no ``kernel`` and so no ``weight`` (nor
    bias).  An int8 projection's ``kernel_q`` ``(in, out)`` becomes
    ``weight_q`` ``(out, in)``, kept int8, and its ``kernel_scale`` ``(1,
    out)`` becomes ``weight_scale`` as it is.  An nf4 projection's
    ``kernel_codes``, ``kernel_bscale_q``, ``kernel_bscale_scale`` and
    ``kernel_bscale_offset`` become ``weight_codes``, ... unchanged: both
    packages store them ``(in, out)`` in the same dtypes (an odd-width
    projection's int8 fallback goes as any int8 base).

    A backbone's tree (no head) gives a state dict without the head.  The
    tree of ``LlamaForSequenceClassification`` (``model`` and ``score``)
    gives :class:`~relora_tpu_torch.models.llama.LlamaForSequenceClassification`'s:
    ``model.`` before each of the backbone's keys, and ``score.weight``."""
    if "score" in tree:
        out = {f"model.{k}": v for k, v in params_from_jax(tree["model"]).items()}
        out["score.weight"] = _weight(_leaf(tree, "score.kernel"), "score.kernel")
        return out
    family = "neox" if "embed_in" in tree else "llama"
    if "layers" in tree:
        stacked = tree["layers"]
        n_layers = _leaf(stacked, "input_layernorm.scale").shape[0]
        layer = lambda i, path, dtype=np.float32: _leaf(stacked, path, dtype)[i]
        layer_has = lambda i, path: _has(stacked, path)
    else:
        n_layers = sum(1 for k in tree if k.startswith("layers_") and k[7:].isdigit())
        layer = lambda i, path, dtype=np.float32: _leaf(tree[f"layers_{i}"], path, dtype)
        layer_has = lambda i, path: _has(tree[f"layers_{i}"], path)
    if n_layers == 0:
        raise KeyError("parameter tree has no decoder layers")
    out = {dst: _weight(_leaf(tree, src), src) for src, dst in _TOP[family].items()
           if src not in _HEADS or _has(tree, src)}
    for i in range(n_layers):
        for src, dst in _LAYER_MAPS[family].items():
            module, leaf = src.rsplit(".", 1)
            if leaf == "kernel" and layer_has(i, f"{module}.kernel_q"):
                codes = layer(i, f"{module}.kernel_q", np.int8)
                out[f"layers.{i}.{module}.weight_q"] = torch.tensor(codes.T)
                out[f"layers.{i}.{module}.weight_scale"] = torch.tensor(
                    layer(i, f"{module}.kernel_scale")
                )
            elif leaf == "kernel" and layer_has(i, f"{module}.kernel_codes"):
                for param in NF4_LEAVES:  # (in, out) leaves in both packages, dtypes kept
                    out[f"layers.{i}.{module}.{param}"] = torch.tensor(
                        layer(i, f"{module}.{jax_nf4_name(param)}", None)
                    )
            elif layer_has(i, src) or not layer_has(i, f"{module}.lora_a"):
                out[f"layers.{i}.{dst}"] = _weight(layer(i, src), src)
            if leaf == "kernel":
                for name in _LORA_LEAVES:
                    if layer_has(i, f"{module}.{name}"):
                        out[f"layers.{i}.{module}.{name}"] = torch.tensor(
                            layer(i, f"{module}.{name}")
                        )
    return out
