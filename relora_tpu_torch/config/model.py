"""Model architecture configs and the reference size sweep.

A standalone copy of ``relora_tpu/config/model.py``: the PyTorch port
imports nothing of the JAX package, so it keeps its own table.

The reference ships 15 Llama JSON configs (``configs/llama_{9m..7b}.json``) in
HF format; here the same sweep lives in one typed table (`MODEL_ZOO`).
`load_model_config` also reads HF-style JSON files directly, so a user of the
reference can point us at their existing config files unchanged.

Reference parity: configs/llama_35m.json etc.; fields mirror
peft_pretraining/modeling_llama.py's LlamaConfig usage and
modeling_pythia.py's GPTNeoXConfig usage.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for both model families.

    ``family`` is "llama" (RMSNorm, SwiGLU, no biases, separate q/k/v) or
    "neox" (LayerNorm, GELU MLP, biases, fused QKV, parallel residual,
    partial rotary) — the two families the reference implements
    (modeling_llama.py, modeling_pythia.py).
    """

    family: str = "llama"
    vocab_size: int = 32100
    hidden_size: int = 384
    intermediate_size: int = 1024
    num_hidden_layers: int = 6
    num_attention_heads: int = 8
    # grouped-query attention: fewer K/V heads than Q heads (None = MHA, the
    # reference's models; an extension for modern Llama variants)
    num_key_value_heads: Optional[int] = None
    max_sequence_length: int = 1024
    rms_norm_eps: float = 1e-6
    layer_norm_eps: float = 1e-5  # neox
    initializer_range: float = 0.02
    rotary_pct: float = 1.0  # neox partial rotary (modeling_pythia.py:97)
    rotary_emb_base: float = 10000.0
    # context extension (parity: rope scaling variants, modeling_pythia.py:333-375)
    rope_scaling_type: Optional[str] = None  # None | "linear" | "dynamic"
    rope_scaling_factor: float = 1.0
    use_parallel_residual: bool = True  # neox (modeling_pythia.py:443-456)
    tie_word_embeddings: bool = False
    bos_token_id: int = 0
    eos_token_id: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    def num_params(self, include_embeddings: bool = True) -> int:
        """Approximate parameter count (dense, untied)."""
        h, i, L, v = self.hidden_size, self.intermediate_size, self.num_hidden_layers, self.vocab_size
        if self.family == "llama":
            per_layer = 4 * h * h + 3 * h * i + 2 * h
            extra = h  # final norm
        else:
            # fused qkv (3h*h+3h), dense (h*h+h), 2-layer mlp, 2 LayerNorms w/ bias
            per_layer = (3 * h * h + 3 * h) + (h * h + h) + (2 * h * i + i + h) + 4 * h
            extra = 2 * h
        n = L * per_layer + extra
        if include_embeddings:
            n += 2 * v * h if not self.tie_word_embeddings else v * h
        return n

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_hf_json(cls, path: str) -> "ModelConfig":
        """Read an HF-style config JSON (the reference's configs/*.json format)."""
        with open(path) as f:
            d = json.load(f)
        family = "neox" if d.get("model_type") == "gpt_neox" else "llama"
        return cls(
            family=family,
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d.get("num_key_value_heads"),
            max_sequence_length=d.get("max_sequence_length", d.get("max_position_embeddings", 2048)),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            layer_norm_eps=d.get("layer_norm_eps", 1e-5),
            initializer_range=d.get("initializer_range", 0.02),
            rotary_pct=d.get("rotary_pct", 1.0),
            rotary_emb_base=d.get("rotary_emb_base", 10000.0),
            use_parallel_residual=d.get("use_parallel_residual", True),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            bos_token_id=d.get("bos_token_id", 0),
            eos_token_id=d.get("eos_token_id", 1),
            rope_scaling_type=(d.get("rope_scaling") or {}).get("type"),
            rope_scaling_factor=(d.get("rope_scaling") or {}).get("factor", 1.0),
        )


def _llama(h: int, i: int, L: int, heads: int, seq: int = 1024, vocab: int = 32100) -> ModelConfig:
    return ModelConfig(
        family="llama",
        hidden_size=h,
        intermediate_size=i,
        num_hidden_layers=L,
        num_attention_heads=heads,
        max_sequence_length=seq,
        vocab_size=vocab,
    )


# The reference's full Llama size sweep (configs/llama_9m.json .. llama_7b.json).
MODEL_ZOO: dict[str, ModelConfig] = {
    "llama_9m": _llama(128, 352, 4, 4),
    "llama_20m": _llama(256, 688, 4, 4),
    "llama_35m": _llama(384, 1024, 6, 8),
    "llama_40m": _llama(416, 1024, 8, 8),
    "llama_60m": _llama(512, 1376, 8, 8),
    "llama_71m": _llama(512, 1368, 12, 8),
    "llama_100m": _llama(640, 1708, 12, 10),
    "llama_130m": _llama(768, 2048, 12, 12),
    "llama_250m": _llama(768, 2560, 24, 16),
    "llama_250m_50K": _llama(768, 2560, 24, 16, vocab=50257),
    "llama_250m_old": _llama(768, 2560, 24, 16, vocab=32000),
    "llama_350m": _llama(1024, 2736, 24, 16),
    "llama_1b": _llama(2048, 5461, 24, 32),
    "llama_3b": _llama(2560, 6848, 32, 32),
    "llama_7b": _llama(4096, 11008, 32, 32, seq=2048),
    # Pythia/GPT-NeoX sizes used by the reference's production recipe
    # (training_configs/1B_v1.0.yaml: EleutherAI/pythia-1b).
    # pythia_14m is a dev size (llama_9m's role for the neox family —
    # smoke tests and CI; not an EleutherAI release).
    "pythia_14m": ModelConfig(
        family="neox", vocab_size=50304, hidden_size=128, intermediate_size=512,
        num_hidden_layers=4, num_attention_heads=4, max_sequence_length=2048,
        rotary_pct=0.25, tie_word_embeddings=False,
    ),
    "pythia_70m": ModelConfig(
        family="neox", vocab_size=50304, hidden_size=512, intermediate_size=2048,
        num_hidden_layers=6, num_attention_heads=8, max_sequence_length=2048,
        rotary_pct=0.25, tie_word_embeddings=False,
    ),
    "pythia_160m": ModelConfig(
        family="neox", vocab_size=50304, hidden_size=768, intermediate_size=3072,
        num_hidden_layers=12, num_attention_heads=12, max_sequence_length=2048,
        rotary_pct=0.25,
    ),
    "pythia_410m": ModelConfig(
        family="neox", vocab_size=50304, hidden_size=1024, intermediate_size=4096,
        num_hidden_layers=24, num_attention_heads=16, max_sequence_length=2048,
        rotary_pct=0.25,
    ),
    "pythia_1b": ModelConfig(
        family="neox", vocab_size=50304, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=8, max_sequence_length=2048,
        rotary_pct=0.25,
    ),
    "pythia_1.4b": ModelConfig(
        family="neox", vocab_size=50304, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=24, num_attention_heads=16, max_sequence_length=2048,
        rotary_pct=0.25,
    ),
}


# HF hub ids used by reference recipes -> zoo entries, so configs like
# "model_name_or_path: EleutherAI/pythia-1b" (training_configs/1B_v1.0.yaml)
# resolve without network access.  Weights still come from a local snapshot
# via --warmed_up_model.
HF_ID_ALIASES = {
    f"EleutherAI/pythia-{size}": f"pythia_{size.replace('-deduped', '')}"
    for size in ("70m", "160m", "410m", "1b", "1.4b")
} | {
    f"EleutherAI/pythia-{size}-deduped": f"pythia_{size}"
    for size in ("70m", "160m", "410m", "1b", "1.4b")
}


def load_model_config(name_or_path: str) -> ModelConfig:
    """Resolve a zoo name ("llama_35m"), a known HF hub id, an HF-style JSON
    path, or a dir with config.json."""
    import os

    if name_or_path in MODEL_ZOO:
        return MODEL_ZOO[name_or_path]
    if name_or_path in HF_ID_ALIASES:
        return MODEL_ZOO[HF_ID_ALIASES[name_or_path]]
    if os.path.isdir(name_or_path):
        name_or_path = os.path.join(name_or_path, "config.json")
    if os.path.exists(name_or_path):
        return ModelConfig.from_hf_json(name_or_path)
    raise ValueError(
        f"Unknown model config {name_or_path!r}: not in MODEL_ZOO "
        f"({sorted(MODEL_ZOO)}), not a known HF id, and not a file"
    )
