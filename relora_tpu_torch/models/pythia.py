"""GPT-NeoX / Pythia decoder in PyTorch: the training forward and the two
serving forwards.

Counterpart of ``relora_tpu/models/pythia.py``: LayerNorm with biases, a
fused and biased QKV projection, partial rotary embeddings (the first
``rotary_dim = head_dim * rotary_pct`` dims of each head), the GELU MLP, the
parallel residual ``x + attn(ln1(x)) + mlp(ln2(x))`` (or the sequential one
when ``use_parallel_residual`` is false), and the causal-LM head.  Parameter
names follow HF GPT-NeoX less its ``gpt_neox.`` prefix
(``relora_tpu/models/hf_compat.py``): ``embed_in.weight``,
``layers.{i}.attention.query_key_value.{weight,bias}``, ...,
``final_layer_norm.{weight,bias}``, ``embed_out.weight``; linear weights are
``(out, in)``.  The fused QKV output is HF's, interleaved per head as
``(heads, 3, head_dim)``, so HF weights load without a reshuffle.

With a ``LoraSpec`` every attention and MLP projection is a biased
:class:`~relora_tpu_torch.models.lora.LoRALinear`; ``embed_out`` never is.
Numerics, the forward's signature and the cache and pool layouts are those of
:class:`~relora_tpu_torch.models.llama.LlamaForCausalLM`: both are
:class:`~relora_tpu_torch.models.llama.CausalLM`, so the engine, the
scheduler and the trainer drive either model unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.models.llama import CausalLM, _seed, apply_rotary, attend
from relora_tpu_torch.models.lora import LoRALinear

#: dropout seeds a NeoX layer spends: one per projection
SEEDS_PER_LAYER = 4


class LayerNorm(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * weight + bias, in f32, cast back
    to ``dtype`` (both parameters f32, as in the JAX model)."""

    def __init__(self, hidden: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(hidden, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(hidden, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype)


def _linear(i, o, lora, dtype, param_dtype):
    return LoRALinear(i, o, lora=lora, bias=True, dtype=dtype, param_dtype=param_dtype)


class NeoXAttention(nn.Module):
    def __init__(self, config: ModelConfig, dtype=torch.float32, lora=None, param_dtype=None):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.query_key_value = _linear(h, 3 * h, lora, dtype, param_dtype)
        self.dense = _linear(h, h, lora, dtype, param_dtype)

    def forward(self, x, cos, sin, positions, block_tables, pool, row_map=None, arm="auto",
                dropout_seed=None, adapter_idx=None):
        cfg = self.config
        n, hd, rot = cfg.num_attention_heads, cfg.head_dim, cfg.rotary_dim
        B, S = x.shape[:2]
        qkv = self.query_key_value(x, _seed(dropout_seed, 0), adapter_idx)
        qkv = qkv.reshape(B, S, n, 3 * hd)  # HF's (heads, 3, head_dim) interleave
        q, k, v = qkv[..., :hd], qkv[..., hd : 2 * hd], qkv[..., 2 * hd :]
        # partial rotary: rotate the first rotary_dim dims, pass the rest
        q = torch.cat([apply_rotary(q[..., :rot], cos, sin), q[..., rot:]], dim=-1)
        k = torch.cat([apply_rotary(k[..., :rot], cos, sin), k[..., rot:]], dim=-1)
        v = v.contiguous()
        out = attend(q, k, v, positions, block_tables, pool, row_map, arm)
        return self.dense(out.reshape(B, S, cfg.hidden_size), _seed(dropout_seed, 1), adapter_idx)


class NeoXMLP(nn.Module):
    """dense_4h_to_h(gelu(dense_h_to_4h(x))), exact GELU."""

    def __init__(self, config: ModelConfig, dtype=torch.float32, lora=None, param_dtype=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.dense_h_to_4h = _linear(h, i, lora, dtype, param_dtype)
        self.dense_4h_to_h = _linear(i, h, lora, dtype, param_dtype)

    def forward(self, x, dropout_seed=None, adapter_idx=None):
        y = self.dense_h_to_4h(x, _seed(dropout_seed, 2), adapter_idx)
        y = F.gelu(y, approximate="none")
        return self.dense_4h_to_h(y, _seed(dropout_seed, 3), adapter_idx)


class NeoXLayer(nn.Module):
    """Parallel residual ``x + attn(ln1(x)) + mlp(ln2(x))``, or sequential
    ``x + attn(ln1(x)) + mlp(ln2(x + attn(ln1(x))))``."""

    def __init__(self, config: ModelConfig, dtype=torch.float32, lora=None, param_dtype=None):
        super().__init__()
        eps = config.layer_norm_eps
        self.parallel = config.use_parallel_residual
        self.input_layernorm = LayerNorm(config.hidden_size, eps, dtype)
        self.attention = NeoXAttention(config, dtype, lora, param_dtype)
        self.post_attention_layernorm = LayerNorm(config.hidden_size, eps, dtype)
        self.mlp = NeoXMLP(config, dtype, lora, param_dtype)

    def forward(self, x, cos, sin, positions, block_tables, pool, row_map=None, arm="auto",
                dropout_seed=None, adapter_idx=None):
        attn_out = self.attention(
            self.input_layernorm(x), cos, sin, positions, block_tables, pool, row_map, arm,
            dropout_seed, adapter_idx,
        )
        mlp_in = self.post_attention_layernorm(x if self.parallel else x + attn_out)
        return x + attn_out + self.mlp(mlp_in, dropout_seed, adapter_idx)


class GPTNeoXForCausalLM(CausalLM):
    """The GPT-NeoX causal LM: ``embed_in``, NeoX layers,
    ``final_layer_norm`` and ``embed_out``, with rotary over the first
    ``rotary_dim`` dims of each head.  Layer ``i`` draws its LoRA dropout
    from seeds ``dropout_seed + 4*i + j``, one per projection."""

    family = "neox"
    embed_name, norm_name, head_name = "embed_in", "final_layer_norm", "embed_out"
    layer_class = NeoXLayer
    seeds_per_layer = SEEDS_PER_LAYER

    def final_norm(self, config: ModelConfig, dtype) -> nn.Module:
        return LayerNorm(config.hidden_size, config.layer_norm_eps, dtype)

    def rotary_dim(self) -> int:
        return self.config.rotary_dim
