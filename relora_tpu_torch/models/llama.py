"""Llama decoder for paged serving, in PyTorch.

Counterpart of ``relora_tpu/models/llama.py`` for the decode forward of the
paged serving path: RMSNorm, rotary tables (with linear and dynamic scaling),
grouped-query attention that writes into and attends from a shared KV page
pool, the SwiGLU MLP, and the causal-LM head.  Parameter names follow the HF
Llama layout (``relora_tpu/models/hf_compat.py``): ``embed_tokens.weight``,
``layers.{i}.self_attn.q_proj.weight``, ..., ``norm.weight``,
``lm_head.weight``; linear weights are ``(out, in)``.

Numerics mirror the JAX model: projections run in the compute dtype, norms
and rotary in f32, attention math in f32, logits returned in f32.  The KV
pool is not module state: the engine owns it as one dict per layer
(``k``/``v`` of shape ``(num_pages, page_size, n_kv, head_dim)`` plus
``k_scale``/``v_scale`` ``(num_pages, n_kv)`` for an int8 pool) and passes it
to every forward, which updates it in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.ops.attention_dispatch import packed_attention, paged_attention

LayerPool = Dict[str, torch.Tensor]


def _write_quantized(codes, scales, new, rows, offs, fresh):
    """Write ``new`` ``(B, T, n_kv, H)`` into an int8 pool at ``(rows,
    offs)``, keeping per-``(page, kv_head)`` scales as a running max.

    An offset-0 write starts a page's life and clears its old scale (and,
    through ratio 0, its codes); the touched pages' scales then grow to cover
    the incoming tokens, their already written codes are requantized by
    old/new, and the fresh tokens are written at the new scale.  Scale
    updates are scatters with duplicate page indices, so they use
    ``scatter_reduce_`` ("prod", "amax"), whose result is defined for
    duplicates, and never an index assignment."""
    B, T, n_kv, _ = new.shape
    flat_rows = rows.reshape(-1).long()
    scatter_index = flat_rows[:, None].expand(-1, n_kv)
    new32 = new.float()
    cand = torch.clamp(new32.abs().amax(dim=-1) / 127.0, min=1e-12)  # (B, T, n_kv)
    scales.scatter_reduce_(0, scatter_index, fresh.reshape(-1, 1).expand(-1, n_kv), "prod")
    new_scale = scales.clone().scatter_reduce_(0, scatter_index, cand.reshape(-1, n_kv), "amax")
    ratio = scales[flat_rows] / new_scale[flat_rows]  # (B*T, n_kv)
    old_pages = codes[flat_rows].float()
    requant = torch.clamp(torch.round(old_pages * ratio[:, None, :, None]), -127, 127)
    codes[flat_rows] = requant.to(torch.int8)  # duplicates write identical pages
    tok_scale = new_scale[flat_rows].reshape(B, T, n_kv)
    q_new = torch.clamp(torch.round(new32 / tok_scale[..., None]), -127, 127)
    codes[rows.long(), offs.long()] = q_new.to(torch.int8)
    scales.copy_(new_scale)


def attend_with_paged_cache(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    positions: torch.Tensor,
    block_tables: torch.Tensor,
    pool: LayerPool,
    row_map: Optional[torch.Tensor] = None,
    arm: str = "auto",
) -> torch.Tensor:
    """Scatter this call's K/V into ``pool`` at ``pool[table[b, pos // ps],
    pos % ps]`` and attend through the block tables.

    The logical page index clips to the last table column, so writes from
    idle rows and padding land in the null page.  With ``row_map`` ``(T,)``
    (B must be 1) the call is a packed mixed batch: token ``t`` writes and
    attends through ``block_tables[row_map[t]]``; every write happens before
    any token attends, so later tokens of one request see earlier ones."""
    B, T = q.shape[:2]
    if row_map is not None and B != 1:
        raise ValueError(f"packed (row_map) forward is token-major: B must be 1, got {B}")
    pk, pv = pool["k"], pool["v"]
    ps = pk.shape[1]
    positions = positions.expand(B, T).to(torch.int32)
    W = block_tables.shape[1]
    logical = torch.clamp(positions // ps, 0, W - 1).long()
    if row_map is None:
        rows = torch.gather(block_tables.long(), 1, logical)  # (B, T)
    else:
        token_tables = block_tables[row_map.reshape(T).long()].long()  # (T, W)
        rows = torch.gather(token_tables, 1, logical.reshape(T, 1)).reshape(B, T)
    offs = (positions % ps).long()
    quantized = "k_scale" in pool
    if quantized:
        fresh = (offs != 0).float()  # (B, T): 0 starts a page's life
        _write_quantized(pk, pool["k_scale"], k_new, rows, offs, fresh)
        _write_quantized(pv, pool["v_scale"], v_new, rows, offs, fresh)
        scales = dict(k_scale=pool["k_scale"], v_scale=pool["v_scale"])
    else:
        pk[rows, offs] = k_new.to(pk.dtype)
        pv[rows, offs] = v_new.to(pv.dtype)
        scales = {}
    if row_map is not None:
        return packed_attention(
            q, pk, pv, block_tables, row_map, positions, arm=arm, **scales
        )
    return paged_attention(q, pk, pv, block_tables, positions, arm=arm, **scales)


class RMSNorm(nn.Module):
    """y = x / rms(x) * weight, in f32, cast back to ``dtype``."""

    def __init__(self, hidden: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(hidden, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (x32 * self.weight).to(self.dtype)


def rotary_tables(
    positions: torch.Tensor,
    head_dim: int,
    base: float = 10000.0,
    *,
    scaling_type: Optional[str] = None,
    scaling_factor: float = 1.0,
    max_position: Optional[int] = None,
    current_length: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for HF-convention RoPE, f32, shape (..., seq, head_dim).
    ``linear`` divides positions by the factor; ``dynamic`` (NTK) raises the
    base when the current length exceeds the trained maximum."""
    pos = positions.float()
    if scaling_type == "linear":
        pos = pos / scaling_factor
    elif (
        scaling_type == "dynamic" and max_position and current_length
        and current_length > max_position
    ):
        base = base * (
            scaling_factor * current_length / max_position - (scaling_factor - 1)
        ) ** (head_dim / (head_dim - 2))
    elif scaling_type not in (None, "linear", "dynamic"):
        raise ValueError(f"Unknown rope scaling type {scaling_type!r}")
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=pos.device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32, device=pos.device), exponent)
    freqs = pos[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE on (B, S, N, H) with (B?, S, H) tables, in f32 (rotate-half)."""
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    x32 = x.float()
    return (x32 * cos + _rotate_half(x32) * sin).to(x.dtype)


def _linear(i: int, o: int, dtype) -> nn.Linear:
    return nn.Linear(i, o, bias=False, dtype=dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config: ModelConfig, dtype=torch.float32):
        super().__init__()
        h, n_kv, hd = config.hidden_size, config.kv_heads, config.head_dim
        self.config = config
        self.q_proj = _linear(h, h, dtype)
        self.k_proj = _linear(h, n_kv * hd, dtype)
        self.v_proj = _linear(h, n_kv * hd, dtype)
        self.o_proj = _linear(h, h, dtype)

    def forward(self, x, cos, sin, positions, block_tables, pool, row_map=None, arm="auto"):
        cfg = self.config
        B, S = x.shape[:2]
        q = self.q_proj(x).reshape(B, S, cfg.num_attention_heads, cfg.head_dim)
        k = self.k_proj(x).reshape(B, S, cfg.kv_heads, cfg.head_dim)
        v = self.v_proj(x).reshape(B, S, cfg.kv_heads, cfg.head_dim)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        out = attend_with_paged_cache(q, k, v, positions, block_tables, pool, row_map, arm)
        return self.o_proj(out.reshape(B, S, cfg.hidden_size))


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: ModelConfig, dtype=torch.float32):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, i, dtype)
        self.up_proj = _linear(h, i, dtype)
        self.down_proj = _linear(i, h, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    """Pre-norm block: x + attn(norm(x)), then + mlp(norm(x))."""

    def __init__(self, config: ModelConfig, dtype=torch.float32):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtype)
        self.self_attn = LlamaAttention(config, dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtype)
        self.mlp = LlamaMLP(config, dtype)

    def forward(self, x, cos, sin, positions, block_tables, pool, row_map=None, arm="auto"):
        x = x + self.self_attn(
            self.input_layernorm(x), cos, sin, positions, block_tables, pool, row_map, arm
        )
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaForCausalLM(nn.Module):
    """Causal LM over the paged KV pool, returning f32 logits.

    ``dtype`` is the compute dtype of the projections and the embedding
    (norm weights stay f32, as in the JAX model).  ``attention_arm`` pins
    the attention arm (``"auto"`` or ``"naive"``) for every layer."""

    def __init__(self, config: ModelConfig, dtype=torch.float32, attention_arm: str = "auto"):
        super().__init__()
        if config.family != "llama":
            raise NotImplementedError(
                f"model family {config.family!r} is not ported yet (llama only)"
            )
        if attention_arm not in ("auto", "naive"):
            raise ValueError(f"attention_arm must be 'auto' or 'naive', got {attention_arm!r}")
        self.config = config
        self.dtype = dtype
        self.attention_arm = attention_arm
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(config, dtype) for _ in range(config.num_hidden_layers)
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtype)
        self.lm_head = _linear(config.hidden_size, config.vocab_size, dtype)

    def forward(
        self,
        input_ids: torch.Tensor,
        positions: torch.Tensor,
        pool: List[LayerPool],
        block_tables: torch.Tensor,
        row_map: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg = self.config
        x = self.embed_tokens(input_ids)
        cos, sin = rotary_tables(
            positions,
            cfg.head_dim,
            cfg.rotary_emb_base,
            scaling_type=cfg.rope_scaling_type,
            scaling_factor=cfg.rope_scaling_factor,
            max_position=cfg.max_sequence_length,
            current_length=input_ids.shape[1],
        )
        for layer, layer_pool in zip(self.layers, pool):
            x = layer(
                x, cos, sin, positions, block_tables, layer_pool, row_map,
                self.attention_arm,
            )
        return self.lm_head(self.norm(x)).float()
