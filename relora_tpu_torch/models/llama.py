"""Llama decoder in PyTorch: the training forward and the two serving forwards.

Counterpart of ``relora_tpu/models/llama.py``: RMSNorm, rotary tables (with
linear and dynamic scaling), grouped-query attention, the SwiGLU MLP, and the
causal-LM head.  Parameter names follow the HF Llama layout
(``relora_tpu/models/hf_compat.py``): ``embed_tokens.weight``,
``layers.{i}.self_attn.q_proj.weight``, ..., ``norm.weight``,
``lm_head.weight``; linear weights are ``(out, in)``.  With a ``LoraSpec``
every attention and MLP projection is a
:class:`~relora_tpu_torch.models.lora.LoRALinear` carrying ``lora_a``,
``lora_b`` (and ``lora_s``) beside its weight; ``lm_head`` never is.

Numerics mirror the JAX model: parameters are stored in ``param_dtype`` (f32
masters in training, the compute dtype in serving), projections run in the
compute dtype, norms and rotary in f32, attention math in f32, logits
returned in f32.

Called without a pool or a cache, the model runs the training forward:
causal self-attention through ``ops.attention.dot_product_attention`` (the
flash kernels on CUDA), optional per-layer activation checkpointing, and
LoRA dropout seeded per call.  Called with a cache, it runs the contiguous
decode forward (``attend_with_cache``): one dict per layer, ``k``/``v`` of
shape ``(B, cache_size, n_kv, head_dim)``, one row per sequence.  Called
with a pool, it runs the paged decode forward: the engine owns the pool as
one dict per layer (``k``/``v`` of shape ``(num_pages, page_size, n_kv,
head_dim)`` plus ``k_scale``/``v_scale`` ``(num_pages, n_kv)`` for an int8
pool).  Either serving forward updates its K/V in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.core.relora import LoraSpec
from relora_tpu_torch.models.lora import LoRALinear
from relora_tpu_torch.ops.attention import cached_attention, dot_product_attention
from relora_tpu_torch.ops.attention_dispatch import packed_attention, paged_attention

#: dropout seeds a decoder layer spends: one per projection (7), rounded up
SEEDS_PER_LAYER = 8

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
    absmax = new32.abs().amax(dim=-1)  # (B, T, n_kv); a true division, also on CUDA
    cand = torch.clamp(absmax / absmax.new_full((), 127.0), min=1e-12)
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


def attend_with_cache(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    positions: torch.Tensor,
    cache: LayerPool,
) -> torch.Tensor:
    """Write this call's K/V into the contiguous ``cache`` (``k``/``v`` of
    shape ``(B, C, n_kv, H)``) and attend against all of it
    (``relora_tpu/models/llama.py:37-69``).

    Row ``b`` writes its ``T`` new entries at ``positions[b, 0] ..``; as in
    JAX's ``dynamic_update_slice`` the start clamps to ``[0, C - T]``, so an
    idle row decoding at a stale position never writes out of bounds.  The
    write comes before the attention, whose mask ``j <= p``
    (:func:`~relora_tpu_torch.ops.attention.cached_attention`) is at once the
    causal mask, the length mask and the pad mask of a right-padded prompt:
    an entry written by padding becomes visible only at a position that a
    later step overwrites first."""
    B, T = q.shape[:2]
    ck, cv = cache["k"], cache["v"]
    C = ck.shape[1]
    if T > C:
        raise ValueError(f"a {T}-token write does not fit the cache's {C} entries")
    positions = positions.expand(B, T)
    start = torch.clamp(positions[:, 0].long(), 0, C - T)
    cols = start[:, None] + torch.arange(T, device=start.device)
    rows = torch.arange(B, device=start.device)[:, None]
    ck[rows, cols] = k_new.to(ck.dtype)
    cv[rows, cols] = v_new.to(cv.dtype)
    return cached_attention(q, ck, cv, positions)


def attend(q, k, v, positions, block_tables, kv, row_map, arm):
    """The attention of a decoder layer, shared by both families: causal
    training attention without ``kv``, the contiguous cache's with ``kv``
    and no ``block_tables``, the paged pool's with both."""
    if kv is None:
        return dot_product_attention(q, k, v, causal=True, impl=arm)
    if block_tables is None:
        return attend_with_cache(q, k, v, positions, kv)
    return attend_with_paged_cache(q, k, v, positions, block_tables, kv, row_map, arm)


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
    # the base filled on the device: a tensor built from a host value would be
    # a blocking copy, a wait on the device in every forward
    inv_freq = 1.0 / torch.pow(torch.full((), base, dtype=torch.float32, device=pos.device), exponent)
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


def _seed(base: Optional[int], offset: int) -> Optional[int]:
    return None if base is None else base + offset


class LlamaAttention(nn.Module):
    def __init__(self, config: ModelConfig, dtype=torch.float32, lora=None, param_dtype=None):
        super().__init__()
        h, n_kv, hd = config.hidden_size, config.kv_heads, config.head_dim
        self.config = config
        linear = lambda i, o: LoRALinear(i, o, lora=lora, dtype=dtype, param_dtype=param_dtype)
        self.q_proj = linear(h, h)
        self.k_proj = linear(h, n_kv * hd)
        self.v_proj = linear(h, n_kv * hd)
        self.o_proj = linear(h, h)

    def forward(self, x, cos, sin, positions, block_tables, pool, row_map=None, arm="auto",
                dropout_seed=None, adapter_idx=None):
        cfg = self.config
        B, S = x.shape[:2]
        q = self.q_proj(x, _seed(dropout_seed, 0), adapter_idx)
        k = self.k_proj(x, _seed(dropout_seed, 1), adapter_idx)
        v = self.v_proj(x, _seed(dropout_seed, 2), adapter_idx)
        q = q.reshape(B, S, cfg.num_attention_heads, cfg.head_dim)
        k = k.reshape(B, S, cfg.kv_heads, cfg.head_dim)
        v = v.reshape(B, S, cfg.kv_heads, cfg.head_dim)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        out = attend(q, k, v, positions, block_tables, pool, row_map, arm)
        return self.o_proj(out.reshape(B, S, cfg.hidden_size), _seed(dropout_seed, 3), adapter_idx)


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: ModelConfig, dtype=torch.float32, lora=None, param_dtype=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        linear = lambda a, b: LoRALinear(a, b, lora=lora, dtype=dtype, param_dtype=param_dtype)
        self.gate_proj = linear(h, i)
        self.up_proj = linear(h, i)
        self.down_proj = linear(i, h)

    def forward(self, x, dropout_seed=None, adapter_idx=None):
        gate = self.gate_proj(x, _seed(dropout_seed, 4), adapter_idx)
        up = self.up_proj(x, _seed(dropout_seed, 5), adapter_idx)
        return self.down_proj(F.silu(gate) * up, _seed(dropout_seed, 6), adapter_idx)


class LlamaDecoderLayer(nn.Module):
    """Pre-norm block: x + attn(norm(x)), then + mlp(norm(x))."""

    def __init__(self, config: ModelConfig, dtype=torch.float32, lora=None, param_dtype=None):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtype)
        self.self_attn = LlamaAttention(config, dtype, lora, param_dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtype)
        self.mlp = LlamaMLP(config, dtype, lora, param_dtype)

    def forward(self, x, cos, sin, positions, block_tables, pool, row_map=None, arm="auto",
                dropout_seed=None, adapter_idx=None):
        x = x + self.self_attn(
            self.input_layernorm(x), cos, sin, positions, block_tables, pool, row_map, arm,
            dropout_seed, adapter_idx,
        )
        return x + self.mlp(self.post_attention_layernorm(x), dropout_seed, adapter_idx)


class CausalLM(nn.Module):
    """A decoder-only causal LM returning f32 logits (``logits_dtype``): the
    constructor and forward loop that both families share.

    ``dtype`` is the compute dtype of the projections and the embedding
    output; ``param_dtype`` (default ``dtype``) stores the weights (norm
    weights stay f32, as in the JAX models).  ``attention_arm`` pins the
    attention arm for every layer: ``"auto"``, ``"naive"``, or ``"flash"``
    (training only).  ``lora`` wraps every attention and MLP projection;
    ``remat`` recomputes each decoder layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant).

    A family names its modules (``embed_name``, ``norm_name``,
    ``head_name``: the HF parameter names), its ``layer_class``, the dropout
    seeds a layer spends (``seeds_per_layer``), and builds its final norm
    (:meth:`final_norm`) and rotary width (:meth:`rotary_dim`)."""

    family: str
    embed_name: str
    norm_name: str
    head_name: str
    layer_class: type
    seeds_per_layer: int

    def __init__(
        self,
        config: ModelConfig,
        dtype=torch.float32,
        attention_arm: str = "auto",
        *,
        lora: Optional[LoraSpec] = None,
        param_dtype=None,
        remat: bool = False,
        logits_dtype=torch.float32,
    ):
        super().__init__()
        if config.family != self.family:
            raise ValueError(
                f"{type(self).__name__} builds the {self.family!r} family, got "
                f"{config.family!r} (models.family.causal_lm_class picks the class of a config)"
            )
        if attention_arm not in ("auto", "naive", "flash"):
            raise ValueError(
                f"attention_arm must be 'auto', 'naive' or 'flash', got {attention_arm!r}"
            )
        param_dtype = param_dtype or dtype
        self.config = config
        self.dtype = dtype
        self.attention_arm = attention_arm
        self.lora = lora
        self.remat = remat
        self.logits_dtype = logits_dtype
        setattr(self, self.embed_name,
                nn.Embedding(config.vocab_size, config.hidden_size, dtype=param_dtype))
        self.layers = nn.ModuleList(
            self.layer_class(config, dtype, lora, param_dtype)
            for _ in range(config.num_hidden_layers)
        )
        setattr(self, self.norm_name, self.final_norm(config, dtype))
        setattr(self, self.head_name, LoRALinear(
            config.hidden_size, config.vocab_size, dtype=dtype, param_dtype=param_dtype
        ))

    def final_norm(self, config: ModelConfig, dtype) -> nn.Module:
        raise NotImplementedError

    def rotary_dim(self) -> int:
        raise NotImplementedError

    def forward(
        self,
        input_ids: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        pool: Optional[List[LayerPool]] = None,
        block_tables: Optional[torch.Tensor] = None,
        row_map: Optional[torch.Tensor] = None,
        *,
        cache: Optional[List[LayerPool]] = None,
        dropout_seed: Optional[int] = None,
        adapter_idx: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Logits ``(B, S, vocab)``.  Without ``pool`` or ``cache`` this is
        the training forward over ``input_ids`` ``(B, S)`` at positions
        ``0..S-1`` (causal attention; ``dropout_seed`` turns LoRA dropout on,
        layer ``i`` drawing from seeds ``dropout_seed + seeds_per_layer*i +
        j``).  With ``cache`` (one ``{"k", "v"}`` dict per layer, ``(B, C,
        n_kv, H)``) it is the contiguous decode forward at ``positions``;
        with ``pool`` the paged decode forward at ``positions`` through
        ``block_tables``.  The rotary tables cover :meth:`rotary_dim`
        (dynamic NTK scaling takes its exponent from it).

        ``adapter_idx`` routes a slotted model's rows (``LoraSpec(num_slots)``)
        to their adapter slots: per batch row ``(B,)``, repeated across its
        tokens, or per token ``(B*S,)`` (the packed forward, B = 1); no index
        is slot 0 everywhere.  Every LoRA projection of every layer takes it."""
        cfg = self.config
        if pool is not None and (cache is not None or block_tables is None):
            raise ValueError("the paged forward takes block_tables and no contiguous cache")
        kv = pool if pool is not None else cache
        x = getattr(self, self.embed_name)(input_ids).to(self.dtype)
        if positions is None:
            if kv is not None:
                raise ValueError("a decode forward needs positions")
            positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        cos, sin = rotary_tables(
            positions,
            self.rotary_dim(),
            cfg.rotary_emb_base,
            scaling_type=cfg.rope_scaling_type,
            scaling_factor=cfg.rope_scaling_factor,
            max_position=cfg.max_sequence_length,
            current_length=input_ids.shape[1],
        )
        layer_kv = kv if kv is not None else [None] * len(self.layers)
        remat = self.remat and kv is None and torch.is_grad_enabled()
        for i, (layer, layer_pool) in enumerate(zip(self.layers, layer_kv)):
            args = (x, cos, sin, positions, block_tables, layer_pool, row_map,
                    self.attention_arm, _seed(dropout_seed, self.seeds_per_layer * i),
                    adapter_idx)
            x = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
        x = getattr(self, self.norm_name)(x)
        return getattr(self, self.head_name)(x).to(self.logits_dtype)


class LlamaForCausalLM(CausalLM):
    """The Llama causal LM: ``embed_tokens``, decoder layers, ``norm``
    (RMSNorm) and ``lm_head``, with rotary over the whole head."""

    family = "llama"
    embed_name, norm_name, head_name = "embed_tokens", "norm", "lm_head"
    layer_class = LlamaDecoderLayer
    seeds_per_layer = SEEDS_PER_LAYER

    def final_norm(self, config: ModelConfig, dtype) -> nn.Module:
        return RMSNorm(config.hidden_size, config.rms_norm_eps, dtype)

    def rotary_dim(self) -> int:
        return self.config.head_dim
