"""The inference engine: model, KV cache or page pool, and step functions.

Counterpart of ``relora_tpu/serve/engine.py``.  The engine owns the decode
model on its device.  Without ``page_size`` it serves the contiguous cache,
one ``(B, cache_size, n_kv, head_dim)`` row per sequence and layer
(``init_cache``):

- ``prefill(ids)`` — a right-padded prompt batch ``(B, T)`` in one forward
  into a fresh cache: the full logits and the cache;
- ``decode(cache, token, pos)`` — one token per row against the cache;
- ``insert(dcache, pcache, slot)`` — a batch-1 prefill cache copied into
  row ``slot`` of the persistent decode cache (continuous batching);
- ``generate(prompts, ...)`` — one-shot batch generation over the three.

With ``page_size`` it also builds the shared KV page pool (``init_pool``),
and four more step functions run forwards through it:

- ``prefill_chunk(ids, start, pool, block_table)`` — one fixed-size prompt
  chunk written straight into the pool through the request's block table;
- ``decode_paged(pool, token, pos, block_tables)`` — one token per slot;
- ``step_paged(pool, ids, positions, block_tables, row_map)`` — one packed
  mixed batch of decode rows and prefill tokens (``token_budget`` set);
- ``verify_paged(pool, tokens, pos, block_tables)`` — speculative verify
  (``spec_k`` set): a ``(B, spec_k+1)`` window per row through ``(B, W+1)``
  tables, returning the whole window's logits.

``load_draft_params`` installs a second, same-config decode model for
``--spec model``; ``draft_prefill_chunk`` and ``draft_decode_paged`` run it
over its own page runs in the one shared pool.

Each takes ``adapter_idx``: with ``adapter_slots`` set (multi-tenant
serving, ``relora_tpu/serve/engine.py:159-199``, ``:556-664``) every LoRA
projection is stacked ``(adapter_slots, ...)`` and each row (each token of a
packed step) decodes through its own slot, slot 0 being the base model;
``write_adapter_slot`` copies a tenant's factors into a slot in place.  With
``lora=`` and no slots the factors are served unmerged for one tenant.

The JAX engine donates the cache or pool to each jitted step and gets a
new one back; here the forward updates the tensors in place and returns the
same object, so the call shape stays ``logits, cache = engine.step(cache,
...)``.  Every forward runs under ``torch.inference_mode()``.

``warmup`` runs each serving shape once, so an online server builds the
kernels before it reports ready.

The fleet tier (``relora_tpu/serve/engine.py:668-722``, ``:1037-1140``):
``reload_params`` swaps the serving weights in place (a hot swap between
decode rounds); ``export_page_run`` and ``import_page_run`` move a request's
page run between two replicas of one config for disaggregated serving.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from relora_tpu_torch import resolve_device
from relora_tpu_torch.config.model import ModelConfig
from relora_tpu_torch.core.relora import LoraSpec, is_lora_name
from relora_tpu_torch.models.family import CausalLM, causal_lm_class
from relora_tpu_torch.models.lora import LoRALinear
from relora_tpu_torch.serve.sampling import SamplingParams, sample, step_generator

Pool = List[Dict[str, torch.Tensor]]
#: the contiguous cache: per layer ``k``/``v`` of shape ``(B, cache_size, n_kv, head_dim)``
Cache = List[Dict[str, torch.Tensor]]

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def bucket_length(n: int, minimum: int = 16) -> int:
    """Round a prompt length up to the next power of two (>= minimum)."""
    if n < 1:
        raise ValueError(f"prompt length must be >= 1, got {n}")
    return max(minimum, 1 << (n - 1).bit_length())


def build_decode_model(
    model_cfg: ModelConfig,
    *,
    dtype=torch.float32,
    device="cuda",
    attention_arm: str = "auto",
    lora: Optional[LoraSpec] = None,
    adapter_slots: int = 0,
) -> CausalLM:
    """The serving model of ``model_cfg``'s family (Llama or GPT-NeoX) on
    ``device`` (parameters uninitialized: load a
    state dict or call ``models.params_util.init_params``).  ``lora=None``
    serves a merged, LoRA-free state dict; the checkpoint's ``LoraSpec``
    serves its factors unmerged, rewritten for decode as the JAX package
    does: ``weights_static=True``, ``fused=False`` promoted to ``"auto"``,
    and ``num_slots=adapter_slots`` when slots are asked for (every LoRA
    leaf stacked, slot 0 the identity adapter)."""
    device = resolve_device(device)
    if lora is not None:
        lora = dataclasses.replace(
            lora,
            weights_static=True,
            fused="auto" if lora.fused is False else lora.fused,
            num_slots=adapter_slots if adapter_slots else lora.num_slots,
        )
    with torch.device("meta"):
        model = causal_lm_class(model_cfg)(
            model_cfg, dtype=dtype, attention_arm=attention_arm, lora=lora
        )
    return model.to_empty(device=device).eval()


class InferenceEngine:
    """Owns the decode model, its device and the cache or pool layout.

    ``params`` is a state dict of the config's model, Llama or GPT-NeoX
    (for instance from :func:`relora_tpu_torch.models.convert.params_from_jax`),
    or an already built model on ``device``.  ``dtype`` is the compute dtype
    and the contiguous cache's.  ``page_size`` (with ``num_pages``) adds the
    paged pool; ``kv_dtype="bf16"`` stores it at the compute dtype,
    ``"int8"`` stores codes plus per-``(page, kv_head)`` f32 scales.
    ``token_budget``, ``kv_dtype="int8"`` and ``spec_k`` need the pool, as
    in the reference.  ``lora`` (the checkpoint's spec)
    serves the factors unmerged; ``adapter_slots >= 2`` with it stacks them
    for multi-tenant serving: the state dict's non-LoRA tensors are loaded,
    its own factors dropped, and every slot starts as the identity.
    ``spec_k >= 1`` sizes the speculative verify window (``spec_k + 1``
    tokens a row); ``draft_model`` is None until ``load_draft_params``.
    """

    def __init__(
        self,
        model_cfg: ModelConfig,
        params,
        *,
        cache_size: int,
        dtype=torch.float32,
        page_size: Optional[int] = None,
        num_pages: Optional[int] = None,
        chunk_size: int = 64,
        kv_dtype: str = "bf16",
        token_budget: Optional[int] = None,
        attention_arm: str = "auto",
        device="cuda",
        lora: Optional[LoraSpec] = None,
        adapter_slots: int = 0,
        spec_k: int = 0,
    ):
        if cache_size < 1:
            raise ValueError(f"cache_size must be >= 1, got {cache_size}")
        if token_budget is not None:
            if page_size is None:
                raise ValueError("token_budget requires the paged engine (page_size set)")
            if token_budget < 1:
                raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        if adapter_slots:
            if lora is None:
                raise ValueError(
                    "adapter_slots > 0 requires the checkpoint's LoraSpec "
                    "(multi-tenant serving runs the factors unmerged)"
                )
            if adapter_slots < 2:
                raise ValueError(
                    f"adapter_slots must be >= 2 (slot 0 is the identity "
                    f"adapter), got {adapter_slots}"
                )
        self.adapter_slots = adapter_slots
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}")
        if kv_dtype == "int8" and page_size is None:
            raise ValueError("kv_dtype='int8' requires the paged engine (page_size set)")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k and page_size is None:
            raise ValueError("spec_k > 0 requires the paged engine (page_size set)")
        self.spec_k = spec_k
        self.paged = page_size is not None
        self.block_table_width = 0
        if self.paged:
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            if cache_size % page_size:
                raise ValueError(
                    f"cache_size ({cache_size}) must be a multiple of "
                    f"page_size ({page_size}) for paged decode"
                )
            self.block_table_width = cache_size // page_size
            if num_pages is None:
                raise ValueError("paged decode requires num_pages")
            if num_pages < self.block_table_width + 1:
                raise ValueError(
                    f"num_pages ({num_pages}) cannot hold one max-size request: "
                    f"need >= {self.block_table_width} + 1 (page 0 is the null page)"
                )
            if chunk_size < 1:
                raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.device = resolve_device(device)
        self.config = model_cfg
        self.cache_size = cache_size
        self.page_size = page_size or 0
        self.num_pages = num_pages or 0
        self.chunk_size = min(chunk_size, cache_size)
        self.kv_dtype = kv_dtype
        self.token_budget = token_budget or 0
        self.dtype = dtype
        self._lora = lora
        self.draft_model: Optional[CausalLM] = None
        if isinstance(params, CausalLM):
            self.model = params.eval()
        else:
            self.model = build_decode_model(
                model_cfg, dtype=dtype, device=self.device, attention_arm=attention_arm,
                lora=lora, adapter_slots=adapter_slots,
            )
            if adapter_slots:
                self._stack_adapter_params(params)
            else:
                self.model.load_state_dict(dict(params))
        self.model.attention_arm = attention_arm

    # -- the contiguous cache ----------------------------------------------------

    def cache_shapes(self, batch: int) -> Cache:
        """The cache of ``batch`` rows as meta tensors: per layer ``k``/``v``
        of shape ``(batch, cache_size, kv_heads, head_dim)`` at the compute
        dtype, with no memory behind them (the reference's ``eval_shape``)."""
        return self._cache(batch, "meta")

    def init_cache(self, batch: int) -> Cache:
        """A zero cache of ``batch`` rows on the engine's device."""
        return self._cache(batch, self.device)

    def _cache(self, batch: int, device) -> Cache:
        cfg = self.config
        shape = (batch, self.cache_size, cfg.kv_heads, cfg.head_dim)
        return [
            {name: torch.zeros(shape, dtype=self.dtype, device=device) for name in ("k", "v")}
            for _ in range(cfg.num_hidden_layers)
        ]

    # -- pool ------------------------------------------------------------------

    def _require_paged(self):
        if not self.paged:
            raise ValueError("engine was built without page_size: no paged entry points")

    def init_pool(self) -> Pool:
        """Zero page pool: per layer ``k``/``v`` ``(num_pages, page_size,
        kv_heads, head_dim)`` at the compute dtype, or int8 codes plus
        ``k_scale``/``v_scale`` ``(num_pages, kv_heads)`` f32."""
        self._require_paged()
        cfg = self.config
        shape = (self.num_pages, self.page_size, cfg.kv_heads, cfg.head_dim)
        quantized = self.kv_dtype == "int8"
        code_dtype = torch.int8 if quantized else self.dtype
        pool = []
        for _ in range(cfg.num_hidden_layers):
            layer = {
                "k": torch.zeros(shape, dtype=code_dtype, device=self.device),
                "v": torch.zeros(shape, dtype=code_dtype, device=self.device),
            }
            if quantized:
                for name in ("k_scale", "v_scale"):
                    layer[name] = torch.zeros(
                        shape[0], shape[2], dtype=torch.float32, device=self.device
                    )
            pool.append(layer)
        return pool

    def pool_bytes(self) -> int:
        """Resident bytes of the page pool (codes plus int8 scales)."""
        cfg = self.config
        per_page = 2 * self.page_size * cfg.kv_heads * cfg.head_dim * (
            1 if self.kv_dtype == "int8" else torch.finfo(self.dtype).bits // 8
        )
        if self.kv_dtype == "int8":
            per_page += 2 * cfg.kv_heads * 4
        return per_page * self.num_pages * cfg.num_hidden_layers

    def kv_bytes_per_token(self) -> float:
        """Pool bytes per cacheable token position (``num_pages x
        page_size`` over the whole pool)."""
        return self.pool_bytes() / float(self.num_pages * self.page_size)

    # -- multi-tenant adapter slots (adapter_slots set at construction) ------

    @torch.no_grad()
    def _stack_adapter_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Fill the slotted model (``relora_tpu/serve/engine.py:558-594``):
        every non-LoRA tensor from the checkpoint, copied onto the device at
        the model's dtype; every stacked factor zero and every ``lora_s``
        the spec's scale, so each slot starts as the identity adapter.  The checkpoint's own factors are
        dropped: tenants load theirs through the registry."""
        for name, t in self.model.state_dict().items():
            if is_lora_name(name):
                continue
            if name not in params:
                raise ValueError(
                    f"checkpoint is missing param leaf {name!r} required by the slotted decode model"
                )
            t.copy_(params[name])
        for module in self._slotted_modules().values():
            module.lora_a.zero_()
            module.lora_b.zero_()
            module.lora_s.fill_(module.lora.scale)

    def _slotted_modules(self) -> Dict[str, torch.nn.Module]:
        return {
            name: m for name, m in self.model.named_modules()
            if isinstance(m, LoRALinear) and m.lora is not None and m.lora.num_slots
        }

    def _require_slots(self):
        if not self.adapter_slots:
            raise ValueError("engine was built without adapter_slots: no slot writes")

    @torch.no_grad()
    def write_adapter_slot(self, slot: int, factors: Mapping[str, torch.Tensor], scale: float) -> None:
        """Copy one adapter's unmerged factors into slot ``slot`` in place
        (``relora_tpu/serve/engine.py:621-658``).  ``factors`` maps the
        port's state-dict names (``layers.{i}.self_attn.q_proj.lora_a`` ...)
        to ``(in, r)`` / ``(r, out)`` tensors, as
        :func:`relora_tpu_torch.serve.adapters.extract_lora_factors` returns
        them; a module the adapter does not name gets zeros.  Factors are
        cast onto the slabs' dtype and device; every shape is checked before
        anything is written, so a refused adapter leaves the slot as it was.
        Slot 0, the identity adapter, is immutable.  The stacked parameters
        keep their storage (``copy_``), so the module never rebinds them."""
        self._require_slots()
        if not (0 < slot < self.adapter_slots):
            raise ValueError(
                f"slot must be in [1, {self.adapter_slots}) (slot 0 is the "
                f"identity adapter), got {slot}"
            )
        modules = self._slotted_modules()
        writes = []
        for name, module in modules.items():
            for leaf in ("lora_a", "lora_b"):
                stacked = getattr(module, leaf)
                value = factors.get(f"{name}.{leaf}")
                if value is not None and tuple(value.shape) != tuple(stacked.shape[1:]):
                    raise ValueError(
                        f"adapter factor {name}.{leaf!r} has shape {tuple(value.shape)}, "
                        f"expected {tuple(stacked.shape[1:])}"
                    )
                writes.append((stacked[slot], value))
        for dst, value in writes:
            if value is None:
                dst.zero_()  # a module the adapter does not touch
            else:
                dst.copy_(value)
        for module in modules.values():
            module.lora_s[slot] = float(scale)

    def adapter_writer(self):
        """The ``writer(slot, factors, scale)`` callback an
        :class:`~relora_tpu_torch.serve.adapters.AdapterRegistry` wants."""
        self._require_slots()
        return self.write_adapter_slot

    # -- weight hot swap -----------------------------------------------------------

    @torch.no_grad()
    def reload_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Swap the serving weights for ``params`` in place
        (``relora_tpu/serve/engine.py:668-722``), a host state dict such as
        ``train/checkpoint.restore_serving_params`` returns.  Every live
        tensor needs a twin of its shape, and no incoming name may be
        unknown; all of it is checked, and every dtype cast on the host,
        before the first device write, so a refused dict leaves the live
        weights untouched.  Then each tensor is copied into the live one's
        storage, one at a time: no second full set of weights is held on
        the device.  On an engine with adapter slots the LoRA leaves (the
        tenants' slabs) are not touched.  Errors of the copies surface here,
        not at the next decode."""
        live = self.model.state_dict()
        extra = sorted(set(params) - set(live))
        if extra:
            raise ValueError(
                f"reload: checkpoint leaf {extra[0]!r} does not exist in the live tree "
                "(wrong model config?)"
            )
        staged = []
        for name, value in live.items():
            if self.adapter_slots and is_lora_name(name):
                continue  # tenant slabs survive a base reload
            if name not in params:
                raise ValueError(f"reload: checkpoint is missing leaf {name!r}")
            new = torch.as_tensor(params[name])
            if tuple(new.shape) != tuple(value.shape):
                raise ValueError(
                    f"reload: shape mismatch at {name!r}: checkpoint {tuple(new.shape)} "
                    f"vs live {tuple(value.shape)}"
                )
            staged.append((value, new.to(value.dtype)))
        for value, new in staged:
            value.copy_(new)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- page-run migration (disaggregated serving) ----------------------------------

    def page_run_buckets(self) -> Tuple[int, ...]:
        """Page counts a migration gathers and scatters at: powers of two up
        to ``block_table_width`` and the width itself; a run's ids pad with
        the null page to the next one."""
        self._require_paged()
        buckets: List[int] = []
        t = 1
        while t < self.block_table_width:
            buckets.append(t)
            t *= 2
        buckets.append(self.block_table_width)
        return tuple(buckets)

    def _page_run_bucket(self, n: int) -> int:
        for b in self.page_run_buckets():
            if b >= n:
                return b
        raise ValueError(f"page run of {n} pages exceeds block_table_width {self.block_table_width}")

    def _page_run_leaves(self, pool: Pool):
        """``(name, tensor)`` of every pool leaf, pages on axis 0:
        ``layers.{i}.k``, ``layers.{i}.v`` and, int8,
        ``layers.{i}.k_scale``, ``layers.{i}.v_scale``."""
        for i, layer in enumerate(pool):
            for leaf, t in layer.items():
                yield f"layers.{i}.{leaf}", t

    @staticmethod
    def _dtype_name(dtype: torch.dtype) -> str:
        return str(dtype).removeprefix("torch.")

    def export_page_run(
        self, pool: Pool, pages: Sequence[int]
    ) -> List[Tuple[str, str, Tuple[int, ...], bytes]]:
        """A page run's slices of every pool leaf as host bytes, ready for
        ``wire.encode_page_run`` (``relora_tpu/serve/engine.py:1060-1084``):
        one ``index_select`` per leaf at the run's padded bucket, one copy to
        the host, then a trim to ``len(pages)``.  Entries are ``(name,
        dtype, shape, bytes)``, named ``layers.{i}.{k|v|k_scale|v_scale}``
        (an int8 pool's codes travel with their per-page scales).  The JAX
        pool stacks its layers under one name, so a frame goes only between
        replicas of the port with one config."""
        self._require_paged()
        n = len(pages)
        if n < 1:
            raise ValueError("empty page run")
        bucket = self._page_run_bucket(n)
        ids = torch.as_tensor(list(pages) + [0] * (bucket - n), dtype=torch.long,
                              device=self.device)
        gathered = [(name, t.index_select(0, ids)) for name, t in self._page_run_leaves(pool)]
        out = []
        for name, t in gathered:
            host = t.cpu()[:n].contiguous()
            out.append((name, self._dtype_name(host.dtype), tuple(host.shape),
                        host.view(torch.uint8).numpy().tobytes()))
        return out

    def import_page_run(
        self,
        pool: Pool,
        pages: Sequence[int],
        entries: Sequence[Tuple[str, str, Sequence[int], bytes]],
    ) -> Pool:
        """Scatter a received run into ``pages`` of ``pool``
        (``relora_tpu/serve/engine.py:1086-1140``).  Every entry is checked
        against the engine's own pool first (the name set; each dtype and
        shape, pages axis ``len(pages)``; each payload's size), and any
        mismatch raises ValueError before a byte lands.  Then one
        ``index_copy_`` per leaf at the padded bucket (pad rows, zeros, land
        in the null page) writes codes and scales together, so a recycled
        page takes the donor's scale with its codes.  Returns the pool."""
        self._require_paged()
        n = len(pages)
        if n < 1:
            raise ValueError("empty page run")
        bucket = self._page_run_bucket(n)
        leaves = dict(self._page_run_leaves(pool))
        got = {e[0]: e for e in entries}
        if set(got) != set(leaves):
            raise ValueError(
                f"page-run leaves mismatch: got {sorted(got)}, want {sorted(leaves)}"
            )
        staged = []
        for name, t in leaves.items():
            _, dtype, shape, raw = got[name]
            want = [n, *t.shape[1:]]
            if str(dtype) != self._dtype_name(t.dtype) or list(shape) != want:
                raise ValueError(
                    f"page-run leaf {name!r}: got {dtype}{list(shape)}, "
                    f"want {self._dtype_name(t.dtype)}{want}"
                )
            if len(raw) != int(np.prod(want)) * t.element_size():
                raise ValueError(f"page-run leaf {name!r}: payload size mismatch")
            staged.append((t, raw, want))
        ids = torch.as_tensor(list(pages) + [0] * (bucket - n), dtype=torch.long,
                              device=self.device)
        with torch.inference_mode():
            for t, raw, want in staged:
                host = torch.zeros((bucket, *want[1:]), dtype=t.dtype)
                host[:n] = torch.frombuffer(bytearray(raw), dtype=t.dtype).reshape(want)
                t.index_copy_(0, ids, host.to(self.device))
        return pool

    # -- step functions ----------------------------------------------------------

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        if isinstance(x, torch.Tensor):  # already on the device (draft chains)
            return x.to(self.device, dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    def _row_idx(self, adapter_idx, rows: int) -> Optional[torch.Tensor]:
        """An optional per-row adapter index as a ``(rows,)`` int32 device
        tensor (None: slot 0 everywhere); None on an engine without slots,
        whose model has none to route."""
        if not self.adapter_slots:
            return None
        if adapter_idx is None:
            return torch.zeros(rows, dtype=torch.int32, device=self.device)
        idx = np.asarray(adapter_idx, np.int32)
        if idx.shape != (rows,):
            raise ValueError(f"adapter_idx must have shape ({rows},), got {idx.shape}")
        return self._tensor(idx)

    def _forward(self, ids, positions, pool, block_tables, row_map=None, adapter_idx=None,
                 model=None, cache=None):
        with torch.inference_mode():
            return (self.model if model is None else model)(
                self._tensor(ids, torch.long),
                self._tensor(positions),
                pool,
                None if block_tables is None else self._tensor(block_tables),
                None if row_map is None else self._tensor(row_map),
                cache=cache,
                adapter_idx=adapter_idx,
            )

    def prefill(self, ids, lengths=None, adapter_idx=None) -> Tuple[torch.Tensor, Cache]:
        """A right-padded prompt batch ``ids`` ``(B, T)`` at positions
        ``0..T-1`` into a fresh cache of ``B`` rows: the full logits ``(B, T,
        V)`` and the cache.  ``T`` must be <= ``cache_size`` (bucket prompts
        with :func:`bucket_length` first).  Pads need no mask: an entry a pad
        writes at ``j`` is seen only from position ``j`` on, which decode
        overwrites before it attends.  ``lengths`` is accepted for the
        reference's signature and unused; ``adapter_idx`` ``(B,)`` each row's
        slot."""
        B, T = np.shape(ids)
        if T > self.cache_size:
            raise ValueError(f"prompt length {T} exceeds cache capacity {self.cache_size}")
        positions = np.tile(np.arange(T, dtype=np.int32), (B, 1))
        cache = self.init_cache(B)
        idx = self._row_idx(adapter_idx, B)
        logits = self._forward(ids, positions, None, None, adapter_idx=idx, cache=cache)
        return logits, cache

    def decode(self, cache: Cache, token, pos, adapter_idx=None) -> Tuple[torch.Tensor, Cache]:
        """One decode step: ``token``/``pos`` ``(B, 1)`` (each row writes at
        its ``pos``, then attends to entries ``<= pos``), ``adapter_idx``
        ``(B,)``.  Returns logits ``(B, V)`` and the cache, updated in place."""
        idx = self._row_idx(adapter_idx, np.shape(token)[0])
        logits = self._forward(token, pos, None, None, adapter_idx=idx, cache=cache)
        return logits[:, -1, :], cache

    @torch.no_grad()
    def insert(self, dcache: Cache, pcache: Cache, slot: int) -> Cache:
        """Copy a prefilled cache (batch 1) into row ``slot`` of the decode
        cache, in place; ``slot`` clamps as JAX's ``dynamic_update_slice``
        clamps its start.  Returns ``dcache``."""
        for dst, src in zip(dcache, pcache):
            for name, d in dst.items():
                n = src[name].shape[0]
                start = min(max(int(slot), 0), d.shape[0] - n)
                d[start : start + n].copy_(src[name])
        return dcache

    def prefill_chunk(
        self, ids, start: int, pool: Pool, block_table, adapter_idx=None
    ) -> Tuple[torch.Tensor, Pool]:
        """One chunk ``(1, chunk_size)`` of a prompt at absolute positions
        ``start ..`` through ``block_table`` ``(1, W)``; ``adapter_idx`` the
        request's slot, ``(1,)``.  Returns the chunk's logits ``(1,
        chunk_size, V)`` and the (updated) pool."""
        self._require_paged()
        B, T = np.shape(ids)
        positions = start + np.broadcast_to(np.arange(T, dtype=np.int32)[None, :], (B, T))
        idx = self._row_idx(adapter_idx, B)
        return self._forward(ids, positions, pool, block_table, adapter_idx=idx), pool

    def decode_paged(
        self, pool: Pool, token, pos, block_tables, adapter_idx=None
    ) -> Tuple[torch.Tensor, Pool]:
        """One decode step: ``token``/``pos`` ``(B, 1)``, ``block_tables``
        ``(B, W)``, ``adapter_idx`` ``(B,)`` each row's slot.  Rows without a
        decoding request carry all-null tables.  Returns logits ``(B, V)``
        and the pool."""
        self._require_paged()
        idx = self._row_idx(adapter_idx, np.shape(token)[0])
        logits = self._forward(token, pos, pool, block_tables, adapter_idx=idx)
        return logits[:, -1, :], pool

    def step_paged(
        self, pool: Pool, ids, positions, block_tables, row_map, adapter_idx=None
    ) -> Tuple[torch.Tensor, Pool]:
        """One packed mixed-batch step: ``ids``/``positions`` ``(1, Tb)``,
        ``row_map`` ``(Tb,)`` the block-table row of each token,
        ``block_tables`` ``(rows, W+1)`` — every slot's table plus a trailing
        null column and a final all-null pad row.  ``adapter_idx`` is per
        token here, ``(Tb,)``: the grouped kernel sees one row per packed
        token.  Returns the window's logits ``(1, Tb, V)`` and the pool."""
        self._require_paged()
        idx = self._row_idx(adapter_idx, np.shape(ids)[1])
        return self._forward(ids, positions, pool, block_tables, row_map, idx), pool

    def verify_paged(
        self, pool: Pool, tokens, pos, block_tables, adapter_idx=None
    ) -> Tuple[torch.Tensor, Pool]:
        """Speculative verify (``relora_tpu/serve/engine.py:948-975``):
        ``tokens``/``pos`` ``(B, S)``, ``S = spec_k + 1`` (the pending token
        then the drafts, at consecutive positions); ``block_tables`` ``(B,
        W+1)``, each row's table plus a trailing null column, so a write past
        ``cache_size`` lands in the null page.  Rows without a decoding
        request carry all-null tables and ``pos = cache_size``.
        ``adapter_idx`` ``(B,)`` is per row, over the whole window.  Returns
        the window's logits ``(B, S, V)`` (slot ``i`` judges draft ``i``, the
        last is the bonus distribution) and the pool.  A rejected draft needs
        no rollback: its K/V lies inside the request's admission allocation
        (or the null page) and is written over before any query sees it."""
        self._require_paged()
        idx = self._row_idx(adapter_idx, np.shape(tokens)[0])
        return self._forward(tokens, pos, pool, block_tables, adapter_idx=idx), pool

    # -- the draft model (--spec model) -------------------------------------------

    @torch.no_grad()
    def load_draft_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Build the draft decode model on the engine's device from a state
        dict of the base's config (``relora_tpu/serve/engine.py:724-745``):
        every tensor of the base model needs a twin of its shape, cast to the
        model's dtype.  The draft shares the one page pool; its requests own
        page runs of their own.  Refused on an engine with adapter slots."""
        if self.adapter_slots:
            raise ValueError(
                "draft models and adapter slots are mutually exclusive: the "
                "draft is a merged base with no tenant slots (serve the "
                "draft from a dedicated replica instead)"
            )
        live = self.model.state_dict()
        for name, t in live.items():
            if name not in params:
                raise ValueError(f"draft checkpoint is missing param leaf {name!r}")
            if tuple(params[name].shape) != tuple(t.shape):
                raise ValueError(
                    f"draft leaf {name!r} has shape {tuple(params[name].shape)}, "
                    f"expected {tuple(t.shape)}"
                )
        draft = build_decode_model(
            self.config, dtype=self.dtype, device=self.device,
            attention_arm=self.model.attention_arm, lora=self._lora,
        )
        for name, t in draft.state_dict().items():
            t.copy_(params[name])
        self.draft_model = draft

    def _require_draft(self) -> CausalLM:
        if self.draft_model is None:
            raise ValueError("no draft model loaded (call load_draft_params first)")
        return self.draft_model

    def draft_prefill_chunk(
        self, ids, start: int, pool: Pool, block_table
    ) -> Tuple[torch.Tensor, Pool]:
        """``prefill_chunk`` through the draft model: the same chunk and
        positions, written through the draft's own block table ``(1, W)``."""
        draft = self._require_draft()
        B, T = np.shape(ids)
        positions = start + np.broadcast_to(np.arange(T, dtype=np.int32)[None, :], (B, T))
        return self._forward(ids, positions, pool, block_table, model=draft), pool

    def draft_decode_paged(
        self, pool: Pool, token, pos, block_tables
    ) -> Tuple[torch.Tensor, Pool]:
        """One draft proposal step: ``decode_paged`` through the draft model
        over the draft block tables ``(B, W)``; ``token`` may be a device
        tensor (the previous step's argmax).  Returns logits ``(B, V)``."""
        draft = self._require_draft()
        logits = self._forward(token, pos, pool, block_tables, model=draft)
        return logits[:, -1, :], pool

    # -- warmup --------------------------------------------------------------------

    def default_prompt_buckets(self) -> Tuple[int, ...]:
        """Every prefill shape a prompt can land in: powers of two from the
        bucket minimum up, capped at ``cache_size`` (itself a bucket when it
        is not a power of two)."""
        buckets: List[int] = []
        t = bucket_length(1)
        while t < self.cache_size:
            buckets.append(t)
            t *= 2
        buckets.append(self.cache_size)
        return tuple(buckets)

    def warmup(self, batch: int, *, packed: bool = False) -> dict:
        """Run every serving shape once before traffic arrives
        (``relora_tpu/serve/engine.py:1152``).  Contiguous engine: one
        ``prefill`` per bucket of :meth:`default_prompt_buckets` (every
        bucket a prompt can land in), one ``insert`` and one ``(batch, 1)``
        ``decode``.  Paged engine: the ``(1, chunk_size)`` prefill chunk
        and the ``(batch, 1)`` decode (and the ``(batch, spec_k+1)`` verify
        window when ``spec_k`` is set), or, ``packed``, one ``step_paged``
        per bucket of :meth:`packed_buckets`.  The port compiles no program,
        but the first launch of each CUDA kernel builds and loads it and the
        first GEMM of a shape creates cuBLAS's handle and workspace: an
        online server pays that here, not inside a request.  Paged writes
        land in the null page of a pool of their own, contiguous ones in a
        cache of their own.  A contiguous engine with adapter slots also
        writes a zero adapter into the last slot, as the reference does to
        compile its slot write (warm up before preloading adapters).

        Returns the reference's report keys, filled with what ran:
        ``shapes``, ``compiles`` (one ``{"fn", "duration_s", "reason"}`` per
        shape run, its wall seconds ending in a device synchronize) and
        ``n_compiles``, the number of shapes run."""
        runs: List[Tuple[str, list, Callable]] = []
        if not self.paged:
            buckets = list(self.default_prompt_buckets())
            for T in buckets:
                runs.append(("prefill", [1, T], lambda T=T: self.prefill(np.zeros((1, T), np.int32))))
            cache = self.init_cache(batch)
            runs.append(("insert", [[batch], [1]], lambda: self.insert(cache, self.init_cache(1), 0)))
            runs.append(("decode", [batch, 1], lambda: self.decode(
                cache, np.zeros((batch, 1), np.int32), np.zeros((batch, 1), np.int32),
            )))
            if self.adapter_slots:
                runs.append(("adapter_write", [self.adapter_slots],
                             lambda: self.write_adapter_slot(self.adapter_slots - 1, {}, 0.0)))
        elif packed:
            buckets = list(self.packed_buckets())
            pool = self.init_pool()
            W = self.block_table_width
            for Tb in buckets:
                runs.append(("step_paged", [1, Tb], lambda Tb=Tb: self.step_paged(
                    pool, np.zeros((1, Tb), np.int32), np.full((1, Tb), self.cache_size, np.int32),
                    np.zeros((batch + 1, W + 1), np.int32), np.full((Tb,), batch, np.int32),
                )))
        else:
            pool = self.init_pool()
            W = self.block_table_width
            runs.append(("prefill_chunk", [1, self.chunk_size], lambda: self.prefill_chunk(
                np.zeros((1, self.chunk_size), np.int32), 0, pool, np.zeros((1, W), np.int32),
            )))
            runs.append(("decode_paged", [batch, 1], lambda: self.decode_paged(
                pool, np.zeros((batch, 1), np.int32), np.zeros((batch, 1), np.int32),
                np.zeros((batch, W), np.int32),
            )))
            if self.spec_k > 0:
                S = self.spec_k + 1
                runs.append(("verify_paged", [batch, S], lambda: self.verify_paged(
                    pool, np.zeros((batch, S), np.int32),
                    np.full((batch, S), self.cache_size, np.int32),
                    np.zeros((batch, W + 1), np.int32),
                )))
        compiles = []
        shapes: dict = {}
        for fn, shape, run in runs:
            t0 = time.perf_counter()
            run()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            compiles.append(
                {"fn": fn, "duration_s": round(time.perf_counter() - t0, 4), "reason": "warmup"}
            )
            shapes.setdefault(fn, []).append(shape)
        report = {"batch": batch, "prompt_buckets": [] if self.paged else buckets}
        if self.paged:
            report.update(kv_dtype=self.kv_dtype, spec_k=self.spec_k)
        report["shapes"] = {
            fn: v if fn in ("step_paged", "prefill") else v[0] for fn, v in shapes.items()
        }
        report.update(n_compiles=len(compiles), compiles=compiles)
        if self.paged and packed:
            report["packed_buckets"] = buckets
            report["token_budget"] = self.token_budget
        return report

    def packed_buckets(self) -> Tuple[int, ...]:
        """Packed-step sizes: halving from ``token_budget`` down to 8."""
        if not self.token_budget:
            raise ValueError("engine was built without token_budget: no packed step")
        buckets = set()
        t = self.token_budget
        while True:
            buckets.add(t)
            if t <= 8:
                break
            t = max(8, t // 2)
        return tuple(sorted(buckets))


    # -- one-shot batch generation ---------------------------------------------------

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        *,
        max_new_tokens: int,
        sampling: SamplingParams = SamplingParams(),
        eos_id: Optional[int] = None,
        seed: int = 0,
        adapter_idx: Optional[Sequence[int]] = None,
    ) -> List[List[int]]:
        """Batch generation without continuous batching
        (``relora_tpu/serve/engine.py:1418-1485``): every prompt right-padded
        to one bucket, one ``prefill``, then ``decode`` steps until every row
        has hit ``eos_id`` or ``max_new_tokens``.  The one-shot ``--prompt``
        path and a parity oracle; the scheduler is the serving path.  Runs on
        a paged engine too, through the contiguous cache.

        Sampled draws come from :func:`~relora_tpu_torch.serve.sampling.
        step_generator` ``(seed, step)``, one stream a step shared by the
        batch (the reference folds ``step`` into its key), so only greedy
        output is token-identical to the JAX package."""
        if not prompts:
            return []
        lengths = np.array([len(p) for p in prompts], np.int64)
        if lengths.min() < 1:
            raise ValueError("empty prompt")
        T = min(bucket_length(int(lengths.max())), self.cache_size)
        if int(lengths.max()) + max_new_tokens > self.cache_size:
            raise ValueError(
                f"prompt ({lengths.max()}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds cache capacity {self.cache_size}"
            )
        B = len(prompts)
        ids = np.zeros((B, T), np.int32)
        for i, p in enumerate(prompts):
            ids[i, : lengths[i]] = np.asarray(p, np.int32)
        logits, cache = self.prefill(ids, lengths, adapter_idx=adapter_idx)
        last = logits[torch.arange(B, device=logits.device), torch.as_tensor(lengths - 1)]

        def draw(step_logits, step):
            gens = [step_generator(seed, step)] * B  # one stream, rows in turn
            return sample(step_logits, gens, temperature=sampling.temperature,
                          top_k=sampling.top_k, top_p=sampling.top_p)

        token = draw(last, 0)
        pos = lengths.astype(np.int32)
        out: List[List[int]] = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        for step in range(max_new_tokens):
            host = token.cpu().numpy()
            for i in range(B):
                if not done[i]:
                    out[i].append(int(host[i]))
                    if eos_id is not None and host[i] == eos_id:
                        done[i] = True
            if done.all() or step == max_new_tokens - 1:
                break
            step_logits, cache = self.decode(cache, host[:, None], pos[:, None], adapter_idx)
            pos = pos + 1
            token = draw(step_logits, step + 1)
        return out


def compute_dtype(name: str) -> torch.dtype:
    """``"f32"``/``"bf16"`` (the CLI's ``--dtype``) to a torch dtype."""
    return _DTYPES[name]
