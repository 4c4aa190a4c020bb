"""Continuous batching over the contiguous and the paged engine.

Counterpart of ``relora_tpu/serve/scheduler.py``:

- :class:`ContinuousBatchingScheduler` is the incremental core —
  ``submit`` queues a validated request, ``step`` runs one round and
  returns the requests that finished in it, ``cancel`` frees a request
  mid-flight, ``run`` submits a batch and steps until idle.  Its own round
  serves the contiguous cache by prefill-on-admission: each request admitted
  to a free slot prefills alone (batch 1, its length bucketed), its first
  token is sampled from that prefill, and its cache row is copied into the
  slot of the persistent ``(max_batch, cache_size)`` decode cache; then one
  decode runs over all ``max_batch`` rows, free ones included (a free row
  decodes at its stale position, hidden by the mask and overwritten by the
  next insert, through adapter slot 0).
- :class:`PagedContinuousBatchingScheduler` runs budgeted rounds: expire
  deadlines, admit pending requests (page allocation and a prefix-cache
  lookup, all-or-nothing on the worst-case page count; the queue head waits
  when the pool is exhausted), run at most one prefill chunk for the oldest
  prefilling slot, then one paged decode over every decoding slot.  With
  ``packed=True`` each round is ONE ``step_paged`` dispatch carrying every
  decoding row plus oldest-first prefill tokens from as many slots as the
  engine's token budget admits.

Sampling is keyed by ``(seed, uid, token_index)``, never by slot or step,
so a request's tokens do not depend on what shares its batch.

Multi-tenant adapters (``adapter_registry``, an engine with
``adapter_slots``): a request's ``adapter`` is pinned to a slot at admission
(the request stays queued while every slot is pinned), every forward routes
each row (each packed token) to its request's slot, free rows and pad
tokens to slot 0, and the pin drops at retirement.  The prefix cache is keyed
per adapter, so a tenant never reads pages another tenant's adapter wrote.

Speculative decoding (``spec="ngram"`` or ``"model"``, an engine with
``spec_k``; ``relora_tpu/serve/scheduler.py:690-720``): each round drafts up
to ``spec_k`` tokens per decoding row, by prompt lookup on the host or by
``spec_k`` greedy steps of a draft model, then ONE ``(batch, spec_k+1)``
verify forward scores every row's window and a host walk commits the
longest accepted prefix plus one token (:func:`~relora_tpu_torch.serve.
sampling.spec_verify_draws`).  Greedy rows accept by argmax match, so their
output is the plain drain's token for token.  A row drafts at most its
remaining budget minus one, so no window writes past the request's
admission allocation and a rejected draft needs no rollback.  A round in
which no row drafted takes the plain decode.  Packed rounds carry the
windows inside the one ``step_paged`` dispatch.

Disaggregated roles (``role="prefill"`` / ``"decode"``,
``relora_tpu/serve/scheduler.py:731-761``, ``:1036-1266``): a prefill-role
scheduler hands each finished prompt's page run, with its first token, to
``migration_sink`` (set by the server) and parks the slot as ``migrating``
until the server reports the handoff's outcome: ``migration_commit`` (the
peer finished the stream), ``migration_failed`` (no token reached the
client: decode locally, token-identical) or ``migration_abort`` (the peer
died mid-stream).  A decode-role scheduler adopts such a run through
``submit_migrated`` into free pages and a free slot, at the donor's
position and with the donor's uid, so the sampling keys ``(uid,
token_index)`` do not change.  ``disagg_stats`` holds the counters.

Telemetry (``relora_tpu/serve/scheduler.py``): ``metrics`` (a
:class:`~relora_tpu_torch.utils.logging.MetricsLogger`) receives one
``serve/*`` record per round and one per finished request; ``tracer`` gets
the ``prefill`` and ``insert`` (contiguous) or ``prefill_chunk`` (paged),
``decode_step`` and per-request ``decode`` spans under each request's
``trace_id`` (``submit(trace_id=)``); ``obs_registry`` (the server's
``ServeMetrics``) the per-phase histograms, the round's gauges and, paged,
the dispatch, round and speculative counters.  All three default to off.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from relora_tpu_torch.obs.tracer import NoopTracer
from relora_tpu_torch.serve import wire
from relora_tpu_torch.serve.adapters import BASE_ADAPTER
from relora_tpu_torch.serve.engine import InferenceEngine, bucket_length
from relora_tpu_torch.serve.paging import PageAllocator, PrefixCache, pages_needed
from relora_tpu_torch.serve.sampling import request_generator, sample, spec_verify_draws
from relora_tpu_torch.utils import faults

logger = logging.getLogger(__name__)

#: uid, token id, token index within the generation (0 = first sampled token)
TokenCallback = Callable[[int, int, int], None]
#: called exactly once per request with its Completion
FinishCallback = Callable[["Completion"], None]


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: token-id prompt plus per-request sampling.
    ``top_k`` is batch-global and lives on the scheduler.  ``spec=False``
    opts the request out of speculative drafting (its tokens follow the same
    distribution either way).  ``adapter`` names a tenant adapter of the
    scheduler's registry; ``None`` decodes the base model (slot 0)."""

    uid: int
    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    spec: bool = True
    adapter: Optional[str] = None


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]
    finish_reason: str  # "eos" | "length" | "timeout" | "cancelled" | "error"
    prompt_tokens: int
    ttft_s: float
    latency_s: float
    error: Optional[str] = None


@dataclasses.dataclass
class _Slot:
    request: Request
    pos: int  # absolute position of the next cache write
    tokens: List[int]
    t_admit: float
    t_first: float
    deadline: Optional[float] = None
    span: Optional[object] = None  # the request's "decode" span, ended at retirement
    adapter_slot: int = 0  # the slot this request's adapter is pinned to


class ContinuousBatchingScheduler:
    """Drains a stream of requests through ``max_batch`` decode slots."""

    def __init__(
        self,
        engine: InferenceEngine,
        *,
        max_batch: int,
        eos_id: Optional[int] = None,
        top_k: int = 0,
        seed: int = 0,
        metrics=None,
        tracer=None,
        obs_registry=None,
        adapter_registry=None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if adapter_registry is not None and not getattr(engine, "adapter_slots", 0):
            raise ValueError(
                "adapter_registry needs an engine built with adapter_slots "
                "(the stacked multi-tenant LoRA layout)"
            )
        self.engine = engine
        self.max_batch = max_batch
        self.eos_id = eos_id
        self.top_k = top_k
        self.seed = seed
        self.metrics = metrics
        self.adapter_registry = adapter_registry
        # tracing is off unless a tracer is given; the HTTP server gives its
        # own Tracer and ServeMetrics
        self.tracer = tracer if tracer is not None else NoopTracer()
        self.obs_registry = obs_registry
        self._step_count = 0
        self._pending: Deque[Request] = deque()
        self._slots: List[Optional[_Slot]] = [None] * max_batch
        self._cache = None  # the contiguous decode cache, made at the first admission
        self._tokens = np.zeros(max_batch, np.int32)
        self._positions = np.zeros(max_batch, np.int32)
        # each row's adapter slot for the grouped kernel; free rows point at
        # slot 0 (the identity adapter), so their garbage decode is base work
        self._adapter_row = np.zeros(max_batch, np.int32)
        self._deadlines: Dict[int, float] = {}
        self._on_token: Dict[int, TokenCallback] = {}
        self._on_finish: Dict[int, FinishCallback] = {}
        self._trace_ids: Dict[int, str] = {}  # uid -> the request's trace id

    def _request_generator(self, req: Request, token_index: int):
        # keyed by (uid, token index): a request's sample stream does not
        # depend on which slot it landed in or what shares its batch
        return request_generator(self.seed, req.uid, token_index)

    # -- incremental API --------------------------------------------------------

    def validate_request(self, req: Request) -> None:
        """Reject requests the decode loop could not serve: empty prompts and
        generations that cannot fit the cache."""
        need = len(req.prompt) + req.max_new_tokens
        if len(req.prompt) < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        if need > self.engine.cache_size:
            raise ValueError(
                f"request {req.uid} needs {need} cache entries, "
                f"capacity is {self.engine.cache_size}"
            )
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.uid}: max_new_tokens must be >= 1, got {req.max_new_tokens}"
            )
        if req.adapter is not None:
            if self.adapter_registry is None:
                raise ValueError(
                    f"request {req.uid}: server is not running with an adapter "
                    "registry (--adapter-dir); 'adapter' is not accepted"
                )
            if not self.adapter_registry.known(req.adapter):
                raise ValueError(f"request {req.uid}: unknown adapter {req.adapter!r}")

    def adapter_stats(self) -> Optional[Dict]:
        """The adapter registry's slot and hit statistics; None without one."""
        if self.adapter_registry is None:
            return None
        return self.adapter_registry.stats()

    def submit(
        self,
        req: Request,
        *,
        on_token: Optional[TokenCallback] = None,
        on_finish: Optional[FinishCallback] = None,
        deadline: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> None:
        """Queue a request for admission at the next ``step()``.
        ``on_token(uid, token, index)`` fires per sampled token, ``on_finish``
        once with the Completion; ``deadline`` is an absolute
        ``time.monotonic()`` bound (past it the request finishes with reason
        ``"timeout"``); ``trace_id`` tags every span the request produces."""
        self.validate_request(req)
        if req.uid in self._deadlines or req.uid in self._on_finish or any(
            r.uid == req.uid for r in self._pending
        ) or any(s is not None and s.request.uid == req.uid for s in self._slots):
            raise ValueError(f"request {req.uid}: uid already in flight")
        if deadline is not None:
            self._deadlines[req.uid] = deadline
        if on_token is not None:
            self._on_token[req.uid] = on_token
        if on_finish is not None:
            self._on_finish[req.uid] = on_finish
        if trace_id is not None:
            self._trace_ids[req.uid] = trace_id
        self._pending.append(req)

    def _observe(self, name: str, value: float) -> None:
        if self.obs_registry is not None:
            self.obs_registry.observe(name, value)

    def cancel(
        self, uid: int, reason: str = "cancelled", detail: Optional[str] = None
    ) -> Optional[Completion]:
        """Free a request's slot (or drop it from the queue) and report its
        partial output; None when the uid is unknown."""
        for req in list(self._pending):
            if req.uid == uid:
                self._pending.remove(req)
                return self._finalize_unadmitted(req, reason, detail)
        for slot_idx, slot in enumerate(self._slots):
            if slot is not None and slot.request.uid == uid:
                return self._retire(slot_idx, reason, detail)
        return None

    def fail_all(self, reason: str = "error", detail: Optional[str] = None) -> List[Completion]:
        """Finish every queued and active request with ``reason`` (the
        model thread's death): each keeps the tokens it has, callbacks fire
        as usual, and nothing touches the device."""
        completions: List[Completion] = []
        for req in list(self._pending):
            self._pending.remove(req)
            completions.append(self._finalize_unadmitted(req, reason, detail))
        for slot_idx, slot in enumerate(self._slots):
            if slot is not None:
                completions.append(self._retire(slot_idx, reason, detail))
        return completions

    def has_work(self) -> bool:
        return bool(self._pending) or any(s is not None for s in self._slots)

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    def step(self) -> List[Completion]:
        """One admit-plus-decode round (``relora_tpu/serve/scheduler.py:
        287-366``): expire deadlines, fill free slots from the queue (a
        prefill and an insert each), then one decode over all ``max_batch``
        rows.  Returns the requests that finished in the round, at admission
        too when the first token already ends one."""
        finished: List[Completion] = []
        # admission runs on the decode loop's critical path: its share of
        # the round is the prefill stall every in-flight stream pays
        t_step = time.monotonic()
        self._expire_deadlines(finished)
        while True:
            self._admit_pass(finished)
            if any(s is not None for s in self._slots) or not self._pending:
                break
            # everything admitted finished at once: admit again
        admit_s = time.monotonic() - t_step
        if not any(s is not None for s in self._slots):
            return finished
        t_decode = time.monotonic()
        n_active = self.active_slots
        with self.tracer.span("decode_step", step=self._step_count, active_slots=n_active):
            logits, self._cache = self.engine.decode(
                self._cache, self._tokens[:, None], self._positions[:, None],
                adapter_idx=self._adapter_row,
            )
            self._step_count += 1
            # one pull of the whole batch's tokens to the host
            next_tokens = self._sample_rows(logits, self._slots).tolist()
        decode_s = time.monotonic() - t_decode
        self._observe("decode_step_seconds", decode_s)
        batch_fill = n_active / self.max_batch
        stall_share = admit_s / max(admit_s + decode_s, 1e-9)
        if self.obs_registry is not None:
            self.obs_registry.set_gauge("batch_fill", batch_fill)
            self.obs_registry.set_gauge("prefill_stall_share", stall_share)
        for slot_idx, slot in enumerate(self._slots):
            if slot is None:
                continue
            tok = next_tokens[slot_idx]
            slot.tokens.append(tok)
            slot.pos += 1
            self._tokens[slot_idx] = tok
            self._positions[slot_idx] = slot.pos
            self._emit_token(slot.request.uid, tok, len(slot.tokens) - 1)
            self._finish_if_done(slot_idx, finished)
        record = None
        if self.metrics is not None:
            record = {
                "serve/decode_step": self._step_count,
                "serve/queue_depth": len(self._pending),
                "serve/active_slots": self.active_slots,
                "serve/batch_fill": round(batch_fill, 4),
                "serve/prefill_stall_s": round(admit_s, 6),
                "serve/prefill_stall_share": round(stall_share, 4),
                # the reference counts jit retraces after warmup here; the
                # port compiles nothing at run time
                "compile/steady_state_retraces": 0,
            }
        self._adapter_gauges(record)
        if record is not None:
            self.metrics.log(record)
        return finished

    def run(self, requests: Iterable[Request]) -> Dict[int, Completion]:
        """Admit-and-decode until every request completes.  Returns
        completions keyed by ``Request.uid``."""
        incoming = list(requests)
        for req in incoming:
            # validate everything before admitting anything
            self.validate_request(req)
        for req in incoming:
            self.submit(req)
        completions: Dict[int, Completion] = {}
        t_start = time.monotonic()
        while self.has_work():
            for completion in self.step():
                completions[completion.uid] = completion
        logger.info(
            f"drained {len(completions)} requests in {time.monotonic() - t_start:.2f}s "
            f"({self._step_count} decode steps)"
        )
        return completions

    # -- internals -------------------------------------------------------------

    def _admit_pass(self, finished: List[Completion]) -> None:
        """Fill free slots, in slot order, from the queue head.  A request
        whose deadline passed while queued times out without a prefill; one
        whose adapter fails to load finishes with ``"error"``; when every
        adapter slot is pinned the head stays queued (FIFO) until a
        retirement drops a pin."""
        for slot_idx in range(self.max_batch):
            if self._slots[slot_idx] is not None or not self._pending:
                continue
            req = self._pending.popleft()
            deadline = self._deadlines.get(req.uid)
            if deadline is not None and time.monotonic() >= deadline:
                finished.append(self._finalize_unadmitted(req, "timeout"))
                continue
            try:
                adapter_slot = self._acquire_adapter(req)
            except Exception as e:
                logger.warning(f"request {req.uid}: adapter load failed: {e!r}")
                finished.append(
                    self._finalize_unadmitted(req, "error", f"adapter load failed: {e}")
                )
                continue
            if adapter_slot is None:
                self._pending.appendleft(req)
                return
            t_admit = time.monotonic()
            self._cache, first = self._admit(req, slot_idx, self._ensure_cache(), adapter_slot)
            self._slots[slot_idx] = _Slot(
                request=req,
                pos=len(req.prompt),
                tokens=[first],
                t_admit=t_admit,
                t_first=time.monotonic(),
                deadline=deadline,
                span=self.tracer.start_span(
                    "decode", trace_id=self._trace_ids.get(req.uid), uid=req.uid
                ),
                adapter_slot=adapter_slot,
            )
            self._tokens[slot_idx] = first
            self._positions[slot_idx] = len(req.prompt)
            self._adapter_row[slot_idx] = adapter_slot
            self._emit_token(req.uid, first, 0)
            self._finish_if_done(slot_idx, finished)

    def _ensure_cache(self):
        if self._cache is None:
            self._cache = self.engine.init_cache(self.max_batch)
        return self._cache

    def _admit(self, req: Request, slot_idx: int, cache, adapter_slot: int = 0):
        """Prefill one request alone (batch 1, its length bucketed), sample
        its first token from the logits at its last prompt position, and
        copy its cache row into ``slot_idx``.  Returns (cache, first token)."""
        L = len(req.prompt)
        T = min(bucket_length(L), self.engine.cache_size)
        ids = np.zeros((1, T), np.int32)
        ids[0, :L] = np.asarray(req.prompt, np.int32)
        tid = self._trace_ids.get(req.uid)
        t0 = time.monotonic()
        # the first token's host pull is the span's sync point
        with self.tracer.span("prefill", trace_id=tid, uid=req.uid, prompt_tokens=L, bucket=T):
            logits, pcache = self.engine.prefill(ids, adapter_idx=[adapter_slot])
            first = self._sample_one(logits[:, L - 1, :], req)
        t1 = time.monotonic()
        self._observe("prefill_seconds", t1 - t0)
        with self.tracer.span("insert", trace_id=tid, uid=req.uid, slot=slot_idx):
            cache = self.engine.insert(cache, pcache, slot_idx)
        del pcache, logits  # the batch-1 cache is spent (the reference donates it)
        self._observe("insert_seconds", time.monotonic() - t1)
        return cache, first

    def _acquire_adapter(self, req: Request) -> Optional[int]:
        """Pin the request's adapter for admission: its slot, or None when
        every slot is pinned (the request stays queued).  Raises when the
        adapter fails to load."""
        if self.adapter_registry is None:
            return 0
        return self.adapter_registry.acquire(req.adapter)

    def _release_adapter(self, req: Request) -> None:
        if self.adapter_registry is not None and req.adapter is not None:
            self.adapter_registry.release(req.adapter)

    def _count_adapter_request(self, req: Request) -> None:
        if self.adapter_registry is not None and self.obs_registry is not None:
            self.obs_registry.inc(
                "adapter_requests_total", label=("adapter", req.adapter or "base")
            )

    def _adapter_gauges(self, record: Optional[Dict] = None) -> None:
        """Publish the registry's occupancy beside the round's gauges, and
        into the round's record when one is being built."""
        if self.adapter_registry is None:
            return
        stats = self.adapter_registry.stats()
        if self.obs_registry is not None:
            self.obs_registry.set_gauge("adapter_slots_used", stats["slots_used"])
            self.obs_registry.set_gauge("adapter_hit_rate", stats["hit_rate"])
        if record is not None:
            record["serve/adapter_slots_used"] = stats["slots_used"]
            record["serve/adapter_evictions_total"] = stats["evictions_total"]
            record["serve/adapter_hit_rate"] = stats["hit_rate"]

    def _expire_deadlines(self, finished: List[Completion]) -> None:
        if not self._deadlines:
            return
        now = time.monotonic()
        for slot_idx, slot in enumerate(self._slots):
            if slot is not None and slot.deadline is not None and now >= slot.deadline:
                finished.append(self._retire(slot_idx, "timeout"))

    def _sample_one(self, logits_row, req: Request) -> int:
        """First token of a request (token index 0) from ``(1, V)`` logits."""
        gens = [self._request_generator(req, 0) if req.temperature > 0 else None]
        drawn = sample(
            logits_row, gens, temperature=req.temperature, top_k=self.top_k,
            top_p=req.top_p,
        )
        return int(drawn[0])

    def _sample_rows(self, logits, slots) -> np.ndarray:
        temps = np.zeros(self.max_batch, np.float32)
        top_ps = np.ones(self.max_batch, np.float32)
        gens: List = [None] * self.max_batch
        for slot_idx, slot in enumerate(slots):
            if slot is None:
                continue
            temps[slot_idx] = slot.request.temperature
            top_ps[slot_idx] = slot.request.top_p
            if slot.request.temperature > 0:
                gens[slot_idx] = self._request_generator(slot.request, len(slot.tokens))
        drawn = sample(
            logits, gens, temperature=temps, top_k=self.top_k, top_p=top_ps
        )
        return drawn.cpu().numpy()

    def _emit_token(self, uid: int, token: int, index: int) -> None:
        callback = self._on_token.get(uid)
        if callback is None:
            return
        try:
            callback(uid, token, index)
        except Exception as e:  # a dead stream must not kill the decode loop
            logger.warning(f"request {uid}: token callback failed: {e!r}")
            self._on_token.pop(uid, None)

    def _finish_if_done(self, slot_idx: int, finished: List[Completion]) -> None:
        slot = self._slots[slot_idx]
        last = slot.tokens[-1]
        reason = None
        if self.eos_id is not None and last == self.eos_id:
            reason = "eos"
        elif len(slot.tokens) >= slot.request.max_new_tokens:
            reason = "length"
        if reason is not None:
            finished.append(self._retire(slot_idx, reason))

    def _retire(self, slot_idx: int, reason: str, detail: Optional[str] = None) -> Completion:
        """Evict a slot: build the Completion, free the row, notify."""
        slot = self._slots[slot_idx]
        req = slot.request
        now = time.monotonic()
        completion = Completion(
            uid=req.uid,
            tokens=list(slot.tokens),
            finish_reason=reason,
            prompt_tokens=len(req.prompt),
            ttft_s=slot.t_first - slot.t_admit,
            latency_s=now - slot.t_admit,
            error=detail,
        )
        self._slots[slot_idx] = None
        self._adapter_row[slot_idx] = 0  # free rows decode the identity adapter
        self._release_adapter(req)
        self._count_adapter_request(req)
        if slot.span is not None:
            slot.span.set(finish_reason=reason, output_tokens=len(completion.tokens)).end()
            self._observe("decode_seconds", now - slot.t_first)
        n = len(completion.tokens)
        self._log_request(completion, (n - 1) / max(now - slot.t_first, 1e-9) if n > 1 else 0.0)
        self._finalize(completion)
        return completion

    def _log_request(self, completion: Completion, decode_tokens_per_s: float) -> None:
        """The finished request's ``metrics.jsonl`` record."""
        if self.metrics is not None:
            self.metrics.log({
                "serve_request": completion.uid,
                "serve/prompt_tokens": completion.prompt_tokens,
                "serve/output_tokens": len(completion.tokens),
                "serve/finish_reason": completion.finish_reason,
                "serve/ttft_s": completion.ttft_s,
                "serve/latency_s": completion.latency_s,
                "serve/decode_tokens_per_s": decode_tokens_per_s,
            })

    def _finalize_unadmitted(
        self, req: Request, reason: str, detail: Optional[str] = None
    ) -> Completion:
        """A request that never reached a slot: empty output, zero times."""
        self._count_adapter_request(req)
        completion = Completion(
            uid=req.uid, tokens=[], finish_reason=reason,
            prompt_tokens=len(req.prompt), ttft_s=0.0, latency_s=0.0, error=detail,
        )
        self._log_request(completion, 0.0)
        self._finalize(completion)
        return completion

    def _finalize(self, completion: Completion) -> None:
        self._deadlines.pop(completion.uid, None)
        self._on_token.pop(completion.uid, None)
        self._trace_ids.pop(completion.uid, None)
        callback = self._on_finish.pop(completion.uid, None)
        if callback is None:
            return
        try:
            callback(completion)
        except Exception as e:
            logger.warning(f"request {completion.uid}: finish callback failed: {e!r}")


@dataclasses.dataclass
class _PagedSlot(_Slot):
    pages: List[int] = dataclasses.field(default_factory=list)  # logical order
    shared_pages: int = 0  # leading pages borrowed from the prefix cache
    prefill_progress: int = 0  # prompt tokens already written to the pool
    decoding: bool = False  # first token sampled; joins the decode batch
    seq: int = 0  # admission order; prefill is scheduled oldest-first
    draft_pages: List[int] = dataclasses.field(default_factory=list)  # spec="model"
    migrating: bool = False  # the handoff to a decode peer is in flight


class PagedContinuousBatchingScheduler(ContinuousBatchingScheduler):
    """Continuous batching over the paged engine: budgeted rounds instead
    of prefill-on-admission (see the module docstring)."""

    #: longest context suffix the prompt-lookup drafter tries to match
    _NGRAM_MAX = 3

    def __init__(
        self,
        engine: InferenceEngine,
        *,
        prefix_cache: bool = True,
        prefix_cache_entries: int = 256,
        spec: str = "off",
        packed: bool = False,
        role: str = "mixed",
        **kwargs,
    ):
        super().__init__(engine, **kwargs)
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(f"role must be 'prefill', 'decode', or 'mixed', got {role!r}")
        if spec not in ("off", "ngram", "model"):
            raise ValueError(f"spec must be 'off', 'ngram', or 'model', got {spec!r}")
        if spec != "off" and getattr(engine, "spec_k", 0) < 1:
            raise ValueError(
                f"spec={spec!r} needs an engine built with spec_k >= 1 "
                "(the verify window is (batch, spec_k+1))"
            )
        if spec == "model":
            if getattr(engine, "draft_model", None) is None:
                raise ValueError(
                    "spec='model' needs a draft model: call "
                    "engine.load_draft_params(...) before building the scheduler"
                )
            if packed:
                raise ValueError(
                    "spec='model' is incompatible with packed=True (the draft "
                    "proposal loop runs on the per-row decode path)"
                )
            if role != "mixed":
                raise ValueError(
                    "spec='model' needs role='mixed': draft KV pages cannot "
                    "migrate between disaggregated peers"
                )
            # base and draft prefill stay in lockstep, so prefix sharing
            # (which skips base prefill the draft still needs) is off
            prefix_cache = False
        # the disaggregated tier: the server sets migration_sink on a
        # prefill-role scheduler (called on the model thread; must not block)
        self.role = role
        self.migration_sink: Optional[Callable[[Dict[str, Any], list], bool]] = None
        # the fleet prefix directory's client: the server sets prefix_fetch
        # (digests -> (n_tokens, entries, nbytes) or None; called on the
        # model thread, blocking) when it has a --fleet-url
        self.prefix_fetch: Optional[Callable[[List[str]], Any]] = None
        self._prefix_fetch_tried: set = set()
        self._pages_migrated = 0
        self._migration_bytes = 0
        self._migration_failures = 0
        self._migrated_inserts = 0
        self._prefix_fetches = 0
        self._prefix_fetch_failures = 0
        if not getattr(engine, "paged", False):
            raise ValueError("PagedContinuousBatchingScheduler needs a paged engine")
        self._spec = spec
        self._spec_drafted = 0  # drafted tokens, cumulative
        self._spec_accepted = 0  # accepted drafted tokens, cumulative
        self._spec_rounds = 0  # verify forwards, cumulative
        self._packed = packed
        if packed:
            if not engine.token_budget:
                raise ValueError("packed=True needs an engine built with token_budget")
            # every decoding row's whole window fits one dispatch: the budget
            # throttles prefill, never decode
            floor = self.max_batch * (engine.spec_k + 1 if spec == "ngram" else 1)
            if engine.token_budget < floor:
                raise ValueError(
                    f"token_budget ({engine.token_budget}) cannot hold every "
                    f"decode row's window: need >= {floor} "
                    f"(max_batch x window size)"
                )
        self.allocator = PageAllocator(
            engine.num_pages,
            engine.page_size,
            page_bytes=engine.pool_bytes() // engine.num_pages,
        )
        self.prefix_cache = (
            PrefixCache(self.allocator, max_entries=prefix_cache_entries)
            if prefix_cache
            else None
        )
        self._pool = None  # allocated on first admission, then persistent
        # decode block tables: all-null rows for free / prefilling slots, so
        # their garbage decode write lands in the null page
        self._tables = np.zeros((self.max_batch, engine.block_table_width), np.int32)
        # spec="model": the draft's tables, null rows alike
        self._draft_tables = np.zeros((self.max_batch, engine.block_table_width), np.int32)
        # the packed step's tables: every slot's (W plus a trailing null
        # column) and a final all-null row that padding tokens point at
        self._ptables = np.zeros(
            (self.max_batch + 1, engine.block_table_width + 1), np.int32
        )
        self._admit_seq = 0
        self._pad_tokens = 0  # prefill chunk padding written, cumulative
        self._prefill_tokens = 0  # real prompt tokens written, cumulative
        # dispatch economics, cumulative: rounds, model dispatches, and the
        # dispatched window positions (all, and those carrying live work)
        self._round_total = 0
        self._dispatch_total = 0
        self._dispatch_tokens = 0
        self._dispatch_tokens_real = 0
        self._admit_time_s = 0.0  # admission and prefill wall time
        self._decode_time_s = 0.0  # decode / packed step wall time
        self._kv_cache_bytes = engine.pool_bytes()
        self._kv_bytes_per_token = engine.kv_bytes_per_token()

    def _ensure_pool(self):
        if self._pool is None:
            self._pool = self.engine.init_pool()
        return self._pool

    @staticmethod
    def _prefix_salt(req: Request) -> Optional[str]:
        """The prefix-cache key's salt: the adapter's name, or None for the
        base model (whose pages every base request shares)."""
        return None if req.adapter in (None, BASE_ADAPTER) else req.adapter

    # -- admission ---------------------------------------------------------------

    def _admit_pass(self, finished: List[Completion]) -> None:
        """Fill free slots from the queue head: prefix lookup + page
        allocation only.  Allocation failure leaves the head queued."""
        while self._pending:
            slot_idx = next(
                (i for i in range(self.max_batch) if self._slots[i] is None), None
            )
            if slot_idx is None:
                return
            req = self._pending[0]
            deadline = self._deadlines.get(req.uid)
            if deadline is not None and time.monotonic() >= deadline:
                self._pending.popleft()
                finished.append(self._finalize_unadmitted(req, "timeout"))
                continue
            try:
                adapter_slot = self._acquire_adapter(req)
            except Exception as e:
                logger.warning(f"request {req.uid}: adapter load failed: {e!r}")
                self._pending.popleft()
                finished.append(
                    self._finalize_unadmitted(req, "error", f"adapter load failed: {e}")
                )
                continue
            if adapter_slot is None:
                # every adapter slot pinned by live traffic: the head stays
                # queued (FIFO) and retries once a retirement drops a pin
                return
            need = pages_needed(len(req.prompt) + req.max_new_tokens, self.engine.page_size)
            shared_pages: List[int] = []
            shared_tokens = 0
            if self.prefix_cache is not None:
                shared_pages, shared_tokens = self.prefix_cache.lookup(
                    req.prompt, self._prefix_salt(req)
                )
                if (
                    not shared_pages
                    and self.prefix_fetch is not None
                    and req.uid not in self._prefix_fetch_tried
                ):
                    # one fetch a uid: a miss or a failed peer falls open
                    # to local prefill, never a retry loop
                    if len(self._prefix_fetch_tried) > 8192:
                        self._prefix_fetch_tried.clear()
                    self._prefix_fetch_tried.add(req.uid)
                    shared_pages, shared_tokens = self._fetch_prefix(req)
            # spec="model": the draft's own page run in the shared pool,
            # allocated with the base's or not at all
            draft_need = need if self._spec == "model" else 0
            fresh = self.allocator.alloc(need - len(shared_pages) + draft_need)
            if fresh is None and self.prefix_cache is not None:
                # under pressure: drop idle prefix entries (LRU) and retry
                self.prefix_cache.evict(need - len(shared_pages) + draft_need)
                fresh = self.allocator.alloc(need - len(shared_pages) + draft_need)
            if fresh is None:
                # allocator exhausted: stay queued; pages free as requests retire
                if shared_pages:
                    self.allocator.decref(shared_pages)
                self._release_adapter(req)  # drop the pin while we wait
                return
            self._pending.popleft()
            t_admit = time.monotonic()
            pages = shared_pages + fresh[: need - len(shared_pages)]
            self._slots[slot_idx] = _PagedSlot(
                request=req,
                pos=0,
                tokens=[],
                t_admit=t_admit,
                t_first=t_admit,
                deadline=deadline,
                pages=pages,
                shared_pages=len(shared_pages),
                prefill_progress=shared_tokens,
                seq=self._admit_seq,
                adapter_slot=adapter_slot,
                draft_pages=fresh[need - len(shared_pages):],
            )
            self._admit_seq += 1
            self._tokens[slot_idx] = 0
            self._positions[slot_idx] = 0
            self._tables[slot_idx, :] = 0
            self._draft_tables[slot_idx, :] = 0
            # the packed table row is live from admission: prefill tokens
            # route through it the round they are admitted
            self._ptables[slot_idx, :] = 0
            self._ptables[slot_idx, : len(pages)] = pages
            self._adapter_row[slot_idx] = adapter_slot

    def _arm_decoding(self, slot_idx: int, first_id: int, finished: List[Completion]) -> None:
        """The prompt is in the pool and its first token sampled: register
        the prompt's full pages with the prefix cache and join decode."""
        slot = self._slots[slot_idx]
        req = slot.request
        L = len(req.prompt)
        if self.prefix_cache is not None:
            # only pages fully covered by prompt tokens register
            self.prefix_cache.register(list(req.prompt), slot.pages, self._prefix_salt(req))
        slot.decoding = True
        slot.tokens = [first_id]
        slot.pos = L
        slot.t_first = time.monotonic()
        slot.span = self.tracer.start_span(
            "decode", trace_id=self._trace_ids.get(req.uid), uid=req.uid
        )
        self._tokens[slot_idx] = first_id
        self._positions[slot_idx] = L
        self._tables[slot_idx, : len(slot.pages)] = slot.pages
        self._draft_tables[slot_idx, : len(slot.draft_pages)] = slot.draft_pages
        self._emit_token(req.uid, first_id, 0)
        self._finish_if_done(slot_idx, finished)
        self._maybe_migrate(slot_idx)

    # -- the disaggregated handoff (prefill role -> decode peer) ---------------------

    def _find_slot(self, uid: int) -> Optional[int]:
        for slot_idx, slot in enumerate(self._slots):
            if slot is not None and slot.request.uid == uid:
                return slot_idx
        return None

    def _maybe_migrate(self, slot_idx: int) -> None:
        """Donor side: a prefill-role scheduler whose slot just finished its
        prompt exports the prompt's page run and hands ``(record, entries)``
        to ``migration_sink``.  The slot parks as ``migrating``, out of the
        prefill and decode sets, until the server resolves it.  A failed
        export or a refusing sink fails open: the slot decodes locally."""
        if self.role != "prefill" or self.migration_sink is None:
            return
        slot = self._slots[slot_idx]
        if slot is None or slot.migrating or not slot.decoding:
            return  # finished at its first token
        req = slot.request
        n_pages = pages_needed(len(req.prompt), self.engine.page_size)
        try:
            faults.maybe_fail("serve_migrate")
            entries = self.engine.export_page_run(self._ensure_pool(), slot.pages[:n_pages])
        except Exception as e:
            logger.warning(f"request {req.uid}: page-run export failed: {e!r}")
            self._count_migration_failure(req.uid, f"export failed: {e}")
            return  # the slot keeps decoding here, untouched
        record = wire.build_migration_record(
            uid=req.uid,
            prompt=req.prompt,
            max_new_tokens=req.max_new_tokens,
            temperature=req.temperature,
            top_p=req.top_p,
            spec=req.spec,
            adapter=req.adapter,
            first_token=slot.tokens[0],
            position=slot.pos,
            token_index=len(slot.tokens),
            n_pages=n_pages,
        )
        # park: the decode row goes back to the null table, so this round's
        # and every later round's write of it lands in the null page
        slot.migrating = True
        slot.decoding = False
        self._tokens[slot_idx] = 0
        self._positions[slot_idx] = 0
        self._tables[slot_idx, :] = 0
        ok = False
        try:
            ok = bool(self.migration_sink(record, entries))
        except Exception as e:
            logger.warning(f"request {req.uid}: migration sink failed: {e!r}")
        if not ok:
            self.migration_failed(req.uid, "sink rejected handoff")

    def migration_failed(self, uid: int, detail: Optional[str] = None) -> None:
        """Fail open: the handoff ended before the peer relayed a token, so
        decoding resumes here exactly where the prefill left it (the same
        keys and token indices); counted as a migration failure."""
        slot_idx = self._find_slot(uid)
        if slot_idx is None:
            return  # cancelled or expired while the transfer was in flight
        slot = self._slots[slot_idx]
        if not slot.migrating:
            return
        slot.migrating = False
        slot.decoding = True
        self._tokens[slot_idx] = slot.tokens[-1]
        self._positions[slot_idx] = slot.pos
        self._tables[slot_idx, : len(slot.pages)] = slot.pages
        self._count_migration_failure(uid, detail)

    def _count_migration_failure(self, uid: int, detail: Optional[str]) -> None:
        self._migration_failures += 1
        logger.warning(
            f"request {uid}: migration failed open to local decode"
            + (f" ({detail})" if detail else "")
        )
        if self.obs_registry is not None:
            self.obs_registry.inc("migration_failures_total")

    def migration_commit(self, uid: int, bytes_sent: int = 0) -> Optional[Completion]:
        """The peer took the run and the relay delivered its finish: retire
        the donor slot without firing the client's callbacks (the relay owns
        that stream) and free its pages; counts the pages and bytes."""
        slot_idx = self._find_slot(uid)
        if slot_idx is None or not self._slots[slot_idx].migrating:
            return None
        slot = self._slots[slot_idx]
        self._on_token.pop(uid, None)
        self._on_finish.pop(uid, None)
        n_pages = pages_needed(len(slot.request.prompt), self.engine.page_size)
        self._pages_migrated += n_pages
        self._migration_bytes += bytes_sent
        if self.obs_registry is not None:
            self.obs_registry.inc("pages_migrated_total", by=n_pages)
            self.obs_registry.inc("migration_bytes_total", by=bytes_sent)
        return self._retire(slot_idx, "migrated")

    def migration_abort(self, uid: int, detail: Optional[str] = None) -> Optional[Completion]:
        """The peer died after relaying a token: the request cannot be
        replayed, so the server sends the client a typed error finish and
        this retires the donor slot without firing the callbacks."""
        slot_idx = self._find_slot(uid)
        if slot_idx is None or not self._slots[slot_idx].migrating:
            return None
        self._on_token.pop(uid, None)
        self._on_finish.pop(uid, None)
        self._count_migration_failure(uid, detail or "peer died mid-relay")
        return self._retire(slot_idx, "error", detail or "migration_failed")

    def submit_migrated(
        self,
        record: Dict[str, Any],
        entries: Sequence,
        *,
        on_token: Optional[TokenCallback] = None,
        on_finish: Optional[FinishCallback] = None,
        deadline: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> None:
        """Receiver side: adopt a migrated request straight into a decoding
        slot.  Its run is scattered into freshly allocated pages, the decode
        row armed at the donor's position with the donor's first token, and
        the uid kept, so sampling continues with the keys ``(uid,
        token_index)`` unchanged: token-identical to a mixed replica.
        Raises on any missed precondition (a uid in flight, no free slot,
        no adapter capacity, an exhausted pool, an inconsistent or malformed
        run) with nothing allocated: the donor then decodes locally."""
        fields = wire.parse_migration_record(record)
        req = Request(
            uid=fields["uid"],
            prompt=fields["prompt"],
            max_new_tokens=fields["max_new_tokens"],
            temperature=fields["temperature"],
            top_p=fields["top_p"],
            spec=fields["spec"],
            adapter=fields["adapter"],
        )
        self.validate_request(req)
        if req.uid in self._deadlines or req.uid in self._on_finish or any(
            r.uid == req.uid for r in self._pending
        ) or self._find_slot(req.uid) is not None:
            raise ValueError(f"migrated request {req.uid}: uid already in flight")
        L = len(req.prompt)
        n_pages = fields["n_pages"]
        if fields["position"] != L or n_pages != pages_needed(L, self.engine.page_size):
            raise ValueError(
                f"migrated request {req.uid}: inconsistent run "
                f"(position {fields['position']}, n_pages {n_pages}, prompt {L})"
            )
        slot_idx = next((i for i in range(self.max_batch) if self._slots[i] is None), None)
        if slot_idx is None:
            raise RuntimeError(f"migrated request {req.uid}: no free slot")
        adapter_slot = self._acquire_adapter(req)
        if adapter_slot is None:
            raise RuntimeError(f"migrated request {req.uid}: no adapter capacity")
        try:
            need = pages_needed(L + req.max_new_tokens, self.engine.page_size)
            pages = self.allocator.alloc(need)
            if pages is None and self.prefix_cache is not None:
                self.prefix_cache.evict(need)
                pages = self.allocator.alloc(need)
            if pages is None:
                raise RuntimeError(f"migrated request {req.uid}: pool exhausted")
            try:
                self._pool = self.engine.import_page_run(
                    self._ensure_pool(), pages[:n_pages], entries
                )
            except Exception:
                self.allocator.decref(pages)
                raise
        except Exception:
            self._release_adapter(req)
            raise
        first = fields["first_token"]
        now = time.monotonic()
        self._slots[slot_idx] = _PagedSlot(
            request=req,
            pos=L,
            tokens=[first],
            t_admit=now,
            t_first=now,
            deadline=deadline,
            span=self.tracer.start_span("decode", trace_id=trace_id, uid=req.uid),
            adapter_slot=adapter_slot,
            pages=pages,
            prefill_progress=L,
            decoding=True,
            seq=self._admit_seq,
        )
        self._admit_seq += 1
        if deadline is not None:
            self._deadlines[req.uid] = deadline
        if on_token is not None:
            self._on_token[req.uid] = on_token
        if on_finish is not None:
            self._on_finish[req.uid] = on_finish
        if trace_id is not None:
            self._trace_ids[req.uid] = trace_id
        self._tokens[slot_idx] = first
        self._positions[slot_idx] = L
        self._tables[slot_idx, :] = 0
        self._tables[slot_idx, : len(pages)] = pages
        self._ptables[slot_idx, :] = 0
        self._ptables[slot_idx, : len(pages)] = pages
        self._adapter_row[slot_idx] = adapter_slot
        if self.prefix_cache is not None:
            # the adopted prompt's pages serve later local hits as well
            self.prefix_cache.register(list(req.prompt), pages, self._prefix_salt(req))
        self._migrated_inserts += 1
        if self.obs_registry is not None:
            self.obs_registry.inc("migrated_inserts_total")

    def _fetch_prefix(self, req: Request) -> tuple:
        """The fleet prefix directory's client path
        (``relora_tpu/serve/scheduler.py:1267-1320``): on a local miss, ask
        ``prefix_fetch`` for the longest page-aligned prefix of ``req``'s
        prompt that a peer holds, import its pages, register them and look
        up again.  The digests carry the request's adapter salt, so a
        tenant's pages never come back for another tenant or for the base
        (the reference asks for unsalted ones).  Every failure returns
        ``([], 0)``: local prefill.  The fetch blocks this thread, and so
        every other slot: each attempt's seconds go to the
        ``prefix_fetch_seconds`` histogram and a ``prefix_fetch`` span."""
        ps = self.engine.page_size
        k_max = (len(req.prompt) - 1) // ps
        if k_max < 1 or self.prefix_cache is None:
            return [], 0
        salt = self._prefix_salt(req)
        digests = [
            PrefixCache._digest(req.prompt[: k * ps], salt).hex() for k in range(k_max, 0, -1)
        ]
        t0 = time.monotonic()
        span = self.tracer.start_span(
            "prefix_fetch", trace_id=self._trace_ids.get(req.uid), uid=req.uid
        )
        outcome = "miss"
        try:
            faults.maybe_fail("serve_prefix_fetch")
            hit = self.prefix_fetch(digests)
            if hit is None:
                return [], 0
            n_tokens, entries, nbytes = hit
            n_tokens = int(n_tokens)
            if n_tokens < ps or n_tokens % ps or n_tokens > k_max * ps:
                raise ValueError(f"peer returned unusable prefix ({n_tokens} tokens)")
            n_pages = n_tokens // ps
            pages = self.allocator.alloc(n_pages)
            if pages is None:
                self.prefix_cache.evict(n_pages)
                pages = self.allocator.alloc(n_pages)
            if pages is None:
                outcome = "no_pages"
                return [], 0  # pool pressure: not a failure, just skip
            try:
                # codes and (int8 pool) scales land together, so a recycled
                # page takes the donor's scale with its codes
                self._pool = self.engine.import_page_run(self._ensure_pool(), pages, entries)
            except Exception:
                self.allocator.decref(pages)
                raise
            self.prefix_cache.register(list(req.prompt[:n_tokens]), pages, salt)
            # the cache's own refs keep the run; drop the alloc ref and let
            # the lookup incref for this request like any local hit
            self.allocator.decref(pages)
            self._prefix_fetches += 1
            self._migration_bytes += int(nbytes)
            if self.obs_registry is not None:
                self.obs_registry.inc("prefix_fetch_total")
                self.obs_registry.inc("migration_bytes_total", by=int(nbytes))
            outcome = "fetched"
            span.set(pages=n_pages, bytes=int(nbytes))
            return self.prefix_cache.lookup(req.prompt, salt)
        except Exception as e:
            logger.warning(f"request {req.uid}: prefix fetch failed: {e!r}")
            outcome = "failed"
            self._prefix_fetch_failures += 1
            if self.obs_registry is not None:
                self.obs_registry.inc("prefix_fetch_failures_total")
            return [], 0
        finally:
            if self.obs_registry is not None:
                self.obs_registry.observe("prefix_fetch_seconds", time.monotonic() - t0)
            span.set(outcome=outcome).end()

    def disagg_stats(self) -> Dict:
        """The disaggregation counters, the ``disagg`` block of
        ``/healthz``: role, pages and bytes migrated (prefix fetches'
        bytes included, as the reference counts them), failures, adopted
        runs, prefix fetches and their failures."""
        return {
            "role": self.role,
            "pages_migrated": self._pages_migrated,
            "migration_bytes": self._migration_bytes,
            "migration_failures": self._migration_failures,
            "migrated_inserts": self._migrated_inserts,
            "prefix_fetches": self._prefix_fetches,
            "prefix_fetch_failures": self._prefix_fetch_failures,
        }

    def _prefilling(self) -> List[int]:
        """Slots still prefilling, oldest admission first (a parked handoff
        is neither prefilling nor decoding)."""
        return [
            i
            for _, i in sorted(
                (s.seq, i)
                for i, s in enumerate(self._slots)
                if s is not None and not s.decoding and not s.migrating
            )
        ]

    # -- prefill (one chunk per round) --------------------------------------------

    def _prefill_pass(self, finished: List[Completion]) -> None:
        """One prefill chunk for the oldest prefilling slot; when it
        completes the prompt, sample the first token and arm decode."""
        prefilling = self._prefilling()
        if not prefilling:
            return
        slot_idx = prefilling[0]
        slot = self._slots[slot_idx]
        req = slot.request
        L = len(req.prompt)
        chunk = self.engine.chunk_size
        start = slot.prefill_progress
        n_real = min(chunk, L - start)
        ids = np.zeros((1, chunk), np.int32)
        ids[0, :n_real] = list(req.prompt[start : start + n_real])
        table = np.zeros((1, self.engine.block_table_width), np.int32)
        table[0, : len(slot.pages)] = slot.pages
        self._pad_tokens += chunk - n_real
        self._prefill_tokens += n_real
        first_id = None
        t0 = time.monotonic()
        with self.tracer.span(
            "prefill_chunk", trace_id=self._trace_ids.get(req.uid), uid=req.uid,
            start=start, chunk=chunk,
        ):
            logits, self._pool = self.engine.prefill_chunk(
                ids, start, self._ensure_pool(), table, adapter_idx=[slot.adapter_slot]
            )
            self._count_dispatch(chunk, n_real)
            if self._spec == "model":
                # the draft prefills the same chunk into its own page run, so
                # base and draft stay in lockstep position by position
                draft_table = np.zeros((1, self.engine.block_table_width), np.int32)
                draft_table[0, : len(slot.draft_pages)] = slot.draft_pages
                _, self._pool = self.engine.draft_prefill_chunk(ids, start, self._pool, draft_table)
                self._count_dispatch(chunk, n_real)
            slot.prefill_progress = start + n_real
            if slot.prefill_progress >= L:
                # the first token's host pull is the span's sync point
                first_id = self._sample_one(logits[:, L - 1 - start, :], req)
        self._observe("prefill_seconds", time.monotonic() - t0)
        if first_id is not None:
            self._arm_decoding(slot_idx, first_id, finished)

    # -- speculative draft / verify ------------------------------------------------

    def _ngram_draft(self, ctx: List[int], k: int) -> List[int]:
        """Prompt-lookup drafting: match the longest context suffix (n-gram,
        ``n <= _NGRAM_MAX``) against an earlier occurrence in the row's own
        prompt and generated tokens, and propose the tokens that followed it
        (the most recent occurrence wins)."""
        if k <= 0 or len(ctx) < 2:
            return []
        for n in range(min(self._NGRAM_MAX, len(ctx) - 1), 0, -1):
            pattern = ctx[-n:]
            for i in range(len(ctx) - n - 1, -1, -1):
                if ctx[i : i + n] == pattern:
                    return ctx[i + n : i + n + k]
        return []

    def _draft_budget(self, slot: Optional[_PagedSlot]) -> int:
        """Tokens a row may draft this round: ``spec_k``, at most its
        remaining budget minus one (the round commits one token besides), so
        every window write stays inside the admission allocation; 0 for a
        row that is not decoding or opted out."""
        if slot is None or not slot.decoding or not slot.request.spec:
            return 0
        return min(self.engine.spec_k, slot.request.max_new_tokens - len(slot.tokens) - 1)

    def _draft_pass(self) -> Dict[int, List[int]]:
        """spec="ngram": up to ``spec_k`` looked-up tokens per decoding row."""
        drafts: Dict[int, List[int]] = {}
        for slot_idx, slot in enumerate(self._slots):
            k = self._draft_budget(slot)
            if k <= 0:
                continue
            d = self._ngram_draft(list(slot.request.prompt) + slot.tokens, k)
            if d:
                drafts[slot_idx] = d
        return drafts

    def _model_draft_pass(self) -> Dict[int, List[int]]:
        """spec="model": up to ``spec_k`` batched ``(batch, 1)`` greedy draft
        decodes over the draft's page runs, chained by argmax on the device
        and pulled to the host once at the end.  Rows past their own budget
        go null mid-loop (all-null table, position 0), so their writes land
        in the null page."""
        B = self.max_batch
        ks = np.array([max(self._draft_budget(s), 0) for s in self._slots], np.int32)
        eligible = [i for i in range(B) if ks[i] > 0]
        if not eligible:
            return {}
        cur = self._tokens[:, None]
        proposals = []
        for step in range(int(ks.max())):
            live = ks > step
            positions = np.where(live, self._positions + step, 0).astype(np.int32)
            tables = np.where(live[:, None], self._draft_tables, 0).astype(np.int32)
            logits, self._pool = self.engine.draft_decode_paged(
                self._ensure_pool(), cur, positions[:, None], tables
            )
            self._count_dispatch(B, int(live.sum()))
            cur = torch.argmax(logits, dim=-1).to(torch.int32).reshape(-1, 1)
            proposals.append(cur)
        stacked = torch.cat(proposals, dim=1).cpu().numpy()  # one host pull
        return {i: [int(t) for t in stacked[i, : int(ks[i])]] for i in eligible}

    def _window_rows(self, drafts: Dict[int, List[int]]):
        """The verify sampler's per-row inputs for the decoding rows:
        ``(draft_mat (B, spec_k), k_eff, uids, starts, temps, top_ps)``."""
        B = self.max_batch
        draft_mat = np.zeros((B, self.engine.spec_k), np.int32)
        k_eff = np.zeros(B, np.int32)
        uids = np.zeros(B, np.int64)
        starts = np.zeros(B, np.int64)
        temps = np.zeros(B, np.float32)
        top_ps = np.ones(B, np.float32)
        for slot_idx, slot in enumerate(self._slots):
            if slot is None or not slot.decoding:
                continue
            d = drafts.get(slot_idx, [])
            draft_mat[slot_idx, : len(d)] = d
            k_eff[slot_idx] = len(d)
            uids[slot_idx] = slot.request.uid
            starts[slot_idx] = len(slot.tokens)
            temps[slot_idx] = slot.request.temperature
            top_ps[slot_idx] = slot.request.top_p
        return draft_mat, k_eff, uids, starts, temps, top_ps

    def _verify_round(self, drafts: Dict[int, List[int]], finished: List[Completion]) -> None:
        """One ``(batch, spec_k+1)`` verify forward over every decoding row,
        then the accept walk.  Window slot 0 carries the pending token, slots
        ``1..k`` the drafts at consecutive positions.  Free and prefilling
        rows, and slots past a row's drafts, write through the trailing null
        column of the ``W+1``-wide tables (positions ``>= cache_size`` on the
        pad rows), so no live page is touched."""
        S = self.engine.spec_k + 1
        B = self.max_batch
        W = self.engine.block_table_width
        tokens = np.zeros((B, S), np.int32)
        positions = np.full((B, S), self.engine.cache_size, np.int32)
        tables = np.zeros((B, W + 1), np.int32)
        rows = self._window_rows(drafts)
        tokens[:, 1:] = rows[0]  # the drafts, zero past each row's k_eff
        eligible = set()
        for slot_idx, slot in enumerate(self._slots):
            if slot is None or not slot.decoding:
                continue
            tokens[slot_idx, 0] = self._tokens[slot_idx]
            positions[slot_idx] = self._positions[slot_idx] + np.arange(S)
            tables[slot_idx, :W] = self._tables[slot_idx]
            eligible.add(slot_idx)
        logits, self._pool = self.engine.verify_paged(
            self._ensure_pool(), tokens, positions, tables, adapter_idx=self._adapter_row
        )
        self._count_dispatch(B * S, len(eligible) + int(rows[1].sum()))
        self._spec_rounds += 1
        self._commit_spec_walk(logits, rows, eligible, finished)

    def _commit_spec_walk(self, logits, rows, eligible, finished: List[Completion]) -> None:
        """The accept walk shared by the sequential verify round and the
        packed step (``relora_tpu/serve/scheduler.py:1461-1503``): draw on
        the window's logits ``(B, S, V)``, then for each row that rode the
        window (``eligible``) commit the longest accepted draft prefix plus
        one token through the plain emit/finish flow, stopping where the
        request finishes."""
        draft_mat, k_eff, uids, starts, temps, top_ps = rows
        accept, alt = spec_verify_draws(
            logits, draft_mat, self.seed, uids, starts, k_eff,
            temperature=temps, top_k=self.top_k, top_p=top_ps,
        )
        drafted = accepted = 0
        for slot_idx in sorted(eligible):
            slot = self._slots[slot_idx]
            if slot is None or not slot.decoding:
                continue
            k = int(k_eff[slot_idx])
            a = 0
            while a < k and accept[slot_idx, a]:
                a += 1
            drafted += k
            accepted += a
            commits = [int(t) for t in draft_mat[slot_idx, :a]] + [int(alt[slot_idx, a])]
            for tok in commits:
                self._advance(slot_idx, tok, finished)
                if self._slots[slot_idx] is None:
                    break  # EOS or the budget inside the window: drop the rest
        self._spec_drafted += drafted
        self._spec_accepted += accepted
        if self.obs_registry is not None and drafted:
            self.obs_registry.inc("spec_drafted_total", by=drafted)
            self.obs_registry.inc("spec_accepted_total", by=accepted)

    def spec_stats(self) -> Dict:
        """Cumulative speculative counters: mode, window size, drafted and
        accepted tokens, their ratio, and verify rounds."""
        return {
            "mode": self._spec,
            "k": self.engine.spec_k,
            "drafted": self._spec_drafted,
            "accepted": self._spec_accepted,
            "accept_rate": round(self._spec_accepted / max(self._spec_drafted, 1), 4),
            "verify_rounds": self._spec_rounds,
        }

    # -- the budgeted round -------------------------------------------------------

    def step(self) -> List[Completion]:
        """One budgeted round: expire deadlines, admit, at most one prefill
        chunk, then one paged decode over every decoding slot, or one verify
        forward when any row drafted (or, packed, the single-dispatch round
        of :meth:`_step_packed`)."""
        if self._packed:
            return self._step_packed()
        finished: List[Completion] = []
        t_step = time.monotonic()
        d0 = self._dispatch_total
        self._expire_deadlines(finished)
        self._admit_pass(finished)
        self._prefill_pass(finished)
        admit_s = time.monotonic() - t_step
        decoding = [s if (s is not None and s.decoding) else None for s in self._slots]
        n_decoding = sum(s is not None for s in decoding)
        if n_decoding == 0:
            if self._dispatch_total > d0:
                self._count_round()  # a round of prefill alone still dispatched
                self._admit_time_s += admit_s
            elif any(s is not None and s.migrating for s in self._slots):
                time.sleep(0.001)  # only parked handoffs: no hot spin
            return finished
        t_decode = time.monotonic()
        if self._spec == "ngram":
            drafts = self._draft_pass()
        elif self._spec == "model":
            drafts = self._model_draft_pass()
        else:
            drafts = {}
        next_tokens = None
        with self.tracer.span(
            "decode_step", step=self._step_count, active_slots=n_decoding,
            spec_drafted=sum(len(d) for d in drafts.values()),
        ):
            if drafts:
                # the walk commits straight into the slots
                self._verify_round(drafts, finished)
            else:
                logits, self._pool = self.engine.decode_paged(
                    self._ensure_pool(),
                    self._tokens[:, None],
                    self._positions[:, None],
                    self._tables,
                    adapter_idx=self._adapter_row,
                )
                self._count_dispatch(self.max_batch, n_decoding)
                next_tokens = self._sample_rows(logits, decoding).tolist()
            self._step_count += 1
        decode_s = time.monotonic() - t_decode
        self._observe("decode_step_seconds", decode_s)
        self._count_round()
        if next_tokens is not None:
            for slot_idx, slot in enumerate(decoding):
                if slot is not None:
                    self._advance(slot_idx, next_tokens[slot_idx], finished)
        self._round_metrics(admit_s, decode_s, n_decoding)
        return finished

    def _advance(self, slot_idx: int, tok: int, finished: List[Completion]) -> None:
        slot = self._slots[slot_idx]
        slot.tokens.append(tok)
        slot.pos += 1
        self._tokens[slot_idx] = tok
        self._positions[slot_idx] = slot.pos
        self._emit_token(slot.request.uid, tok, len(slot.tokens) - 1)
        self._finish_if_done(slot_idx, finished)

    # -- the packed single-dispatch round -------------------------------------------

    def _step_packed(self) -> List[Completion]:
        """Token-budget round in ONE model dispatch: every decoding row's
        window first (its token, or ``spec_k+1`` tokens when any row drafted,
        ``k_eff = 0`` rows included), then oldest-first prefill tokens from
        as many slots as the budget admits, padded to the smallest packed
        bucket.  Each token routes through its own slot's block table
        (``row_map``); sampling uses the sequential round's calls and keys,
        so the drain is token-identical to the unpacked scheduler's."""
        finished: List[Completion] = []
        t_step = time.monotonic()
        self._expire_deadlines(finished)
        self._admit_pass(finished)
        admit_s = time.monotonic() - t_step
        if not any(s is not None for s in self._slots):
            return finished
        t_decode = time.monotonic()
        engine = self.engine
        B = self.max_batch
        drafts = self._draft_pass() if self._spec == "ngram" else {}
        S = engine.spec_k + 1 if drafts else 1
        window = self._window_rows(drafts) if drafts else None
        ids: List[int] = []
        poss: List[int] = []
        rows: List[int] = []
        adap: List[int] = []  # each packed token's adapter slot
        slot_off: Dict[int, int] = {}  # decoding slot -> its window's offset
        for slot_idx, slot in enumerate(self._slots):
            if slot is None or not slot.decoding:
                continue
            slot_off[slot_idx] = len(ids)
            d = drafts.get(slot_idx, [])
            ids.extend([int(self._tokens[slot_idx])] + [int(t) for t in d] + [0] * (S - 1 - len(d)))
            poss.extend(int(self._positions[slot_idx]) + j for j in range(S))
            rows.extend([slot_idx] * S)
            adap.extend([slot.adapter_slot] * S)

        # prefill from several slots into the leftover budget; every write
        # lands before any token attends, so a slot may clear its backlog
        budget_left = engine.token_budget - len(ids)
        prefill_spans: List[tuple] = []  # (slot_idx, start, n, packed offset)
        for slot_idx in self._prefilling():
            if budget_left <= 0:
                break
            slot = self._slots[slot_idx]
            req = slot.request
            start = slot.prefill_progress
            n = min(len(req.prompt) - start, budget_left)
            if n <= 0:
                continue
            prefill_spans.append((slot_idx, start, n, len(ids)))
            ids.extend(int(t) for t in req.prompt[start : start + n])
            poss.extend(range(start, start + n))
            rows.extend([slot_idx] * n)
            adap.extend([slot.adapter_slot] * n)
            budget_left -= n

        n_real = len(ids)
        if n_real == 0:
            if any(s is not None and s.migrating for s in self._slots):
                time.sleep(0.001)  # only parked handoffs: no hot spin
            return finished
        bucket = next(b for b in engine.packed_buckets() if b >= n_real)
        pad = bucket - n_real
        ids.extend([0] * pad)
        poss.extend([engine.cache_size] * pad)  # clips into the null page
        rows.extend([B] * pad)  # the all-null pad row of _ptables
        adap.extend([0] * pad)  # pad tokens decode the identity adapter
        self._pad_tokens += pad
        self._prefill_tokens += sum(n for _, _, n, _ in prefill_spans)
        with self.tracer.span(
            "decode_step", step=self._step_count, active_slots=len(slot_off),
            spec_drafted=int(window[1].sum()) if drafts else 0, packed_tokens=bucket,
        ):
            logits, self._pool = engine.step_paged(
                self._ensure_pool(),
                np.asarray(ids, np.int32)[None, :],
                np.asarray(poss, np.int32)[None, :],
                self._ptables,
                np.asarray(rows, np.int32),
                adapter_idx=np.asarray(adap, np.int32),
            )
            self._step_count += 1

            if slot_off and drafts:
                # each window's logits gathered by its packed offsets: (B, S, V)
                win_idx = np.zeros(B * S, np.int64)
                for slot_idx, off in slot_off.items():
                    win_idx[slot_idx * S : (slot_idx + 1) * S] = off + np.arange(S)
                win = logits[0][torch.as_tensor(win_idx, device=logits.device)]
                self._spec_rounds += 1
                self._commit_spec_walk(win.reshape(B, S, -1), window, set(slot_off), finished)
            elif slot_off:
                sample_idx = np.zeros(B, np.int64)
                for slot_idx, off in slot_off.items():
                    sample_idx[slot_idx] = off
                gathered = logits[0][sample_idx]
                masked = [s if i in slot_off else None for i, s in enumerate(self._slots)]
                next_tokens = self._sample_rows(gathered, masked).tolist()
                for slot_idx in sorted(slot_off):
                    self._advance(slot_idx, next_tokens[slot_idx], finished)

            for slot_idx, start, n, off in prefill_spans:
                slot = self._slots[slot_idx]
                if slot is None:
                    continue
                slot.prefill_progress = start + n
                if slot.prefill_progress < len(slot.request.prompt):
                    continue
                first_id = self._sample_one(logits[:, off + n - 1, :], slot.request)
                self._arm_decoding(slot_idx, first_id, finished)
        decode_s = time.monotonic() - t_decode
        self._observe("decode_step_seconds", decode_s)
        # dispatch and round tick together at the round's end, so a /healthz
        # read between them never sees dispatches != rounds
        self._count_dispatch(bucket, n_real)
        self._count_round()
        self._round_metrics(admit_s, decode_s, len(slot_off))
        return finished

    # -- dispatch accounting and the round's telemetry ----------------------------

    def _count_dispatch(self, tokens: int, real: int) -> None:
        """One model dispatch of ``tokens`` window positions, ``real`` of
        which carried live work (the rest is shape padding)."""
        self._dispatch_total += 1
        self._dispatch_tokens += tokens
        self._dispatch_tokens_real += real
        if self.obs_registry is not None:
            self.obs_registry.inc("model_dispatches_total")
            self.obs_registry.inc("dispatch_tokens_total", by=tokens)
            self.obs_registry.inc("dispatch_tokens_real_total", by=real)

    def _count_round(self) -> None:
        self._round_total += 1
        if self.obs_registry is not None:
            self.obs_registry.inc("sched_rounds_total")

    def _round_metrics(self, admit_s: float, decode_s: float, n_decoding: int) -> None:
        """The round's gauges and ``metrics.jsonl`` record, shared by the
        sequential and packed rounds (``relora_tpu/serve/scheduler.py:
        1605-1686``: the same gauge and counter names and record keys).
        With neither sink attached it only adds up the round's times."""
        self._admit_time_s += admit_s
        self._decode_time_s += decode_s
        if self.obs_registry is None and self.metrics is None:
            return
        batch_fill = n_decoding / self.max_batch
        stall_share = admit_s / max(admit_s + decode_s, 1e-9)
        pad_share = self._pad_tokens / max(self._pad_tokens + self._prefill_tokens, 1)
        hit_rate = self.prefix_cache.hit_rate if self.prefix_cache is not None else 0.0
        dispatches_per_round = self._dispatch_total / max(self._round_total, 1)
        tokens_per_dispatch = self._dispatch_tokens / max(self._dispatch_total, 1)
        token_utilization = self._dispatch_tokens_real / max(self._dispatch_tokens, 1)
        reg = self.obs_registry
        if reg is not None:
            for name, value in (
                ("batch_fill", batch_fill),
                ("prefill_stall_share", stall_share),
                ("kv_pages_used", self.allocator.used_pages),
                ("kv_pages_free", self.allocator.free_pages),
                ("prefix_cache_hit_rate", hit_rate),
                ("prefill_pad_share", pad_share),
                ("kv_cache_bytes", self._kv_cache_bytes),
                ("kv_bytes_per_token", self._kv_bytes_per_token),
                ("dispatches_per_round", dispatches_per_round),
                ("tokens_per_dispatch", tokens_per_dispatch),
                ("packed_token_utilization", token_utilization),
            ):
                reg.set_gauge(name, value)
            # by=0 materializes the counters, so /metrics shows every series
            # from the first round (the prefix-fetch pair stays 0: the fleet
            # prefix directory is not ported)
            for name in (
                "model_dispatches_total", "sched_rounds_total", "dispatch_tokens_total",
                "dispatch_tokens_real_total", "pages_migrated_total", "migration_bytes_total",
                "migration_failures_total", "migrated_inserts_total", "prefix_fetch_total",
                "prefix_fetch_failures_total",
            ):
                reg.inc(name, by=0)
            if self._spec != "off":
                reg.set_gauge("spec_accept_rate", self._spec_accepted / max(self._spec_drafted, 1))
                reg.set_gauge("spec_mode_model", 1.0 if self._spec == "model" else 0.0)
                reg.inc("spec_drafted_total", by=0)
                reg.inc("spec_accepted_total", by=0)
        record = None
        if self.metrics is not None:
            record = {
                "serve/decode_step": self._step_count,
                "serve/queue_depth": len(self._pending),
                "serve/active_slots": self.active_slots,
                "serve/batch_fill": round(batch_fill, 4),
                "serve/prefill_stall_s": round(admit_s, 6),
                "serve/prefill_stall_share": round(stall_share, 4),
                "serve/kv_pages_used": self.allocator.used_pages,
                "serve/kv_pages_free": self.allocator.free_pages,
                "serve/prefix_cache_hit_rate": round(hit_rate, 4),
                "serve/prefill_pad_share": round(pad_share, 4),
                "serve/kv_cache_bytes": self._kv_cache_bytes,
                "serve/kv_bytes_per_token": round(self._kv_bytes_per_token, 4),
                "serve/dispatches_per_round": round(dispatches_per_round, 4),
                "serve/tokens_per_dispatch": round(tokens_per_dispatch, 4),
                "serve/packed_token_utilization": round(token_utilization, 4),
                # the reference counts jit retraces after warmup here; the
                # port compiles nothing at run time
                "compile/steady_state_retraces": 0,
            }
            if self._spec != "off":
                record["serve/spec_drafted_total"] = self._spec_drafted
                record["serve/spec_accepted_total"] = self._spec_accepted
                record["serve/spec_accept_rate"] = round(
                    self._spec_accepted / max(self._spec_drafted, 1), 4
                )
                record["serve/spec_mode_model"] = 1 if self._spec == "model" else 0
        self._adapter_gauges(record)
        if record is not None:
            self.metrics.log(record)

    # -- retirement (page bookkeeping) --------------------------------------------

    def _retire(self, slot_idx: int, reason: str, detail: Optional[str] = None) -> Completion:
        slot = self._slots[slot_idx]
        completion = super()._retire(slot_idx, reason, detail)
        if slot.pages:
            # one decref per page: fresh pages drop their alloc ref, shared
            # pages this request's lookup ref
            self.allocator.decref(slot.pages)
            slot.pages = []
        if slot.draft_pages:
            self.allocator.decref(slot.draft_pages)
            slot.draft_pages = []
        self._tables[slot_idx, :] = 0
        self._draft_tables[slot_idx, :] = 0
        self._ptables[slot_idx, :] = 0
        self._tokens[slot_idx] = 0
        self._positions[slot_idx] = 0
        return completion

    def paging_stats(self) -> Dict:
        """Pool, prefix-cache, speculative and dispatch counters: the
        ``paging`` block of ``/healthz``."""
        stats: Dict = {
            "kv_pages_used": self.allocator.used_pages,
            "kv_pages_free": self.allocator.free_pages,
            "kv_pages_peak": self.allocator.peak_used,
            "kv_dtype": self.engine.kv_dtype,
            "kv_cache_bytes": self._kv_cache_bytes,
            "kv_bytes_per_token": round(self._kv_bytes_per_token, 4),
            "kv_used_bytes": self.allocator.used_bytes,
            "prefill_pad_share": round(
                self._pad_tokens / max(self._pad_tokens + self._prefill_tokens, 1), 4
            ),
        }
        if self.prefix_cache is not None:
            stats["prefix_cache"] = self.prefix_cache.stats()
        if self._spec != "off":
            stats["spec"] = self.spec_stats()
        stats["dispatch"] = self.dispatch_stats()
        stats["disagg"] = self.disagg_stats()
        return stats

    def dispatch_stats(self) -> Dict:
        """Cumulative dispatch economics: rounds, dispatches, dispatched and
        live window positions, admission and decode wall time."""
        stats: Dict = {
            "mode": "packed" if self._packed else "sequential",
            "rounds": self._round_total,
            "model_dispatches": self._dispatch_total,
            "dispatches_per_round": round(self._dispatch_total / max(self._round_total, 1), 4),
            "tokens_total": self._dispatch_tokens,
            "tokens_real": self._dispatch_tokens_real,
            "tokens_per_dispatch": round(self._dispatch_tokens / max(self._dispatch_total, 1), 4),
            "packed_token_utilization": round(
                self._dispatch_tokens_real / max(self._dispatch_tokens, 1), 4
            ),
            "admit_time_s": round(self._admit_time_s, 6),
            "decode_time_s": round(self._decode_time_s, 6),
            "prefill_stall_share": round(
                self._admit_time_s / max(self._admit_time_s + self._decode_time_s, 1e-9), 4
            ),
        }
        if self._packed:
            stats["token_budget"] = self.engine.token_budget
            stats["buckets"] = list(self.engine.packed_buckets())
        return stats
