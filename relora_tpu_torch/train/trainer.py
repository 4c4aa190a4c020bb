"""Training orchestration: the update loop of ``relora_tpu/train/trainer.py``.

Builds the model of the config's family, Llama or GPT-NeoX / Pythia (LoRA
on every attention and MLP projection when ``use_peft``), initialises it from ``--seed``, splits trainable from frozen
parameters, builds AdamW and the schedule, and runs the loop: one update per
``(grad_accum, microbatch, seq)`` batch, a graceful stop at the update
boundary after SIGTERM/SIGINT (``handle_preemption``), eval every
``eval_every``, the ReLoRA merge-and-reinit when ``(update_step -
scheduler_start_step) % relora == 1`` once ``relora`` updates ran here, and
the optimizer reset on the same rule with ``cycle_length``
(``relora_tpu/train/trainer.py:1053-1106``).  Each update makes one metrics
record; :meth:`Trainer.fit` returns the result dict of the JAX trainer plus
the port's counters, the update's counted FLOPs and the card's peak, and the
records.

Telemetry, as the JAX trainer's (``relora_tpu/train/trainer.py:441-505``,
``:834-930``): with ``--save_dir D`` the run writes ``D/metrics.jsonl``
(``source: "train"``) and ``D/run_config.json``.  ``metrics.jsonl`` holds a
``memory_plan`` event at the start (parameter and AdamW state bytes, the
allocator's live stats), one record per update (loss, lr, grad_norm, live
``mfu`` against the card's peak from ``obs/mfu.py``, throughputs, counters,
``update_seconds``) written every ``--log_every`` updates, and at each such
flush one ``mfu_gap`` record: the window's wall time split into
data_fetch, dispatch, compute, comms and host shares that sum to 1, with
the ``hbm/*`` gauges.  The port's step reads the device once an update
(the NaN gate, ``train/step.py``), where the JAX step does not: the time
blocked in that read counts as compute, the rest of the step call (kernel
launches included, which block once the launch queue is full) as dispatch,
the batch wait and its copy to the device as data_fetch and the rest of the
window as host (comms is 0 on one card).  The flush itself waits on no
device work: the records are host values already.  Lifecycle events (``batch_skipped``,
``nan_skip``, ``preemption``, ``emergency_checkpoint``, ``loss_spike``,
``rollback``, ``rollback_skipped``, ``save_failed``) go to the same file;
spans over the update loop (``update_step`` with ``data_fetch`` and
``dispatch``, ``metric_pull``, ``eval``, ``checkpoint``, ``relora_merge``,
``optimizer_reset``) to the flight recorder, dumped into ``save_dir`` when
the loop raises, and to ``$RELORA_TPU_TRACE_DIR/train_spans.jsonl`` when
that is set.  ``--profile true`` writes ``torch.profiler`` Chrome traces
under ``profiler_logs/<run name>`` (``utils/profiling.py``).  Batches are
copied to the card from pinned memory without blocking the host.  None of
this changes a number the trainer computes.

``--warmed_up_model DIR`` grafts ``DIR/pytorch_model.bin``, or the params of
a port checkpoint directory, into the freshly initialised model
(``models/warm_start.py``) and takes the counters of
``DIR/training_state.json`` when it exists, the schedule starting there
(``relora_tpu/train/trainer.py:284-319``).  ``--quantize int8`` stores every
LoRA projection's frozen base as int8 codes and scales: kernel 8 in each
unfused projection, the int8 fused kernels under ``--lora_fused true``, and
a dequantize-add-requantize merge.  ``--quantize nf4`` stores it as nf4
codes and block scales (double-quantized unless ``--use_double_quant
false``): a plain dequantize-matmul under every ``--lora_fused``, and the
same merge; an odd-width projection stores int8 and takes int8's routes.
``--loss_impl chunked`` streams the LM head over ``--vocab_chunk`` rows in
the train and eval steps (``train/step.py``); ``--remat true`` with
``--remat_policy dots | dots_narrow | dots_all`` saves the matmul outputs the
policy names (``models/params_util.remat_context_fn``).

``--save_dir`` writes ``model_{step}`` checkpoints (``train/checkpoint.py``:
params, AdamW state, counters) every ``--save_every`` updates, at the end,
and on SIGTERM/SIGINT before stopping (the emergency save), keeping the
newest ``--keep_checkpoints``; the resolved config goes to
``save_dir/training_config.json`` (the reference writes YAML; the card's
machine has no PyYAML).  ``--autoresume`` resumes from the newest verified
checkpoint of ``save_dir``, else ``--resume_from DIR`` from DIR
(``relora_tpu/train/trainer.py:252-319``): params, AdamW state unless
``--load_optimizer_state_on_resume false``, counters, the schedule's origin,
``skip_batches``, and the data rewound to the update reached; a resumed run
may merge and reset at once.  ``--spike_threshold`` rolls a sustained loss
spike back to the last checkpoint before it and skips its batches
(``:1280-1330``).

Prune-retrain (``relora_tpu/train/trainer.py:414-431``, ``:531-575``): with
``--prune_sparsity`` or ``--prune_nm`` the first merge at or past
``--prune_start_step`` runs unmasked, then computes the keep-mask from the
just-merged base (``compress/prune.magnitude_mask``), zeroes the pruned
positions in place and writes a ``prune_mask_computed`` event (``sparsity``,
``mask_crc32``); every later merge masks the merged base before its cast or
requant.  ``--reset_init magnitude`` draws each merge's A through
``compress/resets.magnitude_a_init``.  Every save writes the mask's sidecar
pair before the manifest; a resume restores it, and a spike rollback takes
its target's (or none).

Options the port does not run yet raise ``NotImplementedError`` when set: a
warm start from a JAX checkpoint's ``state/``, ``wandb`` and its ``watch``
histograms, a custom PRNG, and parallelism beyond one device.
``--lora_fused true`` runs every LoRA projection through the fused kernels
wherever dropout is not active, ``--lora_fused auto`` through the cost
model's pick of the fused, ordered or merged arm.

Randomness is keyed, as the JAX package's ``fold_in(PRNGKey(seed + k),
update_step)``: the weights come from ``seed``; LoRA dropout (``k = 1``, one
seed per microbatch), the A re-draw at a merge (``k = 2``) and random moment
pruning (``k = 3``) at update ``t`` from :func:`fold_in` of ``(seed + k, t)``
alone, never from a generator that runs across updates, so a run reaching
``t`` by any path draws the same bits there.  They are other bits than the
JAX package's ``jax.random`` keys.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from relora_tpu_torch import resolve_device
from relora_tpu_torch.compress.prune import (
    apply_mask,
    load_mask,
    magnitude_mask,
    mask_checksum,
    sparsity_stats,
)
from relora_tpu_torch.compress.resets import make_reinit_fn
from relora_tpu_torch.config.model import ModelConfig, load_model_config
from relora_tpu_torch.config.training import TrainingConfig
from relora_tpu_torch.core.optim import build_optimizer, reset_optimizer_state, zeroed_fraction
from relora_tpu_torch.core.relora import LoraSpec, merge_and_reinit, set_trainable, split_param_counts
from relora_tpu_torch.core.schedules import make_schedule
from relora_tpu_torch.models.family import CausalLM, causal_lm_class
from relora_tpu_torch.models.params_util import init_params
from relora_tpu_torch.models.warm_start import STATE_SUBDIR, load_warm_start, warm_start_counters
from relora_tpu_torch.obs import flight
from relora_tpu_torch.obs import memory as obs_memory
from relora_tpu_torch.obs.metrics import MetricsRegistry
from relora_tpu_torch.obs.mfu import peak_flops, step_flops
from relora_tpu_torch.obs.tracer import Tracer
from relora_tpu_torch.train.checkpoint import (
    delete_old_checkpoints,
    get_last_checkpoint,
    load_optimizer_state,
    load_training_state,
    restore_params_host,
    save_checkpoint,
    verify_checkpoint,
)
from relora_tpu_torch.train.resilience import LossSpikeDetector, PreemptionGuard, SpikeEvent
from relora_tpu_torch.train.step import TrainState, eval_step, make_train_step
from relora_tpu_torch.utils.logging import MetricsLogger
from relora_tpu_torch.utils.profiling import maybe_make_profiler

logger = logging.getLogger(__name__)

_MASK64 = (1 << 64) - 1
#: the resolved config beside the checkpoints, read by the batch-size guard
TRAINING_CONFIG_FILE = "training_config.json"
#: the mfu_gap waterfall's shares, in the JAX trainer's order
GAP_KEYS = ("data_fetch", "dispatch", "compute", "comms", "host")


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed that depends only on ``(seed, data)``: splitmix64's
    finaliser over the pair packed into 64 bits, so neighbouring pairs give
    unrelated seeds (the port's counterpart of ``jax.random.fold_in``)."""
    x = ((((seed & 0xFFFFFFFF) << 32) | (data & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def keyed_generator(seed: int, update_step: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded from ``(seed, update_step)``."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, update_step))


def dropout_seeds(seed: int, update_step: int, microbatches: int) -> list:
    """The LoRA dropout seed of each microbatch of update ``update_step``."""
    key = fold_in(seed, update_step)
    return [fold_in(key, i) for i in range(microbatches)]

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "fp32": torch.float32,
}


def refuse_unported(cfg: TrainingConfig) -> None:
    """Raise ``NotImplementedError`` for every option whose code path the
    port does not have yet: none is skipped silently."""
    unported = {
        "warmed_up_model with a state/ checkpoint": cfg.warmed_up_model is not None
        and os.path.isdir(os.path.join(cfg.warmed_up_model, STATE_SUBDIR)),
        "wandb": cfg.wandb,
        "wandb_watch": cfg.wandb_watch,
        "prng_impl": bool(cfg.prng_impl),
        "fsdp_size / tp_size / sp_size / dp_size > 1 (parallelism)": max(
            cfg.fsdp_size, cfg.tp_size, cfg.sp_size, cfg.dp_size or 1
        ) > 1,
    }
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(
            f"not ported to relora_tpu_torch yet: {', '.join(asked)} (see ROADMAP)"
        )


def build_model(
    model_cfg: ModelConfig, lora: Optional[LoraSpec], cfg: TrainingConfig, device
) -> CausalLM:
    """The training model of ``model_cfg``'s family (Llama or GPT-NeoX) on
    ``device``: f32 parameters, compute in ``cfg.dtype``, attention
    ``auto`` (the flash kernels on CUDA)."""
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {cfg.dtype!r}")
    model_class = causal_lm_class(model_cfg)
    with torch.device(device):
        return model_class(
            model_cfg,
            dtype=_DTYPES[cfg.dtype],
            attention_arm="flash" if cfg.flash_attention and device.type == "cuda" else "auto",
            lora=lora,
            param_dtype=torch.float32,
            remat=cfg.remat,
            remat_policy=cfg.remat_policy,
            logits_dtype=torch.bfloat16 if cfg.bf16_logits else torch.float32,
        )


class Trainer:
    """End-to-end trainer::

        trainer = Trainer(cfg)
        trainer.fit(train_iter, eval_iter_factory)
    """

    def __init__(self, cfg: TrainingConfig, model_cfg: Optional[ModelConfig] = None):
        cfg.finalize()
        refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.n_batch_shards = 1
        self.grad_accum = cfg.grad_accum_for(self.n_batch_shards)

        if model_cfg is None:
            model_cfg = load_model_config(cfg.model_config or cfg.model_name_or_path)
        self.model_cfg = model_cfg
        need_linear_weight = (
            cfg.relora is not None or cfg.force_keep_original or cfg.warmed_up_model is not None
        )
        self.lora_spec = (
            LoraSpec(
                r=cfg.lora_r,
                alpha=cfg.lora_alpha,
                dropout=cfg.lora_dropout,
                trainable_scaling=cfg.train_scaling,
                quantize=cfg.quantize,
                base_dtype=cfg.base_dtype,
                use_double_quant=cfg.use_double_quant,
                lora_only=not need_linear_weight,
                fused="auto" if cfg.lora_fused == "auto" else cfg.lora_fused == "true",
            )
            if cfg.use_peft
            else None
        )
        self.model = build_model(model_cfg, self.lora_spec, cfg, self.device)
        init_params(self.model, torch.Generator(device=self.device).manual_seed(cfg.seed))

        # the resume target (relora_tpu/train/trainer.py:252-261)
        self.resume_dir: Optional[str] = None
        if cfg.autoresume and cfg.save_dir and os.path.isdir(cfg.save_dir):
            _, self.resume_dir = get_last_checkpoint(cfg.save_dir)
            if self.resume_dir:
                self._guard_batch_size_unchanged()
        elif cfg.resume_from:
            self.resume_dir = cfg.resume_from
            self._guard_batch_size_unchanged()
        if cfg.warmed_up_model and not self.resume_dir:
            load_warm_start(self.model, cfg.warmed_up_model)
        set_trainable(self.model)
        self.param_counts = split_param_counts(self.model)
        counts = self.param_counts
        logger.info(
            f"params: total={counts['total_params']/1e6:.2f}M "
            f"trainable={counts['trainable_params']/1e6:.2f}M "
            f"lora={counts['lora_params']/1e6:.2f}M "
            f"equivalent={counts['equivalent_params']/1e6:.2f}M"
        )

        self.update_step = 0
        self.global_step = 0
        self.tokens_seen = 0
        self.tokens_seen_before = 0
        self.n_lora_restarts = 0
        self.n_optimizer_resets = 0
        self.n_spike_rollbacks = 0
        self.eval_batches = 0
        self._local_updates = 0
        self._resumed = False
        if self.resume_dir:
            ts = load_training_state(self.resume_dir)
            self.update_step = ts["update_step"]
            self.global_step = ts["global_step"]
            self.tokens_seen = ts["tokens_seen"]
            self.tokens_seen_before = ts.get("tokens_seen_before", 0)
            self.n_lora_restarts = ts.get("n_lora_restarts", 0)
            self.n_optimizer_resets = ts.get("n_optimizer_resets", 0)
            self.n_spike_rollbacks = ts.get("n_spike_rollbacks", 0)
            # a rollback of the run before may have extended the blacklist
            cfg.skip_batches |= set(ts.get("skip_batches") or ())
            self._resumed = True
            # the schedule's origin as saved, so the schedule is the same one
            self.scheduler_start_step = ts.get("scheduler_start_step", self.update_step)
        else:
            if cfg.warmed_up_model:
                counters = warm_start_counters(cfg.warmed_up_model)
                if counters:
                    self.update_step = counters.get("update_step", 0)
                    self.global_step = counters.get("global_step", 0)
                    self.tokens_seen = counters.get("tokens_seen", 0)
            # the schedule runs over the remaining steps with a fresh first warmup
            self.scheduler_start_step = self.update_step
        self.schedule = make_schedule(
            cfg.scheduler,
            lr=cfg.lr,
            num_training_steps=cfg.num_training_steps - self.scheduler_start_step,
            warmup_steps=cfg.warmup_steps,
            min_lr_ratio=cfg.min_lr_ratio,
            cycle_length=cfg.cycle_length or cfg.relora,
            restart_warmup_steps=cfg.restart_warmup_steps,
            adjust_step=cfg.adjust_step,
        )
        self.optimizer = build_optimizer(
            (p for p in self.model.parameters() if p.requires_grad),
            beta1=cfg.adam_beta1,
            beta2=cfg.adam_beta2,
            eps=cfg.adam_eps,
            weight_decay=cfg.weight_decay,
        )
        self.state = TrainState(step=self.update_step)
        # prune-retrain state (relora_tpu/train/trainer.py:414-431): the mask
        # is computed once at the first merge at or past prune_start_step;
        # a resume restores it from the checkpoint's sidecar
        self._reinit = make_reinit_fn(cfg.reset_init)
        self._prune_mask = None
        self._prune_meta: Optional[dict] = None
        if self.resume_dir and cfg.prune_enabled and self.lora_spec is not None:
            self._prune_mask, self._prune_meta = load_mask(self.resume_dir, device=self.device)
            if self._prune_mask is not None:
                logger.info(f"Restored prune mask from {self.resume_dir} "
                            f"(sparsity {self._prune_meta.get('sparsity', 0) if self._prune_meta else 0:.3f})")
        if self.resume_dir:
            # a fresh optimizer keeps the schedule's position: state.step is
            # the update reached and nothing was skipped since
            self._restore(self.resume_dir, optimizer=cfg.load_optimizer_state_on_resume)
        start = self.scheduler_start_step
        self._train_step = make_train_step(
            self.model,
            self.optimizer,
            clip_grad_norm=cfg.clip_grad_norm,
            schedule=lambda s: self.schedule(s - start),
            loss_impl=cfg.loss_impl,
            vocab_chunk=cfg.vocab_chunk,
            log_per_layer_scaling=cfg.train_scaling,
        )
        self.records: list = []
        if cfg.save_dir:
            os.makedirs(cfg.save_dir, exist_ok=True)
            cfg.save_json(os.path.join(cfg.save_dir, TRAINING_CONFIG_FILE))

        # ---- observability (relora_tpu/train/trainer.py:441-505) ----------
        run_config = dict(cfg.to_dict())
        run_config.update({
            "model": model_cfg.to_dict(),
            "mesh": {"data": self.n_batch_shards},
            "grad_accum": self.grad_accum,
            **{k: v / 1e6 for k, v in counts.items()},
        })
        self.metrics = MetricsLogger(run_dir=cfg.save_dir, source="train", config=run_config)
        trace_dir = os.environ.get("RELORA_TPU_TRACE_DIR")
        # perf_counter spans: the waterfall adds their durations to intervals
        # of the same clock
        self.tracer = Tracer(
            service="train",
            jsonl_path=os.path.join(trace_dir, "train_spans.jsonl") if trace_dir else None,
            clock=time.perf_counter,
        )
        self.obs = MetricsRegistry(namespace="relora_train")
        self._mem_poller = obs_memory.MemoryPoller(registry=self.obs, device=self.device)
        self.metrics.event(
            "memory_plan",
            step=self.update_step,
            source="pytree",
            **obs_memory.state_breakdown({"params": self.model, "opt_state": self.optimizer}),
            **{f"live_{k}": v for k, v in self._mem_poller.poll().items()},
        )
        if cfg.save_dir:
            flight.configure(dump_dir=cfg.save_dir)
        # live MFU: the update's counted FLOPs (on its first batch) over the
        # card's peak; null without a peak
        self._peak_flops = peak_flops(self.device)
        self._step_flops: Optional[float] = None

    def _maybe_compute_prune_mask(self) -> None:
        """First prune event (``relora_tpu/train/trainer.py:531-575``): the
        keep-mask from the just-merged base, the pruned positions zeroed in
        place, and a ``prune_mask_computed`` event."""
        cfg = self.cfg
        if self._prune_mask is not None or not cfg.prune_enabled or self.update_step < cfg.prune_start_step:
            return
        t0 = time.perf_counter()
        mask = magnitude_mask(self.model, cfg.prune_sparsity, scope=cfg.prune_scope, nm=cfg.prune_nm)
        apply_mask(self.model, mask)
        stats = sparsity_stats(mask)
        self._prune_mask = mask
        self._prune_meta = {
            "target_sparsity": cfg.prune_sparsity,
            "scope": cfg.prune_scope,
            "nm": cfg.prune_nm,
            "computed_at_step": self.update_step,
        }
        self.metrics.event("prune_mask_computed", step=self.update_step,
                           sparsity=stats["sparsity"], mask_crc32=mask_checksum(mask))
        logger.info(f"Prune mask computed at update {self.update_step}: "
                    f"{stats['sparsity'] * 100:.2f}% of base weights zeroed "
                    f"({time.perf_counter() - t0:.2f}s)")

    def _guard_batch_size_unchanged(self) -> None:
        """A resume at another batch size would rewind the data wrongly
        (``relora_tpu/train/trainer.py:626-640``); the config beside the
        checkpoints says which size wrote them."""
        p = os.path.join(os.path.dirname(self.resume_dir), TRAINING_CONFIG_FILE)
        if not os.path.exists(p) and self.cfg.save_dir:
            p = os.path.join(self.cfg.save_dir, TRAINING_CONFIG_FILE)
        if os.path.exists(p):
            with open(p) as f:
                old = json.load(f)
            if old.get("batch_size") != self.cfg.batch_size:
                raise RuntimeError("Cannot resume from a checkpoint with a different batch size")

    def _restore(self, path: str, optimizer: bool = True) -> None:
        """The params of the checkpoint at ``path`` and, with ``optimizer``,
        AdamW's state and the NaN gate's counters, the directory verified
        against its manifest first."""
        ok, reason = verify_checkpoint(path)
        if not ok:
            raise ValueError(f"cannot restore from corrupt checkpoint {path}: {reason}")
        self.model.load_state_dict(restore_params_host(path))
        if optimizer:
            saved = load_optimizer_state(path)
            self.optimizer.load_state_dict(saved["optimizer"])
            self.state.step, self.state.n_skipped = saved["step"], saved["n_skipped"]
        logger.info(f"Restored params{' and optimizer state' if optimizer else ''} from {path}")

    def save(self, update_time: float = 0.0) -> str:
        """Checkpoint the run at ``save_dir/model_{update_step}``
        (``relora_tpu/train/trainer.py:1366-1410``) and apply the retention;
        a failed save is logged and returns ``""``: the previous checkpoint
        stays the resume target and the next cadence tries again."""
        cfg = self.cfg
        training_state = {
            "global_step": self.global_step,
            "update_step": self.update_step,
            "tokens_seen": self.tokens_seen,
            "tokens_seen_before": self.tokens_seen_before,
            "n_lora_restarts": self.n_lora_restarts,
            "n_optimizer_resets": self.n_optimizer_resets,
            "update_time": update_time,
            "wandb_id": None,
            "scheduler_start_step": self.scheduler_start_step,
            "skip_batches": sorted(cfg.skip_batches),
            "n_spike_rollbacks": self.n_spike_rollbacks,
        }
        optimizer_state = {
            "optimizer": self.optimizer.state_dict(),
            "step": self.state.step,
            "n_skipped": self.state.n_skipped,
        }
        t0 = time.perf_counter()
        try:
            with self.tracer.span("checkpoint", step=self.update_step):
                path = save_checkpoint(
                    cfg.save_dir, self.update_step, self.model.state_dict(), training_state,
                    self.lora_spec, optimizer_state,
                    retries=cfg.save_retries, retry_backoff=cfg.save_retry_backoff,
                    publish=True, prune_mask=self._prune_mask, prune_meta=self._prune_meta,
                )
        except (OSError, ValueError) as e:
            logger.error(f"Checkpoint save at step {self.update_step} abandoned: {e}")
            self.metrics.event("save_failed", step=self.update_step, error=str(e))
            return ""
        logger.info(f"Saved checkpoint {path} in {time.perf_counter() - t0:.2f}s")
        delete_old_checkpoints(cfg.save_dir, cfg.keep_checkpoints)
        return path

    def _handle_spike(self, spike: SpikeEvent, can_realign: bool) -> bool:
        """Roll back to the last checkpoint strictly before the spike and
        blacklist its batches (``relora_tpu/train/trainer.py:1280-1330``);
        True when it rolled back (the caller rebuilds the data iterator), False
        when the spike is only logged."""
        cfg = self.cfg
        self.metrics.event(
            "loss_spike", step=spike.last_step, first_step=spike.first_step,
            last_step=spike.last_step, loss=spike.loss, median=spike.median, mad=spike.mad,
        )
        logger.error(
            f"Sustained loss spike over updates {spike.first_step}..{spike.last_step} "
            f"(loss={spike.loss:.4f}, baseline median={spike.median:.4f}, mad={spike.mad:.4f})"
        )
        # what the loop did in the updates before the spike, before a
        # rollback changes the state
        flight.dump_on_fault("loss_spike")
        reason = None
        if self.n_spike_rollbacks >= cfg.max_spike_rollbacks:
            reason = f"rollback budget exhausted ({cfg.max_spike_rollbacks})"
        elif not can_realign:
            reason = "no train_iter_factory to realign the data stream"
        elif not cfg.save_dir:
            reason = "no save_dir to roll back to"
        if reason is None:
            ts, target = get_last_checkpoint(cfg.save_dir, before_step=spike.first_step)
            if target is None:
                reason = "no committed checkpoint precedes the spike"
        if reason is not None:
            logger.error(f"Loss spike NOT rolled back: {reason}")
            self.metrics.event("rollback_skipped", step=spike.last_step, reason=reason)
            return False
        # skip indices are the pre-increment counter: the logged window
        # [first, last] is indices [first - 1, last - 1], plus the margin
        new_skips = set(range(spike.first_step - 1, spike.last_step + cfg.spike_rollback_margin))
        cfg.skip_batches |= new_skips
        self._restore(target)
        if cfg.prune_enabled and self.lora_spec is not None:
            # the target may predate the prune event: its mask, or none
            self._prune_mask, self._prune_meta = load_mask(target, device=self.device)
        self.update_step = ts["update_step"]
        self.global_step = ts["global_step"]
        self.tokens_seen = ts["tokens_seen"]
        self.tokens_seen_before = ts.get("tokens_seen_before", self.tokens_seen)
        self.n_lora_restarts = ts.get("n_lora_restarts", self.n_lora_restarts)
        self.n_optimizer_resets = ts.get("n_optimizer_resets", self.n_optimizer_resets)
        # as after a resume: the partial cycle from the target completes first
        self._local_updates = 0
        self._resumed = True
        self.n_spike_rollbacks += 1
        self.metrics.event(
            "rollback", step=self.update_step, target=target, skip_batches=sorted(new_skips),
            n_spike_rollbacks=self.n_spike_rollbacks,
        )
        logger.warning(
            f"Rolled back to {target} (update {self.update_step}); blacklisted batch indices "
            f"{sorted(new_skips)} (rollback {self.n_spike_rollbacks}/{cfg.max_spike_rollbacks})"
        )
        return True

    # ------------------------------------------------------------------
    def _device_batch(self, batch: np.ndarray) -> torch.Tensor:
        """Token ids on the model's device; to a CUDA device through a pinned
        host tensor and an asynchronous copy."""
        host = torch.as_tensor(np.asarray(batch), dtype=torch.long)
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def _measure_step_flops(self, batch: torch.Tensor) -> float:
        """Counted FLOPs of one update of ``batch``'s shape (``obs/mfu.py``),
        attention counted as the arm the device runs (the flash kernels on
        CUDA, the naive arm elsewhere)."""
        ga, micro, seq = batch.shape
        spec = self.lora_spec
        return step_flops(
            self.model_cfg, microbatch=micro, seq=seq, grad_accum=ga,
            lora_r=spec.r if spec is not None else None,
            lora_only=spec is not None and spec.lora_only,
            remat=self.cfg.remat,
            remat_policy=self.cfg.remat_policy,
            loss_impl=self.cfg.loss_impl,
            attention="flash" if self.device.type == "cuda" else "naive",
        )

    def fit(
        self,
        train_iter: Iterator[np.ndarray],
        eval_iter_factory=None,
        train_iter_factory=None,
    ) -> dict:
        """The update loop (``relora_tpu/train/trainer.py:780-1203``).
        ``train_iter`` yields ``(grad_accum, microbatch, seq)`` token arrays;
        ``eval_iter_factory()`` a fresh iterator of ``(microbatch, seq)``
        arrays.  ``train_iter_factory()`` rebuilds the training iterator from
        the trainer's current counters: a spike rollback needs it to realign
        the data, and without it a spike is logged, not rolled back."""
        cfg = self.cfg
        exhausted = True
        aborted = False
        preempted = False
        saved_at = -1
        detector = (
            LossSpikeDetector(cfg.spike_threshold, window=cfg.spike_window,
                              min_history=cfg.spike_min_history, patience=cfg.spike_patience)
            if cfg.spike_threshold > 0
            else None
        )
        prof = maybe_make_profiler(cfg, run_name=os.path.basename(cfg.save_dir or "run"))
        t_fit = time.perf_counter()
        update_start = time.perf_counter()
        logger.info(
            f"Starting training at update step {self.update_step} "
            f"({cfg.num_training_steps - self.update_step} to go)"
        )
        # records wait here for the flush every log_every updates; the
        # window's seconds by waterfall share, each interval inside the window
        pending: list = []  # (record, global_step)
        window = dict.fromkeys(("data_fetch", "dispatch", "compute"), 0.0)
        window_t0 = time.perf_counter()

        def flush_pending() -> None:
            """Write the pending records and the window's mfu_gap record (the
            shares of its wall time, hbm gauges polled here only)."""
            nonlocal window_t0
            if not pending:
                return
            now = time.perf_counter()
            wall = now - window_t0
            window_t0 = now
            if wall > 0:
                shares = {k: v / wall for k, v in window.items()}
                shares["comms"] = 0.0  # one card: no collective
                shares["host"] = max(0.0, 1.0 - sum(shares.values()))
                gap = {"mfu_gap/window_steps": len(pending), "mfu_gap/wall_s": round(wall, 4)}
                for key in GAP_KEYS:
                    gap[f"mfu_gap/{key}"] = round(shares[key], 4)
                    self.obs.set_gauge(f"mfu_gap_{key}", gap[f"mfu_gap/{key}"])
                mem = self._mem_poller.poll()
                if mem["available"]:
                    gap["hbm/bytes_in_use"] = mem["bytes_in_use"]
                    gap["hbm/peak_bytes_in_use"] = mem["peak_bytes_in_use"]
                self.metrics.log(gap, step=pending[-1][1])
            # the records are host values already: the pull is their write
            with self.tracer.span("metric_pull", n_records=len(pending)):
                for record, at_global in pending:
                    self.metrics.log(record, step=at_global)
            pending.clear()
            for key in window:
                window[key] = 0.0

        def take_record(metrics: dict) -> None:
            """The record of the update just taken, queued for the flush."""
            nonlocal update_start
            now = time.perf_counter()
            pending.append((self._log_update(metrics, now - update_start), self.global_step))
            update_start = now
            if len(pending) >= cfg.log_every:
                flush_pending()

        if self.update_step >= cfg.num_training_steps:
            train_iter = iter(())  # a run resumed past its budget reads no data
        self.model.train()
        try:
          with PreemptionGuard(enabled=cfg.handle_preemption) as guard:
            # the outer loop exists for spike rollback: it rewinds the counters
            # and restarts the inner loop on a rebuilt iterator
            while True:
              restart = False
              exhausted = True
              batches = iter(train_iter)
              while True:
                # one update_step span an iteration, the batch wait inside it
                with self.tracer.span("update_step", step=self.update_step):
                  with self.tracer.span("data_fetch") as sp_fetch:
                      batch = next(batches, None)
                      if batch is not None:
                          batch = self._device_batch(batch)
                  window["data_fetch"] += sp_fetch.duration_s
                  if batch is None:
                      break  # the data ran out: exhausted stays True
                  if self.update_step >= cfg.num_training_steps:
                      exhausted = False
                      break
                  if self.update_step in cfg.skip_batches:
                      self.metrics.event("batch_skipped", step=self.update_step)
                      self.update_step += 1
                      self.global_step += self.grad_accum
                      continue
                  self.tokens_seen += batch.numel()
                  if self._step_flops is None:
                      self._step_flops = self._measure_step_flops(batch)
                  seeds = dropout_seeds(cfg.seed + 1, self.update_step, self.grad_accum)
                  with self.tracer.span("dispatch", step=self.update_step) as sp_dispatch:
                      metrics = self._train_step(self.state, batch, seeds)
                  wait = min(self.state.device_wait_s, sp_dispatch.duration_s)
                  window["dispatch"] += sp_dispatch.duration_s - wait
                  window["compute"] += wait
                  self.update_step += 1
                  self._local_updates += 1
                  self.global_step += self.grad_accum
                  if guard.requested:
                      # the update ran in full: log it, then save and stop
                      self.metrics.event("preemption", step=self.update_step, signum=guard.signum)
                      update_time = time.perf_counter() - update_start
                      take_record(metrics)
                      flush_pending()
                      if cfg.save_dir:
                          path = self.save(update_time)
                          if path:
                              saved_at = self.update_step
                              logger.warning(f"Emergency checkpoint at update {self.update_step}")
                              self.metrics.event("emergency_checkpoint", step=self.update_step, path=path)
                      preempted = True
                      exhausted = False
                      break

                  if (
                      cfg.save_dir
                      and cfg.save_every > 0
                      and self._local_updates > 1
                      and self.update_step % cfg.save_every == 0
                  ):
                      if self.save(time.perf_counter() - update_start):
                          saved_at = self.update_step

                  if eval_iter_factory is not None and cfg.eval_every > 0 and self.update_step % cfg.eval_every == 0:
                      with self.tracer.span("eval", step=self.update_step):
                          eval_loss, eval_tokens = self.evaluate(
                              eval_iter_factory(), cfg.eval_tokens_during_training
                          )
                      self.model.train()
                      self.metrics.log({"final_eval_loss": eval_loss, "final_eval_tokens": eval_tokens},
                                       step=self.global_step)
                      logger.info(f"Eval loss at step {self.update_step}: {eval_loss:.4f} ({eval_tokens:.0f} tokens)")

                  relora_every = cfg.relora
                  if (
                      relora_every is not None
                      and (self._resumed or self._local_updates >= relora_every)
                      and (self.update_step - self.scheduler_start_step) % relora_every == 1
                  ):
                      t0 = time.perf_counter()
                      self.n_lora_restarts += 1
                      with self.tracer.span("relora_merge", step=self.update_step, n=self.n_lora_restarts):
                          merge_and_reinit(self.model, keyed_generator(cfg.seed + 2, self.update_step, self.device),
                                           self.lora_spec, a_init=self._reinit, mask=self._prune_mask)
                          # PERP: the first eligible merge fixes the mask,
                          # later merges apply it before the cast or requant
                          self._maybe_compute_prune_mask()
                      logger.info(
                          f"LoRA merge #{self.n_lora_restarts} at update {self.update_step} "
                          f"took {time.perf_counter() - t0:.2f}s"
                      )

                  cycle = cfg.cycle_length or cfg.relora
                  if (
                      cfg.relora is not None
                      and cycle is not None
                      and (self._resumed or self._local_updates >= cycle)
                      and (self.update_step - self.scheduler_start_step) % cycle == 1
                  ):
                      self.n_optimizer_resets += 1
                      with self.tracer.span("optimizer_reset", step=self.update_step, n=self.n_optimizer_resets):
                          reset_optimizer_state(
                              self.optimizer, self.model,
                              mode=cfg.optimizer_reset_mode or "zero",
                              ratio=cfg.optimizer_reset_ratio,
                              generator=keyed_generator(cfg.seed + 3, self.update_step, self.device),
                          )
                          z = zeroed_fraction(self.optimizer)
                      logger.info(
                          f"Optimizer reset #{self.n_optimizer_resets} ({cfg.optimizer_reset_mode}) "
                          f"at update {self.update_step}: {z * 100:.2f}% of moments zero"
                      )
                      lr_now = self.schedule(self.update_step - self.scheduler_start_step)
                      if lr_now > cfg.lr:
                          self.metrics.alert("Learning rate issue", f"LR after reset is {lr_now} > max {cfg.lr}")

                  take_record(metrics)
                  if prof is not None:
                      prof.step()
                  if metrics["skipped"]:
                      logger.error(f"NaN update skipped at step {self.update_step} ({metrics['n_skipped']} total)")
                      self.metrics.event("nan_skip", step=self.update_step, n_skipped=metrics["n_skipped"])
                      if metrics["n_skipped"] > cfg.nan_abort_fraction * cfg.num_training_steps:
                          logger.error("More than 5% of updates NaN-skipped; aborting")
                          aborted = True
                          exhausted = False
                          break

                  spike = detector.update(self.update_step, metrics["loss"]) if detector else None
                  if spike is not None:
                      rolled_back = self._handle_spike(spike, can_realign=train_iter_factory is not None)
                      detector.reset_streak()
                      if rolled_back:
                          pending.clear()  # the updates they describe were undone
                          restart = True
                          exhausted = False
                          break
              if restart:
                  train_iter = train_iter_factory()
                  update_start = time.perf_counter()
                  continue
              break
        except BaseException:
            # a crash inside the loop leaves the last spans and events behind
            flight.dump_on_fault("crash")
            raise
        finally:
            if prof is not None:
                prof.close()  # a window open at the exit ends and is written
        flush_pending()
        if exhausted and self.update_step < cfg.num_training_steps:
            logger.warning("Reached the end of the dataset before num_training_steps")
        if cfg.save_dir and self.update_step != saved_at:
            self.save(time.perf_counter() - update_start)

        result = {
            "update_step": self.update_step,
            "tokens_seen": self.tokens_seen,
            "aborted": aborted,
            "preempted": preempted,
            "n_rollbacks": self.n_spike_rollbacks,
            "n_skipped": self.state.n_skipped,
            "n_lora_restarts": self.n_lora_restarts,
            "n_optimizer_resets": self.n_optimizer_resets,
            "fit_seconds": time.perf_counter() - t_fit,
            "step_flops": self._step_flops,
            "peak_flops": self._peak_flops,
        }
        if eval_iter_factory is not None and not preempted:
            final_loss, final_tokens = self.evaluate(eval_iter_factory(), target_tokens=cfg.final_eval_tokens)
            self.metrics.log({"final_eval_loss": final_loss, "final_eval_tokens": final_tokens},
                             step=self.global_step)
            result["final_eval_loss"] = final_loss
        result["eval_batches"] = self.eval_batches
        result["records"] = self.records
        self.metrics.finish()
        self.tracer.close()
        logger.info("Training finished")
        return result

    def _log_update(self, metrics: dict, update_time: float) -> dict:
        """Append and log the record of the update just taken, its live MFU
        and throughputs over ``update_time`` seconds; returns the record of
        ``metrics.jsonl`` (the JAX trainer's keys and ``update_seconds``)."""
        tokens_in_update = self.tokens_seen - self.tokens_seen_before
        self.tokens_seen_before = self.tokens_seen
        tokens_per_sec = tokens_in_update / update_time
        mfu = None if self._peak_flops is None else self._step_flops / update_time / self._peak_flops
        if mfu is not None:
            self.obs.set_gauge("mfu", mfu)
        self.obs.set_gauge("throughput_tokens_per_s", tokens_per_sec)
        record = {
            **metrics,
            "update_step": self.update_step,
            "global_step": self.global_step,
            "update_seconds": update_time,
            "mfu": mfu,
            "throughput_tokens": tokens_per_sec,
            "throughput_examples": self.cfg.total_batch_size / update_time,
            "throughput_batches": self.grad_accum * self.n_batch_shards / update_time,
            "tokens_seen": self.tokens_seen,
            "n_lora_restarts": self.n_lora_restarts,
            "n_optimizer_resets": self.n_optimizer_resets,
        }
        self.records.append(record)
        logger.info(json.dumps(record))
        return {k: v for k, v in record.items() if k not in ("skipped", "n_skipped", "global_step")}

    # ------------------------------------------------------------------
    def evaluate(self, eval_iter: Iterator[np.ndarray], target_tokens: int = -1, sync_every: int = 8):
        """Token-weighted mean eval loss over ``eval_iter`` until
        ``target_tokens`` (-1: the whole iterator), device sums read every
        ``sync_every`` batches; returns ``(loss, n_tokens)``."""
        self.model.eval()
        loss_sum = n_tokens = 0.0
        pending = []
        expected = 0

        def drain():
            nonlocal loss_sum, n_tokens
            if pending:
                sums = torch.stack([torch.stack(p) for p in pending]).sum(dim=0).tolist()
                loss_sum += sums[0]
                n_tokens += sums[1]
                pending.clear()
                if np.isnan(loss_sum):
                    raise RuntimeError("NaN in evaluation loss")

        for arr in eval_iter:
            pending.append(eval_step(self.model, self._device_batch(arr), self.cfg.loss_impl,
                                     self.cfg.vocab_chunk))
            self.eval_batches += 1
            shape = np.shape(arr)
            expected += shape[0] * max(shape[-1] - 1, 1)
            if len(pending) >= max(sync_every, 1) or (target_tokens > 0 and expected >= target_tokens):
                drain()
                if target_tokens > 0:
                    if n_tokens >= target_tokens:
                        break
                    expected = int(n_tokens)
        drain()
        return loss_sum / max(n_tokens, 1.0), n_tokens
