"""Training orchestration: the update loop of ``relora_tpu/train/trainer.py``.

Builds the model of the config's family, Llama or GPT-NeoX / Pythia (LoRA
on every attention and MLP projection when ``use_peft``), initialises it from ``--seed``, splits trainable from frozen
parameters, builds AdamW and the schedule, and runs the loop: one update per
``(grad_accum, microbatch, seq)`` batch, a graceful stop at the update
boundary after SIGTERM/SIGINT (``handle_preemption``), eval every
``eval_every``, the ReLoRA merge-and-reinit when ``(update_step -
scheduler_start_step) % relora == 1`` once ``relora`` updates ran here, and
the optimizer reset on the same rule with ``cycle_length``
(``relora_tpu/train/trainer.py:1053-1106``).  Each update logs one metrics
record; :meth:`Trainer.fit` returns the result dict of the JAX trainer plus
the port's counters and the records.

``--warmed_up_model DIR`` grafts ``DIR/pytorch_model.bin`` into the freshly
initialised model (``models/warm_start.py``) and takes the counters of
``DIR/training_state.json`` when it exists, the schedule starting there
(``relora_tpu/train/trainer.py:284-319``).  ``--quantize int8`` stores every
LoRA projection's frozen base as int8 codes and scales: kernel 8 in each
unfused projection, the int8 fused kernels under ``--lora_fused true``, and
a dequantize-add-requantize merge.

Options the port does not run yet raise ``NotImplementedError`` when set:
checkpoints (``save_dir``, resume, autoresume, a warm start from a
checkpoint's ``state/``), loss-spike rollback, pruning, magnitude re-init,
``--quantize nf4``, ``--lora_fused auto``, chunked loss, the
``wandb``/``watch``/``profile`` observability, a custom PRNG, and
parallelism beyond one device.  ``--lora_fused true`` runs every LoRA
projection through the fused kernels wherever dropout is not active.

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
from relora_tpu_torch.config.model import ModelConfig, load_model_config
from relora_tpu_torch.config.training import TrainingConfig
from relora_tpu_torch.core.optim import build_optimizer, reset_optimizer_state, zeroed_fraction
from relora_tpu_torch.core.relora import LoraSpec, merge_and_reinit, set_trainable, split_param_counts
from relora_tpu_torch.core.schedules import make_schedule
from relora_tpu_torch.models.family import CausalLM, causal_lm_class
from relora_tpu_torch.models.params_util import init_params
from relora_tpu_torch.models.warm_start import STATE_SUBDIR, load_warm_start, warm_start_counters
from relora_tpu_torch.train.resilience import PreemptionGuard
from relora_tpu_torch.train.step import TrainState, eval_step, make_train_step

logger = logging.getLogger(__name__)

_MASK64 = (1 << 64) - 1


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
        "save_dir (checkpoints)": cfg.save_dir is not None,
        "resume_from": cfg.resume_from is not None,
        "autoresume": cfg.autoresume,
        "warmed_up_model with a state/ checkpoint": cfg.warmed_up_model is not None
        and os.path.isdir(os.path.join(cfg.warmed_up_model, STATE_SUBDIR)),
        "dataset_path (HF datasets)": cfg.dataset_path is not None,
        "spike_threshold (loss-spike rollback)": cfg.spike_threshold > 0,
        "prune_sparsity / prune_nm (pruning)": cfg.prune_enabled,
        "reset_init='magnitude'": cfg.reset_init != "random",
        "quantize='nf4'": cfg.quantize == "nf4",
        "lora_fused='auto' (the LoRA cost model)": cfg.lora_fused == "auto",
        "loss_impl='chunked'": cfg.loss_impl != "dense",
        "wandb": cfg.wandb,
        "wandb_watch": cfg.wandb_watch,
        "profile": cfg.profile,
        "prng_impl": bool(cfg.prng_impl),
        "remat_policy other than 'full'": cfg.remat_policy != "full",
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
                lora_only=not need_linear_weight,
                fused=cfg.lora_fused == "true",
            )
            if cfg.use_peft
            else None
        )
        self.model = build_model(model_cfg, self.lora_spec, cfg, self.device)
        init_params(self.model, torch.Generator(device=self.device).manual_seed(cfg.seed))
        if cfg.warmed_up_model:
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
        self.eval_batches = 0
        self._local_updates = 0
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
        start = self.scheduler_start_step
        self._train_step = make_train_step(
            self.model,
            self.optimizer,
            clip_grad_norm=cfg.clip_grad_norm,
            schedule=lambda s: self.schedule(s - start),
            loss_impl=cfg.loss_impl,
            log_per_layer_scaling=cfg.train_scaling,
        )
        self.records: list = []

    # ------------------------------------------------------------------
    def _device_batch(self, batch: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch), dtype=torch.long).to(self.device)

    def fit(
        self,
        train_iter: Iterator[np.ndarray],
        eval_iter_factory=None,
        train_iter_factory=None,
    ) -> dict:
        """The update loop (``relora_tpu/train/trainer.py:780-1203``).
        ``train_iter`` yields ``(grad_accum, microbatch, seq)`` token arrays;
        ``eval_iter_factory()`` a fresh iterator of ``(microbatch, seq)``
        arrays.  ``train_iter_factory`` is accepted for signature parity (the
        JAX trainer needs it for spike rollback, which is not ported)."""
        cfg = self.cfg
        exhausted = True
        aborted = False
        preempted = False
        t_fit = time.perf_counter()
        update_start = time.perf_counter()
        logger.info(
            f"Starting training at update step {self.update_step} "
            f"({cfg.num_training_steps - self.update_step} to go)"
        )
        self.model.train()
        with PreemptionGuard(enabled=cfg.handle_preemption) as guard:
            for batch in train_iter:
                if self.update_step >= cfg.num_training_steps:
                    exhausted = False
                    break
                if self.update_step in cfg.skip_batches:
                    self.update_step += 1
                    self.global_step += self.grad_accum
                    continue
                self.tokens_seen += int(np.asarray(batch).size)
                seeds = dropout_seeds(cfg.seed + 1, self.update_step, self.grad_accum)
                metrics = self._train_step(self.state, self._device_batch(batch), seeds)
                self.update_step += 1
                self._local_updates += 1
                self.global_step += self.grad_accum
                if guard.requested:
                    # JAX writes an emergency checkpoint here; checkpoints are not ported
                    preempted = True
                    exhausted = False
                    break

                if eval_iter_factory is not None and cfg.eval_every > 0 and self.update_step % cfg.eval_every == 0:
                    eval_loss, eval_tokens = self.evaluate(eval_iter_factory(), cfg.eval_tokens_during_training)
                    self.model.train()
                    logger.info(f"Eval loss at step {self.update_step}: {eval_loss:.4f} ({eval_tokens:.0f} tokens)")

                relora_every = cfg.relora
                if (
                    relora_every is not None
                    and self._local_updates >= relora_every
                    and (self.update_step - self.scheduler_start_step) % relora_every == 1
                ):
                    t0 = time.perf_counter()
                    self.n_lora_restarts += 1
                    merge_and_reinit(self.model, keyed_generator(cfg.seed + 2, self.update_step, self.device),
                                     self.lora_spec)
                    logger.info(
                        f"LoRA merge #{self.n_lora_restarts} at update {self.update_step} "
                        f"took {time.perf_counter() - t0:.2f}s"
                    )

                cycle = cfg.cycle_length or cfg.relora
                if (
                    cfg.relora is not None
                    and cycle is not None
                    and self._local_updates >= cycle
                    and (self.update_step - self.scheduler_start_step) % cycle == 1
                ):
                    self.n_optimizer_resets += 1
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
                        logger.warning(f"Learning rate check: LR after reset is {lr_now} > max {cfg.lr}")

                now = time.perf_counter()
                update_time, update_start = now - update_start, now
                tokens_in_update = self.tokens_seen - self.tokens_seen_before
                self.tokens_seen_before = self.tokens_seen
                record = {
                    **metrics,
                    "update_step": self.update_step,
                    "global_step": self.global_step,
                    "update_seconds": update_time,
                    "throughput_tokens": tokens_in_update / update_time,
                    "throughput_examples": cfg.total_batch_size / update_time,
                    "tokens_seen": self.tokens_seen,
                    "n_lora_restarts": self.n_lora_restarts,
                    "n_optimizer_resets": self.n_optimizer_resets,
                }
                self.records.append(record)
                logger.info(json.dumps(record))
                if metrics["skipped"]:
                    logger.error(f"NaN update skipped at step {self.update_step} ({metrics['n_skipped']} total)")
                    if metrics["n_skipped"] > cfg.nan_abort_fraction * cfg.num_training_steps:
                        logger.error("More than 5% of updates NaN-skipped; aborting")
                        aborted = True
                        exhausted = False
                        break
        if exhausted and self.update_step < cfg.num_training_steps:
            logger.warning("Reached the end of the dataset before num_training_steps")

        result = {
            "update_step": self.update_step,
            "tokens_seen": self.tokens_seen,
            "aborted": aborted,
            "preempted": preempted,
            "n_rollbacks": 0,
            "n_skipped": self.state.n_skipped,
            "n_lora_restarts": self.n_lora_restarts,
            "n_optimizer_resets": self.n_optimizer_resets,
            "fit_seconds": time.perf_counter() - t_fit,
        }
        if eval_iter_factory is not None and not preempted:
            final_loss, _ = self.evaluate(eval_iter_factory(), target_tokens=cfg.final_eval_tokens)
            result["final_eval_loss"] = final_loss
        result["eval_batches"] = self.eval_batches
        result["records"] = self.records
        logger.info("Training finished")
        return result

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
            pending.append(eval_step(self.model, self._device_batch(arr)))
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
