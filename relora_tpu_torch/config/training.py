"""Typed training configuration with full flag parity to the reference CLI.

A copy of ``relora_tpu/config/training.py`` for the PyTorch port (which
imports nothing of the JAX package): every flag of the JAX CLI, with the same
names, defaults, derivation and validation, plus ``device`` (``cuda`` unless
``--device cpu``).  PyYAML is imported only when a YAML file is read or
written.  Flags whose feature the port does not run yet are accepted here
and refused by the trainer with ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Optional

logger = logging.getLogger(__name__)


def parse_token_count(value) -> Optional[int]:
    """Parse "100M"/"1B"/plain ints (parity: training_utils.max_train_tokens_to_number)."""
    if value is None:
        return None
    if isinstance(value, int):
        return value
    s = str(value)
    if s.endswith("M"):
        return int(s[:-1]) * 1_000_000
    if s.endswith("B"):
        return int(s[:-1]) * 1_000_000_000
    return int(s)


@dataclass
class TrainingConfig:
    # --- model source ---
    model_config: Optional[str] = None  # zoo name or HF-style JSON path
    model_name_or_path: Optional[str] = None
    model_revision: Optional[str] = None
    warmed_up_model: Optional[str] = None  # weights + counters, no optimizer
    resume_from: Optional[str] = None  # full state
    load_optimizer_state_on_resume: bool = True

    # --- data ---
    dataset_path: Optional[str] = None
    megatron_dataset_config: Optional[str] = None
    max_length: int = 512
    workers: int = 8

    # --- batch arithmetic ---
    batch_size: Optional[int] = None  # per-device micro batch
    gradient_accumulation: Optional[int] = None
    total_batch_size: Optional[int] = None

    # --- ReLoRA ---
    use_peft: bool = False
    lora_r: Optional[int] = 128
    lora_alpha: float = 32
    lora_dropout: float = 0.1
    relora: Optional[int] = None  # merge-and-reinit every N update steps
    train_scaling: bool = False
    # LoRA composite execution: "false" = historical unfused path, "true" =
    # the fused CUDA kernels (ops/lora_matmul), "auto" = the cost model's
    # per-shape pick (ops/lora_dispatch).  A string (not bool) so the CLI
    # accepts "auto" — maps onto LoraSpec.fused.
    lora_fused: str = "false"
    reset_optimizer_on_relora: bool = True
    optimizer_random_pruning: float = 0.0
    optimizer_magnitude_pruning: float = 0.0
    force_keep_original: bool = False

    # --- compression (relora_tpu/compress; PERP prune-retrain) ---
    # Base-weight magnitude pruning, applied at ReLoRA merges: at the first
    # merge past prune_start_step the mask is computed from the merged base
    # (fixed from then on) and re-applied after every later merge, so each
    # cycle runs merge -> prune -> re-init A/B -> continue and the LoRA
    # factors retrain around the holes.  0.0 disables pruning entirely.
    prune_sparsity: float = 0.0
    prune_scope: str = "global"  # global | per_matrix magnitude threshold
    prune_nm: Optional[str] = None  # structured "N:M" (overrides sparsity/scope)
    prune_start_step: int = 0  # first update step eligible to compute the mask
    # A/B re-draw flavor at ReLoRA resets (compress/resets.py):
    # "random" = historical kaiming draw (byte-for-byte), "magnitude" =
    # weight-magnitude-aligned init from the merged base
    reset_init: str = "random"

    # --- optimization ---
    optimizer: str = "adam"
    lr: float = 1e-4
    scheduler: str = "cosine"  # linear | cosine | cosine_restarts
    cycle_length: Optional[int] = None
    restart_warmup_steps: Optional[int] = None
    adjust_step: int = 0
    min_lr_ratio: float = 0.1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_steps: int = 1_000
    clip_grad_norm: float = 1.0
    num_training_steps: int = 10_000
    max_train_tokens: Optional[Any] = None  # accepts "100M"/"1B"

    # --- eval / save ---
    # Metric-materialization cadence: device metrics from the last
    # `log_every` updates are pulled to the host in ONE bulk transfer
    # (metrics stay lagged by at least one step either way).  Raising this
    # trades NaN-abort latency (the check runs on materialized values) for
    # fewer host round trips.
    log_every: int = 1
    eval_every: int = 1_000
    save_every: int = 10_000
    save_dir: Optional[str] = None
    keep_checkpoints: Optional[int] = None
    autoresume: bool = False

    # --- resilience (train/resilience.py, train/checkpoint.py) ---
    handle_preemption: bool = True  # SIGTERM/SIGINT -> emergency checkpoint
    save_retries: int = 3  # checkpoint-save initiation retries
    save_retry_backoff: float = 0.5  # seconds, doubled each retry
    # loss-spike rollback: 0 disables; otherwise the outlier threshold in
    # sigma-equivalents (median + threshold * 1.4826 * MAD over the window)
    spike_threshold: float = 0.0
    spike_window: int = 64  # rolling baseline size (update steps)
    spike_min_history: int = 16  # updates before detection arms
    spike_patience: int = 3  # consecutive outliers before rollback
    spike_rollback_margin: int = 1  # extra batches skipped past the spike
    max_spike_rollbacks: int = 3  # rollback budget per run

    # --- numerics ---
    dtype: str = "bfloat16"
    quantize: Optional[str] = None  # None | "int8" | "nf4"
    # storage dtype for the unquantized frozen base: None = f32 master,
    # "bf16" halves base HBM (merges still compute f32, core/relora.py)
    base_dtype: Optional[str] = None  # None | "bf16"
    # nf4 only: int8-quantize the blockwise scales too (parity:
    # use_double_quant, args flag -> bnb_4bit_use_double_quant)
    use_double_quant: bool = True

    # --- parallelism (TPU-native; replaces distributed_type) ---
    distributed_type: str = "fsdp"  # accepted alias; "ddp" -> pure data axis
    dp_size: Optional[int] = None  # data axis; None = fill remaining devices
    fsdp_size: int = 1  # parameter-sharding axis
    tp_size: int = 1  # tensor axis
    sp_size: int = 1  # sequence (context parallel) axis
    sp_impl: str = "ring"  # ring (streamed K/V) | ulysses (all-to-all heads)
    remat: bool = False  # gradient checkpointing on decoder layers
    remat_policy: str = "full"  # 'full' | 'dots' | 'dots_narrow' | 'dots_all' (params_util.remat_policy)
    bf16_logits: bool = False  # halve the logits HBM footprint; CE still f32
    loss_impl: str = "dense"  # dense | chunked (streamed vocab CE, no full logits)
    vocab_chunk: int = 8192  # chunk size for loss_impl=chunked
    # force the pallas flash kernel unconditionally (bypasses the per-shape
    # roofline dispatch that impl="auto" runs through attention_dispatch.
    # choose_training_arm); off = dispatch decides flash vs xla per shape
    flash_attention: bool = False

    # --- observability / misc ---
    profile: bool = False
    wandb: bool = False
    wandb_watch: bool = False
    tags: Optional[Any] = None
    comment: Optional[str] = None
    skip_batches: Any = None
    seed: int = 0
    eval_tokens_during_training: int = 10_000_000  # torchrun_main.py:144
    # end-of-run eval budget (reference hardcodes 100M, torchrun_main.py:984);
    # configurable so CPU/scaled runs aren't forced through a full-split pass
    final_eval_tokens: int = 100_000_000
    # '' = jax default (threefry); 'rbg' = hardware RNG for dropout bits
    # (cheaper on TPU; cross-host determinism caveats documented in jax)
    prng_impl: str = ""
    nan_abort_fraction: float = 0.05  # torchrun_main.py:820
    # the port's device: entry points run on CUDA unless asked for the CPU
    device: str = "cuda"

    # derived (set by finalize)
    _finalized: bool = field(default=False, repr=False)

    # ------------------------------------------------------------------
    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "TrainingConfig":
        """Load a reference-format YAML (training_configs/1B_v1.0.yaml) and finalize."""
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f)
        cfg = cls()
        known = {f.name for f in dataclasses.fields(cls)}
        for k, v in {**raw, **overrides}.items():
            if k == "lr":
                v = float(v)  # args_utils.py:20 — yaml may parse 4e-4 as str
            if k not in known:
                logger.warning(f"Unknown config key {k!r} ignored")
                continue
            setattr(cfg, k, v)
        return cfg.finalize()

    def finalize(self) -> "TrainingConfig":
        """Derivation + validation, mirroring args_utils.check_args_torchrun_main."""
        if self._finalized:
            return self

        if (self.dataset_path is None) == (self.megatron_dataset_config is None):
            raise ValueError(
                "Exactly one of dataset_path / megatron_dataset_config must be set; "
                f"got dataset_path={self.dataset_path!r}, "
                f"megatron_dataset_config={self.megatron_dataset_config!r}"
            )
        if self.megatron_dataset_config is not None and not os.path.exists(self.megatron_dataset_config):
            raise ValueError(f"megatron_dataset_config {self.megatron_dataset_config!r} does not exist")
        if self.batch_size is None:
            raise ValueError("batch_size must be specified")

        if isinstance(self.tags, str):
            self.tags = self.tags.split(",")

        # Reference semantics (args_utils.py:37-41 runs before the :65-67
        # promotion, making the promotion dead code): relora without use_peft
        # is dropped and the run is full-rank.  We keep that behavior but warn
        # loudly instead of silently.
        if not self.use_peft:
            if self.relora:
                logger.warning(
                    "relora is set but use_peft is false — matching the "
                    "reference, relora is ignored and this run is full-rank. "
                    "Set use_peft=true for ReLoRA training."
                )
            self.relora = None
            self.lora_r = None
            self.force_keep_original = False
        # relora=0 means disabled, exactly like None — normalize here so no
        # consumer (merge cadence, reset cadence, scheduler cycle fallback,
        # lora_only weight decision) has to remember the 0-vs-None convention
        if self.relora == 0:
            self.relora = None

        if self.total_batch_size is None:
            self.gradient_accumulation = self.gradient_accumulation or 1
            self.total_batch_size = self.batch_size * self.gradient_accumulation
        if self.total_batch_size % self.batch_size != 0:
            raise ValueError("total_batch_size must be divisible by batch_size")

        self.max_train_tokens = parse_token_count(self.max_train_tokens)
        if self.max_train_tokens is not None:
            self.num_training_steps = self.max_train_tokens // self.total_batch_size
            logger.info(f"Training for {self.num_training_steps} update steps")

        if self.warmed_up_model is not None and not os.path.exists(self.warmed_up_model):
            raise ValueError(f"warmed_up_model {self.warmed_up_model!r} does not exist")

        if self.dtype in ("fp16", "float16"):
            raise NotImplementedError("fp16 is not supported; use bfloat16 on TPU")

        n_reset_modes = (
            int(bool(self.reset_optimizer_on_relora))
            + int(bool(self.optimizer_random_pruning))
            + int(bool(self.optimizer_magnitude_pruning))
        )
        if n_reset_modes > 1:
            raise ValueError(
                "reset_optimizer_on_relora, optimizer_random_pruning and "
                "optimizer_magnitude_pruning are mutually exclusive"
            )
        if not 0 <= self.optimizer_random_pruning < 1:
            raise ValueError("optimizer_random_pruning must be in [0, 1)")
        if not 0 <= self.optimizer_magnitude_pruning < 1:
            raise ValueError("optimizer_magnitude_pruning must be in [0, 1)")

        if self.optimizer.lower() not in ("adam", "adamw", "adam_zero"):
            raise ValueError(f"Unsupported optimizer {self.optimizer!r}")

        if isinstance(self.skip_batches, str):
            self.skip_batches = set(map(int, self.skip_batches.split(",")))
        self.skip_batches = set(self.skip_batches or ())

        if self.quantize not in (None, "int8", "nf4"):
            raise ValueError(f"quantize must be None, 'int8' or 'nf4', got {self.quantize!r}")
        if str(self.lora_fused).lower() not in ("false", "true", "auto"):
            raise ValueError(
                f"lora_fused must be 'false', 'true' or 'auto', got {self.lora_fused!r}"
            )
        self.lora_fused = str(self.lora_fused).lower()
        if self.base_dtype not in (None, "bf16"):
            raise ValueError(f"base_dtype must be None or 'bf16', got {self.base_dtype!r}")
        if self.base_dtype and self.quantize:
            raise ValueError("base_dtype applies to the unquantized base; drop it or quantize")
        if self.remat_policy not in ("full", "dots", "dots_narrow", "dots_all"):
            raise ValueError(
                "remat_policy must be 'full', 'dots', 'dots_narrow' or 'dots_all', "
                f"got {self.remat_policy!r}"
            )

        if not 0 <= self.prune_sparsity < 1:
            raise ValueError(f"prune_sparsity must be in [0, 1), got {self.prune_sparsity}")
        if self.prune_scope not in ("global", "per_matrix"):
            raise ValueError(
                f"prune_scope must be 'global' or 'per_matrix', got {self.prune_scope!r}"
            )
        if self.prune_nm is not None:
            from relora_tpu_torch.compress.prune import parse_nm

            parse_nm(self.prune_nm)  # raises on malformed "N:M"
        if self.reset_init not in ("random", "magnitude"):
            raise ValueError(
                f"reset_init must be 'random' or 'magnitude', got {self.reset_init!r}"
            )
        if self.prune_start_step < 0:
            raise ValueError("prune_start_step must be >= 0")
        if (self.prune_sparsity or self.prune_nm) and not self.use_peft:
            raise ValueError(
                "base-weight pruning retrains through the LoRA factors; "
                "it requires use_peft=true (PERP regime)"
            )

        if self.log_every < 1:
            raise ValueError("log_every must be >= 1")
        if self.save_retries < 0:
            raise ValueError("save_retries must be >= 0")
        if self.spike_threshold < 0:
            raise ValueError("spike_threshold must be >= 0 (0 disables spike rollback)")
        if self.spike_threshold > 0:
            if self.spike_patience < 1:
                raise ValueError("spike_patience must be >= 1")
            if self.spike_min_history < 4:
                raise ValueError("spike_min_history must be >= 4")
            if self.spike_window < self.spike_min_history:
                raise ValueError("spike_window must be >= spike_min_history")
            if self.spike_rollback_margin < 0:
                raise ValueError("spike_rollback_margin must be >= 0")
            if self.max_spike_rollbacks < 1:
                raise ValueError("max_spike_rollbacks must be >= 1")

        self._finalized = True
        return self

    # ------------------------------------------------------------------
    @property
    def prune_enabled(self) -> bool:
        """True when the prune-retrain pipeline is active (either dial)."""
        return bool(self.prune_sparsity or self.prune_nm)

    @property
    def optimizer_reset_mode(self) -> Optional[str]:
        """Which of the three mutually exclusive reset modes is active."""
        if self.reset_optimizer_on_relora:
            return "zero"
        if self.optimizer_random_pruning:
            return "random"
        if self.optimizer_magnitude_pruning:
            return "magnitude"
        return None

    @property
    def optimizer_reset_ratio(self) -> float:
        if self.optimizer_random_pruning:
            return self.optimizer_random_pruning
        if self.optimizer_magnitude_pruning:
            return self.optimizer_magnitude_pruning
        return 1.0

    def grad_accum_for(self, n_data_parallel: int) -> int:
        """Derive grad-accum from total batch (parity: torchrun_main.py:357-364)."""
        ga = self.total_batch_size // (self.batch_size * n_data_parallel)
        if ga <= 0 or self.total_batch_size != self.batch_size * ga * n_data_parallel:
            raise ValueError(
                f"total_batch_size={self.total_batch_size} must equal "
                f"batch_size={self.batch_size} * grad_accum * dp={n_data_parallel}"
            )
        return ga

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("_finalized", None)
        d["skip_batches"] = sorted(d.get("skip_batches") or ())
        return d

    def save_json(self, path: str) -> None:
        """Persist the resolved config as JSON, the port's counterpart of
        ``save_dir/training_config.yaml`` (the card's machine has no PyYAML);
        the trainer's batch-size guard reads it back on resume."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def save(self, path: str) -> None:
        """Persist resolved config (parity: save_dir/training_config.yaml)."""
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


def parse_train_args(argv: Optional[list[str]] = None) -> TrainingConfig:
    """CLI entry: every reference flag, plus a YAML full-override path.

    Like the reference (args_utils.py:9-21), ``--training_config file.yaml``
    replaces all other flags and may not be mixed with them.
    """
    import argparse

    parser = argparse.ArgumentParser(description="relora-tpu training (PyTorch port)")
    parser.add_argument("--training_config", type=str, default=None)
    bool_t = lambda x: str(x).lower() == "true"
    for f in dataclasses.fields(TrainingConfig):
        if f.name in ("_finalized",):
            continue
        arg = f"--{f.name}"
        if f.name == "training_config":
            continue
        ann = str(f.type)
        if ann == "bool" or isinstance(f.default, bool):
            parser.add_argument(arg, type=bool_t, default=f.default)
        elif "float" in ann or isinstance(f.default, float):
            parser.add_argument(arg, type=float, default=f.default)
        elif "int" in ann or isinstance(f.default, int):
            parser.add_argument(arg, type=int, default=f.default)
        else:
            parser.add_argument(arg, default=f.default)
    ns = parser.parse_args(argv)

    if ns.training_config is not None:
        import sys

        n_extra = len([a for a in (argv if argv is not None else sys.argv[1:]) if a.startswith("--")])
        if n_extra > 1:
            raise RuntimeError(
                "Provide either --training_config or individual flags, not both"
            )
        return TrainingConfig.from_yaml(ns.training_config)

    kwargs = {k: v for k, v in vars(ns).items() if k != "training_config"}
    return TrainingConfig(**kwargs).finalize()
