"""Megatron-style data path: config parsing, dataset building, iterators.

Capability parity with megatron_dataset/data_utils.py +
the NeoXArgs data surface the training script actually uses
(torchrun_main.py:276-319): mmap ``.bin``/``.idx`` corpora, weighted
multi-corpus blending, train/valid/test from either explicit path lists or a
single ``data_path`` with a ``split`` string, deterministic resume rewind,
and per-host batch sharding.

The 2,800-LoC NeoXArgs dataclass aggregation collapses to the one small
typed config below: everything the reference's loader reads from it
(data paths/weights, split, seq_length, data_impl, seed) — the rest of the
reference YAML (model settings consumed by NeoX proper) is accepted and
ignored, so existing config files (configs/pile_megatron_dataset.yaml) load
unchanged.

A copy of ``relora_tpu/data/megatron.py`` for the PyTorch port, for one
process (no multi-host barrier).  The config is read with PyYAML where it is
installed; without it a JSON-form config (JSON is valid YAML, so the JAX
package reads the same file) is read with ``json``, and any other file
raises a clear error.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Iterator, List, Optional, Sequence

import numpy as np

from relora_tpu_torch.data.blendable import BlendableDataset
from relora_tpu_torch.data.memmap import open_token_dataset
from relora_tpu_torch.data.sample_index import PackedCausalDataset

logger = logging.getLogger(__name__)


def load_config_file(path: str) -> dict:
    """A YAML (or JSON) mapping: PyYAML when installed, else ``json``."""
    try:
        import yaml
    except ImportError:
        yaml = None
    with open(path) as f:
        text = f.read()
    if yaml is not None:
        return yaml.safe_load(text)
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"{path}: PyYAML is not installed, so the data config must be "
            f"JSON-form (JSON is valid YAML): {e}"
        ) from None


@dataclasses.dataclass
class MegatronDataConfig:
    train_data_paths: Optional[List[str]] = None
    valid_data_paths: Optional[List[str]] = None
    test_data_paths: Optional[List[str]] = None
    label_data_paths: Optional[List[str]] = None  # aligned with train_data_paths
    train_data_weights: Optional[List[float]] = None
    valid_data_weights: Optional[List[float]] = None
    test_data_weights: Optional[List[float]] = None
    data_path: Optional[str] = None
    split: str = "969,30,1"
    seq_length: int = 2048
    seed: int = 1234
    data_impl: str = "mmap"
    # NeoX batch-arithmetic keys found in the YAML (not consumed for
    # training — the training config owns batch arithmetic — but kept so
    # the loader can solve/cross-check them once the mesh size is known)
    neox_batch_keys: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_yaml(cls, path: str) -> "MegatronDataConfig":
        raw = load_config_file(path)
        known = {f.name for f in dataclasses.fields(cls) if f.name != "neox_batch_keys"}
        kwargs = {k: v for k, v in raw.items() if k in known and v not in ("", None)}
        cfg = cls(**kwargs)
        # retained for the dp-aware cross-check once the mesh is known
        # (cross_check_neox_batch in build_train_valid_test_iterators)
        cfg.neox_batch_keys = _check_neox_batch_keys(raw, path)
        if cfg.data_impl not in ("mmap", "lazy", "cached", "infer"):
            raise NotImplementedError(
                f"data_impl={cfg.data_impl!r}: supported are mmap/lazy/cached/infer"
            )
        if cfg.data_path is None and not cfg.train_data_paths:
            raise ValueError("config needs train_data_paths or data_path")
        return cfg


def solve_batch_parameters(
    dp_world_size: int,
    train_batch: Optional[int] = None,
    micro_batch: Optional[int] = None,
    grad_acc: Optional[int] = None,
) -> tuple:
    """Solve the NeoX batch triple for whatever values are missing.

    Reference-equivalent case analysis (NeoXArgs.calculate_batch_parameters,
    megatron_dataset/arguments.py:753-791), floor-division quirks included:
    given any sufficient subset of {train_batch_size,
    micro_batch_per_rank, grad_accum_steps} and the data-parallel world
    size, returns the completed ``(train_batch, micro_batch, grad_acc)``.
    Raises ValueError when neither train_batch nor micro_batch is given
    (the reference asserts there).
    """
    if train_batch is not None and micro_batch is not None and grad_acc is not None:
        pass  # fully specified
    elif train_batch is not None and micro_batch is not None:
        grad_acc = (train_batch // micro_batch) // dp_world_size
    elif train_batch is not None and grad_acc is not None:
        micro_batch = (train_batch // dp_world_size) // grad_acc
    elif micro_batch is not None and grad_acc is not None:
        train_batch = micro_batch * grad_acc * dp_world_size
    elif train_batch is not None:
        grad_acc = 1
        micro_batch = train_batch // dp_world_size
    elif micro_batch is not None:
        train_batch = micro_batch * dp_world_size
        grad_acc = 1
    else:
        raise ValueError(
            "batch arithmetic needs train_batch_size or "
            "train_micro_batch_size_per_gpu (arguments.py:788-791)"
        )
    return int(train_batch), int(micro_batch), int(grad_acc)


def check_batch_parameters(
    dp_world_size: int, train_batch: int, micro_batch: int, grad_acc: int
) -> None:
    """Validate a completed batch triple (reference:
    NeoXArgs.check_batch_parameters, arguments.py:793-812): all three
    positive and train_batch == micro_batch * grad_acc * dp_world_size.
    Raises ValueError on violation."""
    for name, v in (
        ("train_batch_size", train_batch),
        ("micro_batch_per_rank", micro_batch),
        ("gradient_accumulation_steps", grad_acc),
    ):
        if v <= 0:
            raise ValueError(f"{name}={v} must be > 0")
    if train_batch != micro_batch * grad_acc * dp_world_size:
        raise ValueError(
            f"inconsistent batch arithmetic: train_batch_size={train_batch} != "
            f"micro={micro_batch} * grad_accum={grad_acc} * dp={dp_world_size}"
        )


def cross_check_neox_batch(
    mcfg: "MegatronDataConfig",
    path: str,
    dp_world_size: int,
    micro_batch: int,
    grad_accum: int,
    total_batch_size: int,
) -> None:
    """Solve the YAML's NeoX batch keys against the ACTUAL mesh size and
    warn when the result disagrees with the training config.

    The training config owns batch arithmetic in this framework (the
    reference instead derives it from the NeoX YAML + world size,
    arguments.py:753-812); a NeoX YAML carrying batch keys that solve to a
    different recipe than the one actually running deserves a loud warning,
    not silence — but not a hard failure, since reference data YAMLs must
    keep loading unchanged.
    """
    keys = mcfg.neox_batch_keys or {}
    if not keys:
        return
    try:
        solved = solve_batch_parameters(
            dp_world_size,
            train_batch=keys.get("train_batch_size"),
            micro_batch=keys.get("train_micro_batch_size_per_gpu"),
            grad_acc=keys.get("gradient_accumulation_steps"),
        )
        check_batch_parameters(dp_world_size, *solved)
    # ZeroDivisionError: a zero-valued divisor key (e.g. micro_batch: 0 with
    # no grad_acc) reaches the solver's floor divisions — warn, don't crash
    except (ValueError, TypeError, ZeroDivisionError) as e:
        logger.warning("%s: NeoX batch keys do not solve at dp=%s: %s", path, dp_world_size, e)
        return
    actual = (total_batch_size, micro_batch, grad_accum)
    if solved != actual:
        logger.warning(
            "%s: NeoX batch keys solve to (train=%s, micro=%s, grad_acc=%s) at "
            "dp=%s, but the training config runs (total=%s, micro=%s, "
            "grad_acc=%s) — the training config wins",
            path, *solved, dp_world_size, *actual,
        )
    else:
        logger.info(
            "%s: NeoX batch keys consistent with the training config at dp=%s",
            path, dp_world_size,
        )


def _check_neox_batch_keys(raw: dict, path: str) -> dict:
    """Collect the NeoX batch-arithmetic keys we deliberately don't consume
    for training, warning that they are data-YAML passengers here.

    The reference solves/validates train_batch_size = micro_batch_per_gpu *
    gradient_accumulation_steps * world_size when loading a NeoX YAML
    (megatron_dataset/arguments.py:753-812).  The full solve/validate runs
    later, against the real mesh size (cross_check_neox_batch); this
    load-time pass only flags triples that are impossible at ANY world size.
    Returns the present keys (ints where parseable).
    """
    present = {}
    for k in (
        "train_batch_size",
        "train_micro_batch_size_per_gpu",
        "gradient_accumulation_steps",
    ):
        v = raw.get(k)
        if v is None:
            continue
        try:
            present[k] = int(v)
        except (TypeError, ValueError):
            present[k] = v
    if present:
        logger.warning(
            "%s: NeoX batch keys %s are not consumed by relora_tpu "
            "(batch arithmetic is set by the training config, not the data "
            "YAML); they will be cross-checked against the mesh at startup",
            path,
            sorted(present),
        )
    tbs = present.get("train_batch_size")
    micro = present.get("train_micro_batch_size_per_gpu")
    ga = present.get("gradient_accumulation_steps")
    if isinstance(tbs, int) and isinstance(micro, int) and isinstance(ga, int):
        # world_size isn't knowable yet; consistency at ANY size requires
        # train_batch_size to be a positive multiple of micro * grad_accum
        per_rank = micro * ga
        if per_rank <= 0 or tbs <= 0 or tbs % per_rank != 0:
            logger.warning(
                "%s: inconsistent NeoX batch arithmetic: train_batch_size=%s "
                "is not a positive multiple of train_micro_batch_size_per_gpu=%s "
                "* gradient_accumulation_steps=%s (reference validates this in "
                "arguments.py:753-812)",
                path,
                tbs,
                micro,
                ga,
            )
    return present


def parse_split_string(split: str, n: int) -> List[range]:
    """'969,30,1' (or '969/30/1') -> three contiguous document ranges
    covering [0, n) (bit-parity: data_utils.get_train_valid_test_split_
    :163-187).

    The rounding correction matters: the reference subtracts the cumulative
    rounding excess from *every* bound, not just the last — clamping only
    the tail can produce a zero-width middle split at small n (e.g.
    '1,1,1' over 10 docs is [0,4,7,10] here, not [0,3,6,10]).
    """
    s = str(split)
    sep = "," if "," in s else ("/" if "/" in s else None)
    parts = [float(x) for x in s.split(sep)] if sep else [float(s)]
    while len(parts) < 3:
        parts.append(0.0)
    parts = parts[:3]
    total = sum(parts)
    if total == 0:
        raise ValueError("split must have a nonzero component")
    fracs = [p / total for p in parts]
    bounds = [0]
    for f in fracs:
        bounds.append(bounds[-1] + int(round(f * float(n))))
    diff = bounds[-1] - n
    bounds = [bounds[0]] + [b - diff for b in bounds[1:]]
    if any(b < 0 for b in bounds) or any(
        bounds[i] > bounds[i + 1] for i in range(3)
    ):
        # degenerate splits (e.g. '0,1,1' over 3 docs) make the uniform
        # correction go negative; the reference silently emits the same
        # bounds and then wraps to wrong documents — fail loudly instead
        raise ValueError(
            f"split {split!r} over {n} documents produces invalid bounds {bounds}"
        )
    return [range(bounds[i], bounds[i + 1]) for i in range(3)]


def _build_packed(
    prefix: str,
    documents: np.ndarray,
    num_samples: int,
    seq_length: int,
    seed: int,
    name: str,
    is_coordinator: bool,
    barrier,
    data_impl: str = "infer",
):
    data = open_token_dataset(prefix, data_impl)
    return PackedCausalDataset(
        name=name,
        data=data,
        documents=documents,
        num_samples=num_samples,
        seq_length=seq_length,
        seed=seed,
        is_coordinator=is_coordinator,
        barrier=barrier,
    )


def build_split_datasets(
    mcfg: MegatronDataConfig,
    num_samples: Sequence[int],
    is_coordinator: bool = True,
    barrier=None,
):
    """(train, valid, test) datasets — weighted blends of explicit path lists,
    or a split of a single corpus (parity: data_utils.py:325-441)."""
    names = ("train", "valid", "test")
    out = []
    if mcfg.train_data_paths:
        path_lists = (mcfg.train_data_paths, mcfg.valid_data_paths, mcfg.test_data_paths)
        weight_lists = (mcfg.train_data_weights, mcfg.valid_data_weights, mcfg.test_data_weights)
        for name, paths, weights, n in zip(names, path_lists, weight_lists, num_samples):
            if not paths:
                out.append(None)
                continue
            weights = weights or [1.0] * len(paths)
            w = np.asarray(weights, dtype=np.float64)
            w = w / w.sum()
            label_paths = mcfg.label_data_paths if name == "train" else None
            parts = []
            for i, p in enumerate(paths):
                data = open_token_dataset(p, mcfg.data_impl)
                docs = np.arange(len(data), dtype=np.int32)
                # each corpus supplies its weighted share of samples (+5%
                # headroom, as the blend is not exactly proportional)
                share = int(np.ceil(n * w[i] * 1.05)) + 1
                parts.append(
                    PackedCausalDataset(
                        name=f"{name}_{i}",
                        data=data,
                        documents=docs,
                        num_samples=share,
                        seq_length=mcfg.seq_length,
                        seed=mcfg.seed,
                        is_coordinator=is_coordinator,
                        barrier=barrier,
                        label_data=(
                            open_token_dataset(label_paths[i], mcfg.data_impl) if label_paths else None
                        ),
                    )
                )
            out.append(parts[0] if len(parts) == 1 else BlendableDataset(parts, w))
    else:
        data = open_token_dataset(mcfg.data_path, mcfg.data_impl)
        ranges = parse_split_string(mcfg.split, len(data))
        for name, rng_, n in zip(names, ranges, num_samples):
            if len(rng_) == 0 or n == 0:
                out.append(None)
                continue
            docs = np.arange(rng_.start, rng_.stop, dtype=np.int32)
            out.append(
                _build_packed(
                    mcfg.data_path, docs, n, mcfg.seq_length, mcfg.seed,
                    name, is_coordinator, barrier, data_impl=mcfg.data_impl,
                )
            )
    return tuple(out)


class PackedBatchIterator:
    """Batches a random-access packed dataset into device-ready arrays with
    deterministic per-host slicing and update-step rewind (parity:
    DistributedBatchSampler + start_iter, samplers.py:88-165,
    data_utils.py:443-466).

    ``interleaved=False`` gives each host a contiguous run of the global
    batch; ``True`` stripes hosts across it (the reference supports both
    slicings, samplers.py:159-165).
    """

    def __init__(
        self,
        dataset,
        *,
        microbatch: int,
        grad_accum: Optional[int] = None,
        skip_updates: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        interleaved: bool = False,
    ):
        self.dataset = dataset
        self.microbatch = microbatch
        self.grad_accum = grad_accum
        self.process_index = process_index
        self.process_count = process_count
        self.interleaved = interleaved
        self._per_update = microbatch * (grad_accum or 1) * process_count
        self._start = skip_updates * self._per_update
        self._n_updates = len(dataset) // self._per_update

    def __len__(self) -> int:
        return max(0, self._n_updates - self._start // self._per_update)

    def _host_rows(self, start: int, per_host: int) -> list:
        if self.interleaved:
            idxs = range(start + self.process_index, start + self._per_update, self.process_count)
        else:
            lo = start + self.process_index * per_host
            idxs = range(lo, lo + per_host)
        return [self.dataset[i]["input_ids"] for i in idxs]

    def __iter__(self) -> Iterator[np.ndarray]:
        per_host = self.microbatch * (self.grad_accum or 1)
        for start in range(self._start, self._n_updates * self._per_update, self._per_update):
            arr = np.asarray(self._host_rows(start, per_host), dtype=np.int32)
            if self.grad_accum is None:
                yield arr
            else:
                yield arr.reshape(self.grad_accum, self.microbatch, -1)


def build_train_valid_test_iterators(cfg, trainer):
    """Wire the megatron path into the Trainer (parity:
    build_train_valid_test_dataloaders, data_utils.py:308-467), for one
    process."""
    mcfg = MegatronDataConfig.from_yaml(cfg.megatron_dataset_config)
    if mcfg.seq_length + 1 < cfg.max_length:
        logger.warning(
            f"megatron seq_length={mcfg.seq_length} < max_length={cfg.max_length}"
        )
    # the mesh is known here: solve the YAML's NeoX batch keys at the real
    # data-parallel size and compare with what's actually running
    cross_check_neox_batch(
        mcfg,
        cfg.megatron_dataset_config,
        dp_world_size=trainer.n_batch_shards,
        micro_batch=cfg.batch_size,
        grad_accum=trainer.grad_accum,
        total_batch_size=cfg.total_batch_size,
    )

    n_train = cfg.num_training_steps * cfg.total_batch_size
    # eval sees each token at most once (one pass of the split), capped at
    # what the 100M-token final eval needs (torchrun_main.py:984-987)
    n_eval = (120_000_000 // mcfg.seq_length) + 1

    # cap each eval split at one pass of its own tokens: the packed dataset
    # otherwise up-samples across epochs to satisfy any requested count, and
    # a 100M-token final eval would loop a small split thousands of times
    def one_pass_cap(split_tokens: int) -> int:
        return max(1, min(n_eval, split_tokens // (mcfg.seq_length + 1)))

    if mcfg.train_data_paths:
        def paths_tokens(paths):
            return sum(open_token_dataset(p, mcfg.data_impl).n_tokens for p in paths) if paths else 0

        valid_tokens = paths_tokens(mcfg.valid_data_paths)
        test_tokens = paths_tokens(mcfg.test_data_paths)
    else:
        data = open_token_dataset(mcfg.data_path, mcfg.data_impl)
        sizes = np.asarray(data.sizes)
        ranges = parse_split_string(mcfg.split, len(data))
        valid_tokens = int(sizes[list(ranges[1])].sum()) if len(ranges[1]) else 0
        test_tokens = int(sizes[list(ranges[2])].sum()) if len(ranges[2]) else 0

    train_ds, valid_ds, test_ds = build_split_datasets(
        mcfg,
        (n_train, one_pass_cap(valid_tokens), one_pass_cap(test_tokens)),
    )

    micro = cfg.batch_size * trainer.n_batch_shards

    def train_factory():
        return iter(
            PackedBatchIterator(
                train_ds,
                microbatch=micro,
                grad_accum=trainer.grad_accum,
                skip_updates=trainer.update_step,
            )
        )

    def eval_factory():
        source = valid_ds if valid_ds is not None else test_ds
        return iter(
            PackedBatchIterator(
                source,
                microbatch=micro,
                grad_accum=None,
            )
        )

    return train_factory, (eval_factory if (valid_ds or test_ds) else None)
