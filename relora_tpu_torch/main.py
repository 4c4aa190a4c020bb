"""relora-tpu training CLI for the PyTorch port (``main.py``'s counterpart).

    python -m relora_tpu_torch.main --model_config llama_250m \\
        --megatron_dataset_config data.json --batch_size 8 --total_batch_size 16 \\
        --max_length 512 --use_peft true --lora_r 128 --lr 1e-3 --relora 3 \\
        --cycle_length 3 --scheduler cosine_restarts --warmup_steps 2 \\
        --restart_warmup_steps 1 --num_training_steps 9

Every flag of the JAX CLI is accepted (``--training_config file.yaml``
replaces the others), plus ``--device`` (default ``cuda``; ``--device cpu``
runs the plain versions of the kernels).  Data comes from the Megatron
memmap path (``--megatron_dataset_config``) or from a dataset that
``relora_tpu_torch.pretokenize`` saved (``--dataset_path``; the HF branch
needs ``datasets``, imported only there).  Logs one JSON record per update
and prints the result dict (without the per-update records) as the last
line of standard output.
"""

from __future__ import annotations

import json
import logging
import os

logger = logging.getLogger("relora_tpu_torch.main")


def main(argv=None) -> dict:
    from relora_tpu_torch.config.training import parse_train_args
    from relora_tpu_torch.data.megatron import build_train_valid_test_iterators
    from relora_tpu_torch.train.trainer import Trainer

    cfg = parse_train_args(argv)
    trainer = Trainer(cfg)
    if cfg.dataset_path is not None:
        train_factory, eval_factory = _hf_data(cfg, trainer)
    else:
        train_factory, eval_factory = build_train_valid_test_iterators(cfg, trainer)
    result = trainer.fit(train_factory(), eval_factory, train_iter_factory=train_factory)
    logger.info("Result: %s", {k: v for k, v in result.items() if k != "records"})
    return result


def _hf_data(cfg, trainer):
    """The pretokenized HF dataset path (``main.py:64-142``), as process 0 of
    1: the train split and the validation (or test) split of a
    ``DatasetDict``, else a seeded ``train_test_split``; the ``args.json``
    sequence-length guard and the planned-tokens warning."""
    import datasets

    from relora_tpu_torch.data.hf_pipeline import TokenBatchIterator

    ds = datasets.load_from_disk(cfg.dataset_path)
    if isinstance(ds, datasets.DatasetDict):
        train_ds = ds["train"]
        eval_ds = ds.get("validation") or ds.get("test")
    else:
        split = ds.train_test_split(test_size=min(2000, max(2, len(ds) // 100)), seed=cfg.seed)
        train_ds, eval_ds = split["train"], split["test"]

    prov = os.path.join(cfg.dataset_path, "args.json")
    if os.path.exists(prov):
        with open(prov) as f:
            args = json.load(f)
        if args.get("sequence_length") not in (None, cfg.max_length):
            raise ValueError(
                f"Dataset was pretokenized with sequence_length="
                f"{args.get('sequence_length')}, but max_length={cfg.max_length}"
            )

    planned_tokens = cfg.num_training_steps * cfg.total_batch_size * cfg.max_length
    available = len(train_ds) * cfg.max_length
    if available < planned_tokens:
        logger.warning(
            f"Dataset has ~{available:,} tokens but the run plans "
            f"{planned_tokens:,}; training will stop early"
        )

    microbatch = cfg.batch_size * trainer.n_batch_shards

    def train_factory():
        return iter(TokenBatchIterator(train_ds, microbatch=microbatch, grad_accum=trainer.grad_accum,
                                       skip_updates=trainer.update_step))

    def eval_factory():
        return iter(TokenBatchIterator(eval_ds, microbatch=microbatch, grad_accum=None))

    return train_factory, eval_factory


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    out = main()
    print(json.dumps({k: v for k, v in out.items() if k != "records"}))
