"""relora-tpu training CLI for the PyTorch port (``main.py``'s counterpart).

    python -m relora_tpu_torch.main --model_config llama_250m \\
        --megatron_dataset_config data.json --batch_size 8 --total_batch_size 16 \\
        --max_length 512 --use_peft true --lora_r 128 --lr 1e-3 --relora 3 \\
        --cycle_length 3 --scheduler cosine_restarts --warmup_steps 2 \\
        --restart_warmup_steps 1 --num_training_steps 9

Every flag of the JAX CLI is accepted (``--training_config file.yaml``
replaces the others), plus ``--device`` (default ``cuda``; ``--device cpu``
runs the plain versions of the kernels).  Data comes from the Megatron
memmap path (``--megatron_dataset_config``); the HF ``--dataset_path`` is
not ported yet.  Logs one JSON record per update and prints the result dict
(without the per-update records) as the last line of standard output.
"""

from __future__ import annotations

import json
import logging


def main(argv=None) -> dict:
    from relora_tpu_torch.config.training import parse_train_args
    from relora_tpu_torch.data.megatron import build_train_valid_test_iterators
    from relora_tpu_torch.train.trainer import Trainer

    cfg = parse_train_args(argv)
    trainer = Trainer(cfg)
    train_factory, eval_factory = build_train_valid_test_iterators(cfg, trainer)
    result = trainer.fit(train_factory(), eval_factory, train_iter_factory=train_factory)
    logging.getLogger("relora_tpu_torch.main").info(
        "Result: %s", {k: v for k, v in result.items() if k != "records"}
    )
    return result


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    out = main()
    print(json.dumps({k: v for k, v in out.items() if k != "records"}))
