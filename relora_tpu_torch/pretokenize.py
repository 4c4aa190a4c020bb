"""Offline pretokenization CLI for the PyTorch port (the root
``pretokenize.py``'s counterpart, with the same flags and output).

Loads an HF dataset (a hub name, or a ``save_to_disk`` directory),
tokenizes and chunks it into fixed-length blocks, and saves it with
``save_to_disk`` beside an ``args.json`` provenance file (the flags plus
``n_sequences``) that ``relora_tpu_torch.main --dataset_path`` checks.

    python -m relora_tpu_torch.pretokenize --dataset allenai/c4 --subset en \\
        --tokenizer t5-base --sequence_length 512 --num_proc 8 \\
        --save_dir data/c4_tok --take 100000

``datasets`` and ``transformers`` are imported inside the functions that
use them, so the module imports without them and a call fails naming the
missing package.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def load_tokenizer(name_or_path: str, eos_token=None):
    """An HF hub id or local directory through ``AutoTokenizer``, or a bare
    tokenizers-format ``.json`` file (offline), whose EOS is ``eos_token``
    (default ``<|endoftext|>``)."""
    if name_or_path.endswith(".json") and os.path.exists(name_or_path):
        from transformers import PreTrainedTokenizerFast

        return PreTrainedTokenizerFast(
            tokenizer_file=name_or_path, eos_token=eos_token or "<|endoftext|>"
        )
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(name_or_path)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--subset", default=None)
    p.add_argument("--split", default="train")
    p.add_argument(
        "--tokenizer",
        required=True,
        help="HF hub id, local dir, or a tokenizers-format .json file "
        "(e.g. the reference's configs/pythia_tokenizer.json)",
    )
    p.add_argument("--eos_token", default=None, help="EOS string when loading a bare .json tokenizer")
    p.add_argument("--text_field", default="text")
    p.add_argument("--sequence_length", type=int, default=512)
    p.add_argument("--num_proc", type=int, default=8)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--take", type=int, default=None, help="Only tokenize the first N documents")
    args = p.parse_args(argv)

    import datasets

    from relora_tpu_torch.data.hf_pipeline import tokenize_and_chunk

    t0 = time.time()
    if os.path.isdir(args.dataset):
        ds = datasets.load_from_disk(args.dataset)
        if isinstance(ds, datasets.DatasetDict):
            ds = ds[args.split]
    elif args.take is not None:
        stream = datasets.load_dataset(args.dataset, args.subset, split=args.split, streaming=True)
        ds = datasets.Dataset.from_list(list(stream.take(args.take)))
    else:
        ds = datasets.load_dataset(args.dataset, args.subset, split=args.split)

    tokenizer = load_tokenizer(args.tokenizer, args.eos_token)
    out = tokenize_and_chunk(
        ds,
        tokenizer,
        text_field=args.text_field,
        sequence_length=args.sequence_length,
        num_proc=args.num_proc,
    )
    os.makedirs(args.save_dir, exist_ok=True)
    out.save_to_disk(args.save_dir)
    with open(os.path.join(args.save_dir, "args.json"), "w") as f:
        json.dump({**vars(args), "n_sequences": len(out)}, f, indent=2)
    print(
        f"Saved {len(out)} sequences x {args.sequence_length} tokens "
        f"({len(out) * args.sequence_length:,} tokens) to {args.save_dir} "
        f"in {time.time() - t0:.1f}s"
    )


if __name__ == "__main__":
    main()
