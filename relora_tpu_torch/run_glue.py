"""GLUE / text-classification fine-tuning CLI for the PyTorch port (the root
``run_glue.py``'s counterpart, with its flags plus ``--device``).

Fine-tunes a (ReLoRA-)pretrained port checkpoint on a GLUE task, or on any
custom csv/json classification dataset, and reports the task metrics.  As
in the JAX CLI: task or custom files, sample caps for train/eval/predict,
padding to the maximum or to the batch's longest row rounded up to 32,
do_train/do_eval/do_predict, the label set inferred from the labeled
splits, regression (stsb, or float-typed custom labels), a fresh shuffle
each epoch, and an output directory holding ``all_results.json`` and
``predict_results_{task}.txt``.  GLUE runs do not checkpoint.

    # a custom csv (columns: sentence[,sentence2],label) with a local
    # tokenizer.json (air-gapped hosts)
    python -m relora_tpu_torch.run_glue --task_name myset --train_file train.csv \\
        --validation_file dev.csv --test_file test.csv --do_predict true \\
        --model_config llama_250m --checkpoint ckpts/relora/model_8000 \\
        --tokenizer /data/corpus.tokenizer.json --output_dir glue_out

    # a GLUE task from the hub (network required)
    python -m relora_tpu_torch.run_glue --task_name sst2 --model_config llama_250m \\
        --checkpoint ckpts/relora/model_20000 --tokenizer t5-base

``--checkpoint`` reads a port checkpoint (``train/checkpoint.py``) and
merges its unmerged LoRA factors first (:func:`load_backbone`).
``transformers`` (the tokenizer) and ``datasets`` (the hub branch) are
imported only where they are used, so the module imports without them.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Optional

import numpy as np

PAD_MULTIPLE = 32  # dynamic padding rounds the batch's longest row up to this


def _flag(x) -> bool:
    return str(x).lower() == "true"


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task_name", required=True,
                   help="GLUE task, or a name for a custom-file dataset")
    p.add_argument("--train_file", default=None, help="custom csv/json train split")
    p.add_argument("--validation_file", default=None, help="custom csv/json validation split")
    p.add_argument("--test_file", default=None, help="custom csv/json test split (do_predict)")
    p.add_argument("--model_config", required=True)
    p.add_argument("--checkpoint", default=None, help="relora_tpu_torch checkpoint dir (model_N)")
    p.add_argument("--tokenizer", required=True,
                   help="HF tokenizer name/dir, or a local tokenizers-json file")
    # the reference's HF-Trainer flag names are accepted as aliases
    p.add_argument("--lr", "--learning_rate", type=float, default=2e-5)
    p.add_argument("--batch_size", "--per_device_train_batch_size", type=int, default=32)
    p.add_argument("--num_epochs", "--num_train_epochs", type=int, default=3)
    p.add_argument("--max_seq_length", "--max_length", dest="max_seq_length", type=int, default=128)
    p.add_argument("--pad_to_max_length", type=_flag, default=True,
                   help="false = dynamic padding to the batch max (rounded up to 32)")
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--use_lora", type=_flag, default=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--max_eval_samples", type=int, default=None)
    p.add_argument("--max_predict_samples", type=int, default=None)
    p.add_argument("--do_train", type=_flag, default=True)
    p.add_argument("--do_eval", type=_flag, default=True)
    p.add_argument("--do_predict", type=_flag, default=False)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--overwrite_output_dir", type=_flag, default=False)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


def load_tokenizer(name_or_path: str):
    """An HF tokenizer by name or directory, or a raw ``tokenizers`` JSON
    file (the air-gapped path), given a pad token if it has none."""
    from transformers import AutoTokenizer, PreTrainedTokenizerFast

    if name_or_path.endswith(".json") and os.path.exists(name_or_path):
        tok = PreTrainedTokenizerFast(tokenizer_file=name_or_path)
        if tok.pad_token_id is None:
            tok.add_special_tokens({"pad_token": "<pad>"})
        return tok
    tok = AutoTokenizer.from_pretrained(name_or_path)
    if tok.pad_token_id is None:
        tok.pad_token = tok.eos_token
    return tok


def read_split(path: str):
    """A csv or json-lines split as a list of dicts."""
    if path.endswith(".csv"):
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
    else:
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    if not rows:
        raise ValueError(f"{path} is empty")
    return rows


def pad_bucket(batch_ids: np.ndarray, pad_id: int, max_seq_length: int) -> np.ndarray:
    """Dynamic padding: trim a batch to its longest row, rounded up to 32, so
    the step sees a handful of widths, not one per batch."""
    lengths = (batch_ids != pad_id).sum(axis=1)
    rounded = int(-(-lengths.max() // PAD_MULTIPLE) * PAD_MULTIPLE)
    return batch_ids[:, : min(max_seq_length, max(PAD_MULTIPLE, rounded))]


def load_backbone(path: str) -> dict:
    """The port checkpoint at ``path`` as a causal LM's state dict on the
    host, its unmerged LoRA factors (a ``relora_config.json`` sidecar)
    folded into the bases first (``core/relora.merged_params``), so the
    classifier starts from the equivalent full-rank model."""
    from relora_tpu_torch.core.relora import merged_params
    from relora_tpu_torch.train.checkpoint import load_lora_spec, restore_params_host

    params = restore_params_host(path)
    spec = load_lora_spec(path)
    return params if spec is None else merged_params(params, spec)


def _infer_regression(raw) -> bool:
    """Float-typed custom labels mean regression: every non-empty label
    parses as a float and one is a decimal literal ({"0", "1"} stays
    classification, {"0.0", "3.3", "1e-1"} is regression)."""
    seen = [s for split in raw.values() for r in split if (s := str(r.get("label", "")).strip())]

    def as_float(s: str):
        try:
            return float(s)
        except ValueError:
            return None

    return bool(seen) and all(as_float(s) is not None for s in seen) and any(
        "." in s or "e" in s.lower() for s in seen
    )


def main(argv=None):
    args = parse_args(argv)

    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.eval.glue import TASK_NUM_LABELS, TASK_TO_KEYS, GlueConfig, finetune

    model_cfg = load_model_config(args.model_config)
    tokenizer = load_tokenizer(args.tokenizer)
    is_custom = any(f is not None for f in (args.train_file, args.validation_file, args.test_file))
    is_regression = args.task_name == "stsb"

    # ---- load splits ------------------------------------------------------
    if is_custom:
        needed = []
        if args.do_train and not args.train_file:
            needed.append("--train_file (do_train)")
        if args.do_eval and not args.validation_file:
            needed.append("--validation_file (do_eval)")
        if args.do_predict and not args.test_file:
            needed.append("--test_file (do_predict)")
        if needed:
            raise ValueError(
                "custom-file mode is missing required splits: " + ", ".join(needed)
                + " — pass the file or disable the stage"
            )
        raw = {}
        if args.train_file:
            raw["train"] = read_split(args.train_file)
        if args.validation_file:
            raw["validation"] = read_split(args.validation_file)
        if args.test_file:
            raw["test"] = read_split(args.test_file)
        cols = [c for c in raw[next(iter(raw))][0] if c != "label"]
        key1, key2 = cols[0], (cols[1] if len(cols) > 1 else None)
        is_regression = is_regression or _infer_regression(raw)
    else:
        import datasets

        hub = datasets.load_dataset("glue", args.task_name)
        eval_split = "validation_matched" if args.task_name == "mnli" else "validation"
        raw = {"train": hub["train"], "validation": hub[eval_split]}
        if args.do_predict:
            raw["test"] = hub["test_matched" if args.task_name == "mnli" else "test"]
        key1, key2 = TASK_TO_KEYS[args.task_name]

    # ---- labels -----------------------------------------------------------
    id2label: Optional[dict]
    if is_regression:
        num_labels, label2id, id2label = 1, None, None
    elif is_custom:
        # the label set from a split that carries labels (a predict-only
        # run may load just an unlabeled test file beside it)
        labeled = next(
            (raw[name] for name in ("train", "validation", "test")
             if raw.get(name) and "label" in raw[name][0]),
            None,
        )
        if labeled is None:
            raise SystemExit(
                "custom task needs at least one split with a 'label' column "
                "to infer the label set (got only unlabeled files)"
            )
        label_list = sorted({str(r["label"]) for r in labeled})
        label2id = {name: i for i, name in enumerate(label_list)}
        id2label = {i: name for name, i in label2id.items()}
        num_labels = len(label_list)
    else:
        num_labels, label2id = TASK_NUM_LABELS[args.task_name], None
        # hub tasks: predictions are written as label names
        names = getattr(raw["train"].features["label"], "names", None)
        id2label = dict(enumerate(names)) if names else None

    # ---- tokenize ---------------------------------------------------------
    def encode(split, limit=None, with_labels=True):
        rows = raw[split]
        if limit is not None:
            rows = rows[: min(limit, len(rows))] if is_custom else rows.select(
                range(min(limit, len(rows)))
            )
        texts1 = [r[key1] for r in rows] if is_custom else rows[key1]
        pair = ([r[key2] for r in rows] if is_custom else rows[key2]) if key2 else None
        enc = tokenizer(
            texts1, pair,
            truncation=True,
            max_length=args.max_seq_length,
            padding="max_length" if args.pad_to_max_length else "longest",
        )
        ids = np.asarray(enc["input_ids"], dtype=np.int32)
        if not with_labels:
            return ids, None
        rl = [r["label"] for r in rows] if is_custom else rows["label"]
        if is_regression:
            labels = np.asarray(rl, dtype=np.float32)
        elif label2id is not None:
            labels = np.asarray([label2id[str(label)] for label in rl])
        else:
            labels = np.asarray(rl)
        return ids, labels

    bs = args.batch_size
    pad_id = tokenizer.pad_token_id or 0

    def bucket(batch_ids):
        if args.pad_to_max_length:
            return batch_ids
        return pad_bucket(batch_ids, pad_id, args.max_seq_length)

    train_ids, train_labels = (None, None)
    steps_per_epoch = 1
    if args.do_train:
        train_ids, train_labels = encode("train", args.max_train_samples)
        steps_per_epoch = max(1, len(train_ids) // bs)

    eval_ids, eval_labels = (None, None)
    if args.do_eval:
        eval_ids, eval_labels = encode("validation", args.max_eval_samples)

    epoch_counter = iter(range(10**9))

    def train_batches():
        # a fresh shuffle each epoch (finetune calls this once an epoch)
        rs = np.random.RandomState(args.seed + next(epoch_counter))
        order = rs.permutation(len(train_ids))
        for i in range(steps_per_epoch):
            sel = order[i * bs : (i + 1) * bs]
            yield bucket(train_ids[sel]), train_labels[sel]

    def eval_batches():
        for i in range(0, len(eval_ids), bs):
            sel = slice(i, min(i + bs, len(eval_ids)))
            yield bucket(eval_ids[sel]), eval_labels[sel]

    predict_batches = None
    if args.do_predict:
        test_ids, _ = encode("test", args.max_predict_samples, with_labels=False)

        def predict_batches():
            for i in range(0, len(test_ids), bs):
                yield bucket(test_ids[i : i + bs])

    # fail on a dirty output dir before the (possibly hours-long) fine-tune
    if args.output_dir and os.path.isdir(args.output_dir) and os.listdir(args.output_dir):
        if not args.overwrite_output_dir:
            raise ValueError(
                f"output_dir {args.output_dir} exists and is not empty "
                "(use --overwrite_output_dir true)"
            )

    pretrained = load_backbone(args.checkpoint) if args.checkpoint else None
    gcfg = GlueConfig(
        task=args.task_name,
        lr=args.lr,
        batch_size=bs,
        num_epochs=args.num_epochs,
        max_length=args.max_seq_length,
        weight_decay=args.weight_decay,
        use_lora=args.use_lora,
        seed=args.seed,
        num_labels=num_labels,
    )
    metrics, predictions = finetune(
        model_cfg,
        gcfg,
        train_batches,
        eval_batches,
        steps_per_epoch,
        pad_token_id=pad_id,
        pretrained_backbone=pretrained,
        predict_batches=predict_batches,
        do_train=args.do_train,
        do_eval=args.do_eval,
        device=args.device,
    )

    # HF Trainer prefixes evaluation metrics with eval_ in all_results.json
    result = {"task": args.task_name}
    for k, v in metrics.items():
        result[k if k.startswith(("eval_", "train_")) else f"eval_{k}"] = v
    print(json.dumps(result))
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        with open(os.path.join(args.output_dir, "all_results.json"), "w") as f:
            json.dump(result, f, indent=2)
        if predictions is not None:
            out = os.path.join(args.output_dir, f"predict_results_{args.task_name}.txt")
            with open(out, "w") as f:
                f.write("index\tprediction\n")
                for i, pred in enumerate(predictions):
                    if is_regression:
                        f.write(f"{i}\t{float(pred):.3f}\n")
                    else:
                        label = id2label[int(pred)] if id2label else int(pred)
                        f.write(f"{i}\t{label}\n")
    return result


if __name__ == "__main__":
    main()
