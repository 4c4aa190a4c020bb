"""Generate with the PyTorch port: drain token-id requests through the paged
continuous-batching scheduler.

Counterpart of ``serve.py`` for the flags the port serves.  Prompts are
token ids (comma- or space-separated ints), one per ``--prompt`` or one per
line of ``--input-file`` (``-`` = stdin); one line of generated ids is printed
per request, in request order.  Runs on ``--device cuda`` (the default);
``--device cpu`` runs every kernel's plain version.

    python -m relora_tpu_torch.serve_cli --model_config llama_250m \
        --random-init --paged --dtype bf16 --max-batch 8 --input-file prompts.txt

Weights come from ``--random-init`` or from ``--checkpoint DIR``, a
checkpoint directory of ``relora_tpu_torch.train.checkpoint``: merged by
default, its factors unmerged with ``--no-merge``.  Multi-tenant serving
stacks tenant adapters over an unmerged base:

    python -m relora_tpu_torch.serve_cli --model_config llama_250m \
        --checkpoint BASE --no-merge --adapter-dir ADAPTERS --adapters tA,tB \
        --paged --dtype bf16 --max-batch 8 --input-file prompts.txt

``--adapter-dir`` holds one checkpoint directory per tenant; the batch mode's
requests name no adapter, so they decode the base through the grouped kernel
(requests pick a tenant through ``Request.adapter`` in the scheduler API).

Speculative decoding drafts ``--spec-k`` tokens a row and verifies them in one
``(batch, K+1)`` forward: ``--spec ngram`` looks them up in the request's own
context, ``--spec model`` runs a draft model, a checkpoint directory of the
port with the base's config:

    python -m relora_tpu_torch.serve_cli --model_config llama_250m \
        --checkpoint BASE --paged --dtype bf16 --max-batch 8 \
        --spec model --spec-k 4 --draft-checkpoint DRAFT --input-file prompts.txt
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Dict, List, Tuple

import torch

from relora_tpu_torch import resolve_device
from relora_tpu_torch.config.model import load_model_config
from relora_tpu_torch.models.params_util import init_params
from relora_tpu_torch.serve.adapters import AdapterRegistry
from relora_tpu_torch.serve.engine import InferenceEngine, build_decode_model, compute_dtype
from relora_tpu_torch.serve.scheduler import (
    Completion,
    PagedContinuousBatchingScheduler,
    Request,
)
from relora_tpu_torch.train.checkpoint import (
    load_lora_spec,
    restore_params_host,
    restore_serving_params,
)

logger = logging.getLogger("relora_tpu_torch.serve")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default=None, help="model_{step} checkpoint dir")
    p.add_argument(
        "--random-init", action="store_true",
        help="serve randomly initialized weights drawn from --seed",
    )
    p.add_argument(
        "--no-merge", action="store_true",
        help="serve LoRA factors unmerged (adapter hot-swap); reads the "
        "checkpoint's relora_config.json",
    )
    p.add_argument(
        "--adapter-dir", default=None,
        help="multi-tenant serving: directory of unmerged adapter checkpoint "
        "dirs (each with a relora_config.json sidecar); requires --no-merge",
    )
    p.add_argument(
        "--adapters", default=None,
        help="comma-separated adapter names to preload into slots at startup; "
        "requires --adapter-dir",
    )
    p.add_argument(
        "--adapter-slots", type=int, default=None,
        help="adapter slot pool size, including the reserved identity slot 0 "
        "(default 4); requires --adapter-dir",
    )
    p.add_argument("--model_config", required=True, help="zoo name, HF config JSON, or dir")
    p.add_argument("--prompt", action="append", default=[], help="one prompt (repeatable)")
    p.add_argument("--input-file", default=None, help="one prompt per line ('-' = stdin)")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    p.add_argument("--top-k", type=int, default=0, help="0 disables")
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--eos-id", type=int, default=None, help="default: model config eos_token_id")
    p.add_argument("--cache-size", type=int, default=None, help="default: max_sequence_length")
    p.add_argument("--max-batch", type=int, default=4, help="decode slots")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--paged", action="store_true", help="paged KV cache (required for now)")
    p.add_argument("--page-size", type=int, default=16, help="tokens per KV page")
    p.add_argument(
        "--num-pages", type=int, default=0,
        help="pool capacity in pages (0 = max_batch full-length requests + the null page)",
    )
    p.add_argument("--chunk-size", type=int, default=64, help="prefill chunk length")
    p.add_argument(
        "--packed", action="store_true",
        help="one step_paged dispatch per round: every decode row plus "
        "token-budget prefill from several slots",
    )
    p.add_argument(
        "--token-budget", type=int, default=0,
        help="packed: tokens per dispatch (0 = max_batch x window + chunk_size, the "
        "window spec-k+1 with --spec ngram, else 1)",
    )
    p.add_argument("--kv-dtype", choices=("bf16", "int8"), default="bf16")
    p.add_argument(
        "--spec", choices=("off", "ngram", "model"), default="off",
        help="paged: speculative decoding; 'ngram' drafts by prompt lookup in "
        "the request's own context, 'model' runs --draft-checkpoint for "
        "--spec-k greedy steps; one (batch, spec-k+1) forward verifies",
    )
    p.add_argument(
        "--spec-k", type=int, default=4,
        help="speculative: drafted tokens per verify step (window spec-k+1)",
    )
    p.add_argument(
        "--draft-checkpoint", default=None,
        help="--spec model: a checkpoint dir of the port with the base's config",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _encode(text: str) -> List[int]:
    try:
        return [int(t) for t in text.replace(",", " ").split()]
    except ValueError:
        raise SystemExit(f"prompt {text!r} is not a token-id list")


def check_adapter_flags(args: argparse.Namespace) -> None:
    """``serve.py``'s checks of the adapter flags, with its messages."""
    if args.adapter_dir is not None and not args.no_merge:
        raise SystemExit(
            "--adapter-dir requires --no-merge (tenant adapters hot-swap "
            "against an unmerged base; a merged checkpoint has no LoRA slots)"
        )
    if args.adapters is not None and args.adapter_dir is None:
        raise SystemExit("--adapters preloads tenant adapters and requires --adapter-dir")
    if args.adapter_slots is not None:
        if args.adapter_dir is None:
            raise SystemExit(
                "--adapter-slots sizes the tenant slot pool and requires --adapter-dir"
            )
        if args.adapter_slots < 2:
            raise SystemExit(
                f"--adapter-slots must be >= 2 (slot 0 is the reserved "
                f"identity adapter), got {args.adapter_slots}"
            )
    if args.adapter_dir is not None and not os.path.isdir(args.adapter_dir):
        raise SystemExit(f"--adapter-dir {args.adapter_dir} is not a directory")


def check_spec_flags(args: argparse.Namespace) -> None:
    """``serve.py``'s checks of the speculative flags, with its messages."""
    if args.spec != "off" and not args.paged:
        raise SystemExit(
            "--spec requires --paged (the verify window writes through the "
            "paged engine's block tables)"
        )
    if args.spec != "off" and args.spec_k < 1:
        raise SystemExit(f"--spec {args.spec} needs --spec-k >= 1, got {args.spec_k}")
    if args.spec == "model":
        if not args.draft_checkpoint:
            raise SystemExit("--spec model needs --draft-checkpoint")
        if args.packed:
            raise SystemExit(
                "--spec model is incompatible with --packed (the draft "
                "proposal loop runs on the per-row decode path)"
            )
        if args.adapter_dir:
            raise SystemExit(
                "--spec model is incompatible with --adapter-dir (a draft model "
                "and adapter slots do not share an engine)"
            )
    elif args.draft_checkpoint:
        raise SystemExit("--draft-checkpoint only applies with --spec model")


def load_params(args: argparse.Namespace, model_cfg, dtype, device):
    """``(params, lora_spec)``: a seeded model under ``--random-init``, else
    the checkpoint's state dict, merged unless ``--no-merge``, with its
    sidecar's spec then."""
    if args.random_init:
        if args.checkpoint or args.no_merge:
            raise SystemExit("--random-init excludes --checkpoint/--no-merge")
        model = build_decode_model(model_cfg, dtype=dtype, device=device)
        return init_params(model, torch.Generator(device=device).manual_seed(args.seed)), None
    if args.checkpoint is None:
        raise SystemExit("pass --checkpoint (or --random-init for drills)")
    logger.info(f"restoring {args.checkpoint}")
    if not args.no_merge:
        return restore_serving_params(args.checkpoint), None
    spec = load_lora_spec(args.checkpoint)
    if spec is None:
        raise SystemExit(
            f"--no-merge: {args.checkpoint} has no relora_config.json sidecar "
            "(full-rank checkpoint? drop the flag)"
        )
    return restore_params_host(args.checkpoint), spec


def build(args: argparse.Namespace) -> PagedContinuousBatchingScheduler:
    """The engine and scheduler the flags describe, weights included."""
    check_adapter_flags(args)
    check_spec_flags(args)
    if not args.paged:
        raise SystemExit("the contiguous engine is not ported yet: pass --paged")
    if args.packed and args.token_budget < 0:
        raise SystemExit("--token-budget must be >= 0")
    if args.token_budget and not args.packed:
        raise SystemExit("--token-budget only applies with --packed")
    device = resolve_device(args.device)
    model_cfg = load_model_config(args.model_config)
    cache_size = args.cache_size or model_cfg.max_sequence_length
    dtype = compute_dtype(args.dtype)
    params, lora_spec = load_params(args, model_cfg, dtype, device)
    adapter_slots = (args.adapter_slots or 4) if args.adapter_dir else 0
    # every slot at full length at once, plus the null page; --spec model
    # reserves a second run per slot for the draft's K/V
    slot_pages = (cache_size // args.page_size) * (2 if args.spec == "model" else 1)
    num_pages = args.num_pages or (args.max_batch * slot_pages + 1)
    window = args.spec_k + 1 if args.spec != "off" else 1
    engine = InferenceEngine(
        model_cfg,
        params,
        cache_size=cache_size,
        dtype=dtype,
        page_size=args.page_size,
        num_pages=num_pages,
        chunk_size=args.chunk_size,
        kv_dtype=args.kv_dtype,
        token_budget=(args.token_budget or args.max_batch * window + args.chunk_size)
        if args.packed
        else None,
        device=device,
        lora=lora_spec,
        adapter_slots=adapter_slots,
        spec_k=args.spec_k if args.spec != "off" else 0,
    )
    if args.spec == "model":
        logger.info(f"restoring draft model {args.draft_checkpoint}")
        engine.load_draft_params(restore_serving_params(args.draft_checkpoint))
    registry = None
    if args.adapter_dir:
        registry = AdapterRegistry(
            args.adapter_dir, adapter_slots, expected_r=lora_spec.r,
            writer=engine.adapter_writer(),
        )
        names = registry.list_adapters()
        logger.info(
            f"adapter registry: {adapter_slots} slots over {args.adapter_dir} "
            f"({len(names)} adapters: {', '.join(names) or 'none'})"
        )
        for name in [n.strip() for n in (args.adapters or "").split(",") if n.strip()]:
            try:
                slot = registry.acquire(name)
            except ValueError as e:
                raise SystemExit(f"--adapters: {e}")
            if slot is None:
                raise SystemExit(f"--adapters: no free slot for {name!r} (raise --adapter-slots)")
            registry.release(name)
            logger.info(f"preloaded adapter {name!r} into slot {slot}")
    return PagedContinuousBatchingScheduler(
        engine,
        packed=args.packed,
        spec=args.spec,
        max_batch=args.max_batch,
        eos_id=args.eos_id if args.eos_id is not None else model_cfg.eos_token_id,
        top_k=args.top_k,
        seed=args.seed,
        adapter_registry=registry,
    )


def read_requests(args: argparse.Namespace) -> List[Request]:
    if args.prompt and args.input_file:
        raise SystemExit("--prompt and --input-file are mutually exclusive")
    if args.prompt:
        lines = list(args.prompt)
    elif args.input_file is not None:
        fh = sys.stdin if args.input_file == "-" else open(args.input_file)
        try:
            lines = [line for line in fh if line.strip()]
        finally:
            if fh is not sys.stdin:
                fh.close()
    else:
        raise SystemExit("nothing to do: pass --prompt or --input-file")
    if not lines:
        raise SystemExit(f"no requests in {args.input_file}")
    return [
        Request(
            uid=i,
            prompt=_encode(line),
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            top_p=args.top_p,
        )
        for i, line in enumerate(lines)
    ]


def drain(argv=None) -> Tuple[Dict[int, Completion], float, PagedContinuousBatchingScheduler]:
    """Build from the flags, drain every request; returns the completions,
    the drain's wall seconds (ending in a device synchronize) and the
    scheduler, whose counters (``spec_stats``) the drain leaves behind."""
    args = parse_args(argv)
    requests = read_requests(args)
    scheduler = build(args)
    t0 = time.perf_counter()
    completions = scheduler.run(requests)
    if scheduler.engine.device.type == "cuda":
        torch.cuda.synchronize(scheduler.engine.device)
    return completions, time.perf_counter() - t0, scheduler


def run(argv=None) -> Tuple[Dict[int, Completion], float]:
    """:func:`drain`'s completions and wall seconds."""
    return drain(argv)[:2]


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    completions, seconds, scheduler = drain(argv)
    for uid in sorted(completions):
        print(" ".join(str(t) for t in completions[uid].tokens))
    n_tokens = sum(len(c.tokens) for c in completions.values())
    logger.info(f"{n_tokens} tokens in {seconds:.3f}s ({n_tokens / seconds:.1f} tokens/s)")
    if scheduler._spec != "off":
        logger.info(f"speculative: {scheduler.spec_stats()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
