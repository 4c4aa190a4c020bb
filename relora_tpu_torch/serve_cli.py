"""Generate with the PyTorch port: drain token-id requests through the paged
continuous-batching scheduler.

Counterpart of ``serve.py`` for the flags the port serves.  Prompts are
token ids (comma- or space-separated ints), one per ``--prompt`` or one per
line of ``--input-file`` (``-`` = stdin); one line of generated ids is printed
per request, in request order.  Runs on ``--device cuda`` (the default);
``--device cpu`` runs every kernel's plain version.

    python -m relora_tpu_torch.serve_cli --model_config llama_250m \
        --random-init --paged --dtype bf16 --max-batch 8 --input-file prompts.txt
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Dict, List, Tuple

import torch

from relora_tpu_torch import resolve_device
from relora_tpu_torch.config.model import load_model_config
from relora_tpu_torch.models.params_util import init_params
from relora_tpu_torch.serve.engine import InferenceEngine, build_decode_model, compute_dtype
from relora_tpu_torch.serve.scheduler import (
    Completion,
    PagedContinuousBatchingScheduler,
    Request,
)

logger = logging.getLogger("relora_tpu_torch.serve")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default=None, help="model_{step} checkpoint dir (not ported yet)")
    p.add_argument(
        "--random-init", action="store_true",
        help="serve randomly initialized weights drawn from --seed",
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
        help="packed: tokens per dispatch (0 = max_batch + chunk_size)",
    )
    p.add_argument("--kv-dtype", choices=("bf16", "int8"), default="bf16")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _encode(text: str) -> List[int]:
    try:
        return [int(t) for t in text.replace(",", " ").split()]
    except ValueError:
        raise SystemExit(f"prompt {text!r} is not a token-id list")


def build(args: argparse.Namespace) -> PagedContinuousBatchingScheduler:
    """The engine and scheduler the flags describe, weights included."""
    if args.checkpoint is not None:
        raise SystemExit(
            "--checkpoint is not ported yet (checkpoints are orbax; reading "
            "them without JAX is a later slice): use --random-init"
        )
    if not args.random_init:
        raise SystemExit("pass --random-init (checkpoint loading is not ported yet)")
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
    model = build_decode_model(model_cfg, dtype=dtype, device=device)
    init_params(model, torch.Generator(device=device).manual_seed(args.seed))
    num_pages = args.num_pages or (args.max_batch * (cache_size // args.page_size) + 1)
    engine = InferenceEngine(
        model_cfg,
        model,
        cache_size=cache_size,
        dtype=dtype,
        page_size=args.page_size,
        num_pages=num_pages,
        chunk_size=args.chunk_size,
        kv_dtype=args.kv_dtype,
        token_budget=(args.token_budget or args.max_batch + args.chunk_size)
        if args.packed
        else None,
        device=device,
    )
    return PagedContinuousBatchingScheduler(
        engine,
        packed=args.packed,
        max_batch=args.max_batch,
        eos_id=args.eos_id if args.eos_id is not None else model_cfg.eos_token_id,
        top_k=args.top_k,
        seed=args.seed,
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


def run(argv=None) -> Tuple[Dict[int, Completion], float]:
    """Build from the flags, drain every request; returns the completions
    and the drain's wall seconds (ending in a device synchronize)."""
    args = parse_args(argv)
    requests = read_requests(args)
    scheduler = build(args)
    t0 = time.perf_counter()
    completions = scheduler.run(requests)
    if scheduler.engine.device.type == "cuda":
        torch.cuda.synchronize(scheduler.engine.device)
    return completions, time.perf_counter() - t0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    completions, seconds = run(argv)
    for uid in sorted(completions):
        print(" ".join(str(t) for t in completions[uid].tokens))
    n_tokens = sum(len(c.tokens) for c in completions.values())
    logger.info(f"{n_tokens} tokens in {seconds:.3f}s ({n_tokens / seconds:.1f} tokens/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
