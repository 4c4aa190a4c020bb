"""Generate with the PyTorch port: token-id prompts through the contiguous or
the paged engine.

Counterpart of ``serve.py`` for the flags the port serves.  Prompts are
token ids (comma- or space-separated ints), one per ``--prompt`` or one per
line of ``--input-file`` (``-`` = stdin); one line of generated ids is printed
per request, in request order.  ``--prompt`` is the one-shot mode: every
prompt padded to one bucket and generated together by
``InferenceEngine.generate``.  ``--input-file`` drains the requests through
the continuous-batching scheduler.  Called from Python, :func:`drain` and
:func:`run` queue ``--prompt`` lines as scheduler requests too (the API the
tests drive); only :func:`main` and :func:`one_shot` send ``--prompt`` to
``generate``.  Runs on ``--device cuda`` (the default);
``--device cpu`` runs every kernel's plain version.

Without ``--paged`` the engine keeps the contiguous KV cache, one
``cache_size`` row per decode slot, and each admitted request prefills
alone before it joins the decode batch (the reference's default mode):

    python -m relora_tpu_torch.serve_cli --model_config llama_250m \
        --random-init --dtype bf16 --max-batch 8 --input-file prompts.txt

``--paged`` serves from a shared page pool instead, prefilling in chunks
between decode rounds; ``--packed``, ``--kv-dtype int8`` and ``--spec``
need it:

    python -m relora_tpu_torch.serve_cli --model_config llama_250m \
        --random-init --paged --dtype bf16 --max-batch 8 --input-file prompts.txt

Weights come from ``--random-init`` or from ``--checkpoint DIR``, a
checkpoint directory of ``relora_tpu_torch.train.checkpoint``: merged by
default (an int8 or nf4 base dequantized into an f32 weight plus the
delta), its factors unmerged with ``--no-merge`` (a dense or int8 base's
projections then run the cost model's pick of the fused, ordered or merged
arm, as the JAX package serves a quantized base it cannot merge into; an
nf4 base's run its plain dequantize-matmul plus the branch, nf4 having no
kernel):

    python -m relora_tpu_torch.serve_cli --model_config llama_250m \
        --checkpoint CKPT --no-merge --paged --dtype bf16 --max-batch 8 \
        --input-file prompts.txt

Multi-tenant serving stacks tenant adapters over an unmerged base:

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

``--port N`` (0 = ephemeral; ``--port-file`` receives the bound port) serves
the same engine online instead (``serve/server.py``), paged or contiguous:
``POST /v1/generate`` (SSE or one JSON body; ``"adapter"`` picks a tenant
under ``--adapter-dir``), ``GET /healthz`` and ``GET /metrics``, with bounded
admission (``--max-queue``, 429 + Retry-After), a warmup that runs every
serving shape before ``/healthz`` reports ok (``--no-warmup`` skips it), a
stall watchdog (``--stall-timeout-s``) and a SIGTERM drain:

    python -m relora_tpu_torch.serve_cli --model_config llama_250m \
        --random-init --paged --dtype bf16 --max-batch 8 --port 0 --port-file F

A server swaps its weights in place for a verified checkpoint on ``POST
/admin/reload {"checkpoint": DIR}``; ``--watch-checkpoints SAVE_DIR`` makes a
checkpoint-backed server do it for every directory the trainer (or
``python -m relora_tpu_torch.serve.deploy publish DIR``) publishes as
``SAVE_DIR/latest``.  ``--role prefill`` and ``--role decode`` split
serving between replicas (``--paged``): a prefill replica hands each
finished prompt's page run to a decode peer of ``--peer-file`` (a
``peers.json`` roster, ``{"replicas": [{"rid", "host", "port", "role"}]}``)
and relays the peer's stream; any failure before a token reached the
client decodes locally:

    python -m relora_tpu_torch.serve_cli --model_config llama_250m \
        --random-init --paged --kv-dtype int8 --dtype bf16 --max-batch 8 \
        --port 0 --port-file F --role prefill --peer-file peers.json
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from relora_tpu_torch import resolve_device
from relora_tpu_torch.config.model import load_model_config
from relora_tpu_torch.models.params_util import init_params
from relora_tpu_torch.serve.adapters import AdapterRegistry
from relora_tpu_torch.serve.engine import InferenceEngine, build_decode_model, compute_dtype
from relora_tpu_torch.serve.sampling import SamplingParams
from relora_tpu_torch.serve.scheduler import (
    Completion,
    ContinuousBatchingScheduler,
    PagedContinuousBatchingScheduler,
    Request,
)
from relora_tpu_torch.serve.deploy import CheckpointWatcher, checkpoint_step
from relora_tpu_torch.serve.server import FLEET_FRONT_END, GenerateServer, run_server
from relora_tpu_torch.train.checkpoint import (
    load_lora_spec,
    restore_params_host,
    restore_serving_params,
    verify_checkpoint,
)
from relora_tpu_torch.utils import faults
from relora_tpu_torch.utils.logging import MetricsLogger

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
    p.add_argument(
        "--paged", action="store_true",
        help="paged KV cache: chunked prefill between decode rounds, page-pool "
        "admission, prefix caching (default: the contiguous cache)",
    )
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
    p.add_argument(
        "--run-dir", default=None, help="metrics.jsonl destination (request-loop/server mode)"
    )
    p.add_argument(
        "--port", type=int, default=None, help="launch the HTTP server on this port (0 = ephemeral)"
    )
    p.add_argument("--host", default="127.0.0.1", help="server bind address")
    p.add_argument(
        "--max-queue", type=int, default=64, help="server: max waiting requests before 429"
    )
    p.add_argument(
        "--port-file", default=None, help="server: write the bound port here once listening"
    )
    p.add_argument(
        "--no-warmup", action="store_true",
        help="server: skip the warmup at startup (the first request then builds the kernels)",
    )
    p.add_argument(
        "--stall-timeout-s", type=float, default=0.0,
        help="server: decode-progress watchdog; no scheduler step for this long flips "
        "/healthz to 503 'stuck' and dumps the flight recorder (0 disables)",
    )
    p.add_argument(
        "--watch-checkpoints", default=None, metavar="DIR",
        help="server: poll DIR/latest (published at every manifest commit of the "
        "trainer) and hot-swap verified new checkpoints in place, the requests in "
        "flight finishing on the old weights; requires --port",
    )
    p.add_argument(
        "--watch-interval-s", type=float, default=2.0, help="checkpoint watcher poll interval"
    )
    p.add_argument(
        "--role", choices=("prefill", "decode", "mixed"), default="mixed",
        help="disaggregated fleet role: 'prefill' replicas hand finished prompts' KV "
        "pages to a decode peer over /internal/migrate, 'decode' replicas adopt them, "
        "'mixed' serves everything (the fallback pool); prefill/decode require --paged",
    )
    p.add_argument(
        "--peer-file", default=None,
        help="disagg: the peers.json roster prefill replicas pick migration targets "
        "from; requires --port",
    )
    p.add_argument(
        "--fleet-url", default=None,
        help="disagg: the fleet prefix directory (not ported yet: ROADMAP Queue 1 item 5b)",
    )
    p.add_argument(
        "--migrate-timeout-s", type=float, default=30.0,
        help="disagg: per-I/O timeout of the migration transfer",
    )
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


def check_paged_flags(args: argparse.Namespace) -> None:
    """``serve.py``'s refusals of the paged-only flags without ``--paged``,
    in its order and with its messages."""
    if args.paged:
        return
    if args.packed:
        raise SystemExit(
            "--packed requires --paged (the packed step routes every token "
            "through the paged pool's block tables)"
        )
    if args.kv_dtype != "bf16":
        raise SystemExit("--kv-dtype int8 requires --paged (the contiguous cache is unquantized)")


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
        if args.role != "mixed":
            raise SystemExit(
                "--spec model needs --role mixed: draft KV pages cannot "
                "migrate between disaggregated peers"
            )
    elif args.draft_checkpoint:
        raise SystemExit("--draft-checkpoint only applies with --spec model")


def check_server_flags(args: argparse.Namespace) -> None:
    """``serve.py``'s checks of the server and fleet flags, with its
    messages (``serve.py:305-320``); ``--fleet-url`` is refused."""
    if args.port is not None and (args.prompt or args.input_file):
        raise SystemExit("--port runs the HTTP server; drop --prompt/--input-file")
    if args.role != "mixed" and not args.paged:
        raise SystemExit(
            f"--role {args.role} requires --paged (KV-page migration ships "
            "page runs; the contiguous cache has none)"
        )
    if (args.peer_file or args.fleet_url) and args.port is None:
        raise SystemExit("--peer-file/--fleet-url configure the HTTP server; pass --port")
    if args.watch_checkpoints is not None:
        if args.port is None:
            raise SystemExit(
                "--watch-checkpoints hot-swaps a running server and requires --port"
            )
        if args.random_init:
            raise SystemExit(
                "--watch-checkpoints needs a checkpoint-backed server, not --random-init"
            )
    if args.fleet_url:
        raise SystemExit(f"--fleet-url: {FLEET_FRONT_END}")
    if args.max_queue < 1:
        raise SystemExit(f"--max-queue must be >= 1, got {args.max_queue}")


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
    ok, reason = verify_checkpoint(args.checkpoint)
    if not ok:
        raise SystemExit(f"refusing to serve corrupt checkpoint {args.checkpoint}: {reason}")
    return restore_params_host(args.checkpoint), spec


def preload_adapters(args: argparse.Namespace, registry: Optional[AdapterRegistry]) -> None:
    """Load ``--adapters`` into slots (none pinned)."""
    if registry is None:
        return
    for name in [n.strip() for n in (args.adapters or "").split(",") if n.strip()]:
        try:
            slot = registry.acquire(name)
        except ValueError as e:
            raise SystemExit(f"--adapters: {e}")
        if slot is None:
            raise SystemExit(f"--adapters: no free slot for {name!r} (raise --adapter-slots)")
        registry.release(name)
        logger.info(f"preloaded adapter {name!r} into slot {slot}")


def build_engine(
    args: argparse.Namespace, preload: bool = True
) -> Tuple[InferenceEngine, Optional[AdapterRegistry]]:
    """The engine the flags describe, weights included, and its adapter
    registry (None without ``--adapter-dir``); ``preload=False`` leaves
    ``--adapters`` to the caller (the server preloads after its warmup)."""
    check_adapter_flags(args)
    check_paged_flags(args)
    check_spec_flags(args)
    check_server_flags(args)
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
    paged = {}
    if args.paged:
        # every slot at full length at once, plus the null page; --spec model
        # reserves a second run per slot for the draft's K/V
        slot_pages = (cache_size // args.page_size) * (2 if args.spec == "model" else 1)
        window = args.spec_k + 1 if args.spec != "off" else 1
        paged = dict(
            page_size=args.page_size,
            num_pages=args.num_pages or (args.max_batch * slot_pages + 1),
            chunk_size=args.chunk_size,
            kv_dtype=args.kv_dtype,
            token_budget=(args.token_budget or args.max_batch * window + args.chunk_size)
            if args.packed
            else None,
            spec_k=args.spec_k if args.spec != "off" else 0,
        )
    engine = InferenceEngine(
        model_cfg,
        params,
        cache_size=cache_size,
        dtype=dtype,
        device=device,
        lora=lora_spec,
        adapter_slots=adapter_slots,
        **paged,
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
        if preload:
            preload_adapters(args, registry)
    return engine, registry


def resolve_eos(args: argparse.Namespace, engine: InferenceEngine) -> Optional[int]:
    return args.eos_id if args.eos_id is not None else engine.config.eos_token_id


def build(
    args: argparse.Namespace, metrics: Optional[MetricsLogger] = None, preload: bool = True
) -> ContinuousBatchingScheduler:
    """The scheduler the flags describe over :func:`build_engine`'s engine:
    a ``PagedContinuousBatchingScheduler`` with ``--paged``, else the
    contiguous ``ContinuousBatchingScheduler``; ``metrics`` receives its
    records, ``preload`` as :func:`build_engine`."""
    engine, registry = build_engine(args, preload)
    common = dict(
        max_batch=args.max_batch,
        eos_id=resolve_eos(args, engine),
        top_k=args.top_k,
        seed=args.seed,
        metrics=metrics,
        adapter_registry=registry,
    )
    if args.paged:
        return PagedContinuousBatchingScheduler(
            engine, packed=args.packed, spec=args.spec, role=args.role, **common
        )
    return ContinuousBatchingScheduler(engine, **common)


def build_server(
    args: argparse.Namespace, metrics: Optional[MetricsLogger] = None
) -> Tuple[ContinuousBatchingScheduler, dict]:
    """The server mode's scheduler and ``GenerateServer`` keyword arguments,
    in ``serve.py``'s order: weights restored and the scheduler built with
    ``metrics`` here; the warmup (every serving shape once, which builds
    the kernels: the chunk and decode shapes, the packed buckets, or
    without ``--paged`` every prompt bucket's prefill, the insert and the
    decode) and then the ``--adapters`` preload run on the server's model
    thread before ``/healthz`` reports ok.  ``reload_prepare`` is the host
    half of a hot swap (``serve.py:589-606``): it verifies and restores a
    checkpoint off the model thread (raising fails the reload closed) and
    returns the swap the model thread applies."""
    scheduler = build(args, metrics, preload=args.no_warmup)
    engine = scheduler.engine
    lora_spec = engine._lora

    def reload_prepare(path: str):
        if args.no_merge:
            ok, reason = verify_checkpoint(path)
            if not ok:
                raise ValueError(f"refusing to reload corrupt checkpoint {path}: {reason}")
            spec = load_lora_spec(path)
            if spec is not None and spec.r != (lora_spec.r if lora_spec else None):
                raise ValueError(
                    f"reload rank mismatch: serving r={lora_spec.r if lora_spec else None}, "
                    f"{path} has r={spec.r}"
                )
            params = restore_params_host(path)
        else:
            params = restore_serving_params(path)  # verifies the manifest first
        return lambda: engine.reload_params(params)

    warmup_fn = None
    if not args.no_warmup:
        def warmup_fn():
            logger.info("warming the serving shapes (disable with --no-warmup)")
            report = scheduler.engine.warmup(args.max_batch, packed=args.packed)
            timings = ", ".join(f"{c['fn']} {c['duration_s']:.2f}s" for c in report["compiles"])
            buckets = report.get("packed_buckets") or report["prompt_buckets"]
            logger.info(
                f"warmup ran {report['n_compiles']} shapes "
                f"({'packed' if args.packed else 'prompt'} buckets {buckets}, "
                f"decode batch {report['batch']}): {timings}"
            )
            if metrics is not None:
                metrics.event(
                    "warmup",
                    batch=report["batch"],
                    prompt_buckets=report["prompt_buckets"],
                    packed_buckets=report.get("packed_buckets", []),
                    n_compiles=report["n_compiles"],
                )
            preload_adapters(args, scheduler.adapter_registry)
            return {"batch": report["batch"], "n_compiles": report["n_compiles"]}

    return scheduler, dict(
        host=args.host,
        port=args.port,
        max_queue=args.max_queue,
        default_max_new_tokens=args.max_new_tokens,
        default_temperature=args.temperature,
        default_top_p=args.top_p,
        stall_timeout_s=args.stall_timeout_s,
        metrics=metrics,
        warmup_fn=warmup_fn,
        reload_prepare=reload_prepare,
        weights_version=(checkpoint_step(args.checkpoint) if args.checkpoint else None) or 0,
        weights_checkpoint=os.path.abspath(args.checkpoint) if args.checkpoint else "",
        peer_file=args.peer_file,
        migrate_timeout_s=args.migrate_timeout_s,
    )


def kernel_launches() -> Dict[str, int]:
    """Each serving kernel wrapper's launches in this process so far.  A
    server logs a ``kernel_launches`` event at its exit: each kernel's
    launches after the warmup, and the warmup's own as ``warmup/<name>``
    (a fleet's kernel accounting across replica processes)."""
    from relora_tpu_torch.ops import attention, lora_matmul

    return {
        fn.__name__: fn.launches
        for fn in (attention.paged_decode_attention, attention.packed_paged_attention,
                   lora_matmul.grouped_lora_matmul, lora_matmul.fused_lora_forward,
                   lora_matmul.fused_lora_int8_forward)
    }


def serve(args: argparse.Namespace) -> int:
    """``--port``: serve ``/v1/generate``, ``/healthz`` and ``/metrics``
    until SIGTERM drains the server; the bound port goes to ``--port-file``
    once the listener is up."""
    faults.configure_from_env()
    if faults.active():
        logger.warning(faults.summary())
    # _source: the replica's identity, as the reference's fleet tooling reads it
    metrics = (
        MetricsLogger(run_dir=args.run_dir, source=os.environ.get("RELORA_TPU_REPLICA_ID", "serve"))
        if args.run_dir
        else None
    )
    scheduler, kwargs = build_server(args, metrics)
    warm: Dict[str, int] = {}  # the kernel launches of the warmup
    if kwargs["warmup_fn"] is not None:
        warmup = kwargs["warmup_fn"]

        def counted_warmup():
            report = warmup()
            warm.update(kernel_launches())
            return report

        kwargs["warmup_fn"] = counted_warmup
    watcher: Optional[CheckpointWatcher] = None

    def ready(server: GenerateServer) -> None:
        nonlocal watcher
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(str(server.port))
        if args.watch_checkpoints:
            # verified new checkpoints go through the server's reload fence
            def on_new(path: str):
                try:
                    req = server.request_reload(
                        kwargs["reload_prepare"](path),
                        checkpoint_step(path) or server.weights_version + 1, path,
                    )
                except Exception as e:
                    logger.error(f"self-update to {path} failed: {e!r}")
                    return False  # the watcher tries again at the next poll
                req.done.wait()
                if not req.ok:
                    logger.error(f"self-update to {path} failed: {req.error}")
                    return False
                logger.info(
                    f"self-update: now serving {path} (weights_version {server.weights_version})"
                )

            watcher = CheckpointWatcher(
                args.watch_checkpoints, on_new, interval_s=args.watch_interval_s,
                current=args.checkpoint,
            ).start()
            logger.info(
                f"watching {args.watch_checkpoints}/latest every {args.watch_interval_s:g}s "
                "for verified checkpoints"
            )

    try:
        return run_server(scheduler, ready_cb=ready, **kwargs)
    finally:
        if watcher is not None:
            watcher.stop()
        if metrics is not None:
            metrics.event("kernel_launches", **{
                **{k: v - warm.get(k, 0) for k, v in kernel_launches().items()},
                **{f"warmup/{k}": v for k, v in warm.items()},
            })
            metrics.finish()


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


def drain(argv=None) -> Tuple[Dict[int, Completion], float, ContinuousBatchingScheduler]:
    """Build from the flags, drain every request through the scheduler:
    ``--input-file``'s, or ``--prompt``'s queued as requests.  Here
    ``--prompt`` is not the command line's one-shot mode (that is
    :func:`one_shot`, which :func:`main` calls); returns the
    completions, the drain's wall seconds (ending in a device synchronize)
    and the scheduler, whose counters (``spec_stats``) the drain leaves
    behind."""
    args = parse_args(argv)
    requests = read_requests(args)
    metrics = MetricsLogger(run_dir=args.run_dir) if args.run_dir else None
    scheduler = build(args, metrics)
    t0 = time.perf_counter()
    try:
        completions = scheduler.run(requests)
        if scheduler.engine.device.type == "cuda":
            torch.cuda.synchronize(scheduler.engine.device)
    finally:
        if metrics is not None:
            metrics.finish()
    return completions, time.perf_counter() - t0, scheduler


def run(argv=None) -> Tuple[Dict[int, Completion], float]:
    """:func:`drain`'s completions and wall seconds (``--prompt`` lines
    queued as scheduler requests, as in :func:`drain`)."""
    return drain(argv)[:2]


def one_shot(argv=None) -> Tuple[List[List[int]], float, InferenceEngine]:
    """The ``--prompt`` mode (``serve.py:680-692``): every prompt generated
    together by ``InferenceEngine.generate``, on either engine.  Returns the
    generated ids per prompt, the wall seconds of the call (ending in a
    device synchronize) and the engine."""
    args = parse_args(argv)
    if not args.prompt:
        raise SystemExit("the one-shot mode needs --prompt")
    if args.input_file:
        raise SystemExit("--prompt and --input-file are mutually exclusive")
    engine, _ = build_engine(args)
    prompts = [_encode(text) for text in args.prompt]
    t0 = time.perf_counter()
    outs = engine.generate(
        prompts,
        max_new_tokens=args.max_new_tokens,
        sampling=SamplingParams(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p),
        eos_id=resolve_eos(args, engine),
        seed=args.seed,
    )
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return outs, time.perf_counter() - t0, engine


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    args = parse_args(argv)
    if args.port is not None:
        check_server_flags(args)
        return serve(args)
    if args.prompt and not args.input_file:
        outs, seconds, _ = one_shot(argv)
        for tokens in outs:
            print(" ".join(str(t) for t in tokens))
        n_tokens = sum(len(t) for t in outs)
        logger.info(f"{n_tokens} tokens in {seconds:.3f}s ({n_tokens / seconds:.1f} tokens/s)")
        return 0
    completions, seconds, scheduler = drain(argv)
    for uid in sorted(completions):
        print(" ".join(str(t) for t in completions[uid].tokens))
    n_tokens = sum(len(c.tokens) for c in completions.values())
    logger.info(f"{n_tokens} tokens in {seconds:.3f}s ({n_tokens / seconds:.1f} tokens/s)")
    if isinstance(scheduler, PagedContinuousBatchingScheduler) and scheduler._spec != "off":
        logger.info(f"speculative: {scheduler.spec_stats()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
