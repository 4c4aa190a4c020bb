#!/usr/bin/env python3
"""Where a PyTorch-port drain spends its time on the card.

Runs one ``relora_tpu_torch.serve_cli`` drain (the same 16 requests as
``chip_smoke.py``: llama_250m, prompts of 32-512 tokens, 64 new tokens,
``--random-init --dtype bf16 --max-batch 8 --paged``) three times — a
warm-up drain, a timed drain, then one under ``torch.profiler`` tracing
the device only — and prints one JSON line: the timed drain's wall seconds
and tokens/s, the profiled drain's wall seconds (the difference is the
tracer's cost), the device's busy time and idle share of the profiled
drain, device time by kernel name (names cut to 80 characters, times
of names that share those summed), largest first, and kernel 5's share of
the busy time.  Extra flags go to the CLI:

    python3 tools/torch_drain_profile.py               # sequential rounds
    python3 tools/torch_drain_profile.py --packed
    python3 tools/torch_drain_profile.py --kv-dtype int8
    python3 tools/torch_drain_profile.py --checkpoint B --no-merge --adapter-dir D
    python3 tools/torch_drain_profile.py --model_config pythia_1b   # the NeoX family

``--model_config`` replaces llama_250m (the prompts are the same).

``--tenants`` drains chip_smoke.py's mixed-tenant traffic instead: a seeded
llama_250m base and three tenant adapters written under ``build/chip_smoke/``,
the 16 prompts round-robin over [base, tA, tB, tC] through the scheduler API
with 4 adapter slots (``--packed`` for packed rounds; ``--slots 3`` for the
contention drain, adapters loaded and evicted mid-traffic).

Needs a CUDA card.  Busy time is the union of kernel intervals on the
device, so overlapping streams are not counted twice.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_drain_profile: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from relora_tpu_torch import serve_cli

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    prompts = os.path.join(work, "prompts.txt")
    chip_smoke.write_prompts(prompts, 32100)
    if "--tenants" in argv:
        from relora_tpu_torch.serve.adapters import AdapterRegistry

        device = torch.device("cuda")
        base, tenants = chip_smoke.write_adapter_checkpoints(torch, work, device)
        slots = int(argv[argv.index("--slots") + 1]) if "--slots" in argv else chip_smoke.ADAPTER_SLOTS
        engine = chip_smoke.tenant_engine(torch, base, slots, device)
        registry = AdapterRegistry(tenants, slots, expected_r=chip_smoke.ADAPTER_R,
                                   writer=engine.adapter_writer())
        requests = chip_smoke.tenant_requests(chip_smoke.read_prompts(prompts),
                                              [None] + list(chip_smoke.TENANT_ALPHAS))

        def drain():
            return chip_smoke.tenant_drain(torch, engine, registry, requests, "--packed" in argv)[:2]
    else:
        init = [] if "--checkpoint" in argv else ["--random-init"]
        model = [] if "--model_config" in argv else ["--model_config", "llama_250m"]
        args = [*model, *init, "--dtype", "bf16", "--max-batch", "8",
                "--paged", "--max-new-tokens", "64", "--input-file", prompts, *argv]

        def drain():
            return serve_cli.run(args)

    drain()  # warm-up: cuBLAS handles, allocator, kernel build
    completions, seconds = drain()
    _, wall, busy_s, by_name = chip_smoke.device_profile(torch, drain)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    tokens = sum(len(c.tokens) for c in completions.values())
    print(json.dumps({
        "flags": argv,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0],
        "drain_s": seconds,
        "profiled_wall_s": wall,
        "tokens_per_s": tokens / seconds,
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall,
        "grouped_lora_share": chip_smoke.grouped_share(by_name, busy_s),
        "kernels_ms": {name: us / 1e3 for name, us in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
