#!/usr/bin/env python3
"""The paged scheduler's own host time per round, the model taken out.

Builds ``relora_tpu_torch.serve_cli``'s scheduler for the drains' traffic
(``chip_smoke.py``'s 16 prompts of 32-512 tokens, 64 new tokens,
``--max-batch 8 --paged``, a llama_9m engine on the CPU) and replaces the
engine's forwards (``prefill_chunk``, ``decode_paged``, ``step_paged``)
with stubs that return one fixed logits tensor of the asked shape, so a
round costs only admission, paging, sampling over the vocabulary and the
scheduler's bookkeeping.  Each mode (sequential, ``--packed``) drains
``--repeats`` times on a fresh scheduler; one JSON line gives the least
and the median microseconds per round and the number of rounds.  Runs
without a card.

    python3 tools/torch_sched_hostcost.py [DIR] [--repeats N]

DIR is a checkout whose package is measured (default: this one), so two
trees compare when run in turns (parent, change, change, parent).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    repeats = int(argv[argv.index("--repeats") + 1]) if "--repeats" in argv else 7
    tree = os.path.abspath(next((a for a in argv if not a.startswith("--") and not a.isdigit()), REPO))
    sys.path.insert(0, tree)
    sys.path.insert(1, REPO)
    import torch

    import chip_smoke
    from relora_tpu_torch import serve_cli

    work = os.path.join(REPO, "build", "sched_hostcost")
    os.makedirs(work, exist_ok=True)
    prompts = os.path.join(work, "prompts.txt")
    chip_smoke.write_prompts(prompts, 32000)
    out = {"tree": tree}
    for label, extra in (("sequential", []), ("packed", ["--packed"])):
        args = serve_cli.parse_args([
            "--model_config", "llama_9m", "--random-init", "--dtype", "f32", "--max-batch", "8",
            "--paged", "--max-new-tokens", "64", "--device", "cpu", "--cache-size", "640",
            "--input-file", prompts, *extra])
        per_round, rounds = [], 0
        for _ in range(repeats):
            scheduler = serve_cli.build(args)
            engine = scheduler.engine
            rows = max(engine.token_budget or 0, engine.chunk_size, args.max_batch)
            logits = torch.rand(engine.config.vocab_size).repeat(rows, 1)

            def fixed(*shape):
                return logits[: math.prod(shape)].reshape(*shape, -1)

            engine.decode_paged = lambda pool, tok, *a, **k: (fixed(tok.shape[0]), pool)
            engine.prefill_chunk = lambda ids, start, pool, *a, **k: (fixed(1, ids.shape[1]), pool)
            engine.step_paged = lambda pool, ids, *a, **k: (fixed(1, ids.shape[1]), pool)
            requests = serve_cli.read_requests(args)
            t0 = time.perf_counter()
            scheduler.run(requests)
            seconds = time.perf_counter() - t0
            rounds = scheduler._step_count
            per_round.append(seconds / max(rounds, 1) * 1e6)
        per_round.sort()
        out[label] = {"us_per_round_min": per_round[0],
                      "us_per_round_median": per_round[len(per_round) // 2], "rounds": rounds}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
