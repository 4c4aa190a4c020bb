#!/usr/bin/env python3
"""Where a PyTorch-port training run spends its time on the card.

Builds the ``chip_smoke.py`` train phase's run (llama_250m at full width and
depth, bf16, LoRA r=128 with dropout 0.1, 9 updates of two 8 x 512
microbatches, merges and resets at updates 4 and 7, on the same seeded Zipf
corpus) and calls ``Trainer.fit`` three times on fresh trainers, without
eval: a warm-up, a timed run, then one under ``torch.profiler`` tracing the
device only.  Prints one JSON line: the timed run's median ms per update
(updates 2-9) and tokens/s, the profiled run's fit seconds (the difference
is the tracer's cost), the device's busy time and idle share of the profiled
fit, and device time by kernel name (names cut to 80 characters, times of
names that share those summed), largest first, with the shares of the
flash kernels, of ``lora_gemm_kernel``/``lora_dab_reduce_kernel``, of the
bf16 fused forward's tensor-core kernels (``fused_fwd_*``, kernels 4 and
4-int8), of the bf16 dx's (``fused_dx_*``, kernels 6 and 6-int8), of
kernel 8's (``dequant_matmul_tc_kernel``) and of kernel 7's (``dab_*``: its
split pass, tensor-core partials and reduce).  The GEMM kernel serves the fused
LoRA kernel 7 and the f32 forward, dx and kernel 8, so the line also gives
the timed run's launch count of every kernel wrapper.  Extra training flags
are appended to the train phase's, e.g. the fused-LoRA and the int8 runs:

    python3 tools/torch_train_profile.py
    python3 tools/torch_train_profile.py --lora_fused true --lora_dropout 0
    python3 tools/torch_train_profile.py --quantize int8 --warmed_up_model build/warm
    python3 tools/torch_train_profile.py --quantize int8 --warmed_up_model build/warm \
        --lora_fused true --lora_dropout 0

A ``--warmed_up_model`` directory without a ``pytorch_model.bin`` gets one
first: ``chip_smoke.write_warm_start``'s seeded full-rank model (f32; bf16
for pythia_1b).  ``--model_config pythia_1b`` profiles ``chip_smoke.py``'s
pythia train phase instead (pythia_1b at full width and depth, two 2 x 2048
microbatches an update, the same corpus at 2048 tokens a sample):

    python3 tools/torch_train_profile.py --model_config pythia_1b
    python3 tools/torch_train_profile.py --model_config pythia_1b --lora_fused true \
        --lora_dropout 0 --warmed_up_model build/warm_pythia_1b

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


def busy_seconds(intervals) -> float:
    busy = 0.0
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from relora_tpu_torch.config.training import parse_train_args
    from relora_tpu_torch.data.megatron import build_train_valid_test_iterators
    from relora_tpu_torch.train.trainer import Trainer

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    flags = sys.argv[1:]
    model = flags[flags.index("--model_config") + 1] if "--model_config" in flags else "llama_250m"
    if model not in ("llama_250m", chip_smoke.PYTHIA):
        raise SystemExit(f"torch_train_profile: --model_config takes {chip_smoke.PYTHIA} only")
    pythia = model == chip_smoke.PYTHIA
    if "--warmed_up_model" in flags:
        warm = flags[flags.index("--warmed_up_model") + 1]
        if not os.path.exists(os.path.join(warm, "pytorch_model.bin")):
            if pythia:
                chip_smoke.write_warm_start(torch, warm, torch.device("cuda"),
                                            model_config=chip_smoke.PYTHIA, dtype=torch.bfloat16)
            else:
                chip_smoke.write_warm_start(torch, warm, torch.device("cuda"))
    base = chip_smoke.PYTHIA_TRAIN_ARGS if pythia else chip_smoke.TRAIN_ARGS
    corpus = chip_smoke.write_corpus(work, seq_length=2048 if pythia else 512)
    cfg = parse_train_args(base + flags + ["--megatron_dataset_config", corpus])

    def run(prof=None):
        trainer = Trainer(cfg)
        batches = build_train_valid_test_iterators(cfg, trainer)[0]()
        torch.cuda.synchronize()
        if prof is None:
            return trainer.fit(batches)
        with prof:
            result = trainer.fit(batches)
            torch.cuda.synchronize()
        return result

    run()  # warm-up: kernel build, cuBLAS handles, allocator
    counters = chip_smoke._counters()
    for c in counters.values():
        c.launches = 0
    timed = run()
    launches = {n: c.launches for n, c in counters.items()}
    prof = profile(activities=[ProfilerActivity.CUDA])
    traced = run(prof)
    intervals, by_name = [], {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.time_range.elapsed_us() > 0:
            intervals.append((ev.time_range.start, ev.time_range.end))
            name = ev.name[:80]
            by_name[name] = by_name.get(name, 0.0) + ev.time_range.elapsed_us()
    if not intervals:
        raise SystemExit("torch_train_profile: the profiler traced no device time")
    busy = busy_seconds(intervals)
    flash_ms = sum(us for name, us in by_name.items() if "flash_" in name) / 1e3
    gemm_ms = sum(us for name, us in by_name.items() if "lora_gemm" in name or "lora_dab" in name) / 1e3
    fwd_tc_ms = sum(us for name, us in by_name.items() if "fused_fwd_" in name) / 1e3
    dx_tc_ms = sum(us for name, us in by_name.items() if "fused_dx_" in name) / 1e3
    dequant_tc_ms = sum(us for name, us in by_name.items() if "dequant_matmul_tc" in name) / 1e3
    # kernel 7: on the tensor cores its split pass, partials and reduce
    dab_ms = sum(us for name, us in by_name.items() if "dab_" in name) / 1e3
    steady = sorted(r["update_seconds"] for r in timed["records"][1:])
    ms = steady[len(steady) // 2] * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "extra_flags": flags,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0],
        "updates": len(timed["records"]),
        "ms_per_update": ms,
        "tokens_per_s": cfg.total_batch_size * cfg.max_length / (ms / 1e3),
        "fit_s": timed["fit_seconds"],
        "profiled_fit_s": traced["fit_seconds"],
        "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / traced["fit_seconds"],
        "flash_kernels_ms": flash_ms,
        "flash_share_of_busy": flash_ms / 1e3 / busy,
        "lora_gemm_kernels_ms": gemm_ms,
        "lora_gemm_share_of_busy": gemm_ms / 1e3 / busy,
        "fused_fwd_tc_kernels_ms": fwd_tc_ms,
        "fused_fwd_tc_share_of_busy": fwd_tc_ms / 1e3 / busy,
        "fused_dx_tc_kernels_ms": dx_tc_ms,
        "fused_dx_tc_share_of_busy": dx_tc_ms / 1e3 / busy,
        "dequant_tc_kernels_ms": dequant_tc_ms,
        "dequant_tc_share_of_busy": dequant_tc_ms / 1e3 / busy,
        "dab_kernels_ms": dab_ms,
        "dab_share_of_busy": dab_ms / 1e3 / busy,
        "launches": launches,
        "kernels_ms": {name: us / 1e3 for name, us in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
