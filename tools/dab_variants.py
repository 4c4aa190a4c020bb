#!/usr/bin/env python3
"""Kernel 7's tensor-core path (the fused LoRA dA/dB) under other tilings.

Builds copies of ``relora_tpu_torch/csrc/lora_matmul.cu`` with one constant
or pragma changed each (under ``build/dab_variants/``), calls each build's
``fused_lora_bwd_dab_launch`` on the three llama_250m projection shapes (M =
4096, r = 128, bf16, u from the dx), and prints one JSON line a variant and
round: the ms per decoder layer (seven projections, ``chip_smoke.time_ms``:
device time, cold L2) and the largest error against the plain twin relative
to max(1, |twin|).  Two rounds, variants in turns, so drift shows.

    python3 tools/dab_variants.py

Needs a CUDA card and nvcc.  The shipped constants are the ``shipped`` row.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KS = "#pragma unroll\n    for (int ks = 0; ks < kDabBK; ks += 16) {"
# name -> {text in the source: its replacement}
VARIANTS = {
    "shipped": {},
    "stages_of_32_rows_4_deep": {"constexpr int kDabBK = 64;": "constexpr int kDabBK = 32;",
                                 "constexpr int kDabStages = 3;": "constexpr int kDabStages = 4;"},
    "k16_loop_rolled": {KS: "#pragma unroll 1\n    for (int ks = 0; ks < kDabBK; ks += 16) {"},
    "stages_4_deep": {"constexpr int kDabStages = 3;": "constexpr int kDabStages = 4;"},
    "tiles_128x64": {"constexpr int kDabCols = 128;": "constexpr int kDabCols = 64;",
                     "constexpr int kDabWarpsR = 2;": "constexpr int kDabWarpsR = 4;"},
    "chunks_of_256_rows": {"constexpr int kChunk = 512;": "constexpr int kChunk = 256;"},
}


def main() -> int:
    import torch

    import chip_smoke
    from relora_tpu_torch.ops import _build
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.ops._build import ptr_arg, stream_arg

    if not torch.cuda.is_available():
        print("dab_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    src = (_build.CSRC / "lora_matmul.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"dab_variants: {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        d = os.path.join(REPO, "build", "dab_variants", name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "lora_matmul.cu"), "w") as f:
            f.write(text)
        so = os.path.join(d, "liblora_matmul.so")
        procs[name] = (so, "kChunk = 256" in text, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", so,
             os.path.join(d, "lora_matmul.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    argtypes = LM._kernel_library().fused_lora_bwd_dab_launch.argtypes
    M, r, s = 4096, 128, 0.25
    cases = []
    for K, N, count in chip_smoke.LORA_SHAPES:
        x, w, a, b, gy = chip_smoke.make_lora_case(torch, dev, M, K, N, r, "bf16", seed=99)
        _, z = LM.fused_lora_forward(x, w, a, b, s)
        _, u = LM.fused_lora_bwd_dx(gy, w, a, b, s)
        cases.append((K, N, count, x, b, gy, z, u, LM.fused_lora_bwd_dab_plain(gy, x, z, b, s, u)))
    libs = {}
    for name, (so, half_chunks, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"dab_variants: {name} did not build:\n{log}")
        lib = ctypes.CDLL(so)
        lib.fused_lora_bwd_dab_launch.argtypes = argtypes
        lib.fused_lora_bwd_dab_launch.restype = ctypes.c_int
        libs[name] = (lib, 256 if half_chunks else LM.DAB_CHUNK)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for round_ in range(2):
        for name, (lib, chunk) in libs.items():
            ms, rel = 0.0, 0.0
            for K, N, count, x, b, gy, z, u, want in cases:
                part = torch.empty((-(-M // chunk), K * r + r * N), dtype=torch.float32, device=dev)
                split = torch.empty((4, M, r), dtype=torch.bfloat16, device=dev)
                da = torch.empty((K, r), dtype=torch.float32, device=dev)
                db = torch.empty((r, N), dtype=torch.float32, device=dev)

                def call():
                    err = lib.fused_lora_bwd_dab_launch(
                        ptr_arg(gy), ptr_arg(x), ptr_arg(z), ptr_arg(u), 1, ptr_arg(b), None, s,
                        ptr_arg(part), ptr_arg(split), ptr_arg(da), ptr_arg(db), M, K, N, r, 1, 1,
                        stream_arg(gy))
                    if err:
                        raise RuntimeError(f"{name}: error {err}")

                call()
                torch.cuda.synchronize()
                rel = max(rel, chip_smoke._rel_err(list(zip((da, db), want)))[1])
                ms += count * chip_smoke.time_ms(torch, call, iters=60)
            print(json.dumps({"variant": name, "round": round_, "ms_per_layer": ms,
                              "rel_err": rel, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
