#!/usr/bin/env python3
"""Where the bf16 int8 dx's error against its twin comes from, and what
carrying the widened base as two bf16 halves would cost.

The tensor-core int8 dx (``fused_dx_tc_int8_kernel``) rounds each dequantized
base element once, ``bf16(q * qscale[n])``, where the twin forms ``q *
qscale`` in f32.  For kernels-8's bf16 cases of ``chip_smoke.py`` (the three
llama_250m projection shapes at M = 4096, r = 128; M = 1024, r = 320; the
ragged M = 200, K = 72, N = 104, r = 8) this prints, relative to max(1,
|dx|): the kernel against the twin (both rounded to bf16 once at the end), the
kernel and the twin each against the exact f32 product, and the base
rounding's own share (the f32 product over the bf16-rounded base against
the exact one).  Then the same for a variant build in which the widening pass
writes hi = bf16(q * scale) and lo = bf16(q * scale - hi) and every B
fragment meets both (twice segment 1's MMAs), and both builds' device time per
decoder layer (100 launches per shape, cold L2).  The variant is the tree's
source patched in ``build/int8_dx_hilo/`` and is not kept in the package.

    python3 tools/int8_dx_precision.py

Needs a CUDA card and nvcc.  Prints one JSON line per build.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the widening pass and segment 1 of the int8 dx, rewritten for hi + lo halves
HILO_PATCH = [
    ("constexpr int kYSmem = kFwdStages * kYStage > kYSmem2 ? kFwdStages * kYStage : kYSmem2;",
     "constexpr int kYSmem = 96 * 1024;"),
    ("+ 2 * kDxWTile <= kYSmem", "+ 4 * kDxWTile <= kYSmem"),
    ("""    const uint4 h0 = widen8_scaled(v.x, v.y, sc), h1 = widen8_scaled(v.z, v.w, sc);
    const bool swap = (tid / 4) % 2;
    bf16* d = dst + row * kYNLd + c;
    *reinterpret_cast<uint4*>(d + (swap ? 8 : 0)) = swap ? h1 : h0;
    *reinterpret_cast<uint4*>(d + (swap ? 0 : 8)) = swap ? h0 : h1;""",
     """    const bool swap = (tid / 4) % 2;
    for (int half = 0; half < 2; ++half) {
      uint4 h0 = widen8_scaled(v.x, v.y, sc), h1 = widen8_scaled(v.z, v.w, sc);
      if (half) {
        h0 = widen8_lo(v.x, v.y, sc, h0);
        h1 = widen8_lo(v.z, v.w, sc, h1);
      }
      bf16* d = dst + half * (kDxWTile / 2) + row * kYNLd + c;
      *reinterpret_cast<uint4*>(d + (swap ? 8 : 0)) = swap ? h1 : h0;
      *reinterpret_cast<uint4*>(d + (swap ? 0 : 8)) = swap ? h0 : h1;
    }"""),
    ("// launch 1: z = x @ a, block",
     """__device__ __forceinline__ uint4 widen8_lo(uint32_t w0, uint32_t w1, float sc, uint4 hi) {
  const uint32_t hw[4] = {hi.x, hi.y, hi.z, hi.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = i < 2 ? w0 : w1;
    const float v0 = static_cast<float>(static_cast<int8_t>(w >> (16 * (i % 2)))) * sc;
    const float v1 = static_cast<float>(static_cast<int8_t>(w >> (16 * (i % 2) + 8))) * sc;
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hw[i]);
    __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __bfloat162float(h.x), v1 - __bfloat162float(h.y));
    o[i] = *reinterpret_cast<uint32_t*>(&l);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// launch 1: z = x @ a, block"""),
    ("    return reinterpret_cast<bf16*>(smem + kFwdStages * kStage + buf * kDxWTile);",
     "    return reinterpret_cast<bf16*>(smem + kFwdStages * kStage + buf * 2 * kDxWTile);"),
    ("""#pragma unroll 1
    for (int ks = 0; ks < kFwdBK; ks += 16) {
      uint32_t b[4][2];
      if constexpr (kDx) {
        const bf16* bt = kWiden ? wide(kt % 2) : reinterpret_cast<const bf16*>(bs(kt % kFwdStages));""",
     """#pragma unroll 1
    for (int kh = 0; kh < (kWiden ? 2 * kFwdBK : kFwdBK); kh += 16) {
      const int ks = kh % kFwdBK;
      uint32_t b[4][2];
      if constexpr (kDx) {
        const bf16* bt = kWiden ? wide(kt % 2) + (kh / kFwdBK) * (kDxWTile / 2)
                                : reinterpret_cast<const bf16*>(bs(kt % kFwdStages));"""),
]


def hilo_library() -> str:
    """Build the hi/lo variant of lora_matmul.cu; returns the library's path."""
    from relora_tpu_torch.ops import _build

    src = (_build.CSRC / "lora_matmul.cu").read_text()
    for old, new in HILO_PATCH:
        if src.count(old) != 1:
            raise RuntimeError(f"the hi/lo patch no longer applies at: {old[:60]!r}")
        src = src.replace(old, new)
    out = os.path.join(REPO, "build", "int8_dx_hilo")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "lora_matmul.cu"), "w") as f:
        f.write(src)
    lib = os.path.join(out, "liblora_matmul.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", lib,
                    os.path.join(out, "lora_matmul.cu")], check=True)
    return lib


def measure(build: str) -> dict:
    import torch

    import chip_smoke as C
    from relora_tpu_torch.core.relora import full_f32_matmul
    from relora_tpu_torch.ops import _build

    if build == "hilo":
        _build._LIBS["lora_matmul"] = ctypes.CDLL(hilo_library())
    from relora_tpu_torch.ops import lora_matmul as LM

    dev = torch.device("cuda")
    cases = [(C.LORA_M, K, N, C.LORA_R) for K, N, _ in C.LORA_SHAPES]
    cases += [(1024, 768, 768, 320), C.RAGGED_TC[:4]]
    errors = {}
    with torch.no_grad(), full_f32_matmul():
        for i, (M, K, N, r) in enumerate(cases):
            x, q, qs, a, b, g = C.make_int8_case(torch, dev, M, K, N, r, "bf16", seed=51 + i)
            tc0 = LM.fused_lora_int8_bwd_dx.tc_launches
            got = LM.fused_lora_int8_bwd_dx(g, q, qs, a, b, 0.25)[0]
            if LM.fused_lora_int8_bwd_dx.tc_launches == tc0:
                raise AssertionError(f"{(M, K, N, r)} did not take the tensor cores")
            twin = LM.fused_lora_int8_bwd_dx_plain(g, q, qs, a, b, 0.25)[0]
            g32, w = g.float(), LM.dequantize_kn(q, qs)
            lora = (g32 @ b.float().t()) @ a.float().t() * 0.25
            exact = g32 @ w.t() + lora
            rounded = g32 @ w.to(torch.bfloat16).float().t() + lora
            scale = max(1.0, exact.abs().max().item())
            errors[f"M={M} K={K} N={N} r={r}"] = {
                "kernel_vs_twin": C._rel_err([(got, twin)])[1],
                "kernel_vs_exact": (got.float() - exact).abs().max().item() / scale,
                "twin_vs_exact": (twin.float() - exact).abs().max().item() / scale,
                "base_rounding": (rounded - exact).abs().max().item() / scale,
            }
        ms = {}
        for K, N, count in C.LORA_SHAPES:
            x, q, qs, a, b, g = C.make_int8_case(torch, dev, C.LORA_M, K, N, C.LORA_R, "bf16", seed=99)
            ms[f"K={K} N={N}"] = C.time_ms(torch, lambda: LM.fused_lora_int8_bwd_dx(g, q, qs, a, b, 0.25),
                                           iters=100)
    per_layer = sum(c * ms[f"K={K} N={N}"] for K, N, c in C.LORA_SHAPES)
    return {"build": build, "card": torch.cuda.get_device_name(0), "errors_rel_to_max1": errors,
            "ms_per_call": ms, "ms_per_layer": per_layer}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("int8_dx_precision: no CUDA card", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--build"]:
        print(json.dumps(measure(sys.argv[2])))
        return 0
    # one process per build: each loads its own library
    for build in ("tree", "hilo"):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--build", build], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
