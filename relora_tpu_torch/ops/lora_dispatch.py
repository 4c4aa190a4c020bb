"""Execution arms of the LoRA composite ``x @ W + ((x @ A) @ B) * s``, and the
cost model that picks one per shape.

Counterpart of ``relora_tpu/ops/lora_dispatch.py``.  :func:`lora_matmul`
(``:271-349``) runs the composite through one of three arms:

- **fused**: :func:`relora_tpu_torch.ops.lora_matmul.fused_lora_matmul`, the
  hand-written kernels 4, 6 and 7 on CUDA (their plain twins on the CPU), for
  every shape (the JAX package's quiet ``plan_blocks`` fallback to ordered has
  no counterpart: the kernels mask ragged tiles);
- **ordered**: ``x@W + ((x@A)@B)*s``, plain PyTorch in the compute dtype
  (``:347-349``);
- **merged**: ``x @ (W + s*(A@B))``, plain PyTorch (``:344-346``), the merged
  weight built anew on every call, as the JAX arm builds it inside each jit.

The base is a dense ``(K, N)`` ``W`` or an int8 pair ``(q, qscale)``
(``q`` ``(K, N)`` int8, ``qscale`` ``(1, N)`` f32, ``:300-349``): the fused arm
then takes :func:`~relora_tpu_torch.ops.lora_matmul.fused_lora_matmul_int8`
(kernels 4-int8, 6-int8, 7), and ordered and merged dequantize in plain
PyTorch and use ``torch.matmul``, as the JAX arms do outside any kernel.

``arm="auto"`` asks :func:`choose_arm`: a roofline ``max(bytes/BW,
flops/rate) + launches * t_launch`` per arm over static Python ints
(``estimate_arm_times``, ``lru_cache``-d, ``:94-162``).  The fused arm is a
candidate only for CUDA tensors (the JAX package's ``default_backend() ==
"tpu"``, ``:317``): on the CPU ``auto`` never picks a kernel arm.  The
constants come from a :class:`Roofline`: :data:`V5E` holds the reference's
(``:73-78``), verbatim, and with it the port's model equals the JAX one;
:data:`H100` is the port's, from measurements on the card, and it corrects
the terms that misdescribe what the port executes:

- the **training backward** (``backward=True``, set by :func:`lora_matmul`
  when autograd will run): the reference's model is forward-only, while each
  arm's backward differs: ordered runs cuBLAS (``g@Wᵀ`` and four rank-r
  products), fused runs kernels 6 and 7, and merged differentiates through
  ``x @ W_eff``, which adds a full ``xᵀg`` product (2·M·K·N operations) and a
  K x N gradient of the merged weight;
- the **serving merged weight** (``weights_static``): the reference costs it
  as built once outside the step (``:143-149``), but neither package builds
  it once: each call forms ``W + s·A@B`` again, so under :data:`H100` merged
  pays that every call, served or not;
- the **launches**: the reference counts its compiled program's (one for a
  fused call, two for merged), while the port runs eager ops, each of which
  costs the host about as much as a launch (ordered 5 forward, merged 4, an
  int8 dequantize 3 more; a fused wrapper call weighs about 6); the drains
  and llama_250m's training are host-bound, so these counts rank the arms
  there, and the picks at those shapes depend on the host's speed as well
  as the card's.

Under :data:`H100` the merged arm is also a candidate only for static
weights (serving): in bf16, ``W + s·A@B`` rounds away the part of a small
training delta below W's last bit, so a run trained through it reaches a
higher loss than the ordered or fused arm (7.305 against 7.171 after nine
llama_250m updates, PERF.md).  A served merged weight rounds exactly as a
checkpoint merged for serving does.

:func:`lora_matmul_grouped` is the multi-tenant composite (``:352-417``),
with its own arms, :data:`GROUPED_ARMS`:

- **grouped** and **looped**:
  :func:`relora_tpu_torch.ops.lora_matmul.grouped_lora_matmul`, kernel 5 on
  CUDA (its plain twin on the CPU); the JAX package's ``looped`` also runs
  the grouped kernel (``:403-412``);
- **gathered**: ``A[idx]``, ``B[idx]`` gathered per row and contracted with
  ``bmm``, plain PyTorch in the compute dtype on any device.

``auto`` asks :func:`choose_grouped_arm` (``:212-237``), kernel 5 being a
candidate only for CUDA tensors; kernel 5 masks ragged tiles, so no N is
struck.  Under :data:`H100` that always gives ``grouped`` on CUDA (it moves
fewer bytes than ``gathered`` in fewer launches, and ties ``looped`` at one
adapter) and ``gathered`` on the CPU, as the reference's gives off-TPU.
An int8 base raises: the spec forbids adapter slots over a quantized base.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple, Union

import torch

from relora_tpu_torch.ops.lora_matmul import (
    Scale,
    dequantize_kn,
    fused_lora_matmul,
    fused_lora_matmul_int8,
    grouped_lora_matmul,
    grouped_shapes,
)

ARMS: Tuple[str, ...] = ("fused", "ordered", "merged")
#: arms of the multi-tenant composite, disjoint from :data:`ARMS`
GROUPED_ARMS: Tuple[str, ...] = ("grouped", "gathered", "looped")

# The reference's roofline constants for TPU v5e (single core), under its names.
HBM_BW_BYTES = 819e9  # HBM bandwidth, bytes/s
PEAK_FLOPS = 197e12  # bf16 MXU peak, FLOP/s
LAUNCH_OVERHEAD_S = 3e-6  # per dispatched op (launch + scheduling)

# NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet at the 700 W limit.
H100_HBM_BW_BYTES = 3.35e12
H100_PEAK_FLOPS = 989e12  # bf16 tensor cores, dense


@dataclasses.dataclass(frozen=True)
class Roofline:
    """The cost model's constants for one device and package.

    ``arm_rate`` is the share of ``peak_flops`` each arm's GEMMs reach
    (absent: 1), the one figure per arm it takes to rank the arms as the
    card does.  ``static_merge_built_once`` is the reference's assumption
    that a served merged weight is built once outside the step; ``False``
    costs the rebuild the port (and the JAX package) runs on every call.
    ``count_backward`` adds each arm's backward when autograd will run; the
    reference's model has no backward.  ``launches`` counts each arm's
    launches ``(arm, forward, backward)`` and ``dequant_launches`` those an
    int8 base adds to an arm that dequantizes it first: the reference counts
    its compiled program's (a fused arm's call as one launch), the port the
    eager ops it runs, a fused wrapper call weighed as the ops whose host time
    it takes.  ``merge_static_only`` strikes the merged arm unless the
    weights are static: its bf16 merged weight rounds a training delta."""

    hbm_bytes_per_s: float
    peak_flops: float
    launch_s: float
    arm_rate: Tuple[Tuple[str, float], ...] = ()
    static_merge_built_once: bool = True
    count_backward: bool = False
    launches: Tuple[Tuple[str, int, int], ...] = (("fused", 1, 2), ("ordered", 4, 7), ("merged", 2, 5))
    dequant_launches: Tuple[Tuple[str, int], ...] = (("merged", 1),)
    merge_static_only: bool = False

    def rate(self, arm: str) -> float:
        return self.peak_flops * dict(self.arm_rate).get(arm, 1.0)

    def time(self, nbytes: float, flops: float, launches: int, arm: Optional[str] = None) -> float:
        rate = self.peak_flops if arm is None else self.rate(arm)
        return max(nbytes / self.hbm_bytes_per_s, flops / rate) + launches * self.launch_s


#: the reference's model, verbatim (``relora_tpu/ops/lora_dispatch.py:73-78``)
V5E = Roofline(HBM_BW_BYTES, PEAK_FLOPS, LAUNCH_OVERHEAD_S)

#: the port's model on the H100 (NVIDIA H100 80GB HBM3, 700 W), from the data
#: sheet's bandwidth and bf16 peak and from ``chip_smoke.py``'s auto-arms phase
#: (PERF.md §6): ``launch_s`` is the mean host cost of one eager op
#: back to back (11.4 µs an in-place add, 16.9 µs an 8 x 8 matmul); one fused
#: wrapper call takes the host time of about six such ops; each arm's rate is
#: its GEMMs' achieved share of the peak at M = 4096 (cuBLAS ordered 0.44-0.5,
#: merged 0.4, the fused kernels 0.2-0.24).  The launches are the eager ops
#: each arm runs: ordered 5 forward (x@A, z@B, x@W, ·s, +) and 7 backward,
#: merged 4 and 5, an int8 base's dequantize 3 more for either.  The launch
#: term is the host's: a later run's host took 8.4 and 16.0 µs, so where
#: launches decide a pick (decode, llama_250m's widths) it follows the host.
#: Merged serves only static weights (``merge_static_only``).
H100 = Roofline(
    H100_HBM_BW_BYTES,
    H100_PEAK_FLOPS,
    launch_s=14.1e-6,
    arm_rate=(("fused", 0.2), ("ordered", 0.5), ("merged", 0.4)),
    static_merge_built_once=False,
    count_backward=True,
    launches=(("fused", 6, 12), ("ordered", 5, 7), ("merged", 4, 5)),
    dequant_launches=(("ordered", 3), ("merged", 3)),
    merge_static_only=True,
)


@functools.lru_cache(maxsize=4096)
def estimate_arm_times(
    M: int,
    K: int,
    N: int,
    r: int,
    act_bytes: int = 2,
    base_bytes: int = 2,
    weights_static: bool = False,
    backward: bool = False,
    roofline: Roofline = H100,
) -> Dict[str, float]:
    """Modeled seconds per arm for one composite of shape (M, K, N, r)
    (``relora_tpu/ops/lora_dispatch.py:94-162``).

    ``act_bytes`` is the activation/LoRA dtype width (2 for bf16), and
    ``base_bytes`` the stored base-weight width (1 for int8).
    ``weights_static`` says W/A/B are constant across calls (serving), which
    amortizes the merged weight only where ``roofline.static_merge_built_once``.
    ``backward`` (training: x, A or B take a gradient) adds each arm's
    backward where ``roofline.count_backward``.  Under :data:`V5E` with
    ``backward=False`` the numbers are the reference's."""
    R = roofline
    base_flops = 2.0 * M * K * N
    lora_flops = 2.0 * M * r * (K + N)
    w_bytes = float(K * N * base_bytes)
    factor_bytes = float((K * r + r * N) * act_bytes)
    train = backward and R.count_backward
    launches = {arm: fwd + (bwd if train else 0) for arm, fwd, bwd in R.launches}
    if base_bytes < act_bytes:
        for arm, n in R.dequant_launches:
            launches[arm] += n

    # ordered: x@W, x@A, z@B, add; the base result and the full-width LoRA
    # output both round-trip through HBM, and the add re-reads both
    ordered_bytes = w_bytes + factor_bytes + (2 * M * K + 2 * M * r + 3 * M * N) * act_bytes
    ordered_flops = base_flops + lora_flops
    # fused: every operand read once, y (+ tiny z) written once, one launch
    fused_bytes = w_bytes + factor_bytes + (M * K + M * N + M * r) * act_bytes
    fused_flops = base_flops + lora_flops
    if train:
        # ordered under autograd: g·s, g@Wᵀ, dz = (g·s)@Bᵀ, dz@Aᵀ, dA = xᵀdz,
        # dB = zᵀ(g·s), dx summed; every intermediate round-trips
        ordered_bytes += w_bytes + 2 * factor_bytes + (4 * M * N + 5 * M * K + 4 * M * r) * act_bytes
        ordered_flops += base_flops + 2 * lora_flops
        # fused: kernel 6 (dx and u from g, W, A, B) and kernel 7 (dA, dB from
        # g, x, z, u), z and u in f32
        fused_bytes += w_bytes + 2 * factor_bytes + (2 * M * N + 2 * M * K) * act_bytes + 3 * M * r * 4
        fused_flops += base_flops + 2 * lora_flops
    ordered = R.time(ordered_bytes, ordered_flops, launches["ordered"], "ordered")
    fused = R.time(fused_bytes, fused_flops, launches["fused"], "fused")

    # merged: one matmul against w_eff = W + s·(A@B)
    if weights_static and R.static_merge_built_once:
        # w_eff is built once outside the step and reused: per-call cost is a
        # bare dense matmul (w_eff is act-width even over a quantized base)
        merged = R.time(float(K * N * act_bytes) + (M * K + M * N) * act_bytes, base_flops, 1,
                        "merged")
    else:
        # rebuilt per call: pay the 2·K·r·N delta FLOPs plus the w_eff HBM
        # round trip (a matmul output cannot fuse into a matmul operand)
        merged_bytes = w_bytes + factor_bytes + (M * K + M * N) * act_bytes + 2.0 * K * N * act_bytes
        merged_flops = base_flops + 2.0 * K * r * N
        if train:
            # dx = g@w_effᵀ, the merged weight's gradient xᵀg (K x N, written
            # and read back), dA = dW·Bᵀ, dB = Aᵀ·dW
            merged_bytes += (K * N * 4 + 2 * M * N + 2 * M * K) * act_bytes + 2 * factor_bytes
            merged_flops += 2 * base_flops + 4.0 * K * r * N
        merged = R.time(merged_bytes, merged_flops, launches["merged"], "merged")

    return {"fused": fused, "ordered": ordered, "merged": merged}


@functools.lru_cache(maxsize=4096)
def estimate_grouped_arm_times(
    M: int,
    K: int,
    N: int,
    r: int,
    num_adapters: int = 1,
    act_bytes: int = 2,
    base_bytes: int = 2,
    roofline: Roofline = H100,
) -> Dict[str, float]:
    """Modeled seconds per grouped arm for a mixed-tenant batch of M rows
    touching ``num_adapters`` distinct slots (``:165-209``): ``grouped``
    streams W and the activations once and reads ``G`` factor slabs in one
    launch; ``gathered`` writes and reads back a gathered slab per row;
    ``looped`` runs one fused launch per adapter, W read each time."""
    R = roofline
    G = max(1, min(num_adapters, M))
    base_flops = 2.0 * M * K * N
    lora_flops = 2.0 * M * r * (K + N)
    w_bytes = float(K * N * base_bytes)
    slab_bytes = float((K * r + r * N) * act_bytes)
    act_io = (M * K + M * N) * act_bytes

    grouped = R.time(w_bytes + G * slab_bytes + act_io, base_flops + lora_flops, 1)
    gathered = R.time(
        w_bytes + (G + 2.0 * M) * slab_bytes + act_io + 2 * M * N * act_bytes,
        base_flops + lora_flops,
        4,
    )
    looped = R.time(G * (w_bytes + slab_bytes) + act_io, base_flops + lora_flops, G)
    return {"grouped": grouped, "gathered": gathered, "looped": looped}


@functools.lru_cache(maxsize=4096)
def choose_grouped_arm(
    M: int,
    K: int,
    N: int,
    r: int,
    num_adapters: int = 1,
    act_bytes: int = 2,
    base_bytes: int = 2,
    grouped_available: bool = True,
    allow: Tuple[str, ...] = GROUPED_ARMS,
    roofline: Roofline = H100,
) -> str:
    """The cheapest grouped arm under the model (``:212-237``).
    ``grouped_available=False`` (a CPU tensor or an int8 base) strikes both
    kernel arms; ``gathered`` is always available.  The reference also strikes
    them for an N with no lane-tile divisor; kernel 5 masks ragged tiles."""
    times = estimate_grouped_arm_times(M, K, N, r, num_adapters, act_bytes, base_bytes, roofline)
    candidates = [arm for arm in allow if arm in GROUPED_ARMS]
    if not grouped_available:
        candidates = [a for a in candidates if a not in ("grouped", "looped")]
    if not candidates:
        return "gathered"
    return min(candidates, key=lambda arm: times[arm])


@functools.lru_cache(maxsize=4096)
def choose_arm(
    M: int,
    K: int,
    N: int,
    r: int,
    act_bytes: int = 2,
    base_bytes: int = 2,
    fused_available: bool = True,
    weights_static: bool = False,
    allow: Tuple[str, ...] = ARMS,
    backward: bool = False,
    roofline: Roofline = H100,
) -> str:
    """The cheapest arm for (M, K, N, r) under the model (``:240-264``),
    among :func:`candidate_arms`."""
    times = estimate_arm_times(M, K, N, r, act_bytes, base_bytes, weights_static, backward, roofline)
    candidates = candidate_arms(fused_available, weights_static, allow, roofline)
    if not candidates:
        return "ordered"
    return min(candidates, key=lambda arm: times[arm])


def candidate_arms(
    fused_available: bool = True,
    weights_static: bool = False,
    allow: Tuple[str, ...] = ARMS,
    roofline: Roofline = H100,
) -> Tuple[str, ...]:
    """The arms :func:`choose_arm` may pick.  ``fused_available=False`` (a
    CPU tensor) strikes the fused arm; the reference also strikes it where
    ``plan_blocks`` finds no tiling, which the port's kernels do not need.
    ``roofline.merge_static_only`` strikes merged unless ``weights_static``.
    ``allow`` restricts the candidates."""
    struck = set() if fused_available else {"fused"}
    if roofline.merge_static_only and not weights_static:
        struck.add("merged")
    return tuple(arm for arm in allow if arm in ARMS and arm not in struck)


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1] if x.dim() else 1


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    )


def lora_matmul(
    x: torch.Tensor,
    base: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    a: torch.Tensor,
    b: torch.Tensor,
    scale: Scale = 1.0,
    *,
    arm: str = "auto",
    dtype: Optional[torch.dtype] = None,
    weights_static: bool = False,
) -> torch.Tensor:
    """``x @ W + ((x @ A) @ B) * scale`` through ``arm``, with ``x``, the
    ``(K, N)`` base ``W`` (dequantized first for an int8 ``(q, qscale)``
    base, outside the fused arm) and the factors cast to ``dtype`` (default
    x's).  ``arm="auto"`` asks :func:`choose_arm` under :data:`H100`, the
    fused arm a candidate for CUDA tensors only and the merged arm for
    ``weights_static`` (serving) only.  The fused arm gives a dense base no gradient; pass a
    detached base to every arm so they agree."""
    if arm not in ARMS and arm != "auto":
        raise ValueError(f"unknown arm {arm!r}; expected one of {ARMS + ('auto',)}")
    dtype = dtype or x.dtype
    quantized = isinstance(base, tuple)
    if arm == "auto":
        K, N = base[0].shape if quantized else base.shape
        arm = choose_arm(
            _rows(x), K, N, a.shape[-1], dtype.itemsize, 1 if quantized else base.element_size(),
            fused_available=x.is_cuda, weights_static=weights_static,
            backward=_needs_grad(x, a, b, scale),
        )
    xd, ad, bd = (t.to(dtype) for t in (x, a, b))
    if quantized:
        q, qscale = base
        if arm == "fused":
            return fused_lora_matmul_int8(xd, q, qscale, ad, bd, scale)
        w = dequantize_kn(q, qscale).to(dtype)
    else:
        w = base.to(dtype)
        if arm == "fused":
            return fused_lora_matmul(xd, w, ad, bd, scale)
    if arm == "merged":
        delta = torch.matmul(ad, bd) * scale
        return torch.matmul(xd, w + delta.to(dtype))
    z = torch.matmul(torch.matmul(xd, ad), bd)
    return torch.matmul(xd, w) + z * scale


def lora_matmul_grouped(
    x: torch.Tensor,
    base: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    a_stack: torch.Tensor,
    b_stack: torch.Tensor,
    scale_stack: torch.Tensor,
    adapter_idx: torch.Tensor,
    *,
    arm: str = "auto",
    dtype: Optional[torch.dtype] = None,
    num_adapters: Optional[int] = None,
) -> torch.Tensor:
    """``y[m] = x[m] @ W + ((x[m] @ A[idx[m]]) @ B[idx[m]]) * s[idx[m]]``
    through ``arm``, with x, the ``(K, N)`` base and the ``(S, K, r)`` /
    ``(S, r, N)`` stacks cast to ``dtype`` (default x's); ``scale_stack``
    ``(S,)`` f32, ``adapter_idx`` ``(M,)`` int32.  ``num_adapters`` is the
    distinct-slot count for the cost model (default ``min(S, M)``, the worst
    case).  Inference only."""
    if arm not in GROUPED_ARMS and arm != "auto":
        raise ValueError(f"unknown grouped arm {arm!r}; expected one of {GROUPED_ARMS + ('auto',)}")
    if isinstance(base, tuple):
        raise ValueError(
            "lora_matmul_grouped needs a dense base: adapter slots over a quantized base "
            "are refused by LoraSpec (num_slots with quantize)"
        )
    dtype = dtype or x.dtype
    if arm == "auto":
        S, K, r = a_stack.shape
        M = _rows(x)
        arm = choose_grouped_arm(
            M, K, base.shape[1], r, num_adapters or min(S, M), dtype.itemsize, base.element_size(),
            grouped_available=x.is_cuda,
        )
    xd, w, ad, bd = (t.to(dtype) for t in (x, base, a_stack, b_stack))
    if arm != "gathered":
        return grouped_lora_matmul(xd, w, ad, bd, scale_stack, adapter_idx)
    M, K, N, _, _ = grouped_shapes(xd, w, ad, bd, adapter_idx)
    idx = adapter_idx.reshape(-1).long()
    x2 = xd.reshape(M, 1, K)
    z = torch.bmm(torch.bmm(x2, ad[idx]), bd[idx]).reshape(M, N)
    s = scale_stack.reshape(-1)[idx].to(dtype)
    y = torch.matmul(x2.reshape(M, K), w) + z * s[:, None]
    return y.reshape(*x.shape[:-1], N)
