"""Layer-wise magnitude pruning of the frozen base (PERP, arXiv:2312.15230).

The port's copy of ``relora_tpu/compress/prune.py``.  ReLoRA's merge makes
the frozen base a living artifact: every cycle folds the low-rank update into
it and re-draws the factors.  PERP prunes the merged base by magnitude at
that moment and lets the next cycles' factors (the only trainable weights)
recover.  The mask is computed **once**, at the first merge at or past
``prune_start_step``, and re-applied inside every later merge, so pruned
positions stay exactly zero for the rest of the run.

Mask format
-----------
A dict ``{module name: keep}``: the port's name of every pruned LoRA-wrapped
projection (``layers.0.self_attn.q_proj``) to a bool tensor (True = keep)
in the reference's ``(in, out)`` kernel layout, on the weights' device.  The
port stores a dense ``weight`` and an int8 ``weight_q`` ``(out, in)``, so
their masks apply transposed; nf4 leaves are ``(in, out)`` already.  N:M
groups run along ``in`` in every storage.

The sidecar pair keeps the reference's format: ``prune_mask.npz`` holds the
masks as numpy bool ``(in, out)`` arrays keyed by the JAX package's
``/``-joined module paths of an unrolled tree (``layers_0/self_attn/q_proj``),
``prune_meta.json`` the same keys as the reference's, and the crc32 runs
over the paths in the reference's sorted order, so either package's
``load_mask`` reads the other's file and both checksums agree.

Magnitudes come from the dequantized f32 base whatever the storage, so a
mask means the same in dense, int8 and nf4.  Exact zeros in every storage:
``0.0`` casts to ``0.0``; int8 code 0 dequantizes to 0; nf4's codebook
entry 7 is 0.0 and the encoder maps 0 to it.

The global threshold is ``jnp.quantile(flat, sparsity)`` (linear method)
bit for bit: the index ``q * (n - 1)`` and the interpolation in f32, as JAX
computes them without x64 on the CPU (past 2**24 magnitudes the index rounds;
XLA fuses the interpolation's second product and sum), the two
order statistics taken by selection (``torch.quantile`` refuses inputs past
2**24 elements).  N:M ranks with a stable argsort, as ``jnp.argsort`` does,
so tied magnitudes (constant in an int8 base) rank in row order and the
later row is kept.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib
from fractions import Fraction
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from relora_tpu_torch.ops.quant import (
    NF4_LEAVES,
    dequantize_int8,
    dequantize_nf4,
    quantize_int8,
    quantize_nf4,
)

PRUNE_MASK_FILE = "prune_mask.npz"
PRUNE_META_FILE = "prune_meta.json"

_VALID_SCOPES = ("global", "per_matrix")
#: a module's leaves that matter here: its base in any storage and lora_a
_LEAVES = ("weight", "weight_q", "weight_scale", *NF4_LEAVES, "lora_a")

Mask = Dict[str, torch.Tensor]


class PruneMaskMismatchError(ValueError):
    """A prune mask does not line up with the weights it is applied to
    (missing module, or a shape mismatch): named so callers (``export_hf
    --pruned``, the draft exporter) refuse loudly."""


def parse_nm(nm: Union[str, Tuple[int, int], None]) -> Optional[Tuple[int, int]]:
    """``"2:4"`` -> ``(2, 4)``; validates 0 < N < M."""
    if nm is None:
        return None
    if isinstance(nm, str):
        parts = nm.split(":")
        if len(parts) != 2:
            raise ValueError(f"nm must look like 'N:M', got {nm!r}")
        n, m = (int(p) for p in parts)
    else:
        n, m = nm
    if not (0 < n < m):
        raise ValueError(f"N:M sparsity needs 0 < N < M, got {n}:{m}")
    return n, m


# ------------------------------------------------------------------ names


def jax_path(name: str) -> Tuple[str, ...]:
    """The JAX package's unrolled module path of the port's module ``name``:
    ``layers.3.mlp.down_proj`` -> ``("layers_3", "mlp", "down_proj")``."""
    parts = name.split(".")
    if len(parts) > 1 and parts[0] == "layers" and parts[1].isdigit():
        parts = [f"layers_{parts[1]}"] + parts[2:]
    return tuple(parts)


def port_name(path: Sequence[str]) -> str:
    """Inverse of :func:`jax_path`."""
    head, *rest = path
    if head.startswith("layers_") and head[7:].isdigit():
        head = f"layers.{head[7:]}"
    return ".".join([head, *rest])


# ---------------------------------------------------------------- modules


def _module_leaves(target) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{module name: {leaf: tensor}}`` of a model (its parameters) or of
    a flat state dict (keys grouped by their last ``.``)."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    if isinstance(target, nn.Module):
        for name, module in target.named_modules():
            leaves = {leaf: t for leaf in _LEAVES
                      if isinstance(t := getattr(module, leaf, None), torch.Tensor)}
            if leaves:
                out[name] = leaves
        return out
    for key, value in target.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf in _LEAVES:
            out.setdefault(prefix, {})[leaf] = value
    return out


def _has_base(leaves: Mapping[str, torch.Tensor]) -> bool:
    return any(k in leaves for k in ("weight", "weight_q", "weight_codes"))


def _base_shape(leaves: Mapping[str, torch.Tensor]) -> Tuple[int, int]:
    """The ``(in, out)`` shape of a module's base, read from its leaves."""
    if "weight" in leaves:
        return tuple(leaves["weight"].shape[::-1])
    if "weight_q" in leaves:
        return tuple(leaves["weight_q"].shape[::-1])
    half, out_f = leaves["weight_codes"].shape
    return 2 * half, out_f


def _nf4(leaves: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {leaf: leaves[param] for param, leaf in NF4_LEAVES.items()}


def _module_base(leaves: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """A module's frozen base as f32 ``(in, out)``: dequantized for int8 and
    nf4, a view of a dense f32 weight (``prune.py:72-85``)."""
    if "weight" in leaves:
        return leaves["weight"].float().t()
    if "weight_q" in leaves:
        return dequantize_int8(leaves["weight_q"], leaves["weight_scale"]).t()
    return dequantize_nf4(_nf4(leaves))


def _prunable(target) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    """Every LoRA-wrapped module that owns a base, in module order."""
    for name, leaves in _module_leaves(target).items():
        if "lora_a" in leaves and _has_base(leaves):
            yield name, leaves


def prunable_paths(target) -> List[str]:
    """The names of :func:`magnitude_mask`'s modules of ``target``: how the
    draft exporter remembers them from the unmerged checkpoint."""
    return [name for name, _ in _prunable(target)]


# ------------------------------------------------------------------ masks


def quantile_linear(values: torch.Tensor, q: float) -> float:
    """``jnp.quantile(values, q)`` (linear method, x64 off) bit for bit, as
    a Python float holding an f32 value: the index ``q * (n - 1)``, its
    floor, ceil and weights in f32 (``jax/_src/numpy/reductions.py``
    ``_quantile``), the order statistics by ``kthvalue`` (by a sort on CUDA);
    NaN when any value is NaN."""
    flat = values.reshape(-1)
    if bool(torch.isnan(flat).any()):
        return float("nan")
    n = np.float32(flat.numel())
    pos = np.float32(q) * (n - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    high_weight = pos - low
    low_weight = np.float32(1) - high_weight
    last = n - np.float32(1)
    lo = int(min(max(low, np.float32(0)), last))
    hi = int(min(max(high, np.float32(0)), last))
    if flat.is_cuda:
        # CUDA's kthvalue selects within one thread block per slice: one
        # radix sort of the pool is far faster at ~10^8 magnitudes
        ordered = torch.sort(flat).values
        lo_v, hi_v = np.float32(ordered[lo].item()), np.float32(ordered[hi].item())
    else:
        lo_v = np.float32(flat.kthvalue(lo + 1).values.item())
        hi_v = lo_v if hi == lo else np.float32(flat.kthvalue(hi + 1).values.item())
    # XLA contracts the second product and the sum into one fused multiply-add
    return float(_fma_f32(hi_v, high_weight, lo_v * low_weight))


def _fma_f32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """``a * b + c`` rounded once to the nearest f32 (ties to even): the
    exact value as a fraction, then the nearest of f32 neighbours."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    best = np.float32(float(exact))
    for cand in (np.nextafter(best, np.float32(-np.inf)), np.nextafter(best, np.float32(np.inf))):
        d_cand, d_best = abs(Fraction(float(cand)) - exact), abs(Fraction(float(best)) - exact)
        if d_cand < d_best or (d_cand == d_best and not cand.view(np.int32) & 1):
            best = cand
    return best


def _nm_mask(mags: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Structured N:M keep-mask of ``(in, out)`` magnitudes: within every
    group of M consecutive input rows, keep the N largest, a tie ranked by
    row so the later row is kept (two stable argsorts, ``prune.py:111-123``)."""
    in_f, out_f = mags.shape
    if in_f % m:
        raise ValueError(f"N:M pruning needs in_features % M == 0, got {in_f} % {m}")
    groups = mags.reshape(in_f // m, m, out_f)
    order = torch.argsort(groups, dim=-2, stable=True)
    ranks = torch.argsort(order, dim=-2, stable=True)
    return (ranks >= m - n).reshape(in_f, out_f)


def magnitude_mask(
    target,
    sparsity: float,
    *,
    scope: str = "global",
    nm: Union[str, Tuple[int, int], None] = None,
    paths: Optional[Sequence[str]] = None,
) -> Mask:
    """A keep-mask over every frozen base of ``target`` (a model or a flat
    state dict).

    ``scope="global"`` ranks magnitudes across all prunable bases with one
    threshold, ``"per_matrix"`` applies ``sparsity`` to each base alone;
    ``nm`` switches to structured N:M sparsity (N kept per group of M along
    ``in``) and ignores ``sparsity``/``scope``.  ``paths`` names the modules
    explicitly: how the draft exporter prunes a merged state dict (no
    ``lora_a`` left to find them by) at the unmerged checkpoint's modules.
    """
    if scope not in _VALID_SCOPES:
        raise ValueError(f"scope must be one of {_VALID_SCOPES}, got {scope!r}")
    nm_t = parse_nm(nm)
    if nm_t is None and not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
    if paths is not None:
        leaves_of = _module_leaves(target)
        modules = []
        for name in paths:
            leaves = leaves_of.get(name)
            if leaves is None or not _has_base(leaves):
                raise PruneMaskMismatchError(
                    f"requested prune path {name} has no base kernel in this weight tree"
                )
            modules.append((name, leaves))
    else:
        modules = list(_prunable(target))
    if not modules:
        raise ValueError("no prunable modules found (is this a LoRA model?)")

    with torch.no_grad():
        if nm_t is not None:
            n, m = nm_t
            return {name: _nm_mask(_module_base(l).abs(), n, m) for name, l in modules}
        if sparsity == 0.0:
            return {name: torch.ones(_base_shape(l), dtype=torch.bool,
                                     device=next(iter(l.values())).device)
                    for name, l in modules}
        mags = {name: _module_base(l).abs() for name, l in modules}
        if scope == "global":
            thresh = quantile_linear(torch.cat([m.reshape(-1) for m in mags.values()]), sparsity)
            return {name: (m > thresh).contiguous() for name, m in mags.items()}
        return {name: (m > quantile_linear(m, sparsity)).contiguous() for name, m in mags.items()}


def _masked(base: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``base`` with the positions ``keep`` drops set to 0 (``keep`` in
    ``base``'s layout)."""
    return torch.where(keep.to(base.device), base, 0.0)


def _masked_leaves(leaves: Mapping[str, torch.Tensor], keep: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The module's base leaves with the pruned positions zeroed: a dense
    base cast back to its dtype, a quantized one dequantized, masked and
    requantized (``prune.py:232-260``), nf4 in its double-quant layout."""
    if "weight" in leaves:
        w = leaves["weight"]
        return {"weight": _masked(w.float(), keep.t()).to(w.dtype)}
    if "weight_q" in leaves:
        base = dequantize_int8(leaves["weight_q"], leaves["weight_scale"])
        q, scale = quantize_int8(_masked(base, keep.t()))
        return {"weight_q": q, "weight_scale": scale}
    nf4 = _nf4(leaves)
    requant = quantize_nf4(_masked(dequantize_nf4(nf4), keep),
                           double_quant=nf4["bscale_q"].dtype == torch.int8)
    return {param: requant[leaf] for param, leaf in NF4_LEAVES.items()}


def apply_mask(target, mask: Mask):
    """Zero the pruned positions of every masked base.  A model is written
    in place and returned; a flat state dict gives a new dict.

    The mask is checked against ``target`` first: a module the mask names
    that ``target`` lacks (or that has no base), or a shape mismatch, raises
    :class:`PruneMaskMismatchError` before anything is written.  Requantizing
    already-quantized values is idempotent, so applying twice is safe.
    """
    leaves_of = _module_leaves(target)
    missing = sorted(name for name in mask
                     if name not in leaves_of or not _has_base(leaves_of[name]))
    if missing:
        raise PruneMaskMismatchError(
            f"prune mask names modules absent from the weight tree: "
            f"{['/'.join(jax_path(n)) for n in missing]}"
        )
    for name, keep in mask.items():
        shape = _base_shape(leaves_of[name])
        if tuple(keep.shape) != shape:
            raise PruneMaskMismatchError(
                f"prune mask shape {tuple(keep.shape)} != kernel shape {shape} at "
                f"{'/'.join(jax_path(name))}"
            )
    with torch.no_grad():
        if isinstance(target, nn.Module):
            for name, keep in mask.items():
                module = target.get_submodule(name)
                for leaf, value in _masked_leaves(leaves_of[name], keep).items():
                    getattr(module, leaf).copy_(value)
            return target
        out = dict(target)
        for name, keep in mask.items():
            for leaf, value in _masked_leaves(leaves_of[name], keep).items():
                out[f"{name}.{leaf}" if name else leaf] = value
        return out


# --------------------------------------------------------- stats, sidecar


def _mask_items(mask: Mask) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """``(JAX path, keep)`` of every mask leaf, in the reference's order
    (its nested dict walked with sorted keys)."""
    return sorted(((jax_path(name), keep) for name, keep in mask.items()), key=lambda kv: kv[0])


def sparsity_stats(mask: Mask) -> Dict[str, Any]:
    """Fraction pruned, overall and per module (keyed by the JAX paths, as
    the reference's sidecar), host scalars."""
    per_module = {}
    pruned = total = 0
    for path, keep in _mask_items(mask):
        kept, size = int(keep.sum()), keep.numel()
        per_module["/".join(path)] = 1.0 - kept / size
        pruned += size - kept
        total += size
    return {
        "sparsity": pruned / total if total else 0.0,
        "pruned": pruned,
        "total": total,
        "per_module": per_module,
    }


def _checksum(items) -> int:
    crc = 0
    for path, keep in items:
        crc = zlib.crc32("/".join(path).encode(), crc)
        crc = zlib.crc32(np.packbits(np.asarray(keep, dtype=bool)).tobytes(), crc)
    return crc


def mask_checksum(mask: Mask) -> int:
    """crc32 over the packed ``(in, out)`` mask bits in the reference's path
    order: the identity recorded in the sidecar and in exports."""
    return _checksum((path, keep.cpu().numpy()) for path, keep in _mask_items(mask))


def save_mask(dir_path: str, mask: Mask, meta: Optional[dict] = None) -> dict:
    """Write the sidecar pair into a checkpoint directory; returns the meta
    dict (the caller's keys, the stats and the checksum)."""
    arrays = {"/".join(path): keep.cpu().numpy().astype(bool, copy=False)
              for path, keep in _mask_items(mask)}
    full_meta = dict(meta or {})
    full_meta.update(sparsity_stats(mask))
    full_meta["mask_crc32"] = _checksum((tuple(k.split("/")), v) for k, v in arrays.items())
    os.makedirs(dir_path, exist_ok=True)
    _savez_fast(os.path.join(dir_path, PRUNE_MASK_FILE), arrays)
    with open(os.path.join(dir_path, PRUNE_META_FILE), "w") as f:
        json.dump(full_meta, f, indent=2)
    return full_meta


def _savez_fast(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    """``np.savez_compressed``'s file (a zip of ``.npy`` members that
    ``np.load`` reads), deflated at level 1 instead of 6: a mask's 0/1 bytes
    still shrink about 4x, in about a tenth of the time."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED, compresslevel=1,
                         allowZip64=True) as zf:
        for name, arr in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)


def load_mask(dir_path: str, device="cpu") -> Tuple[Optional[Mask], Optional[dict]]:
    """The sidecar pair of a checkpoint directory, the masks on ``device``;
    ``(None, None)`` when it was never pruned.  The recorded crc32 is checked
    against the bits read.  A sidecar of a scanned JAX tree (``layers/...``,
    stacked ``(L, in, out)``) reads as the unrolled layers."""
    mask_path = os.path.join(dir_path, PRUNE_MASK_FILE)
    if not os.path.exists(mask_path):
        return None, None
    with np.load(mask_path) as z:
        items = sorted(((tuple(name.split("/")), z[name]) for name in z.files), key=lambda kv: kv[0])
    meta = None
    meta_path = os.path.join(dir_path, PRUNE_META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        want = meta.get("mask_crc32")
        if want is not None and _checksum(items) != want:
            raise PruneMaskMismatchError(
                f"prune mask at {dir_path} fails its recorded crc32 ({want})"
            )
    mask: Mask = {}
    for path, keep in items:
        if path[0] == "layers" and keep.ndim == 3:
            for i, layer in enumerate(keep):
                mask[port_name((f"layers_{i}",) + path[1:])] = torch.as_tensor(layer, device=device)
        else:
            mask[port_name(path)] = torch.as_tensor(keep, device=device)
    return mask, meta
