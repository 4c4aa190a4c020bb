"""Device-memory accounting: per-group byte counts and live allocator gauges.

The port's counterpart of ``relora_tpu/obs/memory.py``, in the same
schemas:

- :func:`tensor_bytes` / :func:`state_breakdown`: byte sums over what the
  run keeps resident, ``{"params": module, "opt_state": optimizer}`` ->
  ``params_bytes``, ``opt_state_bytes``, ``total_bytes`` (the JAX
  package's ``pytree_breakdown`` keys).  A module counts its parameters and
  buffers, int8 codes and scales included; an optimizer its state tensors
  (AdamW's ``exp_avg``, ``exp_avg_sq`` and ``step``), and, for a parameter
  whose state the first ``step()`` has not made yet, the state it will make.
  Metadata only: no device work.
- :func:`live_memory_stats` / :class:`MemoryPoller`: the CUDA caching
  allocator's current and peak allocated bytes (``torch.cuda.memory_stats``'
  ``allocated_bytes.all.current`` / ``.peak``) and the card's total memory
  as ``bytes_limit``; ``available: False`` with ``None`` values on the CPU.
  The poller reads allocator metadata, not device values, and even so the
  trainer calls it at its metric flush only, never per update.

``xla_memory_plan`` and ``plan_for`` read the static memory plan of a
compiled XLA program; PyTorch compiles no whole-step program, so they have
no counterpart here (as ``obs/compile.py`` has none).  ``hbm_peak_gb`` and
``reconcile`` wait for a caller.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping

__all__ = [
    "tensor_bytes",
    "state_breakdown",
    "live_memory_stats",
    "MemoryPoller",
]

#: the bytes of AdamW's ``step`` entry: a 0-d f32 tensor per parameter
ADAM_STEP_BYTES = 4


def tensor_bytes(tensors: Iterable[Any]) -> int:
    """Bytes of the distinct tensors of ``tensors`` (a tensor reached twice,
    as a tied weight is, counts once); non-tensors count zero."""
    import torch

    seen, total = set(), 0
    for t in tensors:
        if not isinstance(t, torch.Tensor) or id(t) in seen:
            continue
        seen.add(id(t))
        total += t.numel() * t.element_size()
    return total


def _optimizer_bytes(optimizer) -> int:
    """Bytes of an Adam-style optimizer's state, including the state its
    first ``step()`` will allocate for parameters that have none yet."""
    total = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state:
                total += tensor_bytes(state.values())
            else:
                total += 2 * p.numel() * p.element_size() + ADAM_STEP_BYTES
    return total


def _group_bytes(obj: Any) -> int:
    import torch

    if isinstance(obj, torch.nn.Module):
        return tensor_bytes([*obj.parameters(), *obj.buffers()])
    if isinstance(obj, torch.optim.Optimizer):
        return _optimizer_bytes(obj)
    return tensor_bytes(obj)


def state_breakdown(named: Mapping[str, Any]) -> Dict[str, int]:
    """``{"params": module, "opt_state": optimizer, ...}`` -> ``{name}_bytes``
    per group plus ``total_bytes``: the ``memory_plan`` event's
    ``source: "pytree"`` fields."""
    out: Dict[str, int] = {}
    total = 0
    for name, obj in named.items():
        b = _group_bytes(obj)
        out[f"{name}_bytes"] = b
        total += b
    out["total_bytes"] = total
    return out


def live_memory_stats(device: Any = None) -> Dict[str, Any]:
    """The allocator's live and peak bytes and the card's total, in the JAX
    package's schema; ``available: False`` and ``None`` values where there
    is no CUDA device."""
    import torch

    out: Dict[str, Any] = {
        "available": False,
        "bytes_in_use": None,
        "peak_bytes_in_use": None,
        "bytes_limit": None,
    }
    if device is None:
        if not torch.cuda.is_available():
            return out
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return out
    stats = torch.cuda.memory_stats(device)
    out.update(
        available=True,
        bytes_in_use=int(stats.get("allocated_bytes.all.current", 0)),
        peak_bytes_in_use=int(stats.get("allocated_bytes.all.peak", 0)),
        bytes_limit=int(torch.cuda.get_device_properties(device).total_memory),
    )
    return out


class MemoryPoller:
    """``poll()`` reads the allocator stats once and mirrors them into a
    :class:`~relora_tpu_torch.obs.metrics.MetricsRegistry` as ``hbm_*``
    gauges.  Called at the metric flush only."""

    def __init__(self, registry: Any = None, device: Any = None):
        self.registry = registry
        self.device = device

    def poll(self) -> Dict[str, Any]:
        stats = live_memory_stats(self.device)
        if self.registry is not None and stats["available"]:
            for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
                self.registry.set_gauge(f"hbm_{key}", float(stats[key]))
        return stats
