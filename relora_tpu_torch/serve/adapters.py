"""Refcounted LRU registry of adapter slots for multi-tenant serving.

The port's copy of ``relora_tpu/serve/adapters.py``.  One base model, many
tenants: every LoRA factor of the decode model is stacked ``(num_slots,
...)`` (``LoraSpec(num_slots)``) and kernel 5 routes each batch row to its
slot through a per-row ``adapter_idx``.  This module owns the *contents* of
those slots:

- **Slot 0 is the identity (base-model) adapter**: zeros, never loaded,
  never evicted.  Requests that name no adapter decode the base.
- **Load/evict is refcounted LRU**: a free list of slots, a refcount per
  resident adapter (one per in-flight request using it), and an
  ``OrderedDict`` in LRU order.  ``acquire`` on a miss pops a free slot or
  evicts the least-recently-used adapter *with no active requests*; when
  every slot is pinned by live traffic it returns ``None`` and the scheduler
  keeps the request queued (evict-then-retry).
- **Loading is unmerged**: an adapter directory (a checkpoint of
  ``relora_tpu_torch.train.checkpoint`` with its ``relora_config.json``
  sidecar) is read on the host and only its ``lora_a``/``lora_b`` tensors are
  kept; the base never moves.  The engine's ``writer(slot, factors, scale)``
  copies them into the stacked device parameters in place.

The registry itself touches no device: the injected loader and writer do.
"""

from __future__ import annotations

import logging
import os
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

#: the reserved identity adapter: slot 0, always resident, zero factors
BASE_ADAPTER = "base"

#: sidecar an adapter directory must carry (train/checkpoint.py)
RELORA_CONFIG_FILE = "relora_config.json"

Factors = Dict[str, torch.Tensor]


def extract_lora_factors(params: Mapping[str, Any]) -> Factors:
    """The ``lora_a``/``lora_b`` tensors of a flat state dict, keyed by their
    state-dict names (``layers.{i}.self_attn.q_proj.lora_a`` ...), the names
    the engine's slot writer aligns against its stacked parameters."""
    return {k: v for k, v in params.items() if k.rsplit(".", 1)[-1] in ("lora_a", "lora_b")}


def default_loader(path: str, expected_r: Optional[int] = None) -> Tuple[Factors, float]:
    """Read an adapter directory on the host and return ``(factors,
    scale)``: its unmerged factors and the sidecar's ``alpha / r``.  Raises
    ``ValueError`` when the directory has no sidecar or its rank disagrees
    with the serving stack's."""
    from relora_tpu_torch.train.checkpoint import load_lora_spec, restore_params_host

    spec = load_lora_spec(path)
    if spec is None:
        raise ValueError(
            f"adapter dir {path} has no {RELORA_CONFIG_FILE} sidecar "
            "(adapters must be unmerged ReLoRA checkpoints)"
        )
    if expected_r is not None and spec.r != expected_r:
        raise ValueError(
            f"adapter {path} has r={spec.r} but the serving stack was built "
            f"with r={expected_r}; all tenant adapters must share the base rank"
        )
    factors = extract_lora_factors(restore_params_host(path))
    if not factors:
        raise ValueError(f"adapter dir {path} restored no lora_a/lora_b leaves")
    return factors, spec.scale


class AdapterRegistry:
    """Fixed pool of adapter slots with refcounted LRU load/evict."""

    def __init__(
        self,
        adapter_dir: Optional[str],
        num_slots: int,
        *,
        expected_r: Optional[int] = None,
        writer: Optional[Callable[[int, Factors, float], None]] = None,
        loader: Optional[Callable[[str, Optional[int]], Tuple[Factors, float]]] = None,
        metrics: Any = None,
    ):
        if num_slots < 2:
            raise ValueError(
                f"num_slots must be >= 2 (slot 0 is the identity adapter), got {num_slots}"
            )
        self.adapter_dir = adapter_dir
        self.num_slots = num_slots
        self.expected_r = expected_r
        self._writer = writer
        self._loader = loader or default_loader
        # a metrics registry (the server's): evictions and load seconds
        self.metrics = metrics
        # slot 0 is the identity adapter: out of the free list forever
        self._free: List[int] = list(range(num_slots - 1, 0, -1))
        self._resident: "OrderedDict[str, int]" = OrderedDict()  # name -> slot, LRU order
        self._refs: Dict[str, int] = {}  # name -> active requests (loaded names only)
        self.loads_total = 0
        self.evictions_total = 0
        self.hits_total = 0
        self.misses_total = 0

    # -- discovery -----------------------------------------------------------

    def adapter_path(self, name: str) -> Optional[str]:
        if self.adapter_dir is None:
            return None
        path = os.path.join(self.adapter_dir, name)
        if os.path.isfile(os.path.join(path, RELORA_CONFIG_FILE)):
            return path
        return None

    def known(self, name: str) -> bool:
        """Can this adapter be served at all?  ``base`` always; others iff a
        directory with a sidecar exists, or it is already resident."""
        if name == BASE_ADAPTER:
            return True
        return name in self._resident or self.adapter_path(name) is not None

    def list_adapters(self) -> List[str]:
        if self.adapter_dir is None or not os.path.isdir(self.adapter_dir):
            return []
        return sorted(
            d for d in os.listdir(self.adapter_dir)
            if os.path.isfile(os.path.join(self.adapter_dir, d, RELORA_CONFIG_FILE))
        )

    # -- the admission surface -------------------------------------------------

    def slot_of(self, name: Optional[str]) -> Optional[int]:
        if name is None or name == BASE_ADAPTER:
            return 0
        return self._resident.get(name)

    def acquire(self, name: Optional[str]) -> Optional[int]:
        """Pin ``name``'s slot for one request and return its index, loading
        the adapter into a slot first if it is not resident.  Returns
        ``None`` when no slot can be made free (every resident adapter has
        live requests): the caller keeps the request queued and retries.
        The identity adapter always succeeds."""
        if name is None or name == BASE_ADAPTER:
            return 0
        slot = self._resident.get(name)
        if slot is not None:
            self.hits_total += 1
            self._refs[name] = self._refs.get(name, 0) + 1
            self._resident.move_to_end(name)
            return slot
        self.misses_total += 1
        if self.adapter_path(name) is None:
            # unknown names fail loudly even when every slot is pinned;
            # otherwise the caller queues a request that can never run
            raise ValueError(f"unknown adapter {name!r} (no dir under {self.adapter_dir})")
        slot = self._take_slot()
        if slot is None:
            return None  # every slot pinned: stay queued, evict-then-retry later
        try:
            self._load_into(name, slot)
        except Exception:
            self._free.append(slot)  # the slot stays clean: nothing was registered
            raise
        self._refs[name] = 1
        return slot

    def release(self, name: Optional[str]) -> None:
        """Drop one request's pin.  The adapter stays resident (warm) until
        eviction needs its slot."""
        if name is None or name == BASE_ADAPTER:
            return
        refs = self._refs.get(name)
        if refs is None or refs <= 0:
            raise ValueError(f"release of adapter {name!r} with no active requests")
        self._refs[name] = refs - 1

    # -- internals ---------------------------------------------------------------

    def _take_slot(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        # evict the least-recently-used resident adapter with no live pins
        for victim, slot in self._resident.items():
            if self._refs.get(victim, 0) == 0:
                del self._resident[victim]
                del self._refs[victim]
                self.evictions_total += 1
                if self.metrics is not None:
                    self.metrics.inc("adapter_evictions_total")
                logger.info(f"evicting adapter {victim!r} from slot {slot}")
                return slot
        return None

    def _load_into(self, name: str, slot: int) -> None:
        path = self.adapter_path(name)
        t0 = time.monotonic()
        factors, scale = self._loader(path, self.expected_r)
        if self._writer is not None:
            self._writer(slot, factors, scale)
        dt = time.monotonic() - t0
        self.loads_total += 1
        if self.metrics is not None:
            self.metrics.observe("adapter_load_seconds", dt)
        self._resident[name] = slot
        self._resident.move_to_end(name)
        logger.info(f"loaded adapter {name!r} into slot {slot} in {dt * 1e3:.1f} ms")

    def preload(self, name: str, factors: Factors, scale: float) -> int:
        """Install already materialized factors without touching disk.  The
        slot discipline of :meth:`acquire`, with the refcount left at zero:
        nothing is pinned."""
        if name == BASE_ADAPTER:
            raise ValueError("slot 0 is reserved; the identity adapter is not loadable")
        if name in self._resident:
            return self._resident[name]
        slot = self._take_slot()
        if slot is None:
            raise RuntimeError("no adapter slot free for preload (all pinned)")
        if self._writer is not None:
            self._writer(slot, factors, scale)
        self.loads_total += 1
        self._resident[name] = slot
        self._refs[name] = 0
        return slot

    # -- observability -------------------------------------------------------------

    def slots_used(self) -> int:
        return 1 + len(self._resident)  # the identity slot counts as used

    def stats(self) -> Dict[str, Any]:
        return {
            "num_slots": self.num_slots,
            "slots_used": self.slots_used(),
            "slots_free": len(self._free),
            "resident": {
                name: {"slot": slot, "refs": self._refs.get(name, 0)}
                for name, slot in self._resident.items()
            },
            "loads_total": self.loads_total,
            "evictions_total": self.evictions_total,
            "hits_total": self.hits_total,
            "misses_total": self.misses_total,
            "hit_rate": (
                round(self.hits_total / (self.hits_total + self.misses_total), 4)
                if (self.hits_total + self.misses_total)
                else 0.0
            ),
        }
