"""Checkpoint directories of the port.

Counterpart of ``relora_tpu/train/checkpoint.py``.  The JAX package writes
each ``model_{step}`` directory as an orbax ``state/`` tree; the port writes
its own format beside the same JSON sidecars:

- ``params.pt`` — the model's flat state dict (``torch.save`` of CPU
  tensors, read back with ``torch.load(weights_only=True)``);
- ``optimizer.pt`` — a training run's AdamW state (step and moments) and the
  NaN gate's counters (``step``, ``n_skipped``), absent from a serving or
  adapter checkpoint;
- ``training_state.json`` — the reference's counters, as given;
- ``relora_config.json`` — ``dataclasses.asdict`` of the ``LoraSpec``, the
  same keys as the JAX sidecar, so either package's spec loads it;
- ``prune_mask.npz`` and ``prune_meta.json`` — a pruned run's keep-mask
  sidecar pair (``compress/prune.py``, the reference's format), when the
  caller passes one;
- ``manifest.json`` — per tensor ``{shape, dtype}``, per file ``{size,
  crc32}`` (``_walk_state_files``, ``:116-134``; the sidecar pair
  included, so :func:`verify_checkpoint` covers the pruned zeros' mask) and
  the caller's ``metadata`` beside ``format``, written last: it is the
  port's commit marker (the reference's is orbax's renamed ``state/``), so a
  directory without it was cut off mid-write and is invisible to
  :func:`get_last_checkpoint` and :func:`delete_old_checkpoints`.

A trainer's save (``publish=True``) then moves the save directory's
``latest`` pointer onto the new directory (``serve/deploy.publish_latest``,
``relora_tpu/train/checkpoint.py:157-163``): the pointer names only
committed directories, so a watching server never sees a torn one.

A tenant adapter directory is such a checkpoint of an unmerged ReLoRA run;
it may hold only the ``lora_*`` tensors.  An orbax directory (``state/``)
raises: the port reads only its own format.  Saves are synchronous (the
reference's orbax writes are asynchronous) and retried with backoff.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import time
import zlib
from typing import Dict, Mapping, Optional, Tuple

import torch

from relora_tpu_torch.compress.prune import PRUNE_MASK_FILE, PRUNE_META_FILE, save_mask
from relora_tpu_torch.core.relora import LoraSpec, merged_params

logger = logging.getLogger(__name__)

PARAMS_FILE = "params.pt"
OPTIMIZER_FILE = "optimizer.pt"
TRAINING_STATE_FILE = "training_state.json"
RELORA_CONFIG_FILE = "relora_config.json"
MANIFEST_FILE = "manifest.json"
#: the JAX package's orbax subdirectory, which the port does not read
ORBAX_SUBDIR = "state"


def checkpoint_dir(save_dir: str, update_step: int) -> str:
    return os.path.join(save_dir, f"model_{update_step}")


def file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def _write_json(path: str, payload) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, path)


def _write_checkpoint(
    path: str,
    params: Mapping[str, torch.Tensor],
    optimizer_state: Optional[dict],
    training_state: dict,
    lora_spec: Optional[LoraSpec],
    publish: bool = False,
    prune: Optional[Tuple[Mapping[str, torch.Tensor], Optional[dict]]] = None,
    metadata: Optional[dict] = None,
) -> None:
    os.makedirs(path, exist_ok=True)
    for name in (MANIFEST_FILE, RELORA_CONFIG_FILE, OPTIMIZER_FILE, PRUNE_MASK_FILE, PRUNE_META_FILE):
        if os.path.exists(os.path.join(path, name)):
            os.remove(os.path.join(path, name))  # a stale file must not survive
    files = [PARAMS_FILE]
    tmp = os.path.join(path, PARAMS_FILE + ".tmp")
    torch.save(params, tmp)
    os.replace(tmp, os.path.join(path, PARAMS_FILE))
    if optimizer_state is not None:
        tmp = os.path.join(path, OPTIMIZER_FILE + ".tmp")
        torch.save(optimizer_state, tmp)
        os.replace(tmp, os.path.join(path, OPTIMIZER_FILE))
        files.append(OPTIMIZER_FILE)
    _write_json(os.path.join(path, TRAINING_STATE_FILE), training_state)
    files.append(TRAINING_STATE_FILE)
    if lora_spec is not None:
        _write_json(os.path.join(path, RELORA_CONFIG_FILE), dataclasses.asdict(lora_spec))
        files.append(RELORA_CONFIG_FILE)
    if prune is not None:
        save_mask(path, *prune)
        files += [PRUNE_MASK_FILE, PRUNE_META_FILE]
    manifest = {
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in params.items()},
        "files": {
            name: {"size": os.path.getsize(os.path.join(path, name)),
                   "crc32": file_crc32(os.path.join(path, name))}
            for name in files
        },
        "metadata": {"format": "relora_tpu_torch", **(metadata or {})},
    }
    _write_json(os.path.join(path, MANIFEST_FILE), manifest)
    if publish:
        # the manifest is the commit: only now may the pointer name the dir
        from relora_tpu_torch.serve import deploy

        deploy.publish_latest(os.path.dirname(path) or ".", path)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(
    save_dir: str,
    update_step: int,
    state_dict: Mapping[str, torch.Tensor],
    training_state: dict,
    lora_spec: Optional[LoraSpec] = None,
    optimizer_state: Optional[dict] = None,
    retries: int = 3,
    retry_backoff: float = 0.5,
    publish: bool = False,
    prune_mask: Optional[Mapping[str, torch.Tensor]] = None,
    prune_meta: Optional[dict] = None,
    metadata: Optional[dict] = None,
) -> str:
    """Write ``save_dir/model_{update_step}/`` and return its path: the
    params, the optimizer state when given, the JSON sidecars, the prune
    sidecar pair of ``prune_mask`` (and ``prune_meta``) when given, then the
    manifest over all of them, ``metadata`` in its ``metadata`` block
    (a draft's ``pruned``); ``publish`` then points ``save_dir/latest``
    at it (the trainer's saves).  A failed write (``OSError``, ``ValueError``)
    is retried ``retries`` times, ``retry_backoff`` seconds doubled each time
    (``relora_tpu/train/checkpoint.py:205-274``), then raised."""
    path = checkpoint_dir(save_dir, update_step)
    params = {k: v.detach().cpu() for k, v in state_dict.items()}
    optimizer_state = _to_cpu(optimizer_state)
    for attempt in range(retries + 1):
        try:
            _write_checkpoint(path, params, optimizer_state, training_state, lora_spec, publish,
                              None if prune_mask is None else (prune_mask, prune_meta), metadata)
            return path
        except (OSError, ValueError) as e:
            if attempt >= retries:
                logger.error(
                    f"checkpoint save at step {update_step} failed after {retries + 1} attempts: {e}"
                )
                raise
            delay = retry_backoff * (2**attempt)
            logger.warning(
                f"checkpoint save attempt {attempt + 1}/{retries + 1} failed ({e}); "
                f"retrying in {delay:.1f}s"
            )
            time.sleep(delay)


def _refuse_orbax(path: str) -> None:
    if os.path.isdir(os.path.join(path, ORBAX_SUBDIR)) and not os.path.exists(
        os.path.join(path, PARAMS_FILE)
    ):
        raise ValueError(
            f"{path} is an orbax checkpoint ({ORBAX_SUBDIR}/, written by the JAX package): "
            f"relora_tpu_torch reads only its own format ({PARAMS_FILE})"
        )


def verify_checkpoint(path: str) -> Tuple[bool, str]:
    """``(ok, reason)``: the directory against its manifest, each recorded
    file's size and crc32.  A directory without params or without a
    manifest is refused (the manifest is written last); an orbax directory
    raises."""
    _refuse_orbax(path)
    if not os.path.exists(os.path.join(path, PARAMS_FILE)):
        return False, f"uncommitted: no {PARAMS_FILE}"
    try:
        with open(os.path.join(path, MANIFEST_FILE)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:  # ValueError: bad JSON or bytes that are not UTF-8
        return False, f"unreadable manifest: {e}"
    for rel, rec in manifest.get("files", {}).items():
        full = os.path.join(path, rel)
        if not os.path.exists(full):
            return False, f"missing file {rel}"
        size = os.path.getsize(full)
        if size != rec["size"]:
            return False, f"size mismatch for {rel}: {size} != {rec['size']}"
        if file_crc32(full) != rec["crc32"]:
            return False, f"checksum mismatch for {rel}"
    return True, "ok"


def restore_params_host(path: str) -> Dict[str, torch.Tensor]:
    """The checkpoint's flat state dict as CPU tensors."""
    _refuse_orbax(path)
    full = os.path.join(path, PARAMS_FILE)
    if not os.path.exists(full):
        raise FileNotFoundError(f"no checkpoint params at {full}")
    return torch.load(full, map_location="cpu", weights_only=True)


def load_lora_spec(path: str) -> Optional[LoraSpec]:
    """The ``relora_config.json`` sidecar as a ``LoraSpec``, or None."""
    p = os.path.join(path, RELORA_CONFIG_FILE)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return LoraSpec(**json.load(f))


def restore_serving_params(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Params ready for merged serving (``:336-375``): verified against the
    manifest first (a corrupt directory raises before anything is read),
    moved to ``device`` when given, then, when a sidecar is present, the
    factors merged into the bases in f32 with TF32 off and dropped."""
    ok, reason = verify_checkpoint(path)
    if not ok:
        raise ValueError(f"refusing to serve corrupt checkpoint {path}: {reason}")
    params = restore_params_host(path)
    if device is not None:
        params = {k: v.to(device) for k, v in params.items()}
    spec = load_lora_spec(path)
    return params if spec is None else merged_params(params, spec)


def load_training_state(path: str) -> dict:
    with open(os.path.join(path, TRAINING_STATE_FILE)) as f:
        return json.load(f)


def load_optimizer_state(path: str) -> dict:
    """The ``optimizer.pt`` a training run saved, its tensors on the CPU."""
    full = os.path.join(path, OPTIMIZER_FILE)
    if not os.path.exists(full):
        raise FileNotFoundError(f"no optimizer state at {full}")
    return torch.load(full, map_location="cpu", weights_only=True)


def _step_of(name: str) -> int:
    return int(name.split("_")[-1])


def _committed_checkpoints(save_dir: str) -> list:
    """``model_{step}`` directories with a manifest, the port's commit marker
    (written last), sorted by step (``:444-456``)."""
    dirs = [
        d
        for d in os.listdir(save_dir)
        if d.startswith("model_") and d.split("_")[-1].isdigit()
        and os.path.exists(os.path.join(save_dir, d, MANIFEST_FILE))
    ]
    return sorted(dirs, key=_step_of)


def get_last_checkpoint(
    save_dir: str, before_step: Optional[int] = None
) -> Tuple[Optional[dict], Optional[str]]:
    """``(training_state, path)`` of the newest verified checkpoint of
    ``save_dir``, or ``(None, None)`` (``:406-441``).  Newest first, a
    directory that fails verification or whose ``training_state.json`` is
    unreadable is skipped with a warning; ``before_step`` keeps only steps
    strictly below it (the spike rollback's target)."""
    if not os.path.isdir(save_dir):
        return None, None
    dirs = _committed_checkpoints(save_dir)
    if before_step is not None:
        dirs = [d for d in dirs if _step_of(d) < before_step]
    if not dirs:
        logger.warning(f"Save directory {save_dir} exists but has no checkpoints; starting fresh")
        return None, None
    for d in reversed(dirs):
        path = os.path.join(save_dir, d)
        ok, reason = verify_checkpoint(path)
        if not ok:
            logger.warning(f"Skipping corrupt checkpoint {path}: {reason}")
            continue
        try:
            return load_training_state(path), path
        except (OSError, json.JSONDecodeError, KeyError) as e:
            logger.warning(f"Skipping checkpoint {path} with unreadable training state: {e}")
    logger.warning(
        f"Save directory {save_dir} has checkpoints but none passed verification; starting fresh"
    )
    return None, None


def delete_old_checkpoints(save_dir: str, keep: Optional[int]) -> None:
    """Keep the newest ``keep`` committed checkpoints (``:459-475``); an
    uncommitted directory neither counts nor is deleted."""
    if keep is None:
        return
    dirs = _committed_checkpoints(save_dir)
    if len(dirs) <= keep:
        return
    for d in dirs[:-keep]:
        full = os.path.join(save_dir, d)
        logger.info(f"Deleting old checkpoint {full}")
        shutil.rmtree(full)
