"""Checkpoint directories of the port: the params half.

Counterpart of the params side of ``relora_tpu/train/checkpoint.py``.  The
JAX package writes each ``model_{step}`` directory as an orbax ``state/``
tree; the port writes its own format beside the same JSON sidecars:

- ``params.pt`` — the model's flat state dict (``torch.save`` of CPU
  tensors, read back with ``torch.load(weights_only=True)``);
- ``training_state.json`` — the reference's counters, as given;
- ``relora_config.json`` — ``dataclasses.asdict`` of the ``LoraSpec``, the
  same keys as the JAX sidecar, so either package's spec loads it;
- ``manifest.json`` — per tensor ``{shape, dtype}`` and per file ``{size,
  crc32}`` (``_walk_state_files``, ``:116-134``), written last, so a
  directory without it was cut off mid-write.

A tenant adapter directory is such a checkpoint of an unmerged ReLoRA run;
it may hold only the ``lora_*`` tensors.  An orbax directory (``state/``)
raises: the port reads only its own format.  Optimizer state, resume and the
trainer's ``--save_dir`` are not ported yet (see ROADMAP).
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Dict, Mapping, Optional, Tuple

import torch

from relora_tpu_torch.core.relora import LoraSpec, merged_params

PARAMS_FILE = "params.pt"
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


def save_checkpoint(
    save_dir: str,
    update_step: int,
    state_dict: Mapping[str, torch.Tensor],
    training_state: dict,
    lora_spec: Optional[LoraSpec] = None,
) -> str:
    """Write ``save_dir/model_{update_step}/`` and return its path: the
    params, the two JSON sidecars, then the manifest over all three."""
    path = checkpoint_dir(save_dir, update_step)
    os.makedirs(path, exist_ok=True)
    for name in (MANIFEST_FILE, RELORA_CONFIG_FILE):
        if os.path.exists(os.path.join(path, name)):
            os.remove(os.path.join(path, name))  # a stale sidecar must not survive
    params = {k: v.detach().cpu() for k, v in state_dict.items()}
    tmp = os.path.join(path, PARAMS_FILE + ".tmp")
    torch.save(params, tmp)
    os.replace(tmp, os.path.join(path, PARAMS_FILE))
    _write_json(os.path.join(path, TRAINING_STATE_FILE), training_state)
    files = [PARAMS_FILE, TRAINING_STATE_FILE]
    if lora_spec is not None:
        _write_json(os.path.join(path, RELORA_CONFIG_FILE), dataclasses.asdict(lora_spec))
        files.append(RELORA_CONFIG_FILE)
    manifest = {
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in params.items()},
        "files": {
            name: {"size": os.path.getsize(os.path.join(path, name)),
                   "crc32": file_crc32(os.path.join(path, name))}
            for name in files
        },
        "metadata": {"format": "relora_tpu_torch"},
    }
    _write_json(os.path.join(path, MANIFEST_FILE), manifest)
    return path


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
    except (OSError, json.JSONDecodeError) as e:
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


def restore_serving_params(path: str) -> Dict[str, torch.Tensor]:
    """Params ready for merged serving (``:336-375``): verified against the
    manifest first (a corrupt directory raises before anything is read),
    then, when a sidecar is present, the factors merged into the bases in f32
    with TF32 off and dropped."""
    ok, reason = verify_checkpoint(path)
    if not ok:
        raise ValueError(f"refusing to serve corrupt checkpoint {path}: {reason}")
    params = restore_params_host(path)
    spec = load_lora_spec(path)
    return params if spec is None else merged_params(params, spec)
