"""Export a pruned, merged checkpoint as a servable draft model.

The port's copy of ``relora_tpu/compress/draft.py``.  A prune-retrain run
leaves a training checkpoint whose frozen base is already sparse; this turns
it, or any LoRA checkpoint pruned here by magnitude, into a standalone
checkpoint that the serving path loads beside the full model for
model-drafted speculative decoding (``serve_cli --spec model
--draft-checkpoint ...``).

The export is the serving restore (verified, merged on ``device`` in f32)
with the prune mask applied, written by the port's checkpoint writer: the
output directory is what ``restore_serving_params`` reads, its manifest
covers the ``prune_mask.npz`` / ``prune_meta.json`` pair and carries a
``pruned`` block (sparsity, mask checksum, source checkpoint).  The draft
has the base's architecture, so the engine runs it through the base's
decode model.

    python -m relora_tpu_torch.compress.draft CKPT OUT [--sparsity S]
        [--scope global|per_matrix] [--nm N:M] [--device cpu]
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple, Union

import torch

from relora_tpu_torch.compress.prune import (
    Mask,
    PruneMaskMismatchError,
    apply_mask,
    load_mask,
    magnitude_mask,
    mask_checksum,
    prunable_paths,
    sparsity_stats,
)

logger = logging.getLogger(__name__)


def build_draft_params(
    checkpoint_dir: str,
    *,
    sparsity: Optional[float] = None,
    scope: str = "global",
    nm: Union[str, Tuple[int, int], None] = None,
    device="cpu",
) -> Tuple[Dict[str, torch.Tensor], Mask, dict]:
    """Restore ``checkpoint_dir`` merged for serving on ``device`` and prune
    it; returns ``(pruned state dict, mask, meta)``.  The mask is the
    checkpoint's own ``prune_mask.npz`` sidecar when it has one (the factors
    were trained against exactly that mask), else computed here at
    ``sparsity``/``nm`` over the merged bases, at the modules that carry
    LoRA factors in the unmerged checkpoint."""
    from relora_tpu_torch.train import checkpoint as ckpt

    mask, meta = load_mask(checkpoint_dir, device=device)
    params = ckpt.restore_serving_params(checkpoint_dir, device=device)
    if mask is None:
        if sparsity is None and nm is None:
            raise ValueError(
                f"{checkpoint_dir} has no prune_mask.npz sidecar and no "
                "sparsity/nm was given: nothing to prune with"
            )
        paths = prunable_paths(ckpt.restore_params_host(checkpoint_dir))
        if not paths:
            raise PruneMaskMismatchError(
                f"{checkpoint_dir} has no LoRA factors to locate prunable "
                "modules by: export from an unmerged training checkpoint, "
                "or from one carrying a prune_mask.npz sidecar"
            )
        mask = magnitude_mask(params, 0.0 if sparsity is None else sparsity,
                              scope=scope, nm=nm, paths=paths)
        meta = {"target_sparsity": sparsity, "scope": scope, "nm": nm,
                "computed_at": "draft_export"}
    return apply_mask(params, mask), mask, dict(meta or {})


def export_draft_checkpoint(
    checkpoint_dir: str,
    out_dir: str,
    *,
    sparsity: Optional[float] = None,
    scope: str = "global",
    nm: Union[str, Tuple[int, int], None] = None,
    device="cpu",
) -> str:
    """Write a pruned, merged draft checkpoint under ``out_dir``; returns its
    ``model_N`` path (N = the source's update step).  The output passes
    ``verify_checkpoint`` and loads through ``restore_serving_params``, what
    ``serve_cli --draft-checkpoint`` reads."""
    from relora_tpu_torch.train import checkpoint as ckpt

    pruned, mask, mask_meta = build_draft_params(
        checkpoint_dir, sparsity=sparsity, scope=scope, nm=nm, device=device)
    stats = sparsity_stats(mask)
    try:
        training_state = ckpt.load_training_state(checkpoint_dir)
    except (OSError, ValueError):
        training_state = {}
    step = int(training_state.get("update_step", 0))
    block = {
        "sparsity": round(stats["sparsity"], 6),
        "mask_crc32": mask_checksum(mask),
        "source_checkpoint": os.path.abspath(checkpoint_dir),
    }
    path = ckpt.save_checkpoint(
        out_dir, step, pruned, {**training_state, "draft_export": True},
        prune_mask=mask, prune_meta=mask_meta, metadata={"pruned": block},
    )
    logger.info(f"draft export: {path} at {stats['sparsity']:.1%} sparsity "
                f"(mask crc32 {block['mask_crc32']})")
    return path


def main(argv=None) -> str:
    """``python -m relora_tpu_torch.compress.draft CKPT OUT [--sparsity S]``"""
    import argparse

    from relora_tpu_torch import resolve_device

    p = argparse.ArgumentParser(description=export_draft_checkpoint.__doc__)
    p.add_argument("checkpoint", help="source checkpoint dir (model_N)")
    p.add_argument("out_dir", help="output dir; the export lands in out_dir/model_N")
    p.add_argument("--sparsity", type=float, default=None,
                   help="target sparsity when the source has no prune_mask.npz sidecar")
    p.add_argument("--scope", choices=("global", "per_matrix"), default="global")
    p.add_argument("--nm", default=None, help="structured N:M sparsity, e.g. 2:4")
    p.add_argument("--device", default="cuda", help="where the merge and the mask run")
    args = p.parse_args(argv)
    path = export_draft_checkpoint(args.checkpoint, args.out_dir, sparsity=args.sparsity,
                                   scope=args.scope, nm=args.nm, device=resolve_device(args.device))
    print(path)
    return path


if __name__ == "__main__":
    main()
