"""Compression: prune-retrain, magnitude-aware resets, draft export.

The port of ``relora_tpu/compress``:

- :mod:`relora_tpu_torch.compress.prune`: magnitude pruning of the frozen
  base (PERP, arXiv:2312.15230), the masks (global / per-matrix thresholds,
  structured N:M), their application in every storage, and the checkpoint
  sidecar;
- :mod:`relora_tpu_torch.compress.resets`: the magnitude-informed A
  re-init at ReLoRA resets (arXiv:2507.06558), ``reset_init``;
- :mod:`relora_tpu_torch.compress.draft`: a pruned, merged checkpoint as a
  draft model for ``--spec model``.
"""

from relora_tpu_torch.compress.prune import (  # noqa: F401
    PruneMaskMismatchError,
    apply_mask,
    load_mask,
    magnitude_mask,
    mask_checksum,
    save_mask,
    sparsity_stats,
)
from relora_tpu_torch.compress.draft import (  # noqa: F401
    build_draft_params,
    export_draft_checkpoint,
)
from relora_tpu_torch.compress.resets import magnitude_a_init, make_reinit_fn  # noqa: F401
