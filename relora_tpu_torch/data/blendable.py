"""Weighted mixture over datasets (parity: megatron_dataset/blendable_dataset.py).

A copy of ``relora_tpu/data/blendable.py`` for the PyTorch port: the blend
index (which dataset serves global sample i, and which of its local samples)
comes from the greedy max-error interleave in NumPy, which gives the same
indices as the JAX package's C++ helper.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def build_blending_indices_py(weights: np.ndarray, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The greedy interleave: sample ``i`` goes to the dataset furthest below
    its weighted share."""
    weights = np.asarray(weights, dtype=np.float64)
    taken = np.zeros(len(weights), dtype=np.int64)
    dataset_index = np.zeros(size, dtype=np.uint8)
    dataset_sample_index = np.zeros(size, dtype=np.int64)
    for i in range(size):
        position = max(float(i), 1.0)
        errors = weights * position - taken
        best = int(np.argmax(errors))
        dataset_index[i] = best
        dataset_sample_index[i] = taken[best]
        taken[best] += 1
    return dataset_index, dataset_sample_index


class BlendableDataset:
    """Mixture dataset honoring per-corpus weights (normalized)."""

    def __init__(self, datasets: Sequence, weights: Sequence[float]):
        if len(datasets) != len(weights):
            raise ValueError("datasets and weights must align")
        self.datasets = list(datasets)
        w = np.asarray(weights, dtype=np.float64)
        if (w <= 0).any():
            raise ValueError("weights must be positive")
        self.weights = w / w.sum()
        self.size = int(sum(len(d) for d in datasets))
        self.dataset_index, self.dataset_sample_index = build_blending_indices_py(
            self.weights, self.size
        )

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int):
        d = int(self.dataset_index[idx])
        s = int(self.dataset_sample_index[idx])
        ds = self.datasets[d]
        return ds[s % len(ds)]
