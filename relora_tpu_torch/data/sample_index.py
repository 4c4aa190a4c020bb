"""Sample-index mappings: random-access ``idx -> seq_length+1 tokens`` over a
document corpus.

Capability parity with GPT2Dataset
(peft_pretraining/megatron_dataset/dataset.py): three cached numpy arrays —

- ``doc_idx``     epoch-repeated shuffled document order (:275-287 analogue)
- ``sample_idx``  (num_samples+1, 2) [position-in-doc_idx, token-offset]
  marking each sample boundary; consecutive samples share one boundary token
  (input/target shift) (:289-320)
- ``shuffle_idx`` sample-order permutation

built once, cached as .npy and mmap-loaded (:129-241).

A copy of ``relora_tpu/data/sample_index.py`` for the PyTorch port.  The
JAX package packs with a C++ helper (``relora_tpu/data/native``) and keeps
the NumPy packer as its oracle; the port packs with the NumPy packer, which
gives the same indices (the C++ helper is listed in ROADMAP).
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from typing import Optional, Tuple

import numpy as np

from relora_tpu_torch.data.memmap import MemmapTokenDataset

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# NumPy packers
# ---------------------------------------------------------------------------


def num_epochs_needed(tokens_per_epoch: int, seq_length: int, num_samples: int) -> int:
    """Smallest epoch count whose token supply covers num_samples windows
    (the -1: adjacent samples overlap by one boundary token)."""
    epochs = 0
    total = 0
    while True:
        epochs += 1
        total += tokens_per_epoch
        if (total - 1) // seq_length >= num_samples:
            return epochs


def build_doc_idx(documents: np.ndarray, num_epochs: int, rng: np.random.RandomState) -> np.ndarray:
    """Epoch-repeated document order, shuffled globally."""
    doc_idx = np.tile(np.asarray(documents, dtype=np.int32), num_epochs)
    rng.shuffle(doc_idx)
    return doc_idx


def build_sample_idx_py(
    sizes: np.ndarray, doc_idx: np.ndarray, seq_length: int, num_samples: int
) -> np.ndarray:
    """``(num_samples + 1, 2)`` sample boundaries ``[position in doc_idx,
    token offset]``: each sample spans ``seq_length + 1`` tokens and shares
    its last token with the next sample's first."""
    sample_idx = np.zeros((num_samples + 1, 2), dtype=np.int64)
    doc_pos = 0
    doc_offset = 0
    sample_idx[0] = (doc_pos, doc_offset)
    for out in range(1, num_samples + 1):
        remaining = seq_length + 1
        while remaining > 0:
            doc_len = int(sizes[doc_idx[doc_pos]]) - doc_offset
            if doc_len >= remaining:
                doc_offset += remaining - 1
                remaining = 0
            else:
                remaining -= doc_len
                doc_pos += 1
                doc_offset = 0
        sample_idx[out] = (doc_pos, doc_offset)
    return sample_idx


def build_shuffle_idx(size: int, rng: np.random.RandomState) -> np.ndarray:
    dtype = np.uint32 if size < np.iinfo(np.uint32).max - 1 else np.int64
    idx = np.arange(size, dtype=dtype)
    rng.shuffle(idx)
    return idx


# ---------------------------------------------------------------------------
# cached builder
# ---------------------------------------------------------------------------


def build_index_mappings(
    name: str,
    prefix: str,
    documents: np.ndarray,
    sizes: np.ndarray,
    num_samples: int,
    seq_length: int,
    seed: int,
    cache_dir: Optional[str] = None,
    is_coordinator: bool = True,
    barrier=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build-or-load the three mapping arrays.

    Process 0 builds and writes ``.npy`` caches; other processes wait at
    ``barrier`` then mmap-load (parity: dataset.py:161-241 rank-0 pattern).
    """
    cache_dir = cache_dir or os.path.dirname(os.path.abspath(prefix))
    tokens_per_epoch = int(np.sum(sizes[documents]))
    epochs = num_epochs_needed(tokens_per_epoch, seq_length, num_samples)
    # the digest covers the document ids themselves, not just their count and
    # token total — two different subsets with coincident totals (e.g. a moved
    # split boundary) must not reuse each other's cached mappings
    doc_digest = hashlib.md5(np.ascontiguousarray(documents).tobytes()).hexdigest()[:16]
    key = hashlib.md5(
        f"{name}:{doc_digest}:{tokens_per_epoch}:{epochs}:{num_samples}:{seq_length}:{seed}".encode()
    ).hexdigest()[:16]
    base = os.path.join(cache_dir, f"{os.path.basename(prefix)}_{name}_{key}")
    paths = {k: f"{base}_{k}.npy" for k in ("doc_idx", "sample_idx", "shuffle_idx")}

    if is_coordinator and not all(os.path.exists(p) for p in paths.values()):
        t0 = time.time()
        rng = np.random.RandomState(seed)
        doc_idx = build_doc_idx(documents, epochs, rng)
        total_samples = (epochs * tokens_per_epoch - 1) // seq_length
        n = min(num_samples, total_samples)

        sample_idx = build_sample_idx_py(sizes, doc_idx, seq_length, n)
        shuffle_idx = build_shuffle_idx(sample_idx.shape[0] - 1, rng)

        np.save(paths["doc_idx"], doc_idx, allow_pickle=False)
        np.save(paths["sample_idx"], sample_idx, allow_pickle=False)
        np.save(paths["shuffle_idx"], shuffle_idx, allow_pickle=False)
        logger.info(
            f"built index mappings for {name} ({n} samples, {epochs} epochs) "
            f"in {time.time()-t0:.1f}s"
        )
    if barrier is not None:
        barrier()

    doc_idx = np.load(paths["doc_idx"], mmap_mode="r")
    sample_idx = np.load(paths["sample_idx"], mmap_mode="r")
    shuffle_idx = np.load(paths["shuffle_idx"], mmap_mode="r")
    return doc_idx, sample_idx, shuffle_idx


class PackedCausalDataset:
    """Random-access packed-sample view: ``ds[i]`` is ``seq_length+1`` int
    tokens assembled across document boundaries (parity: GPT2Dataset
    __getitem__ :78-126 including the modulo wrap on out-of-range)."""

    def __init__(
        self,
        name: str,
        data: MemmapTokenDataset,
        documents: np.ndarray,
        num_samples: int,
        seq_length: int,
        seed: int,
        cache_dir: Optional[str] = None,
        is_coordinator: bool = True,
        barrier=None,
        label_data: Optional[MemmapTokenDataset] = None,
    ):
        self.name = name
        self.data = data
        # optional parallel label corpus, token-aligned with ``data``
        # (parity: label_dataset, dataset.py:96-126 / label_data_paths)
        self.label_data = label_data
        if label_data is not None and len(label_data) != len(data):
            raise ValueError("label corpus must align document-for-document with data")
        self.seq_length = seq_length
        self.doc_idx, self.sample_idx, self.shuffle_idx = build_index_mappings(
            name,
            data.prefix,
            documents,
            data.sizes,
            num_samples,
            seq_length,
            seed,
            cache_dir=cache_dir,
            is_coordinator=is_coordinator,
            barrier=barrier,
        )

    def __len__(self) -> int:
        return min(len(self.shuffle_idx), self.sample_idx.shape[0] - 1)

    def _assemble(self, source: MemmapTokenDataset, s: int) -> np.ndarray:
        pos_f, off_f = int(self.sample_idx[s][0]), int(self.sample_idx[s][1])
        pos_l, off_l = int(self.sample_idx[s + 1][0]), int(self.sample_idx[s + 1][1])
        if pos_f == pos_l:
            tokens = source.get(int(self.doc_idx[pos_f]), offset=off_f, length=off_l - off_f + 1)
        else:
            parts = [source.get(int(self.doc_idx[pos_f]), offset=off_f)]
            for p in range(pos_f + 1, pos_l):
                parts.append(source.get(int(self.doc_idx[p])))
            parts.append(source.get(int(self.doc_idx[pos_l]), length=off_l + 1))
            tokens = np.concatenate(parts)
        return np.asarray(tokens, dtype=np.int64)

    def __getitem__(self, idx) -> dict:
        if isinstance(idx, slice):
            return {"input_ids": np.stack([self[i]["input_ids"] for i in range(*idx.indices(len(self)))])}
        if idx >= len(self):
            idx = idx % len(self)  # parity: modulo wrap (dataset.py:78-86)
        s = int(self.shuffle_idx[idx])
        out = {"input_ids": self._assemble(self.data, s)}
        if self.label_data is not None:
            # labels assembled with the same index maps — fully in sync
            # (parity: dataset.py:96-126)
            out["label"] = self._assemble(self.label_data, s)
        return out
