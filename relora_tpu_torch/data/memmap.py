"""Memory-mapped indexed token storage, binary-compatible with the Megatron
``.idx``/``.bin`` format.

A copy of ``relora_tpu/data/memmap.py`` for the PyTorch port, which imports
nothing of the JAX package.

Capability parity with MMapIndexedDataset
(peft_pretraining/megatron_dataset/indexed_dataset.py:348-565): zero-copy
np.memmap reads, partial ``get(doc, offset, length)`` access, and a builder
that autoselects uint16 for vocab < 65500 (:28-32).  Binary compatibility
means existing corpora (e.g. the tokenized Pile the reference's production
recipe points at) load unchanged.

Format (one header + three arrays in ``.idx``, raw tokens in ``.bin``)::

    magic   b"MMIDIDX\\x00\\x00"
    version u64 = 1
    dtype   u8 code (1 u8, 2 i8, 3 i16, 4 i32, 5 i64, 6 f32, 7 f64, 8 u16)
    n_seqs  u64
    n_docs  u64
    sizes   i32[n_seqs]      tokens per sequence
    ptrs    i64[n_seqs]      byte offset of each sequence in .bin
    docs    i64[n_docs]      sequence index at each document boundary
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

_MAGIC = b"MMIDIDX\x00\x00"
_VERSION = 1

_CODE_TO_DTYPE = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float32,
    7: np.float64,
    8: np.uint16,
}
_DTYPE_TO_CODE = {np.dtype(v): k for k, v in _CODE_TO_DTYPE.items()}


def best_dtype(vocab_size: int) -> np.dtype:
    """uint16 when the vocab fits (parity: indexed_dataset.py:28-32)."""
    return np.dtype(np.uint16) if vocab_size is not None and vocab_size < 65500 else np.dtype(np.int32)


def data_path(prefix: str) -> str:
    return prefix + ".bin"


def index_path(prefix: str) -> str:
    return prefix + ".idx"


def _read_index_arrays(prefix: str):
    """Parse just the ``.idx`` header + arrays: (dtype, sizes, doc_idx).

    Unlike MemmapTokenDataset this never touches the ``.bin`` file, so it
    works on empty shards and holds no mappings open."""
    with open(index_path(prefix), "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{index_path(prefix)}: bad magic {magic!r}")
        (version,) = struct.unpack("<Q", f.read(8))
        if version != _VERSION:
            raise ValueError(f"unsupported index version {version}")
        (code,) = struct.unpack("<B", f.read(1))
        dtype = np.dtype(_CODE_TO_DTYPE[code])
        (n_seqs,) = struct.unpack("<Q", f.read(8))
        (n_docs,) = struct.unpack("<Q", f.read(8))
        sizes = np.frombuffer(f.read(n_seqs * 4), dtype=np.int32)
        f.seek(n_seqs * 8, os.SEEK_CUR)  # skip the byte-offset pointers
        doc_idx = np.frombuffer(f.read(n_docs * 8), dtype=np.int64)
    return dtype, sizes, doc_idx


class MemmapTokenDataset:
    """Read-only mmap view of a tokenized corpus.

    ``self.sizes`` is the per-sequence token count; ``get(i, offset, length)``
    returns a zero-copy slice of sequence ``i``'s tokens.
    """

    def __init__(self, prefix: str):
        self.prefix = prefix
        with open(index_path(prefix), "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{index_path(prefix)}: bad magic {magic!r}")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != _VERSION:
                raise ValueError(f"unsupported index version {version}")
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = np.dtype(_CODE_TO_DTYPE[code])
            (n_seqs,) = struct.unpack("<Q", f.read(8))
            (n_docs,) = struct.unpack("<Q", f.read(8))
            header_end = f.tell()

        self._idx_map = np.memmap(index_path(prefix), mode="r", order="C")
        off = header_end
        self.sizes = np.frombuffer(self._idx_map, dtype=np.int32, count=n_seqs, offset=off)
        off += n_seqs * 4
        self.pointers = np.frombuffer(self._idx_map, dtype=np.int64, count=n_seqs, offset=off)
        off += n_seqs * 8
        self.doc_idx = np.frombuffer(self._idx_map, dtype=np.int64, count=n_docs, offset=off)
        self._data = np.memmap(data_path(prefix), dtype=self.dtype, mode="r", order="C")

    def __len__(self) -> int:
        return len(self.sizes)

    def get(self, idx: int, offset: int = 0, length: Optional[int] = None) -> np.ndarray:
        """Partial read of one sequence (parity: indexed_dataset.py:528-541)."""
        size = int(self.sizes[idx])
        if length is None:
            length = size - offset
        start = self.pointers[idx] // self.dtype.itemsize + offset
        return self._data[start : start + length]

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.get(idx)

    @property
    def n_tokens(self) -> int:
        return int(self.sizes.sum())


_LEGACY_MAGIC = b"TNTIDX\x00\x00"


class LegacyIndexedDataset:
    """Reader for the legacy (pre-mmap, fairseq-derived) ``.idx``/``.bin``
    format (parity: IndexedDataset / IndexedCachedDataset,
    indexed_dataset.py:133-273).

    Header: magic ``TNTIDX``, <Q version 1, <QQ dtype code + element size,
    <QQ n_items + n_sizes, <Q doc_idx length; int64 arrays dim_offsets,
    data_offsets, sizes, doc_idx.  ``cached=True`` reads the whole token
    buffer into RAM once (the IndexedCachedDataset behavior); otherwise
    reads seek the file lazily.
    """

    def __init__(self, prefix: str, cached: bool = False):
        self.prefix = prefix
        with open(index_path(prefix), "rb") as f:
            magic = f.read(len(_LEGACY_MAGIC))
            if magic != _LEGACY_MAGIC:
                raise ValueError(f"{index_path(prefix)}: bad legacy magic {magic!r}")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != 1:
                raise ValueError(f"unsupported legacy index version {version}")
            dcode, self.element_size = struct.unpack("<QQ", f.read(16))
            self.dtype = np.dtype(_CODE_TO_DTYPE[dcode])
            n_items, n_sizes = struct.unpack("<QQ", f.read(16))
            (n_docs,) = struct.unpack("<Q", f.read(8))
            self.dim_offsets = np.fromfile(f, np.int64, n_items + 1)
            self.data_offsets = np.fromfile(f, np.int64, n_items + 1)
            self.sizes = np.fromfile(f, np.int64, n_sizes).astype(np.int32)
            self.doc_idx = np.fromfile(f, np.int64, n_docs)
        self._file = None
        self._cache = None
        if cached:
            self._cache = np.fromfile(data_path(prefix), dtype=self.dtype)

    def __len__(self) -> int:
        return len(self.data_offsets) - 1

    def get(self, idx: int, offset: int = 0, length: Optional[int] = None) -> np.ndarray:
        size = int(self.data_offsets[idx + 1] - self.data_offsets[idx])
        if length is None:
            length = size - offset
        start = int(self.data_offsets[idx]) + offset
        if self._cache is not None:
            return self._cache[start : start + length]
        if self._file is None:
            self._file = open(data_path(self.prefix), "rb", buffering=0)
        self._file.seek(start * self.element_size)
        return np.frombuffer(self._file.read(length * self.element_size), dtype=self.dtype)

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.get(idx)

    @property
    def n_tokens(self) -> int:
        return int(self.data_offsets[-1])


class LegacyIndexedWriter:
    """Writer for the legacy format (parity: IndexedDatasetBuilder,
    indexed_dataset.py:276-339) — mainly for tests and migration tooling."""

    def __init__(self, prefix: str, dtype: np.dtype = np.dtype(np.int32)):
        self.prefix = prefix
        self.dtype = np.dtype(dtype)
        os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
        self._bin = open(data_path(prefix), "wb")
        self.data_offsets = [0]
        self.dim_offsets = [0]
        self.sizes: list[int] = []
        self.doc_idx = [0]

    def add_document(self, tokens) -> None:
        arr = np.asarray(tokens, dtype=self.dtype)
        self._bin.write(arr.tobytes())
        self.data_offsets.append(self.data_offsets[-1] + arr.size)
        self.sizes.append(arr.size)
        self.dim_offsets.append(self.dim_offsets[-1] + 1)
        self.doc_idx.append(len(self.sizes))

    def finalize(self) -> None:
        self._bin.close()
        with open(index_path(self.prefix), "wb") as f:
            f.write(_LEGACY_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<QQ", _DTYPE_TO_CODE[self.dtype], self.dtype.itemsize))
            f.write(struct.pack("<QQ", len(self.data_offsets) - 1, len(self.sizes)))
            f.write(struct.pack("<Q", len(self.doc_idx)))
            for arr in (self.dim_offsets, self.data_offsets, self.sizes, self.doc_idx):
                f.write(np.asarray(arr, dtype=np.int64).tobytes())

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # finalize only on clean exit: writing a valid-looking .idx over a
        # partially-streamed .bin would leave a silently truncated corpus
        # that downstream pipelines could load and train on
        if exc_type is None:
            self.finalize()
        else:
            self._bin.close()


def open_token_dataset(prefix: str, impl: str = "infer"):
    """Open a tokenized corpus by format: 'mmap', 'lazy', 'cached', or
    'infer' (sniff the index magic — parity: make_dataset/infer_dataset_impl,
    indexed_dataset.py:36-78)."""
    if impl == "infer":
        with open(index_path(prefix), "rb") as f:
            magic = f.read(9)
        impl = "mmap" if magic.startswith(_MAGIC[:8]) else "lazy"
    if impl == "mmap":
        return MemmapTokenDataset(prefix)
    if impl == "lazy":
        return LegacyIndexedDataset(prefix, cached=False)
    if impl == "cached":
        return LegacyIndexedDataset(prefix, cached=True)
    raise ValueError(f"unknown data impl {impl!r}")


class MemmapTokenWriter:
    """Streaming writer producing the same ``.idx``/``.bin`` pair
    (parity: MMapIndexedDatasetBuilder, indexed_dataset.py:568-603)."""

    def __init__(self, prefix: str, dtype: np.dtype = np.dtype(np.uint16)):
        self.prefix = prefix
        self.dtype = np.dtype(dtype)
        if self.dtype not in _DTYPE_TO_CODE:
            raise ValueError(f"unsupported dtype {dtype}")
        os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
        self._bin = open(data_path(prefix), "wb")
        self._sizes: list[int] = []
        self._doc_ends: list[int] = [0]

    def add_document(self, tokens) -> None:
        arr = np.asarray(tokens, dtype=self.dtype)
        self._bin.write(arr.tobytes(order="C"))
        self._sizes.append(len(arr))
        self._doc_ends.append(len(self._sizes))

    def merge_file(self, prefix: str) -> None:
        """Append an already-written corpus shard wholesale (parity:
        MMapIndexedDatasetBuilder.merge_file_, indexed_dataset.py:596-603).

        The shard's raw ``.bin`` bytes are streamed onto this writer's data
        file and its sizes/doc boundaries grafted onto the index, so merging
        pre-tokenized shards never re-encodes tokens.  Only the shard's
        ``.idx`` arrays are parsed (no memmap of the data file), so an
        empty shard — a per-worker pretokenizer output that received no
        documents — merges as a no-op instead of crashing."""
        import shutil

        if os.path.realpath(os.path.abspath(prefix)) == os.path.realpath(
            os.path.abspath(self.prefix)
        ):
            raise ValueError(
                f"cannot merge a corpus into itself ({prefix!r}): the "
                "writer already truncated this prefix's .bin"
            )
        dtype, sizes, doc_idx = _read_index_arrays(prefix)
        if dtype != self.dtype:
            raise ValueError(
                f"cannot merge {prefix!r} ({dtype}) into a "
                f"{self.dtype} corpus — re-tokenize or migrate the shard"
            )
        base = len(self._sizes)
        self._sizes.extend(int(s) for s in sizes)
        # doc_idx[0] is the leading 0 sentinel — already represented by
        # this writer's current end marker
        self._doc_ends.extend(base + int(d) for d in doc_idx[1:])
        with open(data_path(prefix), "rb") as f:
            shutil.copyfileobj(f, self._bin)

    def finalize(self) -> None:
        self._bin.close()
        sizes = np.asarray(self._sizes, dtype=np.int32)
        pointers = np.zeros(len(sizes), dtype=np.int64)
        np.cumsum(sizes[:-1] * self.dtype.itemsize, out=pointers[1:])
        docs = np.asarray(self._doc_ends, dtype=np.int64)
        with open(index_path(self.prefix), "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", _VERSION))
            f.write(struct.pack("<B", _DTYPE_TO_CODE[self.dtype]))
            f.write(struct.pack("<Q", len(sizes)))
            f.write(struct.pack("<Q", len(docs)))
            f.write(sizes.tobytes(order="C"))
            f.write(pointers.tobytes(order="C"))
            f.write(docs.tobytes(order="C"))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # finalize only on clean exit: writing a valid-looking .idx over a
        # partially-streamed .bin would leave a silently truncated corpus
        # that downstream pipelines could load and train on
        if exc_type is None:
            self.finalize()
        else:
            self._bin.close()
