"""HF datasets pipeline: tokenize-and-chunk plus resumable batch iterators.

A copy of ``relora_tpu/data/hf_pipeline.py`` for the PyTorch port, which
imports nothing of the JAX package.  NumPy only: the ``datasets`` and
tokenizer objects arrive as arguments, so this module imports on a machine
without ``datasets``, ``transformers`` or ``tokenizers``.

- ``tokenize_and_chunk``       — tokenize + append EOS, concatenate and cut
  into fixed ``sequence_length`` blocks, drop the remainder, drop attention
  masks.  Used offline by ``relora_tpu_torch.pretokenize`` and checked at
  train time through the ``args.json`` provenance file.
- ``TokenBatchIterator``       — batches a pretokenized dataset into
  ``(grad_accum, microbatch, seq)`` int32 arrays with a deterministic skip
  for resume (index arithmetic, no data reads) and per-process slicing.
- ``StreamingTokenIterator``   — on-the-fly tokenize + pack for iterable or
  raw datasets.
"""

from __future__ import annotations

import itertools
import logging
from typing import Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)


def tokenize_and_chunk(
    dataset,
    tokenizer,
    text_field: str = "text",
    sequence_length: int = 512,
    num_proc: int = 8,
):
    """Pretokenize a text dataset into fixed-length ``input_ids`` blocks.

    Every document gets an EOS appended, documents are concatenated, the
    stream is cut into ``sequence_length`` chunks and the tail remainder is
    dropped (the reference's "extra [EOS]" between documents included).
    """
    eos = tokenizer.eos_token_id
    if eos is None:
        raise ValueError("tokenizer must define an EOS token")

    def tokenize(examples):
        out = tokenizer(examples[text_field], add_special_tokens=False)
        return {"input_ids": [ids + [eos] for ids in out["input_ids"]]}

    tokenized = dataset.map(
        tokenize,
        batched=True,
        num_proc=num_proc,
        remove_columns=list(dataset.column_names),
        desc="tokenizing",
    )

    def group(examples):
        concat = list(itertools.chain.from_iterable(examples["input_ids"]))
        total = (len(concat) // sequence_length) * sequence_length
        return {
            "input_ids": [
                concat[i : i + sequence_length] for i in range(0, total, sequence_length)
            ]
        }

    return tokenized.map(group, batched=True, num_proc=num_proc, desc="chunking")


class TokenBatchIterator:
    """Batches from a pretokenized dataset.

    Yields int32 arrays of shape ``(grad_accum, microbatch, seq)`` (train) or
    ``(microbatch, seq)`` (eval, ``grad_accum=None``).  ``skip_updates``
    fast-forwards whole updates for resume by index arithmetic.
    ``process_index`` / ``process_count`` give each process a contiguous
    slice of every update's global batch.
    """

    def __init__(
        self,
        dataset,
        *,
        microbatch: int,
        grad_accum: Optional[int] = None,
        skip_updates: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.microbatch = microbatch
        self.grad_accum = grad_accum
        self.process_index = process_index
        self.process_count = process_count
        seqs_per_update = microbatch * (grad_accum or 1) * process_count
        self._seqs_per_update = seqs_per_update
        self._start = skip_updates * seqs_per_update
        n = len(dataset)
        self._n_updates_total = n // seqs_per_update if drop_last else -(-n // seqs_per_update)

    def __len__(self) -> int:
        return max(0, self._n_updates_total - self._start // self._seqs_per_update)

    def __iter__(self) -> Iterator[np.ndarray]:
        mb, ga = self.microbatch, self.grad_accum
        per_process = mb * (ga or 1)
        end = self._n_updates_total * self._seqs_per_update
        for start in range(self._start, end, self._seqs_per_update):
            lo = start + self.process_index * per_process
            arr = np.asarray(self.dataset[lo : lo + per_process]["input_ids"], dtype=np.int32)
            yield arr if ga is None else arr.reshape(ga, mb, -1)


class StreamingTokenIterator:
    """On-the-fly tokenize + pack for raw or iterable text datasets.

    Documents are tokenized with EOS appended and packed into a rolling token
    buffer; a full ``(grad_accum, microbatch, seq)`` batch is emitted each
    time the buffer fills.  Processes share the documents by index (islice).
    """

    def __init__(
        self,
        dataset,
        tokenizer,
        *,
        text_field: str = "text",
        sequence_length: int,
        microbatch: int,
        grad_accum: int = 1,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.text_field = text_field
        self.sequence_length = sequence_length
        self.microbatch = microbatch
        self.grad_accum = grad_accum
        self.process_index = process_index
        self.process_count = process_count

    def __iter__(self) -> Iterator[np.ndarray]:
        eos = self.tokenizer.eos_token_id
        need = self.sequence_length * self.microbatch * self.grad_accum
        buffer: list = []
        docs = itertools.islice(iter(self.dataset), self.process_index, None, self.process_count)
        for doc in docs:
            ids = self.tokenizer(doc[self.text_field], add_special_tokens=False)["input_ids"]
            buffer.extend(ids)
            buffer.append(eos)
            while len(buffer) >= need:
                chunk = np.asarray(buffer[:need], dtype=np.int32)
                buffer = buffer[need:]
                yield chunk.reshape(self.grad_accum, self.microbatch, self.sequence_length)
