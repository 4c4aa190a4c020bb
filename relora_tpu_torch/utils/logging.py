"""Process-0 logging and the ``metrics.jsonl`` sink.

The port's own copy of ``relora_tpu/utils/logging.py``'s ``get_logger`` and
``MetricsLogger``.  The reference also forwards records to wandb when it is
importable; wandb is absent on every machine the port runs on, where the
reference writes JSONL alone, so this copy writes JSONL alone (the
trainer refuses ``--wandb``).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Any, Mapping, Optional

_LOGGERS: dict[str, logging.Logger] = {}
# the sink's own messages go through a plain module logger: get_logger()'s
# package logger stops propagation, which would hide every relora_tpu_torch
# record from the root logger's handlers once a trainer logged an event
_log = logging.getLogger(__name__)


def _process_index() -> int:
    """This process's rank (``torch.distributed``'s ``RANK``; 0 alone)."""
    return int(os.environ.get("RANK", "0"))


class _Process0Filter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        return _process_index() == 0 or record.levelno >= logging.ERROR


def get_logger(name: str = "relora_tpu_torch") -> logging.Logger:
    """A stderr logger that emits INFO on process 0 only (errors on every
    process)."""
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s | %(levelname)-7s | %(name)s:%(lineno)d | %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.addFilter(_Process0Filter())
        logger.propagate = False
    _LOGGERS[name] = logger
    return logger


class MetricsLogger:
    """JSONL metrics sink: ``<run_dir>/metrics.jsonl``, one record a line.

    ``log(dict, step=)`` writes a metrics record, ``event(kind, **fields)`` a
    lifecycle record tagged ``_event``; every record carries ``_time`` and,
    when ``source`` is set, ``_source``.  ``config`` is written once to
    ``<run_dir>/run_config.json`` (the reference's wandb config capture,
    offline).  Writes are line-atomic under a lock: the server logs from its
    model thread and its event loop alike.
    """

    def __init__(
        self,
        run_dir: Optional[str] = None,
        source: Optional[str] = None,
        config: Optional[Mapping[str, Any]] = None,
    ):
        self.enabled = _process_index() == 0
        self.source = source
        self._fh = None
        self._lock = threading.Lock()
        if self.enabled and run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            self._fh = open(os.path.join(run_dir, "metrics.jsonl"), "a")
            if config:
                try:
                    with open(os.path.join(run_dir, "run_config.json"), "w") as f:
                        json.dump(dict(config), f, indent=2, default=str)
                except OSError as e:
                    _log.warning(f"could not write run_config.json: {e}")

    def _write(self, record: dict) -> None:
        record["_time"] = time.time()
        if self.source is not None:
            record["_source"] = self.source
        with self._lock:
            if self._fh is not None:
                self._fh.write(json.dumps(record) + "\n")
                self._fh.flush()

    def log(self, metrics: Mapping[str, Any], step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        record = {k: _to_scalar(v) for k, v in metrics.items()}
        if step is not None:
            record["_step"] = step
        self._write(record)

    def event(self, kind: str, step: Optional[int] = None, **fields: Any) -> None:
        """A lifecycle record (drain, warmup, stall, ...) tagged ``_event``."""
        if not self.enabled:
            return
        _log.info(f"event {kind}: {fields}")
        record = {"_event": kind, **{k: _to_scalar(v) for k, v in fields.items()}}
        if step is not None:
            record["_step"] = step
        self._write(record)

    def alert(self, title: str, text: str) -> None:
        """A warning the run's operator must see (the reference's
        ``wandb.alert``, training_utils.py:397-404): logged at WARNING."""
        _log.warning(f"ALERT [{title}]: {text}")

    def finish(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def _to_scalar(v: Any) -> Any:
    """Python scalars for JSON: 0-d tensors and numpy scalars through
    ``item()``, unknown objects through ``str``."""
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    return v if isinstance(v, (int, float, str, bool, type(None), list)) else str(v)
