"""Structured logging and a JSONL metrics stream.

A copy of ``pathtracer_gaussiansplatting_tpu/utils/logging.py``: that
module imports no jax, but importing it runs the JAX package's
``__init__``. ``get_logger()`` gives the ``gspt`` logger with its own
stderr handler and format; it does not propagate to the root logger.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict, Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"


def get_logger(name: str = "gspt") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class MetricsLogger:
    """Append-only JSONL metrics stream (rays/s, spp, losses, flux stats);
    without a path each record goes to the ``gspt`` logger."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None

    def log(self, step: int, **metrics: Any):
        rec: Dict[str, Any] = dict(step=step, ts=time.time(), **metrics)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        else:
            get_logger().info("step %d %s", step, json.dumps(metrics))

    def close(self):
        if self._fh:
            self._fh.close()
