"""Metrics logger: JSONL file + the log stream (counterpart of
pytorchvideo_tpu/train/logger.py): newline-delimited json records (step,
epoch, wall time, metrics) under ``<log_dir>/metrics.jsonl``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class MetricsLogger:
    """Append metric records to <dir>/metrics.jsonl and the log stream."""

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self._fh = None
        self._t0 = time.time()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, metrics: Dict[str, Any], step: int, epoch: Optional[int] = None):
        record = {
            "step": int(step),
            "wall_time": round(time.time() - self._t0, 3),
            **({"epoch": int(epoch)} if epoch is not None else {}),
            **{
                k: (float(v) if hasattr(v, "__float__") else v)
                for k, v in metrics.items()
            },
        }
        logger.info("metrics %s", record)
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        return record

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
