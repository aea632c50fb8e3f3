"""Structured training metrics, a JSONL sink: the counterpart of
``micronet_tpu/utils/metrics.py``, row for row.

One row per event, appended::

    {"event": "epoch", "epoch": 3, "loss": 1.71, "lr": 1e-3, "img_per_s": 5891.2,
     "seconds": 12.4, "step_ms": [...], "step_loss": [...]}
    {"event": "eval", "epoch": 3, "acc": 0.874, "best_acc": 0.881}

The port's epoch rows add each step's time and loss (``step_ms``,
``step_loss``). Files are append-only: a restart adds a ``run_start``
row and keeps the rows before it. Rows carry no wall-clock time unless
``stamp=True``.
"""

from __future__ import annotations

import json
import time
from typing import Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    """Append-only JSONL writer (a no-op when ``path`` is None)."""

    def __init__(self, path: Optional[str], stamp: bool = False):
        self.path = path
        self.stamp = stamp
        if path:
            self.log("run_start")

    def log(self, event: str, **fields) -> None:
        if not self.path:
            return
        row = {"event": event, **fields}
        if self.stamp:
            row["time"] = time.time()
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
