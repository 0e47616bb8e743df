"""Training metrics logging (a copy of ravvent_tpu/training/logging.py).

Equivalents of the reference's observability surface (SURVEY.md §5):
``CSVLogger`` per epoch (reference: ravvent.py:72-74), ``BatchLogs``
per-batch series collector (reference: utils.py:130-136), plus simple stage
timers matching the performance evaluator's partition
(reference: ravvent_performance_evaluator.py:32-87).
"""

from __future__ import annotations

import csv
import os
import time
from contextlib import contextmanager
from typing import Dict, List, Optional


class CSVLogger:
    """Appends one row per epoch: epoch + sorted metric columns."""

    def __init__(self, path: str, append: bool = False) -> None:
        self.path = path
        self.keys: Optional[List[str]] = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not append and os.path.exists(path):
            os.remove(path)

    def log(self, epoch: int, metrics: Dict[str, float]) -> None:
        if self.keys is None:
            self.keys = sorted(metrics.keys())
            write_header = not os.path.exists(self.path)
            with open(self.path, "at", newline="") as f:
                w = csv.writer(f)
                if write_header:
                    w.writerow(["epoch"] + self.keys)
        with open(self.path, "at", newline="") as f:
            csv.writer(f).writerow([epoch] + [metrics.get(k, "") for k in self.keys])


class BatchLogs:
    """Collects one metric per train batch (reference: utils.py:130-136)."""

    def __init__(self, key: str) -> None:
        self.key = key
        self.logs: List[float] = []

    def on_train_batch_end(self, _n: int, logs: Dict[str, float]) -> None:
        self.logs.append(float(logs[self.key]))


class StageTimers:
    """Named wall-clock accumulators (the reference's 4-way timing partition)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def get(self, name: str) -> float:
        return self.totals.get(name, 0.0)
