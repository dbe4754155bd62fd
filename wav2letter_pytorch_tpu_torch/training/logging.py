"""Metric logging: ``metrics.csv`` always, TensorBoard where ``tensorboardX``
imports.

Same file as ``wav2letter_pytorch_tpu.training.logging``: one row per
metric, columns ``time, step, metric, value``, appended across resumes.
"""

from __future__ import annotations

import csv
import os
import time


class MetricLogger:
    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self._csv_path = os.path.join(run_dir, 'metrics.csv')
        self._csv_file = open(self._csv_path, 'a', newline='')
        self._csv = csv.writer(self._csv_file)
        if os.path.getsize(self._csv_path) == 0:
            self._csv.writerow(['time', 'step', 'metric', 'value'])
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(os.path.join(run_dir, 'tb'))

    def log(self, step: int, metrics: dict):
        now = time.time()
        for key, value in metrics.items():
            value = float(value)
            self._csv.writerow([f'{now:.3f}', step, key, value])
            if self._tb is not None:
                self._tb.add_scalar(key, value, step)
        self._csv_file.flush()

    def close(self):
        self._csv_file.close()
        if self._tb is not None:
            self._tb.close()
