"""Structured per-step logger: JSON-lines to PADDLE_TPU_METRICS_DIR
(counterpart of paddle_tpu/observability/steplog.py).

Each training step appends one JSON object to `steps.jsonl` (timestamp,
step counter, phase durations, donation counts, byte volumes, loss when the
caller passes it). A human-readable mirror goes through log_helper.get_logger
at DEBUG — never print() — so headless runs can capture it with ordinary
logging config, and the default INFO level keeps stderr quiet.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time

from ..log_helper import get_logger

__all__ = ['StepLogger', 'step_logger']

_logger = get_logger(
    'paddle_tpu_torch.telemetry', logging.INFO,
    fmt='%(asctime)s-%(levelname)s: %(message)s')


class StepLogger:
    def __init__(self):
        self._lock = threading.Lock()
        self._file = None
        self._path = None
        self.records = 0

    def open(self, directory):
        """(Re)point the JSONL stream at `directory`/steps.jsonl."""
        path = os.path.join(directory, 'steps.jsonl')
        with self._lock:
            if self._path == path and self._file is not None:
                return path
            self.close()
            os.makedirs(directory, exist_ok=True)
            self._file = open(path, 'a')
            self._path = path
        return path

    @property
    def path(self):
        return self._path

    def log(self, record):
        """Append one step record. Unopened logger → DEBUG mirror only."""
        rec = {'ts': time.time()}
        rec.update(record)
        line = json.dumps(rec, default=str)
        with self._lock:
            self.records += 1
            if self._file is not None:
                self._file.write(line + '\n')
                self._file.flush()
        _logger.debug('step %s', line)

    def close(self):
        # caller holds no lock here only via open(); guard for direct use
        f, self._file, self._path = self._file, None, None
        if f is not None:
            try:
                f.close()
            except Exception:
                pass


step_logger = StepLogger()
