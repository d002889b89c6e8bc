"""Metrics logging: `MetricsLogger` appends one JSON row per `log` call
to `<out_dir>/<run_name>.jsonl`, the JAX package's format."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

log = logging.getLogger("embodied_captioning_tpu_torch")


class MetricsLogger:
    def __init__(self, out_dir: Optional[str] = None, run_name: str = "run"):
        self.out_dir = out_dir
        self._fh = None
        self._step = 0
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._fh = open(os.path.join(out_dir, f"{run_name}.jsonl"), "a")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        step = self._step if step is None else step
        self._step = step + 1
        row = {"step": step, "time": time.time(), **metrics}
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        log.info("step %d: %s", step,
                 {k: v for k, v in metrics.items() if not isinstance(v, str)})

    def close(self) -> None:
        if self._fh:
            self._fh.close()
