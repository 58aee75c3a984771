"""Run logging and meters, counterpart of otvm_tpu/utils/logging.py
(helpers.py:125-162 of the reference, and a step timer)."""
from __future__ import annotations

import logging
import time
from pathlib import Path


class AverageMeter:
    """helpers.py:125-158."""

    def __init__(self):
        self.val = self.sum = self.count = self.avg = 0.0
        self.initialized = False

    def update(self, val, weight=1):
        if not self.initialized:
            self.val, self.sum, self.count = val, val * weight, weight
            self.avg = val
            self.initialized = True
        else:
            self.val = val
            self.sum += val * weight
            self.count += weight
            self.avg = self.sum / self.count


def create_logger(output_dir: str, cfg_name: str, phase: str = "train"):
    """helpers.py:136-162: logs to <outdir>/<name>/<name>_<time>_<phase>.log
    and the console.  Returns (logger, the run's directory)."""
    out = Path(output_dir) / cfg_name
    out.mkdir(parents=True, exist_ok=True)
    ts = time.strftime("%Y-%m-%d-%H-%M")
    logger = logging.getLogger(f"otvm.{cfg_name}.{phase}")
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fh = logging.FileHandler(str(out / f"{cfg_name}_{ts}_{phase}.log"))
    fh.setFormatter(logging.Formatter("%(asctime)-15s %(message)s"))
    logger.addHandler(fh)
    logger.addHandler(logging.StreamHandler())
    return logger, str(out)


class StepTimer:
    """Per-step wall clock, with an ETA over a sliding window of steps
    (helpers.py:222-274)."""

    def __init__(self, window: int = 1000):
        self.window = window
        self.times = []
        self.last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self.last
        self.last = now
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    def eta(self, remaining_steps: int) -> float:
        if not self.times:
            return float("nan")
        return remaining_steps * (sum(self.times) / len(self.times))
