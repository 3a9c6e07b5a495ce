"""Experiment directories, logging and a scalar writer (stdlib only).

The port's own copy of the parts of ``sam_quantization_tpu/utils/experiment.py``
that the trainer uses: auto-numbered experiment directories with resume by
prefix (ref utils/exp.py), a console + file logger, and the period-averaged
scalar writer (ref utils/log.py) appending to ``scalars.jsonl``.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional


def init_experiment(
    base_dir: str, exp_name: str = "exp", resume_prefix: Optional[str] = None
) -> Path:
    """Create (or resume) an auto-numbered experiment directory tree:
    <base>/<NNN>-<name>/{checkpoints,logs,vis}."""
    base = Path(base_dir)
    base.mkdir(parents=True, exist_ok=True)
    if resume_prefix is not None:
        matches = sorted(
            d for d in base.iterdir() if d.is_dir() and d.name.startswith(resume_prefix)
        )
        if not matches:
            raise FileNotFoundError(f"no experiment starting with {resume_prefix!r}")
        exp_dir = matches[-1]
    else:
        nums = [
            int(d.name.split("-")[0])
            for d in base.iterdir()
            if d.is_dir() and d.name.split("-")[0].isdigit()
        ]
        exp_dir = base / f"{(max(nums) + 1 if nums else 0):03d}-{exp_name}"
    for sub in ("checkpoints", "logs", "vis"):
        (exp_dir / sub).mkdir(parents=True, exist_ok=True)
    return exp_dir


def setup_logger(log_dir: Optional[str] = None, rank: int = 0) -> logging.Logger:
    """Console + per-run file logging, rank-gated like the reference
    (train_sm.py:617-624)."""
    logger = logging.getLogger("samq")
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    if logger.handlers:
        return logger
    fmt = logging.Formatter("(%(asctime)s) [%(levelname)s] %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir and rank == 0:
        fh = logging.FileHandler(
            os.path.join(log_dir, time.strftime("%Y-%m-%d_%H-%M-%S.log"))
        )
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class ScalarWriterAvg:
    """Period-averaged scalar writer to JSONL: every scalar is averaged over
    ``dump_period`` updates and appended to ``scalars.jsonl``."""

    def __init__(self, log_dir: str, dump_period: int = 10):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.dump_period = dump_period
        self._avg: Dict[str, list] = {}
        self._file = open(self.log_dir / "scalars.jsonl", "a")

    def add_scalar(self, tag: str, value: float, global_step: int, disable_avg=False):
        if disable_avg:
            self._write(tag, value, global_step)
            return
        buf = self._avg.setdefault(tag, [])
        buf.append(float(value))
        if len(buf) >= self.dump_period:
            self._write(tag, sum(buf) / len(buf), global_step)
            buf.clear()

    def _write(self, tag, value, step):
        self._file.write(json.dumps({"tag": tag, "value": value, "step": step}) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()
