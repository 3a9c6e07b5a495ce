"""Experiment directories, logging, a scalar writer and a scheduled profiler.

The port's own copy of ``sam_quantization_tpu/utils/experiment.py``:
auto-numbered experiment directories with resume by prefix (ref
utils/exp.py), a console + file logger, tqdm output routed into a logger and
the period-averaged scalar writer (ref utils/log.py) appending to
``scalars.jsonl``, and :class:`Profiler`, a ``torch.profiler`` trace of a
window of steps (ref analysis/profiler.py:59-124).
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


class TqdmToLogger:
    """File-like adapter routing tqdm output into a logger
    (ref utils/log.py:19-42)."""

    def __init__(self, logger: logging.Logger, level=logging.INFO, mininterval=5.0):
        self.logger = logger
        self.level = level
        self.mininterval = mininterval
        self._last = 0.0
        self._buf = ""

    def write(self, buf):
        self._buf = buf.strip("\r\n\t ")

    def flush(self):
        now = time.time()
        if self._buf and now - self._last >= self.mininterval:
            self.logger.log(self.level, self._buf)
            self._last = now


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


class Profiler:
    """A ``torch.profiler`` trace of a window of ``step()`` calls, counted as
    the JAX package's ``Profiler`` counts them: the trace starts at the
    ``(wait + warmup)``-th call and stops at the ``active``-th call after it,
    so it holds the work of ``active`` steps. It records CPU activity, and
    the CUDA card's when there is one, and writes a Chrome trace
    (``trace_steps<first>-<last>.json``, the 1-based steps traced) to
    ``log_dir``; ``trace_path`` names it and ``profile`` holds the
    ``torch.profiler.profile`` for ``key_averages()``. Leaving the context
    ends a trace still open."""

    def __init__(self, log_dir: str, wait: int = 2, warmup: int = 2, active: int = 6):
        self.log_dir = log_dir
        self.wait, self.warmup, self.active = wait, warmup, active
        self._step = 0
        self._tracing = None
        self.profile = None
        self.trace_path: Optional[str] = None

    def step(self):
        self._step += 1
        start = self.wait + self.warmup
        if self._step == start and self._tracing is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._tracing = profile(activities=activities)
            self._tracing.start()
        elif self._tracing is not None and self._step >= start + self.active:
            self._stop()

    def _stop(self):
        prof, self._tracing = self._tracing, None
        prof.stop()
        first = self.wait + self.warmup + 1
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(self.log_dir, f"trace_steps{first}-{self._step}.json")
        prof.export_chrome_trace(self.trace_path)
        self.profile = prof

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._tracing is not None:
            self._stop()
