"""Tracing and debug hooks of the training loop (counterpart of
``gke_ray_train_tpu/train/profiling.py``).

:class:`TraceProfiler` runs ``torch.profiler`` (CPU and, where CUDA is
present, CUDA activities) over a window of steps mid-run, after the
first step's warm-up, and writes the trace as Chrome-trace JSON under
``logdir`` (``<host>_<pid>.<ms>.pt.trace.json``, the name
``torch.profiler.tensorboard_trace_handler`` gives, so TensorBoard's
PyTorch profiler plugin reads it).

Config keys (fine_tune_config.json):
  "PROFILE": true | "dir"        enable (default dir under the run's
                                 output dir)
  "PROFILE_START_STEP": 10       steps to run after (re)start before
                                 tracing begins
  "PROFILE_NUM_STEPS": 5         traced window length
  "DEBUG_NANS": true             autograd anomaly detection (below)
"""

from __future__ import annotations

import logging
import os
import socket
import time
from typing import Optional

logger = logging.getLogger(__name__)


class TraceProfiler:
    """Start / stop a ``torch.profiler`` trace around a step window.

    Host-side and idempotent; never fatal (a profiler that fails to start
    or stop warns and stays off). ``trace_path`` names the file written.
    """

    def __init__(self, logdir: str, start_step: int = 10,
                 num_steps: int = 5):
        self.logdir = logdir
        self.start_step = start_step
        self.num_steps = num_steps
        self.trace_path: Optional[str] = None
        self._first = None           # first global step seen this run
        self._stop_at = None
        self._prof = None
        self._active = False
        self._done = False

    @property
    def active(self) -> bool:
        """Whether a trace is in flight now."""
        return self._active

    @property
    def stop_step(self) -> int:
        """Exclusive end of the trace window relative to this run's
        first step: traced steps are [start_step, stop_step)."""
        return self.start_step + self.num_steps

    def step(self, global_step: int) -> None:
        """Call once per train step, after the step ran (post-increment
        index). The window is relative to the first step this process
        runs, so a resumed run also skips its own warm-up steps."""
        if self._done:
            return
        if self._first is None:
            self._first = global_step
        # start after `start_step` steps have completed, so the first
        # traced step is first + start_step
        if not self._active and \
                global_step >= self._first + self.start_step - 1:
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                os.makedirs(self.logdir, exist_ok=True)
                self._prof = profile(activities=acts)
                self._prof.start()
                self._active = True
                self._stop_at = global_step + self.num_steps
                logger.info("profiler: tracing steps %d-%d to %s",
                            global_step + 1, self._stop_at, self.logdir)
            except Exception as e:  # noqa: BLE001 - profiling never fatal
                logger.warning("profiler start failed: %s", e)
                self._prof = None
                self._done = True
        elif self._active and global_step >= self._stop_at:
            self.close()

    def close(self) -> None:
        if self._active:
            try:
                self._prof.stop()
                path = os.path.join(
                    self.logdir, f"{socket.gethostname()}_{os.getpid()}."
                    f"{int(time.time() * 1000)}.pt.trace.json")
                self._prof.export_chrome_trace(path)
                self.trace_path = path
                logger.info("profiler: trace written to %s", path)
            except Exception as e:  # noqa: BLE001
                logger.warning("profiler stop failed: %s", e)
            self._prof = None
            self._active = False
        self._done = True


def profiler_from_config(config: dict, default_dir: str) -> Optional[
        TraceProfiler]:
    """A TraceProfiler from the flat config keys, or None when profiling
    is off."""
    prof = config.get("PROFILE", False)
    if not prof:
        return None
    logdir = prof if isinstance(prof, str) else default_dir
    return TraceProfiler(
        logdir,
        start_step=int(config.get("PROFILE_START_STEP", 10)),
        num_steps=int(config.get("PROFILE_NUM_STEPS", 5)))


def apply_debug_flags(config: dict) -> None:
    """``DEBUG_NANS``: ``torch.autograd.set_detect_anomaly(True,
    check_nan=True)``, process-wide.

    What it catches differs from JAX's ``jax_debug_nans``. Anomaly mode
    checks the output of every backward function and raises at the first
    NaN gradient, naming the forward op that made it (with the forward's
    stack, recorded for every op). It has no forward check: a NaN loss
    or activation raises nothing until a gradient comes out NaN, and a
    NaN in a metric or eval output never raises. ``jax_debug_nans``
    checks every primitive's output, forward and backward. Both slow
    every step."""
    if bool(config.get("DEBUG_NANS", False)):
        import torch
        torch.autograd.set_detect_anomaly(True, check_nan=True)
        logger.info("autograd anomaly detection (check_nan) enabled")
