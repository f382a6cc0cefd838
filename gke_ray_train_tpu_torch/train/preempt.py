"""Graceful preemption (SIGTERM) handling (counterpart of
``gke_ray_train_tpu/train/preempt.py``, the port's own copy).

A spot or preemptible host is evicted with a SIGTERM followed by a grace
window (``PREEMPT_GRACE_S``, default 25 s) before SIGKILL. This module
turns that request into a flag the train loop checks at each step
boundary (``train/loop.py``): on preemption the loop force-saves a
checkpoint, waits until it is durable, and raises :class:`Preempted`, a
status a trainer's retry loop does not count as a failure.

Stdlib only: importable without torch.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)

DEFAULT_GRACE_S = 25.0

_flag = threading.Event()
_deadline: Optional[float] = None   # monotonic end of the grace window
_installed = False
_prev_handler = None
_lock = threading.Lock()
# device-pool target attached to the preemption (elastic training): a
# slice eviction / spot shrink notice names the SURVIVING chip count,
# so the trainer's post-mortem can re-form the mesh instead of burning
# retries waiting for the old topology (rayint/trainer.py)
_pool: Optional[int] = None


class Preempted(Exception):
    """The distinct "preempted" exit status of a training attempt.

    Carries the attempt metadata the trainer records: the step the loop
    stopped at, the step it had resumed from, how long the forced
    checkpoint save took (must fit the grace window), the surviving
    device-pool size when the preemption was a pool-change notice
    (elastic shrink/grow — ``pool``), and the attempt's goodput ledger
    (``train/metrics.py``) so a preempted attempt's wall-clock
    decomposition survives the exception path.
    """

    def __init__(self, step: int, resumed_step: Optional[int] = None,
                 save_s: Optional[float] = None,
                 grace_s: Optional[float] = None,
                 pool: Optional[int] = None,
                 ledger: Optional[dict] = None):
        self.step = step
        self.resumed_step = resumed_step
        self.save_s = save_s
        self.grace_s = grace_s
        self.pool = pool
        self.ledger = ledger
        saved = (f"checkpoint durable in {save_s:.2f}s"
                 if save_s is not None else "no checkpoint manager — "
                 "nothing saved")
        super().__init__(f"preempted at step {step} ({saved})")


def grace_s() -> float:
    """SIGTERM→SIGKILL window advertised by the platform."""
    return float(os.environ.get("PREEMPT_GRACE_S", DEFAULT_GRACE_S))


def _handler(signum, frame):  # pragma: no cover - exercised via trigger()
    request(source="SIGTERM")


def install() -> bool:
    """Install the SIGTERM handler (idempotent). Returns False when the
    caller is not the main thread (flag-based ``request`` still works)."""
    global _installed, _prev_handler
    with _lock:
        if _installed:
            return True
        try:
            _prev_handler = signal.signal(signal.SIGTERM, _handler)
        except ValueError:
            logger.warning(
                "cannot install SIGTERM handler outside the main thread; "
                "preemption is still honored via preempt.request()")
            return False
        _installed = True
    return True


def uninstall() -> None:
    """Restore the previous SIGTERM disposition (test teardown)."""
    global _installed, _prev_handler
    with _lock:
        if not _installed:
            return
        try:
            signal.signal(signal.SIGTERM,
                          _prev_handler if _prev_handler is not None
                          else signal.SIG_DFL)
        except ValueError:  # pragma: no cover - non-main-thread teardown
            pass
        _installed = False
        _prev_handler = None


def request(source: str = "request", pool: Optional[int] = None) -> None:
    """Mark this process as preempted; the loop exits at the next step
    boundary. Safe from signal handlers and any thread. ``pool`` names
    the surviving device count when the preemption is a pool-change
    notice (slice eviction / spot shrink / node return) — the trainer
    reads it off the raised :class:`Preempted` and re-forms the mesh."""
    global _deadline, _pool
    if pool is not None:
        _pool = int(pool)
    if not _flag.is_set():
        _deadline = time.monotonic() + grace_s()
        logger.warning(
            "preemption requested (%s): %.0fs grace window — will "
            "checkpoint at the next step boundary and exit 'preempted'",
            source, grace_s())
    _flag.set()


def pool_target() -> Optional[int]:
    """Surviving device count attached to the pending preemption, if
    the notice was a pool change (None = plain eviction of this job)."""
    return _pool


def trigger() -> None:
    """Deliver a preemption the way the platform would: a real SIGTERM
    when the handler is installed (exercising the signal path), the flag
    directly otherwise (non-main-thread workers)."""
    if _installed:
        os.kill(os.getpid(), signal.SIGTERM)
    else:
        request(source="trigger")


def requested() -> bool:
    return _flag.is_set()


def remaining_grace_s() -> Optional[float]:
    if _deadline is None:
        return None
    return max(0.0, _deadline - time.monotonic())


def reset() -> None:
    """Clear the flag (start of a fresh attempt — a retried attempt must
    not inherit the previous attempt's preemption)."""
    global _deadline, _pool
    _flag.clear()
    _deadline = None
    _pool = None
