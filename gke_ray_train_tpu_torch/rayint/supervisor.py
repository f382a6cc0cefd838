"""Heartbeat supervision (counterpart of
``gke_ray_train_tpu/rayint/supervisor.py``, the port's own copy):
step-granular liveness for training workers.

``RunConfig.worker_timeout_s`` bounds a whole attempt with one wall
clock, which forces the operator to guess total run time. This module
detects the actual failure signature of a wedged collective or dead
host instead: *no step progress for N seconds* (``HEARTBEAT_TIMEOUT_S``).

Workers report ``(rank, step)`` after every completed step through
``rayint/context.py`` (``ctx.heartbeat``); the sink is wired by the
trainer — a :class:`Supervisor` actor on Ray clusters, an in-process
:class:`HeartbeatBoard` + :class:`Watchdog` thread in the local path.
The trainer polls for stalls and kills the attempt with an error that
NAMES the stalled rank, so the operator learns which host to drain.

Arrival times are stamped by the receiving board (the trainer's or the actor's clock) —
worker clocks are never trusted across machines. A rank is tracked only
once it has beaten (model build/compile before the first step is not a
stall; ``worker_timeout_s`` still bounds that phase if set) and is
exempt once it reports done (a finished or failed worker is not a
stalled one).

Stdlib-only by design: importable by the trainer and the
Ray actor runtime without torch.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# (rank, last_step, seconds_since_last_progress)
StallInfo = Tuple[int, int, float]


class HeartbeatTimeout(RuntimeError):
    """An attempt killed because a named rank stopped making step
    progress. Retryable: workers resume from the latest checkpoint.

    ``slice_map`` (rank → slice index, per the ``slice_index`` contract
    in ``parallel/mesh.py``) scopes the failure domain: when EVERY
    stalled rank belongs to one slice (``uniform_slice``), the
    signature is a slice eviction/loss — the trainer classifies it as a
    *shrink* event (elastic re-form on the survivors) instead of a
    whole-job failure burning ``max_failures``."""

    def __init__(self, stalled: List[StallInfo], timeout_s: float,
                 slice_map: Optional[Dict[int, int]] = None):
        self.stalled = list(stalled)
        self.timeout_s = timeout_s
        self.slice_map = dict(slice_map or {})
        ranks = ", ".join(
            f"rank {r} (last step {s}, {age:.1f}s ago"
            + (f", slice {self.slice_map[r]}" if r in self.slice_map
               else "") + ")"
            for r, s, age in self.stalled)
        msg = (f"heartbeat timeout: no step progress for {timeout_s:g}s "
               f"from {ranks}; killed all workers for retry-with-resume")
        u = self.uniform_slice
        if u is not None:
            msg += (f" [every stalled rank is on slice {u} — "
                    "slice-loss signature]")
        super().__init__(msg)

    @property
    def uniform_slice(self) -> Optional[int]:
        """The single slice every stalled rank belongs to, or None when
        the stall spans slices (or no slice identity is known)."""
        if not self.stalled or not self.slice_map:
            return None
        slices = {self.slice_map.get(r) for r, _, _ in self.stalled}
        if len(slices) == 1 and None not in slices:
            return slices.pop()
        return None


def slice_shrink_pool(evicted_slice: int, slice_map: Dict[int, int],
                      chips_per_worker: float) -> int:
    """Surviving chip count after one slice's workers are written off —
    the pool the elastic trainer re-forms on when a stall has the
    slice-loss signature (every rank of ``slice_map`` is a worker)."""
    survivors = sum(1 for s in slice_map.values() if s != evicted_slice)
    return int(survivors * chips_per_worker)


class HeartbeatBoard:
    """Thread-safe rank → (step, arrival_time-of-last-PROGRESS) board.

    A beat only refreshes the clock when the step advanced — a worker
    re-reporting the same step is as stalled as one reporting nothing.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._last = {}      # rank -> (step, monotonic_time)
        self._done = set()
        self._slices = {}    # rank -> slice index (slice_index contract)

    def set_slices(self, mapping: Dict[int, int]) -> None:
        """Teach the board slice identity (rank → slice index) so stall
        reports carry the failure domain, not just the rank."""
        with self._lock:
            self._slices.update({int(r): int(s)
                                 for r, s in mapping.items()})

    def slice_map(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._slices)

    def beat(self, rank: int, step: int, done: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            if done:
                self._done.add(rank)
                return
            prev = self._last.get(rank)
            if prev is None or step > prev[0]:
                self._last[rank] = (int(step), now)

    def stalled(self, timeout_s: float,
                now: Optional[float] = None) -> List[StallInfo]:
        now = time.monotonic() if now is None else now
        with self._lock:
            return sorted(
                (rank, step, now - t)
                for rank, (step, t) in self._last.items()
                if rank not in self._done and now - t > timeout_s)

    def snapshot(self) -> dict:
        with self._lock:
            return {rank: {"step": step, "age_s": time.monotonic() - t,
                           "done": rank in self._done,
                           **({"slice": self._slices[rank]}
                              if rank in self._slices else {})}
                    for rank, (step, t) in self._last.items()}

    def metrics_view(self, timeout_s: Optional[float] = None) -> dict:
        """Serializable view: the per-rank last-beat age/step/slice
        snapshot plus — when a timeout is given — the ranks currently
        past it, BY NAME; JSON-safe by construction (string rank
        keys)."""
        snap = self.snapshot()
        view = {"ranks": {str(r): {k: (round(v, 3)
                                       if isinstance(v, float) else v)
                                   for k, v in info.items()}
                          for r, info in snap.items()}}
        if timeout_s is not None:
            view["timeout_s"] = float(timeout_s)
            view["stalled"] = [
                {"rank": r, "last_step": s, "age_s": round(age, 3)}
                for r, s, age in self.stalled(timeout_s)]
        return view


class Supervisor:
    """Actor body for the Ray path: ``ray.remote(Supervisor)`` in the
    trainer (decorating here would make Ray an import-time dependency).
    Workers fire-and-forget ``beat``; the trainer polls ``stalled``."""

    def __init__(self):
        self._board = HeartbeatBoard()

    def beat(self, rank: int, step: int, done: bool = False) -> None:
        self._board.beat(rank, step, done=done)

    def set_slices(self, mapping: Dict[int, int]) -> None:
        self._board.set_slices(mapping)

    def stalled(self, timeout_s: float) -> List[StallInfo]:
        return self._board.stalled(timeout_s)

    def snapshot(self) -> dict:
        return self._board.snapshot()

    def metrics_view(self, timeout_s: Optional[float] = None) -> dict:
        return self._board.metrics_view(timeout_s)


class Watchdog:
    """Local-path supervision: a daemon thread polling a board.

    On stall it records ``stalled_info`` and interrupts the main thread
    (the worker shares our process — a wedged collective ignores
    everything short of an interrupt); ``TorchTrainer._fit_local``
    converts that KeyboardInterrupt into :class:`HeartbeatTimeout`.

    Python runs a signal handler only once the main thread is back in
    the interpreter: a ``hang`` fault (a Python sleep) and a blocking
    syscall end there, but a collective wedged inside NCCL's C++ (a
    ``cudaStreamSynchronize`` that never returns) does not. On the local
    path such a hang outlives the timeout; only the Ray path's
    ``ray.kill`` of the worker process ends it (ROADMAP.md, known
    divergences).
    """

    def __init__(self, board: HeartbeatBoard, timeout_s: float,
                 poll_s: Optional[float] = None,
                 on_stall: Optional[Callable] = None,
                 pre_interrupt: Optional[Callable] = None):
        self.board = board
        self.timeout_s = timeout_s
        self.poll_s = poll_s if poll_s is not None else max(
            0.01, min(timeout_s / 4.0, 5.0))
        self.stalled_info: Optional[List[StallInfo]] = None
        self._on_stall = on_stall
        # best-effort hook fired with the stall list BEFORE the
        # interrupt, while the wedged attempt is still alive
        self._pre_interrupt = pre_interrupt
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="heartbeat-watchdog")

    def start(self) -> "Watchdog":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            stalled = self.board.stalled(self.timeout_s)
            if stalled:
                # confirmation read: a worker finishing exactly at the
                # detection boundary marks itself done in between — a
                # completed attempt must not be interrupted and retried
                time.sleep(min(0.05, self.poll_s))
                stalled = self.board.stalled(self.timeout_s)
            # re-check stop right before acting: a worker that completed
            # while we computed the stall must not be interrupted
            if stalled and not self._stop.is_set():
                self.stalled_info = stalled
                logger.error("%s", HeartbeatTimeout(stalled, self.timeout_s))
                if self._pre_interrupt is not None:
                    try:
                        self._pre_interrupt(stalled)
                    except Exception as e:  # noqa: BLE001 - never
                        logger.warning(    # block the kill on telemetry
                            "pre-interrupt hook failed: %s", e)
                if self._on_stall is not None:
                    self._on_stall(stalled)
                else:
                    # a real SIGINT to the process: unlike
                    # _thread.interrupt_main(), it EINTRs a main thread
                    # blocked in C (time.sleep, a dead collective's
                    # syscall) instead of waiting for its next bytecode
                    import os
                    import signal
                    os.kill(os.getpid(), signal.SIGINT)
                return
