"""Worker train context (counterpart of
``gke_ray_train_tpu/rayint/context.py``, the port's own copy): the
``ray.train.get_context()`` / ``train.report`` surface a worker function
relies on, for one process or a rank of a ``torch.distributed`` world
(:meth:`TrainContext.is_host0` is rank 0). The training loop records the
step it resumed from (:meth:`TrainContext.note_resume`) and its goodput
ledger (:meth:`TrainContext.note_goodput`) here.

Stdlib only. The trainer (``trainer.py``) wires its heartbeat sink and
reads what the loop recorded here.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


def _group():
    """``torch.distributed`` when a process group is up (imported only
    if torch is already loaded), else None."""
    import sys
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist
    return None


class TrainContext:
    def __init__(self):
        self.last_reported: Optional[dict] = None
        # step the current attempt resumed from (None = fresh start);
        # set by the train loop, read into Result.attempt_log
        self.resumed_step: Optional[int] = None
        # the attempt's goodput ledger (train/metrics.py LEDGER_TERMS),
        # set by the loop's exit path on success AND failure — on the
        # local trainer path it survives a crashed attempt where the
        # worker payload does not
        self.goodput: Optional[dict] = None
        # fingerprint of the ExecutionPlan the attempt ran under (set
        # by _run_worker after resolve/replan) — attempt_log provenance
        self.plan_fingerprint: Optional[str] = None
        # heartbeat sink wired by the trainer: callable(rank, step, done)
        # forwarding to the supervisor actor (Ray) or the local board
        self._heartbeat = None

    def get_world_size(self) -> int:
        """The ``torch.distributed`` world when a group is up, else
        ``WORLD_SIZE`` (torchrun, Ray Train), else ``NUM_PROCESSES``."""
        dist = _group()
        if dist is not None:
            return dist.get_world_size()
        return int(os.environ.get("WORLD_SIZE",
                                  os.environ.get("NUM_PROCESSES", "1")))

    def get_world_rank(self) -> int:
        """The group's rank when a group is up, else ``RANK``, else
        ``PROCESS_ID``."""
        dist = _group()
        if dist is not None:
            return dist.get_rank()
        return int(os.environ.get("RANK", os.environ.get("PROCESS_ID", "0")))

    def get_local_rank(self) -> int:
        """This process's card on its host (``LOCAL_RANK``; one rank per
        card)."""
        return int(os.environ.get("LOCAL_RANK", "0"))

    def is_host0(self) -> bool:
        return self.get_world_rank() == 0

    def set_heartbeat_sink(self, fn) -> None:
        self._heartbeat = fn

    def heartbeat(self, step: int, done: bool = False) -> None:
        """Report step progress to the supervisor (rayint/supervisor.py).
        Best-effort: liveness reporting must never kill a live worker."""
        if self._heartbeat is None:
            return
        try:
            self._heartbeat(self.get_world_rank(), int(step), done)
        except Exception as e:  # noqa: BLE001
            logger.debug("heartbeat dropped: %s", e)

    def heartbeat_done(self) -> None:
        """Mark this rank finished — a done worker is never 'stalled'."""
        self.heartbeat(-1, done=True)

    def note_resume(self, step: Optional[int]) -> None:
        self.resumed_step = step

    def note_goodput(self, ledger: Optional[dict]) -> None:
        self.goodput = dict(ledger) if ledger is not None else None

    def report(self, metrics: dict, checkpoint_path: Optional[str] = None):
        """train.report parity: metrics become the trainer Result. Unlike
        Ray Train this is not a barrier — collective synchronization
        belongs to the collectives themselves (orbax save / psum), not to
        the metrics channel."""
        self.last_reported = dict(metrics)
        if checkpoint_path:
            self.last_reported["checkpoint_path"] = checkpoint_path
        if self.is_host0():
            logger.info("report: %s", self.last_reported)


_context = TrainContext()


def get_context() -> TrainContext:
    return _context


def report(metrics: dict, checkpoint_path: Optional[str] = None) -> None:
    _context.report(metrics, checkpoint_path)
