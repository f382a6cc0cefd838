"""Deterministic fault injection (counterpart of
``gke_ray_train_tpu/testing/faults.py``, the port's own copy).

``FAULT_SPEC`` causes each failure the fault-tolerance layer handles at
an exact step: the train loop (``train/loop.py``) calls
:meth:`FaultInjector.on_step` after every completed step, on one card,
on every rank of a ``torch.distributed`` world (the variable reaches
every rank through the environment) and in every attempt of a
``rayint/trainer.py::TorchTrainer``.

Grammar, ``;``-separated entries of ``:``-separated ``key=value``
fields::

    FAULT_SPEC="rank=1:kind=kill:step=5;rank=*:kind=sigterm:step=8"

- ``kind`` (required): ``kill`` (raise :class:`InjectedKill`: the worker
  dies), ``hang`` (sleep ``seconds``: a wedged collective), ``sigterm``
  (a preemption, ``train/preempt.py``), ``ckpt_truncate`` (cut the
  newest checkpoint step's largest file in half: a torn tail),
  ``pool_shrink`` (the pool of ranks changes to ``to``: recorded in the
  pool registry, and a preemption carrying it is delivered),
  ``slice_evict`` (slice ``slice``, default the last, is lost: its
  ranks leave the pool, delivered as ``pool_shrink`` delivers it;
  slices are ``$NUM_SLICES``'s contiguous blocks of the world's ranks,
  ``parallel/mesh.py::slice_assignments``), ``kill_during_commit`` (freeze the async committer's
  in-flight commit in its COMMITTING-without-COMMITTED state,
  ``ckpt/manager.py::tear_mid_commit``, then die; needs an
  ``ASYNC_CKPT=1`` manager).
- ``step`` (required int): the global step after which it fires.
- ``rank`` (int or ``*``, default ``*``): which rank fires it.
- ``seconds`` (``hang`` only, default 3600).
- ``to`` (``pool_shrink`` only, required): the surviving number of
  ranks; above the current pool it is a grow.
- ``slice`` (``slice_evict`` only).

Each entry fires at most once per run: the fired registry is module-
global (an in-process retry does not re-fire) and, with a checkpoint
manager bound, a marker file beside the checkpoints keeps it spent for
a fresh worker process. Tests call :func:`reset_fired` between cases.

Stdlib only at import: importable without torch.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
import time
from typing import List, Optional

logger = logging.getLogger(__name__)

KINDS = ("kill", "hang", "sigterm", "ckpt_truncate", "pool_shrink",
         "slice_evict", "kill_during_commit")
_FIELDS = ("rank", "kind", "step", "seconds", "to", "slice")


class InjectedKill(RuntimeError):
    """A deliberately killed worker (retryable, like the real thing)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    step: int
    rank: str = "*"          # "*" or the decimal rank
    seconds: float = 3600.0  # hang duration
    to: Optional[int] = None       # pool_shrink: surviving rank count
    slice: Optional[int] = None    # slice_evict: which slice dies

    def matches(self, rank: int, step: int) -> bool:
        return self.step == step and (
            self.rank == "*" or int(self.rank) == rank)


def parse_fault_spec(spec: str) -> List[FaultSpec]:
    """Parse the grammar; anything it does not understand raises
    ValueError (a typo'd fault must fail loudly, not silently not fire)."""
    out = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        fields = {}
        for part in entry.split(":"):
            if "=" not in part:
                raise ValueError(
                    f"FAULT_SPEC field {part!r} is not key=value "
                    f"(entry {entry!r})")
            k, v = part.split("=", 1)
            if k not in _FIELDS:
                raise ValueError(
                    f"FAULT_SPEC unknown field {k!r} (entry {entry!r}); "
                    f"known: {_FIELDS}")
            fields[k] = v
        if "kind" not in fields or "step" not in fields:
            raise ValueError(
                f"FAULT_SPEC entry {entry!r} needs kind= and step=")
        if fields["kind"] not in KINDS:
            raise ValueError(
                f"FAULT_SPEC unknown kind {fields['kind']!r}; "
                f"known: {KINDS}")
        rank = fields.get("rank", "*")
        if rank != "*":
            int(rank)  # fail fast on garbage
        if fields["kind"] == "pool_shrink" and "to" not in fields:
            raise ValueError(
                f"FAULT_SPEC kind=pool_shrink needs to=<surviving "
                f"device count> (entry {entry!r})")
        for f, kinds in (("to", ("pool_shrink",)),
                         ("slice", ("slice_evict",)),
                         ("seconds", ("hang",))):
            if f in fields and fields["kind"] not in kinds:
                raise ValueError(
                    f"FAULT_SPEC field {f}= only applies to kind in "
                    f"{kinds} (entry {entry!r})")
        out.append(FaultSpec(
            kind=fields["kind"], step=int(fields["step"]), rank=rank,
            seconds=float(fields.get("seconds", 3600.0)),
            to=int(fields["to"]) if "to" in fields else None,
            slice=int(fields["slice"]) if "slice" in fields else None))
    return out


# process-global: an in-process retry (which builds a new injector from
# the environment) must not re-fire a spent fault; the marker file below
# extends that to fresh worker processes
_FIRED = set()

MARKER_NAME = ".fault_spec_fired"


def reset_fired() -> None:
    _FIRED.clear()


# ---------------------------------------------------------------------------
# the emulated pool of ranks: infrastructure state behind pool faults
# ---------------------------------------------------------------------------

# current pool size (None = the full pool). It outlives the attempt, as a
# spot nodepool's size does, and is persisted beside the checkpoints so a
# fresh worker process sees it too.
_POOL: Optional[int] = None

POOL_MARKER_NAME = ".elastic_pool"


def set_pool(n_devices: int, ckpt_manager=None) -> None:
    """Record the pool size (persisted beside the checkpoints when a
    manager is bound)."""
    global _POOL
    _POOL = int(n_devices)
    if ckpt_manager is None:
        return
    try:
        with open(os.path.join(str(ckpt_manager.directory),
                               POOL_MARKER_NAME), "w") as f:
            f.write(str(_POOL))
    except OSError as e:  # pragma: no cover - the marker is best-effort
        logger.debug("could not persist pool marker: %s", e)


def current_pool(ckpt_dir: Optional[str] = None) -> Optional[int]:
    """The pool size: the in-process registry, then the persisted marker,
    else None (the full pool). A marker that is present but unreadable
    raises: the pool is then unknown, and assuming the full one would
    re-form the mesh on ranks that may not exist."""
    if _POOL is not None:
        return _POOL
    if ckpt_dir:
        path = os.path.join(str(ckpt_dir), POOL_MARKER_NAME)
        try:
            with open(path) as f:
                return int(f.read().strip())
        except FileNotFoundError:
            pass
        except (OSError, ValueError) as e:
            raise RuntimeError(
                f"elastic pool marker {path} exists but is unreadable "
                f"({type(e).__name__}: {e}); refusing to assume the "
                "full pool — repair or remove the marker") from e
    return None


def reset_pool() -> None:
    global _POOL
    _POOL = None


def _rank_from_env() -> int:
    return int(os.environ.get("RANK", os.environ.get("PROCESS_ID", "0")))


class FaultInjector:
    """The step-boundary hook the train loop calls (``on_step``)."""

    def __init__(self, specs: List[FaultSpec], *, rank: int = 0,
                 ckpt_manager=None):
        self.specs = list(specs)
        self.rank = int(rank)
        self.ckpt_manager = ckpt_manager

    @staticmethod
    def from_env(rank: Optional[int] = None,
                 ckpt_manager=None) -> Optional["FaultInjector"]:
        """The injector of ``$FAULT_SPEC``, or None when it is unset. The
        rank defaults to ``RANK`` (torchrun, the trainer's Ray path), else
        ``PROCESS_ID``."""
        raw = os.environ.get("FAULT_SPEC", "").strip()
        if not raw:
            return None
        if rank is None:
            rank = _rank_from_env()
        return FaultInjector(parse_fault_spec(raw), rank=rank,
                             ckpt_manager=ckpt_manager)

    def bind_ckpt(self, ckpt_manager) -> None:
        if self.ckpt_manager is None:
            self.ckpt_manager = ckpt_manager

    def _marker_path(self) -> Optional[str]:
        if self.ckpt_manager is None:
            return None
        return os.path.join(str(self.ckpt_manager.directory), MARKER_NAME)

    def _marker_key(self, spec: FaultSpec) -> str:
        key = f"rank{self.rank}:{spec.kind}@{spec.step}:match={spec.rank}"
        if spec.to is not None:
            key += f":to={spec.to}"
        if spec.slice is not None:
            key += f":slice={spec.slice}"
        return key

    def _already_fired(self, spec: FaultSpec) -> bool:
        if (self.rank, spec) in _FIRED:
            return True
        path = self._marker_path()
        if path is None:
            return False
        try:
            with open(path) as f:
                text = f.read()
        except FileNotFoundError:
            return False
        except OSError:
            # present but unreadable: at most once must hold
            logger.warning("fired-fault marker %s is unreadable; "
                           "treating every fault as already fired", path)
            return True
        key = self._marker_key(spec)
        lines = text.splitlines()
        if key in lines:
            return True
        # a torn last line, a strict prefix of the key: the attempt that
        # fired the fault was killed mid-append, so it did fire
        if text and not text.endswith("\n") and lines:
            tail = lines[-1]
            if tail and key.startswith(tail):
                return True
        return False

    def _mark_fired(self, spec: FaultSpec) -> None:
        _FIRED.add((self.rank, spec))
        path = self._marker_path()
        if path is None:
            return
        try:
            with open(path, "a") as f:
                f.write(self._marker_key(spec) + "\n")
        except OSError as e:  # pragma: no cover - the marker is best-effort
            logger.debug("could not persist fired-fault marker: %s", e)

    def on_step(self, step: int) -> None:
        for spec in self.specs:
            if spec.matches(self.rank, step) and \
                    not self._already_fired(spec):
                self._mark_fired(spec)
                self._fire(spec, step)

    def _fire(self, spec: FaultSpec, step: int) -> None:
        logger.warning("FAULT_SPEC firing kind=%s at step %d (rank %d)",
                       spec.kind, step, self.rank)
        if spec.kind == "kill":
            raise InjectedKill(
                f"injected kill at step {step} (rank {self.rank})")
        if spec.kind == "kill_during_commit":
            self._kill_during_commit(step)
        if spec.kind == "hang":
            time.sleep(spec.seconds)
        elif spec.kind == "sigterm":
            from gke_ray_train_tpu_torch.train import preempt
            preempt.trigger()
        elif spec.kind == "ckpt_truncate":
            self._truncate_latest(step)
        elif spec.kind == "pool_shrink":
            self._pool_change(spec.to, step, reason="pool_shrink")
        elif spec.kind == "slice_evict":
            survivors, evicted = self._slice_evict_target(spec)
            self._pool_change(survivors, step,
                              reason=f"slice_evict:slice={evicted}")

    def _pool_change(self, n_devices: int, step: int,
                     reason: str) -> None:
        """A pool-change notice as the platform delivers it: the
        surviving size lands in the registry and a preemption carrying it
        is requested, so the loop saves in its grace window and the
        trainer re-forms the world on the survivors."""
        set_pool(n_devices, self.ckpt_manager)
        from gke_ray_train_tpu_torch.train import preempt
        preempt.request(source=f"{reason}@step{step}", pool=n_devices)

    def _slice_evict_target(self, spec: FaultSpec):
        """(surviving rank count, evicted slice index) of a slice_evict
        fault: slice identity through ``slice_assignments`` over the
        world's ranks and ``$NUM_SLICES`` (JAX's :345-370)."""
        from gke_ray_train_tpu_torch.parallel.mesh import (
            is_distributed, slice_assignments)
        if is_distributed():
            import torch.distributed as dist
            world = dist.get_world_size()
        else:
            world = int(os.environ.get("WORLD_SIZE", "1"))
        # default 1 like every other slice-identity reader: an unset
        # NUM_SLICES is a single-domain pool, whose only slice cannot go
        num_slices = int(os.environ.get("NUM_SLICES", "1"))
        assign = slice_assignments(range(world), num_slices)
        evicted = spec.slice if spec.slice is not None else max(assign)
        if evicted not in assign:
            raise RuntimeError(
                f"FAULT_SPEC slice_evict: slice {evicted} does not "
                f"exist (slices present: {sorted(set(assign))})")
        survivors = sum(1 for s in assign if s != evicted)
        if survivors == 0:
            raise RuntimeError(
                "FAULT_SPEC slice_evict would evict the ENTIRE pool — "
                "use kind=sigterm for a whole-job eviction")
        return survivors, evicted

    def _kill_during_commit(self, step: int) -> None:
        """Freeze the in-flight commit mid-commit (COMMITTING without
        COMMITTED), then die: the resumed attempt must treat the torn
        step as never saved."""
        mgr = self.ckpt_manager
        if mgr is None:
            raise RuntimeError(
                "FAULT_SPEC kind=kill_during_commit needs a checkpoint "
                "manager bound to the injector (run with checkpointing "
                "enabled)")
        if not getattr(mgr, "async_commit", False):
            raise RuntimeError(
                "FAULT_SPEC kind=kill_during_commit requires an "
                "async-commit checkpoint manager (ASYNC_CKPT=1) — the "
                "sync save path has no background commit window to "
                "kill inside")
        # the kill lands inside the commit of the step just saved, and
        # leaves one state on disk whichever way the race with the
        # committer went (ckpt/manager.py::tear_mid_commit)
        mgr.wait_until_committing(step)
        torn = mgr.tear_mid_commit(partial=True)
        raise InjectedKill(
            f"injected kill during commit of step {torn} "
            f"(fired at step {step}, rank {self.rank})")

    def _truncate_latest(self, step: int) -> None:
        """Tear the newest checkpoint step as an interrupted save does:
        cut its largest data file in half. Its restore then fails and the
        manager falls back (``ckpt/manager.py``)."""
        mgr = self.ckpt_manager
        if mgr is None:
            raise RuntimeError(
                "FAULT_SPEC kind=ckpt_truncate needs a checkpoint "
                "manager bound to the injector (run with checkpointing "
                "enabled)")
        mgr.wait()  # the torn tail must be of a committed save
        latest = mgr.latest_step()
        if latest is None:
            raise RuntimeError(
                f"FAULT_SPEC ckpt_truncate at step {step}: no checkpoint "
                "saved yet (schedule the fault after a save step)")
        step_dir = os.path.join(str(mgr.directory), str(latest))
        files = [f for f in glob.glob(os.path.join(step_dir, "**", "*"),
                                      recursive=True) if os.path.isfile(f)]
        if not files:
            raise RuntimeError(f"ckpt_truncate: no files under {step_dir}")
        files.sort(key=os.path.getsize, reverse=True)
        target = files[0]
        size = os.path.getsize(target)
        with open(target, "r+b") as f:
            f.truncate(max(1, size // 2))
        logger.warning(
            "truncated %s (%d -> %d bytes): checkpoint step %d is now a "
            "corrupt tail", target, size, max(1, size // 2), latest)
