"""Checkpointing with retention, resume and a write-ahead commit
(counterpart of ``gke_ray_train_tpu/ckpt/manager.py``), on
``torch.distributed.checkpoint``.

A step is a directory ``<directory>/<step>`` written by ``dcp.save`` into
``<step>.tmp`` and renamed into place, with the save's metrics in
``metrics.json``. What a state puts in it (:func:`flat_state`): for a
``TrainState`` the params (full fine-tuning, or a full-state view), the
LoRA adapters, the optimizer's per-parameter state keyed by the
trainable's name, ``opt/count`` and ``step``; for a (nested) dict its
leaves. A restore loads **in place into the live tensors** of the
template, because the train step checks the optimizer by identity, and
sets the counters.

Write-ahead commit, as in the JAX manager: every save is bracketed by
fsync'd markers beside the step directories,

    COMMITTING.<step>   (before any step data is written)
    COMMITTED.<step>    (after the step data is durable)

and a ``COMMITTING`` without its ``COMMITTED`` twin is the signature of
a death mid-commit. With ``async_commit`` (``ASYNC_CKPT=1``) ``save``
takes one device-to-host snapshot and returns; a committer thread writes
it behind the markers, and ``restore_if_available`` quarantines every
mid-commit step without a restore attempt. In the synchronous mode the
markers are advisory: ``latest_step`` never offers a marker-suspect
step, but the restore walk verifies it by restoring and heals the marker
on success. Marker-less step directories stay trusted.

The save gate, retention and ``best_step`` follow orbax's rules over
its step cache (step order at open, then save order): a save must pass
the last step saved and fall on ``save_interval_steps``, or be the
first; retention keeps the last ``max_to_keep`` saved with
``score_attribute=None``, else the ``max_to_keep`` best by that metric
(of equal scores the later saved) and every step saved without metrics;
a score metric missing from a save's metrics raises ``KeyError`` where
orbax ranks. Not ported yet: peer-slice replication
(``PEER_REPLICATION``, ROADMAP queue 1 item 8).

Across a ``torch.distributed`` world above one every rank calls
``save`` and the restores together: ``dcp`` writes each rank's shards of
a sharded state (DTensors: the params and optimizer state of a model
sharded with FSDP2) and one copy of what is replicated (the adapters),
and reads a step back into whatever placement the template has, so a
step saved at world N restores at world M, or into the plain tensors of
one process (:meth:`CheckpointManager.restore_resharded`); a pipeline
stage saves its own layers (and adapters) under their global names, so
a step saved over ``pipe`` restores at world 1 and back. Rank 0 alone
writes the markers, the metrics, the rename and ``topology.json`` (the
saving world's size, so a restore can say it resharded), between
barriers.

Async commit across ranks (the JAX manager's multi-host async save): the
snapshot of a rank's shards is ``dcp``'s CPU staging of its flat state
(DTensors keep their placements around CPU local shards), and each
rank's committer thread writes them through ``dcp.save`` over a gloo
group of its own, so its collectives never meet the training's on the
default group. The committers meet twice a commit in a MAX all-reduce
of the local tear flags (before the write and after it), so every rank
tears or commits the same step; rank 0 writes ``COMMITTED`` only after
the save returned, and ``dcp.save`` returns on rank 0 only once every
rank's files are written and fsync'd and their results gathered.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
import shutil
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

import torch

from gke_ray_train_tpu_torch.device import world_size

logger = logging.getLogger(__name__)

# write-ahead marker names; <name>.<step> files beside the step dirs
_WAL_OPEN = "COMMITTING"
_WAL_DONE = "COMMITTED"
METRICS_FILE = "metrics.json"
TOPOLOGY_NOTE = "topology.json"


def _barrier(group=None) -> None:
    if world_size() > 1:
        import torch.distributed as dist
        dist.barrier(group=group)


def _env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("", "0", "false", "no")


class CheckpointRestoreError(RuntimeError):
    """``torch.distributed.checkpoint`` failed to read or write a step."""


class CheckpointCommitError(RuntimeError):
    """The background committer failed or did not drain in time
    (``CKPT_COMMIT_TIMEOUT_S``), surfaced from ``wait()``."""


# ---------------------------------------------------------------------------
# what a state puts in a checkpoint
# ---------------------------------------------------------------------------

def _is_train_state(x: Any) -> bool:
    return dataclasses.is_dataclass(x) and all(
        hasattr(x, f) for f in ("params", "lora", "opt_state", "step"))


def flat_state(state: Any) -> Dict[str, Any]:
    """The flat ``{key: tensor or number}`` a checkpoint of ``state``
    holds. Tensors are detached views of the live ones (a load writes
    through them)."""
    out: Dict[str, Any] = {}
    if _is_train_state(state):
        from gke_ray_train_tpu_torch.train.step import trainable_tensors
        out["step"] = int(state.step)
        if state.params is not None:
            from gke_ray_train_tpu_torch.parallel.sharding import as_dtype
            for k, v in state.params.state_dict(keep_vars=True).items():
                if k.endswith(".codes"):
                    # the codes as a QTensor defines them, whatever byte
                    # dtype a sharded one holds them in
                    v = as_dtype(v, state.params.get_submodule(
                        k[:-len(".codes")]).code_dtype)
                out[f"params/{k}"] = v.detach()
        if state.lora is not None:
            # a pipeline stage's adapters under their global layers
            from gke_ray_train_tpu_torch.models.transformer import (
                lora_layer_ids)
            for i, layer in zip(lora_layer_ids(state.lora), state.lora):
                for t, ab in layer.items():
                    for k, v in ab.items():
                        out[f"lora/{i}.{t}.{k}"] = v.detach()
        opt = state.opt_state
        out["opt/count"] = int(opt.count)
        if state.params is not None or state.lora is not None:
            for name, p in trainable_tensors(state.params, state.lora):
                for k, v in opt.state[p].items():
                    out[f"opt/{name}/{k}"] = v.detach()
        return out

    def walk(prefix: str, x: Any) -> None:
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}{k}/", v)
        elif torch.is_tensor(x):
            out[prefix[:-1]] = x.detach()
        elif isinstance(x, (int, float)):
            out[prefix[:-1]] = x
        else:
            raise TypeError(f"cannot checkpoint {type(x).__name__} at "
                            f"{prefix[:-1]!r}")
    walk("", state)
    return out


def _apply_numbers(state: Any, flat: Dict[str, Any]) -> Any:
    """Set the restored numbers back into ``state`` (tensors were loaded
    in place already); returns ``state``."""
    if _is_train_state(state):
        state.step = int(flat["step"])
        state.opt_state.count = int(flat["opt/count"])
        return state

    def walk(prefix: str, x: dict) -> None:
        for k, v in x.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(key + "/", v)
            elif not torch.is_tensor(v):
                x[k] = flat[key]
    walk("", state)
    return state


def _host_snapshot(flat: Dict[str, Any]) -> Dict[str, Any]:
    """One device-to-host copy of every tensor. A card's tensors go into
    pinned memory without a wait each (a copy to pageable memory waits
    per tensor, and pinned blocks are reused across saves by torch's
    host allocator), then one wait for the card."""
    out: Dict[str, Any] = {}
    cards = set()
    for k, v in flat.items():
        if torch.is_tensor(v) and v.device.type == "cuda":
            out[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            out[k].copy_(v, non_blocking=True)
            cards.add(v.device)
        elif torch.is_tensor(v):
            out[k] = v.to("cpu", copy=True)
        else:
            out[k] = v
    for d in cards:
        torch.cuda.synchronize(d)
    return out


def _staged_snapshot(flat: Dict[str, Any]) -> Dict[str, Any]:
    """A rank's snapshot at a world above one: ``dcp``'s CPU staging of
    the flat state (a DTensor stays one, around a CPU copy of its local
    shard), then one wait for the card."""
    from torch.distributed.checkpoint.staging import BlockingAsyncStager
    out = BlockingAsyncStager().stage(flat)
    if any(torch.is_tensor(v) and v.device.type == "cuda"
           for v in flat.values()):
        torch.cuda.synchronize()
    return out


def _dcp_call(name: str, *args, collective: bool = True, **kwargs):
    """``dcp.save`` / ``dcp.load``: over the world's ranks when a world
    above one is up and ``collective``, else in this process. dcp raises
    its ``CheckpointException``, a ``BaseException``, which becomes a
    ``CheckpointRestoreError`` here so callers catch it as an error; its
    warning that with no process group it assumes one process is this
    manager's design, and is silenced."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.api import CheckpointException
    no_dist = not (collective and world_size() > 1)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process.*")
        try:
            return getattr(dcp, name)(*args, no_dist=no_dist, **kwargs)
        except CheckpointException as e:
            raise CheckpointRestoreError(f"dcp.{name}: {e}") from None


class CheckpointManager:
    """The JAX manager's contract on ``torch.distributed.checkpoint``."""

    def __init__(self, directory: str, *, max_to_keep: int = 1,
                 score_attribute: Optional[str] = "loss",
                 score_mode: str = "min", save_interval_steps: int = 1,
                 async_commit: Optional[bool] = None,
                 commit_timeout_s: Optional[float] = None,
                 storage_delay_s: Optional[float] = None,
                 peer: Any = None):
        if peer is None and _env_flag("PEER_REPLICATION"):
            peer = True
        if peer not in (None, False):
            raise NotImplementedError(
                "peer-slice replication (PEER_REPLICATION) is not ported "
                "yet (ROADMAP queue 1 item 8)")
        if score_mode not in ("min", "max"):
            raise ValueError(f"score_mode={score_mode!r} not in min / max")
        if async_commit is None:
            async_commit = _env_flag("ASYNC_CKPT")
        self.async_commit = bool(async_commit)
        self.world = world_size()
        self.is_writer = True
        # the committers' own group across ranks (module doc)
        self._commit_group = None
        if self.world > 1:
            import torch.distributed as dist
            self.is_writer = dist.get_rank() == 0
            if self.async_commit:
                self._commit_group = dist.new_group(backend="gloo")
        if commit_timeout_s is None:
            commit_timeout_s = float(
                os.environ.get("CKPT_COMMIT_TIMEOUT_S", "120"))
        self.commit_timeout_s = float(commit_timeout_s)
        if storage_delay_s is None:
            storage_delay_s = float(
                os.environ.get("CKPT_STORAGE_DELAY_S", "0"))
        # emulated storage latency per commit
        self.storage_delay_s = max(float(storage_delay_s), 0.0)
        self.directory = str(directory)
        if self.is_writer:
            os.makedirs(self.directory, exist_ok=True)
        _barrier()
        self.max_to_keep = int(max_to_keep)
        self.score_attribute = score_attribute
        self.score_mode = score_mode
        self.save_interval_steps = int(save_interval_steps)
        # "storage" | None: which path served the last
        # restore_if_available (the loop books restore_s off it)
        self.last_restore_source: Optional[str] = None
        # (saved world, restoring world) of the last restore that
        # resharded, else None
        self.last_restore_resharded: Optional[tuple] = None
        # async-commit machinery (committer thread started lazily)
        self._commit_lock = threading.Condition()
        self._commit_queue: list = []
        self._committing_now: Optional[int] = None
        self._abort_step: Optional[int] = None
        self._commit_error: Optional[BaseException] = None
        self._committer: Optional[threading.Thread] = None
        self._stop = False
        self.commits_done = 0
        # one {"step", "commit_s", "status": "ok" | "torn"} a background
        # commit (JAX emits each as its ``ckpt_commit`` event)
        self.commit_log: List[dict] = []
        self.last_torn_step: Optional[int] = None
        # steps already snapshot by this manager (the end-of-epoch save
        # re-offers the cadence save's step)
        self._snapshotted: set = set()
        # orbax's step cache: [(step, metrics or None)], read sorted from
        # disk at open and after a quarantine, appended in save order
        self._checkpoints: List[tuple] = []
        self._reload()

    # ------------------------------------------------------------------
    # layout

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _reload(self) -> None:
        """Re-read the step cache from disk, in step order."""
        steps = sorted(int(n) for n in os.listdir(self.directory)
                       if n.isdigit() and os.path.isdir(
                           os.path.join(self.directory, n)))
        self._checkpoints = [(s, self._metrics(s)) for s in steps]

    def all_steps(self) -> List[int]:
        """The steps this manager tracks, committed or not, in orbax's
        order: step order at open, then save order."""
        return [s for s, _ in self._checkpoints]

    def step_nbytes(self, step: int) -> int:
        """Bytes on disk of one saved step."""
        total = 0
        for root, _, files in os.walk(self._step_dir(step)):
            total += sum(os.path.getsize(os.path.join(root, f))
                         for f in files)
        return total

    def _metrics(self, step: int) -> Optional[dict]:
        try:
            with open(os.path.join(self._step_dir(step), METRICS_FILE)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # ------------------------------------------------------------------
    # write-ahead markers

    def _marker_path(self, kind: str, step: int) -> str:
        return os.path.join(self.directory, f"{kind}.{int(step)}")

    def _fsync_dir(self) -> None:
        try:
            dfd = os.open(self.directory, os.O_RDONLY)
        except OSError:  # pragma: no cover - directory raced away
            return
        try:
            os.fsync(dfd)
        except OSError:  # pragma: no cover - fs without dir fsync
            pass
        finally:
            os.close(dfd)

    def _write_marker(self, kind: str, step: int) -> None:
        """A marker, fsync'd (file then directory) so the ordering the
        recovery rule relies on survives a crash (rank 0's)."""
        if not self.is_writer:
            return
        fd = os.open(self._marker_path(kind, step),
                     os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
        try:
            os.write(fd, f"{kind} step={int(step)}\n".encode())
            os.fsync(fd)
        finally:
            os.close(fd)
        self._fsync_dir()

    def _remove_marker(self, kind: str, step: int) -> None:
        if not self.is_writer:
            return
        try:
            os.remove(self._marker_path(kind, step))
        except FileNotFoundError:
            pass

    def _mark_committed(self, step: int) -> None:
        self._write_marker(_WAL_DONE, step)
        self._remove_marker(_WAL_OPEN, step)

    def _step_eligible(self, step: int) -> bool:
        """A step is offered iff it is not mid-commit: COMMITTED wins; a
        bare COMMITTING means the writer died between the two records;
        no markers at all stay trusted."""
        if os.path.exists(self._marker_path(_WAL_DONE, step)):
            return True
        return not os.path.exists(self._marker_path(_WAL_OPEN, step))

    def _purge_uncommitted(self) -> None:
        """Async-commit recovery sweep: every COMMITTING-without-
        COMMITTED step never existed; quarantine it (or drop the orphan
        marker when the death came before any step data)."""
        # every rank reads the markers before rank 0 changes any, so the
        # ranks agree on what to quarantine (each quarantine is a barrier)
        pattern = os.path.join(self.directory, _WAL_OPEN + ".*")
        found = []
        for path in sorted(glob.glob(pattern)):
            try:
                step = int(os.path.basename(path).split(".", 1)[1])
            except (IndexError, ValueError):
                continue
            found.append((step,
                          os.path.exists(self._marker_path(_WAL_DONE, step)),
                          os.path.isdir(self._step_dir(step))))
        _barrier()
        for step, committed, has_dir in found:
            if committed:
                # the death came between COMMITTED and the cleanup
                self._remove_marker(_WAL_OPEN, step)
                continue
            logger.warning(
                "checkpoint step %d has a write-ahead marker but no "
                "commit record — the previous attempt died mid-commit; "
                "treating the step as never saved and falling back to "
                "the last committed one", step)
            if has_dir:
                self._quarantine(step)
            else:
                self._remove_marker(_WAL_OPEN, step)

    # ------------------------------------------------------------------
    # save

    def _should_save(self, step: int) -> bool:
        """orbax's rule: past the last step saved and on the interval,
        or the first save."""
        if self._checkpoints and self._checkpoints[-1][0] >= step:
            return False
        return step % self.save_interval_steps == 0 or not self._checkpoints

    def _by_score(self, infos: list) -> list:
        """The infos that carry metrics, worst first (orbax's sort: a
        stable one, so of equal scores the later saved ranks better);
        a metrics dict without the score attribute raises KeyError."""
        return sorted((i for i in infos if i[1] is not None),
                      key=lambda i: i[1][self.score_attribute],
                      reverse=self.score_mode == "min")

    def _write_step(self, step: int, flat: Dict[str, Any],
                    metrics: dict, group=None) -> None:
        """orbax's save of one step: ``dcp.save`` into ``<step>.tmp``,
        the metrics beside it when a score ranks the steps, one rename
        into place, then the step joins the cache and retention runs.
        ``group``: the process group of the save's collectives (default:
        the world's)."""
        if step in self.all_steps():
            raise FileExistsError(f"checkpoint step {step} already exists "
                                  f"in {self.directory}")
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if self.is_writer:
            shutil.rmtree(tmp, ignore_errors=True)
        _barrier(group)
        if group is None:
            _dcp_call("save", flat, checkpoint_id=tmp)
        else:
            _dcp_call("save", flat, checkpoint_id=tmp, process_group=group)
        kept = metrics if self.score_attribute is not None else None
        if self.is_writer:
            if kept is not None:
                with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                    json.dump(kept, f)
                    f.flush()
                    os.fsync(f.fileno())
            # a torn directory of this step the cache does not hold
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            self._fsync_dir()
            self._write_topology_note(step)
        _barrier(group)
        self._checkpoints.append((step, kept))
        self._retain()

    def _retain(self) -> None:
        """Delete the steps orbax's retention drops: with no score the
        last ``max_to_keep`` saved are kept, else the ``max_to_keep``
        best and every step saved without metrics. Their markers stay,
        as in the JAX manager."""
        infos, n = self._checkpoints, self.max_to_keep
        if len(infos) <= n:
            return
        if n == 0:
            keep = set()
        elif self.score_attribute is None:
            keep = {s for s, _ in infos[-n:]}
        else:
            keep = {s for s, _ in self._by_score(infos)[-n:]}
            keep |= {s for s, m in infos if m is None}
        self._checkpoints = [i for i in infos if i[0] in keep]
        for s, _ in infos:
            if s not in keep and self.is_writer:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def save(self, step: int, state: Any, metrics: Optional[dict] = None,
             force: bool = False) -> bool:
        """Save ``state`` as ``step``; False when the interval or an
        existing newer step refuses it (``force`` skips that gate)."""
        step = int(step)
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        if self.async_commit:
            return self._save_async(step, state, metrics, force)
        if not force and not self._should_save(step):
            return False
        self._write_marker(_WAL_OPEN, step)
        try:
            self._write_step(step, flat_state(state), metrics)
        except BaseException:
            self._remove_marker(_WAL_OPEN, step)
            raise
        if self.storage_delay_s:
            # the emulated storage round trip blocks the loop here
            time.sleep(self.storage_delay_s)
        self._mark_committed(step)
        _barrier()
        logger.info("checkpoint saved at step %d (metrics=%s)", step,
                    metrics)
        return True

    def _save_async(self, step: int, state: Any, metrics: dict,
                    force: bool) -> bool:
        """The caller-facing half of an async-commit save: one
        device-to-host snapshot, then enqueue for the committer."""
        if self._stop:
            # a torn manager is dead, like the process it stands in for
            return False
        if self._commit_error is not None:
            self.wait()  # re-raise the committer's failure loudly
        if step in self._snapshotted:
            return False
        if not force and not self._should_save(step):
            return False
        if self._commit_group is not None:
            host = _staged_snapshot(flat_state(state))
        else:
            host = _host_snapshot(flat_state(state))
        with self._commit_lock:
            self._ensure_committer()
            self._commit_queue.append((step, host, metrics))
            self._snapshotted.add(step)
            self._commit_lock.notify_all()
        logger.info("checkpoint snapshot taken at step %d "
                    "(commit queued; metrics=%s)", step, metrics)
        return True

    def _ensure_committer(self) -> None:
        if self._committer is None or not self._committer.is_alive():
            self._committer = threading.Thread(
                target=self._commit_loop, name="ckpt-committer",
                daemon=True)
            self._committer.start()

    def _commit_loop(self) -> None:
        while True:
            with self._commit_lock:
                while not self._commit_queue and not self._stop:
                    self._commit_lock.wait()
                if not self._commit_queue and self._stop:
                    return
                step, host, metrics = self._commit_queue.pop(0)
                self._committing_now = step
            try:
                self._commit_one(step, host, metrics)
            except Exception as e:  # noqa: BLE001 - surfaced in wait()
                logger.exception("background commit of step %d failed",
                                 step)
                with self._commit_lock:
                    if self._commit_error is None:
                        self._commit_error = e
                    self._committing_now = None
                    self._commit_lock.notify_all()
                continue
            with self._commit_lock:
                self._committing_now = None
                self.commits_done += 1
                self._commit_lock.notify_all()

    def _commit_one(self, step: int, host: Dict[str, Any],
                    metrics: dict) -> None:
        """COMMITTING -> serialize -> COMMITTED. A death anywhere inside
        leaves the COMMITTING signature."""
        t0 = time.perf_counter()
        self._write_marker(_WAL_OPEN, step)
        if self.storage_delay_s:
            time.sleep(self.storage_delay_s)
        aborted = self._agreed_abort(step)
        if not aborted:
            self._write_step(step, host, metrics, group=self._commit_group)
            aborted = self._agreed_abort(step)
        if aborted:
            # tear_mid_commit: the kill lands before COMMITTED
            logger.warning("commit of step %d torn mid-flight", step)
            self.commit_log.append({"step": step, "status": "torn",
                                    "commit_s": time.perf_counter() - t0})
            return
        self._mark_committed(step)
        _barrier(self._commit_group)
        self.commit_log.append({"step": step, "status": "ok",
                                "commit_s": time.perf_counter() - t0})
        logger.info("checkpoint committed at step %d (metrics=%s)", step,
                    metrics)

    def _agreed_abort(self, step: int) -> bool:
        """Whether ``step``'s commit is torn: this rank's flag, and across
        ranks any rank's (a MAX all-reduce on the committers' group)."""
        with self._commit_lock:
            aborted = self._abort_step == step
        if self._commit_group is None:
            return aborted
        import torch.distributed as dist
        flag = torch.tensor([int(aborted)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._commit_group)
        return bool(flag.item())

    def wait_until_committing(self, step: int,
                              timeout: Optional[float] = None) -> bool:
        """Block until the committer holds ``step`` (it left the queue
        and its commit began); False at once when ``step`` is neither
        queued nor in flight, and after ``timeout`` (default the commit
        timeout). The commit drill waits here so the kill lands inside
        the commit, not on a queue the committer has yet to reach."""
        deadline = time.monotonic() + (self.commit_timeout_s
                                       if timeout is None else timeout)
        with self._commit_lock:
            while self._committing_now != step:
                queued = any(int(q[0]) == step for q in self._commit_queue)
                if not queued or time.monotonic() > deadline:
                    return False
                self._commit_lock.wait(timeout=0.05)
        return True

    def tear_mid_commit(self, partial: bool = False) -> int:
        """Drill hook for a kill during a commit: freeze the in-flight
        commit in its mid-commit state (COMMITTING, no COMMITTED), purge
        anything else queued, and return the torn step. The manager is
        dead afterwards (further saves return False). ``partial``: where
        the kill lands on a commit that has not serialized yet, whether
        still queued or held by the committer before its write, leave the
        marker and a torn partial step directory, one state whichever way
        the race went (the ``FAULT_SPEC`` drill); without it a held
        commit torn before its write leaves its marker only, as the JAX
        manager's does. One process only: across ranks the committers
        agree where to tear."""
        if not self.async_commit:
            raise RuntimeError(
                "tear_mid_commit requires an async-commit manager "
                "(ASYNC_CKPT=1); the sync save path has no commit "
                "window to kill inside")
        if self._commit_group is not None:
            return self._tear_across_ranks()
        with self._commit_lock:
            if self._commit_queue:
                step = int(self._commit_queue[-1][0])
                self._commit_queue.clear()
                self._stop = True
                self._commit_lock.notify_all()
                in_flight = False
            elif self._committing_now is not None:
                step = int(self._committing_now)
                self._abort_step = step
                deadline = time.monotonic() + self.commit_timeout_s
                while self._committing_now is not None:
                    if time.monotonic() > deadline:  # pragma: no cover
                        raise CheckpointCommitError(
                            f"committer did not tear step {step} within "
                            f"{self.commit_timeout_s}s")
                    self._commit_lock.wait(timeout=0.05)
                self._stop = True
                self._commit_lock.notify_all()
                in_flight = True
            else:
                raise RuntimeError(
                    "kill_during_commit fired with no in-flight commit; "
                    "schedule it on a step the checkpoint cadence "
                    "actually saves")
        if not in_flight or (partial
                             and not os.path.isdir(self._step_dir(step))):
            # the kill landed between the write-ahead record and the
            # serialize: marker + a torn partial step directory
            self._write_marker(_WAL_OPEN, step)
            d = self._step_dir(step)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "_PARTIAL"), "wb") as f:
                f.write(b"\x00" * 64)
        self.last_torn_step = step
        logger.warning("checkpoint commit of step %d torn", step)
        return step

    def _tear_across_ranks(self) -> int:
        """``tear_mid_commit`` at a world above one: whether the newest
        step is still queued or in flight differs from rank to rank, so
        each rank marks it torn and lets its committer reach it; the
        committers' MAX all-reduce then tears it on every rank alike
        (before the write, leaving COMMITTING without data, or after it,
        leaving COMMITTING beside the step)."""
        with self._commit_lock:
            pending = [int(q[0]) for q in self._commit_queue]
            if self._committing_now is not None:
                pending.append(int(self._committing_now))
            if not pending:
                raise RuntimeError(
                    "kill_during_commit fired with no in-flight commit; "
                    "schedule it on a step the checkpoint cadence "
                    "actually saves")
            step = max(pending)
            self._abort_step = step
            deadline = time.monotonic() + self.commit_timeout_s
            while self._committing_now == step or any(
                    int(q[0]) == step for q in self._commit_queue):
                if time.monotonic() > deadline:  # pragma: no cover
                    raise CheckpointCommitError(
                        f"committer did not tear step {step} within "
                        f"{self.commit_timeout_s}s")
                self._commit_lock.wait(timeout=0.05)
            self._stop = True
            self._commit_lock.notify_all()
        self.last_torn_step = step
        logger.warning("checkpoint commit of step %d torn", step)
        return step

    # ------------------------------------------------------------------
    # topology note

    def _write_topology_note(self, step: int) -> None:
        """The saving world's size beside the steps (best-effort)."""
        try:
            with open(os.path.join(self.directory, TOPOLOGY_NOTE),
                      "w") as f:
                json.dump({"step": int(step), "n_devices": self.world}, f)
        except OSError as e:  # pragma: no cover - the note is best-effort
            logger.debug("could not write topology note: %s", e)

    def saved_topology(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.directory, TOPOLOGY_NOTE)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _note_reshard(self, step: int) -> None:
        """Log and record a restore onto another world size than the
        save's (the JAX manager's elastic-resume witness)."""
        self.last_restore_resharded = None
        note = self.saved_topology()
        saved = int(note.get("n_devices", 0)) if note else 0
        if saved and saved != self.world:
            self.last_restore_resharded = (saved, self.world)
            logger.warning(
                "checkpoint step %d was saved on %d ranks; restored "
                "RESHARDED onto %d (placements from the restore "
                "template)", step, saved, self.world)

    # ------------------------------------------------------------------
    # queries

    def latest_step(self) -> Optional[int]:
        steps = [s for s in self.all_steps() if self._step_eligible(s)]
        return max(steps) if steps else None

    def best_step(self) -> Optional[int]:
        """orbax's: the last step saved with no score, else the best
        scored one (of equal scores, the later saved)."""
        if self.score_attribute is None:
            return self._checkpoints[-1][0] if self._checkpoints else None
        ranked = self._by_score(self._checkpoints)
        return ranked[-1][0] if ranked else None

    # ------------------------------------------------------------------
    # restore

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Load ``step`` (default the latest) into ``state_like``'s
        tensors in place and set its counters; returns ``state_like``.
        Keys the checkpoint lacks raise; keys it holds beyond the
        template's are not read (a view restores from a full-state
        checkpoint)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        flat = flat_state(state_like)
        with torch.no_grad():
            _dcp_call("load", flat, checkpoint_id=self._step_dir(step))
        self._note_reshard(step)
        return _apply_numbers(state_like, flat)

    def restore_resharded(self, state_like: Any,
                          step: Optional[int] = None) -> Any:
        """Cross-topology restore: load ``step`` into ``state_like``'s
        placements, whatever the saving world was (``dcp`` reads each
        rank's part of the saved shards; a one-process template reads
        whole tensors). The JAX manager re-derives shardings from a spec
        tree on a new mesh; a port template already carries its
        placements (``make_train_state(mesh=)``). Sets
        ``last_restore_resharded``; returns ``state_like``."""
        return self.restore(state_like, step)

    def restore_raw(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Topology-free restore: the keys, shapes and dtypes come from
        the step's ``torch.distributed.checkpoint`` metadata, and every
        tensor lands on the CPU, so a host with no live state (a serving
        replica, a converter) can read a checkpoint. Returns the
        :func:`flat_state` keys nested at their first ``/``, with a
        train state's ``lora/<layer>.<target>.<a|b>`` entries as the
        port's per-layer adapter list."""
        from torch.distributed.checkpoint import FileSystemReader
        from torch.distributed.checkpoint.metadata import (
            TensorStorageMetadata)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = self._step_dir(step)
        meta = FileSystemReader(path).read_metadata()
        flat: Dict[str, Any] = {
            k: (torch.empty(tuple(m.size), dtype=m.properties.dtype)
                if isinstance(m, TensorStorageMetadata) else None)
            for k, m in meta.state_dict_metadata.items()}
        with torch.no_grad():
            _dcp_call("load", flat, checkpoint_id=path, collective=False)
        out: Dict[str, Any] = {}
        for key, v in flat.items():
            head, _, rest = key.partition("/")
            if not rest:
                out[key] = v
            else:
                out.setdefault(head, {})[rest] = v
        if isinstance(out.get("lora"), dict):
            layers: Dict[int, dict] = {}
            for key, v in out["lora"].items():
                i, target, ab = key.split(".")
                layers.setdefault(int(i), {}).setdefault(target, {})[ab] = v
            out["lora"] = [layers[i] for i in sorted(layers)]
        return out

    def _quarantine(self, step: int) -> str:
        """Move an unrestorable step aside (``<step>.corrupt``) so it
        never shadows a good checkpoint again, drop its markers (a later
        save of the step writes fresh ones) and re-read the step cache."""
        src = self._step_dir(step)
        dst = src + ".corrupt"
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = f"{src}.corrupt{n}"
        if os.path.isdir(src) and self.is_writer:
            shutil.move(src, dst)
        self._remove_marker(_WAL_OPEN, step)
        self._remove_marker(_WAL_DONE, step)
        _barrier()
        self._reload()
        return dst

    def restore_if_available(self, state_like: Any):
        """(state, resumed_step); (state_like, None) on a fresh start.

        In async-commit mode every mid-commit step is quarantined first,
        without a restore attempt. Then the latest step is verified by
        restoring it, with one retry; when it fails, the newest earlier
        restorable step is used and each newer unrestorable one is
        quarantined as ``<step>.corrupt``. When every step fails the
        first error re-raises and nothing is quarantined: that is a
        template / layout mismatch, and quarantining healthy checkpoints
        on a caller bug would destroy the run's resume points."""
        self.last_restore_source = None
        if self.async_commit:
            self._purge_uncommitted()
        steps = sorted(self.all_steps(), reverse=True)
        # sync mode: marker suspects are still verified below and
        # promoted on success
        suspects = {s for s in steps if not self._step_eligible(s)}
        if not steps:
            return state_like, None
        first_err: Optional[Exception] = None
        failed: list = []
        for step in steps:
            out = err = None
            for attempt in range(2):
                try:
                    out = self.restore(state_like, step)
                    err = None
                    break
                except Exception as e:  # noqa: BLE001 - classified below
                    err = e
                    if attempt == 0:
                        logger.warning(
                            "restore of step %d failed (%s: %s); retrying "
                            "once before treating it as corrupt", step,
                            type(e).__name__, e)
            if err is not None:
                first_err = first_err if first_err is not None else err
                failed.append((step, err))
                continue
            for bad, bad_err in failed:
                logger.warning(
                    "checkpoint step %d is unrestorable (%s: %s); "
                    "quarantining it and resuming from step %d",
                    bad, type(bad_err).__name__, bad_err, step)
                self._quarantine(bad)
            if step in suspects:
                # the save was durable: only the marker flush was lost
                self._mark_committed(step)
            self.last_restore_source = "storage"
            logger.info("resuming from checkpoint step %d in %s", step,
                        self.directory)
            return out, step
        raise first_err

    # ------------------------------------------------------------------
    # lifecycle

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every save is committed (call before exit). In
        async-commit mode this drains the committer queue, bounded by
        ``CKPT_COMMIT_TIMEOUT_S``, and re-raises a background failure."""
        if not self.async_commit:
            return
        budget = self.commit_timeout_s if timeout is None else float(timeout)
        deadline = time.monotonic() + budget
        with self._commit_lock:
            while self._commit_queue or self._committing_now is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise CheckpointCommitError(
                        f"checkpoint commit queue did not drain within "
                        f"{budget}s (CKPT_COMMIT_TIMEOUT_S)")
                self._commit_lock.wait(timeout=min(remaining, 0.1))
            if self._commit_error is not None:
                err = self._commit_error
                self._commit_error = None
                raise CheckpointCommitError(
                    "background checkpoint commit failed") from err

    def close(self) -> None:
        if self._committer is not None and self._committer.is_alive():
            with self._commit_lock:
                self._stop = True
                self._commit_lock.notify_all()
            self._committer.join(timeout=self.commit_timeout_s)
