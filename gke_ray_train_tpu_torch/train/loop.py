"""Host-side training loop (counterpart of
``gke_ray_train_tpu/train/loop.py``).

Per-epoch batch iteration, logging every ``log_every`` steps (loss, LR,
tokens/s per card, MFU, input stall), eval every ``eval_every`` steps,
checkpoints, the end-of-epoch report, resume fast-forward, the SIGTERM
preemption exit and the goodput ledger, line for line as in the JAX
loop. PyTorch's idiom in its place:

- the step runs eagerly, so the first step's ``compile_s`` is its wall
  time (kernel libraries loaded, cuBLAS and the allocator warmed; no
  trace, no compile), ended by a ``torch.cuda.synchronize`` on the
  state's device where JAX blocks on the loss;
- the metrics of a log step reach the host in one copy
  (:func:`_fetch_metrics`);
- ``TRANSFER_GUARD`` is ``torch.cuda.set_sync_debug_mode``
  (``analysis/guards.py``), and every sanctioned wait on the card runs
  inside ``allow_transfers()``.

The checkpoint manager is ``ckpt/manager.py::CheckpointManager``; any
object with ``restore_if_available`` / ``save`` / ``wait`` /
``latest_step``, optionally ``async_commit`` and
``last_restore_source``, serves. Across a ``torch.distributed`` world
every rank exits a preemption at the same boundary: every
``PREEMPT_SYNC_EVERY`` boundaries the local SIGTERM flags meet in a MAX
all-reduce (:func:`agree_preempt`), and off-cycle boundaries never
exit. ``FAULT_SPEC`` fires its faults after each completed step
(``testing/faults.py``). Not ported yet: the telemetry hooks (ROADMAP
queue 1 item 9).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from gke_ray_train_tpu_torch.analysis.guards import (
    RuntimeGuards, allow_transfers)
from gke_ray_train_tpu_torch.data.prefetch import make_batch_source
from gke_ray_train_tpu_torch.device import synchronize, world_size
from gke_ray_train_tpu_torch.rayint.context import get_context
from gke_ray_train_tpu_torch.train import preempt
from gke_ray_train_tpu_torch.train.metrics import (
    GoodputLedger, ThroughputMeter, paused)
from gke_ray_train_tpu_torch.train.step import TrainState

logger = logging.getLogger(__name__)


def agree_preempt(local: bool) -> bool:
    """Any rank's preemption flag, on every rank: a MAX all-reduce of
    the local flag over the world (on the group's device: the card under
    NCCL)."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel.mesh import collective_device
    flag = torch.tensor([1 if local else 0], dtype=torch.int32,
                        device=collective_device())
    with allow_transfers():
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())


def _fetch_metrics(m: dict) -> dict:
    """ONE host copy for the whole metrics dict: the 0-dim tensors are
    stacked (in float64, exact for their fp32 / integer values) and
    copied once, inside the transfer guard's allow-list; Python numbers
    (``learning_rate``) pass through."""
    with allow_transfers():
        keys = [k for k, v in m.items() if torch.is_tensor(v)]
        vals = {}
        if keys:
            host = torch.stack([m[k].detach().reshape(()).double()
                                for k in keys]).cpu().tolist()
            vals = dict(zip(keys, host))
        return {k: float(vals[k]) if k in vals else float(v)
                for k, v in m.items()}


def _state_device(state: TrainState) -> torch.device:
    return state.params.embed.device


def _wait(state: TrainState) -> None:
    """Wait for the state's device (nothing on the CPU)."""
    with allow_transfers():
        synchronize(_state_device(state))


def run_training(state: TrainState,
                 train_step: Callable,
                 epoch_batches: Callable[[int], Iterable],
                 *,
                 epochs: int = 1,
                 steps_per_epoch: Optional[int] = None,
                 log_every: int = 20,
                 meter: Optional[ThroughputMeter] = None,
                 ckpt_manager=None,
                 report_fn: Optional[Callable] = None,
                 eval_fn: Optional[Callable] = None,
                 eval_every: Optional[int] = None,
                 eval_at_epoch_end: bool = False,
                 ckpt_every: Optional[int] = None,
                 place_batch: Optional[Callable] = None,
                 prefetch: int = 0,
                 ckpt_view: Optional[tuple] = None,
                 profiler=None,
                 tb_writer=None,
                 heartbeat_fn: Optional[Callable] = None,
                 fault_injector=None,
                 guards: Optional[RuntimeGuards] = None,
                 is_host0: bool = True) -> tuple:
    """Returns (final_state, last_metrics).

    last_metrics carries two timings beside the step metrics:
    ``compile_s`` (wall time of the first step call, to a synchronize on
    the state's device: in eager PyTorch that is the warm-up, not a
    compile) and ``restart_to_first_step_s`` (entry to the first
    completed step: restore + fast-forward + first step).

    epoch_batches(epoch) -> iterable of numpy batch dicts.
    place_batch(batch) -> the batch on the card
    (``data/prefetch.py::make_place_batch``); default as is (the step
    places it). prefetch: queue depth of the asynchronous input pipeline
    (``data/prefetch.py``): a background thread runs the epoch iterator
    and ``place_batch`` ahead of the step; 0 = inline (the same batch
    stream either way; resume fast-forward never places skipped
    batches). With a meter, the share of the train window spent blocked
    on the pipeline is ``data_stall_frac``.
    report_fn(metrics) -> the trainer context's report.
    ckpt_view: optional (save_view, load_view) pair mapping the state to
    the part the checkpoint persists (LoRA: adapters and optimizer).
    heartbeat_fn(step, done=False) -> per-step liveness report, after
    every completed step, and with done=True at loop exit.
    fault_injector: fault hook called once per completed step
    (``bind_ckpt``, ``on_step``); None = ``FAULT_SPEC``'s
    (``testing/faults.py::FaultInjector.from_env``, bound to the
    checkpoint manager), or none when it is unset.
    guards: runtime guards (``analysis/guards.py``); None = from env.
    ``KERNELCHECK=1`` runs ``analysis/kernelcheck.py::quick_verify`` on
    the state's device before anything trains.

    Preemption (``train/preempt.py``): with the SIGTERM flag up at a
    step boundary the loop force-saves a checkpoint, waits until it is
    durable, and raises ``Preempted`` carrying the goodput ledger.
    """
    # the clock starts before the restore: restart_to_first_step_s
    # covers restore + fast-forward + first step
    t_loop0 = time.perf_counter()
    loop_timing: dict = {}
    # per-attempt goodput ledger: every second of this call decomposes
    # into LEDGER_TERMS; it is parked on the context at exit
    ledger = GoodputLedger()
    if guards is None:
        guards = RuntimeGuards.from_config()
    # KERNELCHECK=1: every registered kernel's first case against its
    # oracle before anything trains, so a disagreement fails the attempt
    # instead of corrupting a run
    if os.environ.get("KERNELCHECK", "0").lower() not in (
            "", "0", "false", "no", "off"):
        from gke_ray_train_tpu_torch.analysis.kernelcheck import (
            quick_verify)
        quick_verify(device=_state_device(state), log=logger.info)
    save_view = (ckpt_view[0] if ckpt_view else (lambda st: st))
    load_view = (ckpt_view[1] if ckpt_view else (lambda st, v: v))
    if fault_injector is None:
        # FAULT_SPEC drills (testing/faults.py): None when it is unset
        from gke_ray_train_tpu_torch.testing.faults import FaultInjector
        fault_injector = FaultInjector.from_env(ckpt_manager=ckpt_manager)
    elif ckpt_manager is not None:
        fault_injector.bind_ckpt(ckpt_manager)
    resumed_step = None
    if ckpt_manager is not None:
        t_restore0 = time.perf_counter()
        try:
            view, resumed = ckpt_manager.restore_if_available(
                save_view(state))
            if resumed is not None:
                state = load_view(state, view)
        except Exception as e:  # noqa: BLE001 - layout-mismatch fallback
            if ckpt_view is None:
                raise
            # a checkpoint written before the view existed stores the
            # full state: retry against the full-state template
            logger.warning(
                "ckpt_view restore failed (%s: %s); retrying as a "
                "full-state checkpoint (pre-view layout)",
                type(e).__name__, e)
            full, resumed = ckpt_manager.restore_if_available(state)
            if resumed is not None:
                state = full
        restore_dt = time.perf_counter() - t_restore0
        # a restore served from a live peer books peer_restore_s
        peer_served = getattr(ckpt_manager, "last_restore_source",
                              None) == "peer"
        ledger.note("peer_restore_s" if peer_served else "restore_s",
                    restore_dt)
        if resumed is not None and is_host0:
            logger.info("resumed at step %d", resumed)
        resumed_step = resumed
        get_context().note_resume(resumed)

    last_metrics = {}
    global_step = int(state.step)
    n_procs = world_size()
    # the flag agreement runs only every K-th boundary, so the ranks do
    # not meet in a collective every step; K is the same on every rank,
    # so they still agree on the exit step (JAX loop.py:241-273)
    preempt_sync_every = max(
        1, int(os.environ.get("PREEMPT_SYNC_EVERY", "4")))
    boundary = [0]

    def _preempt_requested() -> bool:
        """The preemption verdict at a step boundary: the local flag in
        one process; across ranks every one exits at the same boundary,
        any rank's flag preempting all, and an off-cycle boundary never
        exits."""
        local = preempt.requested()
        if n_procs <= 1:
            return local
        boundary[0] += 1
        if boundary[0] % preempt_sync_every:
            return False
        return agree_preempt(local)

    def _preempt_exit(state, m, step):
        """Grace-window exit: force-save, wait until durable, raise the
        distinct 'preempted' status (train/preempt.py)."""
        # flush TB first: the grace window may end in SIGKILL mid-save
        if tb_writer is not None:
            tb_writer.flush()
        save_s = None
        if ckpt_manager is not None:
            t0 = time.perf_counter()
            with allow_transfers():
                if m is not None and ckpt_manager.latest_step() != step:
                    ckpt_manager.save(step, save_view(state),
                                      metrics=_fetch_metrics(m),
                                      force=True)
                ckpt_manager.wait()
            save_s = time.perf_counter() - t0
            ledger.note("eval_ckpt_stall_s", save_s)
            kept = ckpt_manager.latest_step()
            if kept != step:
                # best-by-score retention can delete a forced save: the
                # resume then loses every step since the survivor
                logger.error(
                    "preemption save at step %d was DROPPED by "
                    "retention (surviving latest: %s) — the retry "
                    "resumes from there; use score_attribute=None on "
                    "resume managers", step, kept)
            elif is_host0:
                logger.warning(
                    "preemption: checkpoint at step %d durable in %.2fs "
                    "(grace remaining: %s s)", step, save_s,
                    preempt.remaining_grace_s())
        # close the ledger now so it rides the exception (the finally
        # below re-closes idempotently)
        ledger.close(time.perf_counter() - t_loop0)
        raise preempt.Preempted(step=step, resumed_step=resumed_step,
                                save_s=save_s, grace_s=preempt.grace_s(),
                                pool=preempt.pool_target(),
                                ledger=ledger.as_dict())
    # resume fast-forward: batches the restored step counter already
    # consumed are skipped, not retrained (the epoch iterators are
    # seeded by epoch index, so replaying them positions the stream
    # where the checkpoint left off)
    to_skip = global_step
    # TRANSFER_GUARD: the loop below runs under the sync debug mode;
    # every sanctioned wait inside wraps itself in allow_transfers()
    _guard_region = contextlib.ExitStack()
    _guard_region.enter_context(guards.transfer_ctx())
    try:
      for epoch in range(epochs):
        if _preempt_requested():
            _preempt_exit(state, None, global_step)
        if meter is not None:
            meter.reset()
        m = None
        trained_this_epoch = 0
        # one iteration shape for both pipelines: the source pulls from
        # the epoch iterator, skips (never places) fast-forward batches,
        # and runs place_batch inline (prefetch 0) or on a background
        # thread ahead of the step
        source = make_batch_source(epoch_batches(epoch),
                                   place_fn=place_batch,
                                   depth=prefetch, skip=to_skip)
        try:
          for batch in source:
            if _preempt_requested():
                _preempt_exit(state, m, global_step)
            wait_s = source.consume_wait()
            if trained_this_epoch == 0:
                # fast-forwarding costs wall clock that must not deflate
                # the trained steps' tokens/s; the reset also drops the
                # first batch's pipeline warm-up wait
                if meter is not None:
                    meter.reset()
            else:
                if meter is not None:
                    meter.data_wait(wait_s)
                ledger.data_wait(wait_s)
            trained_this_epoch += 1
            if not loop_timing:
                guards.check_divergence(train_step, state, batch)
                t_step0 = time.perf_counter()
                state, m = train_step(state, batch)
                # the first call's wall time must cover its work on the
                # card, not just the launches
                _wait(state)
                now = time.perf_counter()
                loop_timing = {
                    "compile_s": now - t_step0,
                    "restart_to_first_step_s": now - t_loop0,
                }
                # the restart window: restore was timed directly, the
                # first step is compile_s; on a resumed attempt the rest
                # up to the first completed step is the fast-forward
                ledger.note("compile_s", loop_timing["compile_s"])
                if resumed_step is not None:
                    ledger.note("fast_forward_s",
                                loop_timing["restart_to_first_step_s"]
                                - loop_timing["compile_s"]
                                - ledger.restore_s)
            else:
                state, m = train_step(state, batch)
            global_step += 1
            if heartbeat_fn is not None:
                heartbeat_fn(global_step)
            if profiler is not None:
                profiler.step(global_step)
            if meter is not None:
                # the tokens metric lies on the card; the batch's static
                # token count needs no wait
                meter.update(int(np.prod(batch["inputs"].shape)))
            if log_every and global_step % log_every == 0:
                m_host = _fetch_metrics(m)
                last_metrics = {"epoch": epoch, "step": global_step,
                                **loop_timing, **m_host}
                if meter is not None:
                    last_metrics.update(meter.snapshot())
                if tb_writer is not None:
                    tb_writer.log(global_step, last_metrics)
                if is_host0:
                    logger.info(
                        "epoch %d step %d loss %.4f lr %.3g%s",
                        epoch, global_step, m_host.get("loss", float("nan")),
                        m_host.get("learning_rate", float("nan")),
                        (f" tok/s/chip {last_metrics['tokens_per_sec_per_chip']:.0f}"
                         f" mfu {last_metrics['mfu']:.1%}"
                         f" stall {last_metrics['data_stall_frac']:.1%}"
                         if meter is not None else ""))
            if eval_fn is not None and eval_every and \
                    global_step % eval_every == 0:
                # eval / ckpt stalls leave the meter's training window
                # (*_incl_stalls keep them); wait for the queued step
                # first so its work is booked as training, not stall
                if meter is not None:
                    _wait(state)
                with paused(meter), paused(ledger), allow_transfers():
                    eval_metrics = eval_fn(state)
                last_metrics.update(eval_metrics)
                if tb_writer is not None:
                    tb_writer.log(global_step, eval_metrics)
                if is_host0:
                    logger.info("eval @ %d: %s", global_step, eval_metrics)
            # SAVE_STRATEGY="steps": mid-epoch checkpoints
            if ckpt_manager is not None and ckpt_every and \
                    global_step % ckpt_every == 0:
                m_host = _fetch_metrics(m)
                if getattr(ckpt_manager, "async_commit", False):
                    # async commit: the loop blocks only for the snapshot
                    # and enqueue, booked as ckpt_async_s
                    t_save0 = time.perf_counter()
                    try:
                        with paused(meter), allow_transfers():
                            ckpt_manager.save(global_step,
                                              save_view(state),
                                              metrics=m_host)
                    finally:
                        ledger.note("ckpt_async_s",
                                    time.perf_counter() - t_save0)
                else:
                    with paused(meter), paused(ledger), \
                            allow_transfers():
                        ckpt_manager.save(global_step, save_view(state),
                                          metrics=m_host)
            if fault_injector is not None:
                # after the step's bookkeeping and its scheduled save
                fault_injector.on_step(global_step)
        finally:
            # exhaustion already joined the workers; this reclaims them
            # on the exception path
            source.close()
        yielded = source.yielded
        to_skip -= source.skipped

        # end of epoch: checkpoint + report
        if m is None:
            if yielded > 0:
                # every batch of this epoch was consumed before the
                # restore point: nothing to retrain or re-save
                if is_host0:
                    logger.info("epoch %d already completed before "
                                "resume point (step %d); skipping",
                                epoch, global_step)
                continue
            # an iterator that yielded nothing is a data / config error
            # on fresh and resumed runs alike
            raise ValueError(
                f"epoch {epoch} produced 0 batches — the dataset is "
                "smaller than one global batch (shrink GLOBAL_BATCH / "
                "PER_DEVICE_TRAIN_BATCH_SIZE or grow the dataset)")
        m_host = _fetch_metrics(m)
        epoch_metrics = {"epoch": epoch, "step": global_step,
                         **loop_timing, **m_host}
        if meter is not None:
            epoch_metrics.update(meter.snapshot())
        if eval_fn is not None and eval_at_epoch_end:
            with paused(ledger), allow_transfers():
                epoch_metrics.update(eval_fn(state))
        if tb_writer is not None:
            tb_writer.log(global_step, epoch_metrics)
            tb_writer.flush()
        last_metrics = epoch_metrics
        if ckpt_manager is not None:
            if getattr(ckpt_manager, "async_commit", False):
                t_save0 = time.perf_counter()
                try:
                    with allow_transfers():
                        ckpt_manager.save(global_step, save_view(state),
                                          metrics=m_host)
                finally:
                    ledger.note("ckpt_async_s",
                                time.perf_counter() - t_save0)
            else:
                with paused(ledger), allow_transfers():
                    ckpt_manager.save(global_step, save_view(state),
                                      metrics=m_host)
        if report_fn is not None:
            report_fn(epoch_metrics)
    finally:
        # seal the ledger on every exit path (normal, Preempted, crash)
        # and park it on the context
        ledger.close(time.perf_counter() - t_loop0)
        get_context().note_goodput(ledger.as_dict())
        # only the hot loop is guarded
        _guard_region.close()
        # a failing step must still flush an in-flight trace
        if profiler is not None:
            profiler.close()
        if tb_writer is not None:
            tb_writer.close()

    if ckpt_manager is not None:
        ckpt_manager.wait()
    if heartbeat_fn is not None:
        # the supervised region ends here
        heartbeat_fn(global_step, done=True)
    return state, last_metrics
