"""TorchTrainer — Ray Train style orchestration of the port's workers
(counterpart of ``gke_ray_train_tpu/rayint/trainer.py``).

``TorchTrainer(train_loop_per_worker, train_loop_config=...,
scaling_config=..., run_config=...).fit() -> Result``: Ray Train's own
class name, the one the reference drove (``ray-jobs/
fine_tune_llama_ray.py:445-457``). The JAX package's trainer runs one
worker per TPU host; this one runs one worker per card
(``resources_per_worker={"GPU": 1}``, the reference's layout), and the
Ray path hands each worker the rendezvous ``parallel/mesh.py::
distributed_init`` reads: ``MASTER_ADDR`` (worker 0's node),
``MASTER_PORT`` (a port free on it), ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, with the node's cards shared
in ``CUDA_VISIBLE_DEVICES`` as Ray Train shares them.

Fault tolerance, as in the JAX trainer:

- genuine failures (a crash, ``InjectedKill``, a heartbeat or worker
  timeout) consume ``FailureConfig.max_failures`` and retry with
  exponential backoff and jitter;
- preemptions (SIGTERM -> ``train/preempt.py`` -> the loop saves and
  raises ``Preempted``) consume ``max_preemptions`` instead, and resume
  at once;
- non-retryable errors (``KeyError``, ``ValueError``, ... : a config
  error fails alike every attempt) fail on the first attempt;
  ``CheckpointRestoreError`` stays retryable whatever its cause;
- ``RunConfig.heartbeat_timeout_s`` supervises step progress
  (``rayint/supervisor.py``), naming the stalled rank;
- with ``ELASTIC`` a pool change re-forms the next attempt on the
  survivors (``rayint/elastic.py``).

A failed attempt's exception keeps its traceback, whose frames hold the
attempt's train state (weights and optimizer moments: about 26 GB for
the 1.6 G-parameter pre-train model under AdamW). Before the next
in-process attempt the trainer clears those frames, collects, and
returns the freed blocks to the card (:func:`_release_attempt`), so a
retry starts from the first attempt's footprint.

Not ported, each raising ``NotImplementedError`` where the config or
environment asks for it: the telemetry run and the autotune overlay
(``OBS``, ``OBS_DIR``, ``OBS_CAPTURE``, ``TRACE``, ``AUTOTUNE``; ROADMAP
queue 1 item 9). With ``NUM_SLICES`` declared (config, else
environment) the Ray path hands the supervisor the rank → slice map
(``parallel/mesh.py::slice_assignments``), so a stall confined to one
slice is reported, and classified on an elastic job, as that slice's
loss: the survivors are the other slices' workers. The XLA compile
cache and the AOT sidecar have no counterpart: the port runs eagerly and
its kernels build once into ``_build/``.

Ray is optional at import time: without it (or with ``use_ray=False``)
the trainer runs one in-process worker, which is also the unit-test
path; under torchrun each rank is such a worker.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import os
import random
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

try:  # pragma: no cover - exercised only on clusters with Ray installed
    import ray
    _HAS_RAY = True
except ImportError:
    ray = None
    _HAS_RAY = False

DEFAULT_MASTER_PORT = 29500  # fallback when port discovery fails

# deterministic errors: retrying replays the identical failure. Matched
# by type AND name (Ray's serialized task errors may rebuild instances).
NONRETRYABLE_TYPES = (KeyError, ValueError, TypeError, AttributeError,
                      ImportError, NotImplementedError)
_NONRETRYABLE_NAMES = frozenset(t.__name__ for t in NONRETRYABLE_TYPES) | {
    "ModuleNotFoundError",
    # the runtime guards' violations (analysis/guards.py) replay alike
    "GuardViolation", "HloDivergenceError", "RecompileLimitExceeded"}
# a checkpoint-restore failure is often a ValueError underneath, but a
# fresh attempt re-reads storage
_RETRYABLE_NAMES = frozenset({"CheckpointRestoreError"})

# the telemetry and autotune knobs of ROADMAP queue 1 item 9: set, they
# raise instead of being skipped
_ITEM9_FLAGS = ("OBS", "OBS_CAPTURE", "TRACE", "AUTOTUNE")
_ITEM9_PATHS = ("OBS_DIR",)


@dataclasses.dataclass
class ScalingConfig:
    """Ray Train's ScalingConfig as the reference sets it
    (fine_tune_llama_ray.py:439-449): one worker per card."""
    num_workers: int = 1
    resources_per_worker: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"GPU": 1})
    placement_strategy: str = "SPREAD"

    @staticmethod
    def from_env() -> "ScalingConfig":
        """``NUM_NODES`` x ``NUM_GPUS_PER_NODE`` workers (the reference's
        variables, SURVEY.md §5.6), one card each."""
        nodes = int(os.environ.get("NUM_NODES", "1"))
        gpus = int(os.environ.get("NUM_GPUS_PER_NODE", "1"))
        return ScalingConfig(num_workers=nodes * gpus,
                             resources_per_worker={"GPU": 1})


@dataclasses.dataclass
class FailureConfig:
    # genuine-failure retry budget (crashes, hangs, timeouts)
    max_failures: int = 0
    # a separate budget for preemptions: a preemption saves in its grace
    # window and resumes, so it must not burn a max_failures slot
    max_preemptions: int = 8


@dataclasses.dataclass
class RunConfig:
    name: str = "torch-train"
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    # elastic re-formation on a pool change (rayint/elastic.py); None =
    # $ELASTIC (default off)
    elastic: Optional[bool] = None
    # the smallest pool worth re-forming on; None = $MIN_DEVICES or 1
    min_devices: Optional[int] = None
    # wall-clock bound of one attempt; None = none
    worker_timeout_s: Optional[float] = None
    # kill the attempt, naming the rank, when a worker reports no step
    # progress for this long; None = no heartbeat supervision
    heartbeat_timeout_s: Optional[float] = None
    # base of the backoff between genuine-failure retries (base *
    # 2^(failures-1), capped at 60 s, x jitter in [0.5, 1.5)); None =
    # $RETRY_BACKOFF_S or 1.0
    retry_backoff_s: Optional[float] = None

    @staticmethod
    def from_env(name: str, storage_path: Optional[str] = None,
                 env=None) -> "RunConfig":
        """The JAX entries' fault-tolerance knobs: ``MAX_FAILURES``,
        ``MAX_PREEMPTIONS`` (a spot eviction must not burn a retry
        slot), ``WORKER_TIMEOUT_S`` and ``HEARTBEAT_TIMEOUT_S``."""
        env = os.environ if env is None else env
        return RunConfig(
            name=name, storage_path=storage_path,
            failure_config=FailureConfig(
                max_failures=int(env.get("MAX_FAILURES", "0")),
                max_preemptions=int(env.get("MAX_PREEMPTIONS", "8"))),
            worker_timeout_s=(float(env["WORKER_TIMEOUT_S"])
                              if "WORKER_TIMEOUT_S" in env else None),
            heartbeat_timeout_s=(float(env["HEARTBEAT_TIMEOUT_S"])
                                 if "HEARTBEAT_TIMEOUT_S" in env else None))


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    error: Optional[str] = None
    # per-worker metrics (worker 0 first); `metrics` is worker 0's view
    worker_metrics: Optional[list] = None
    # "ok" | "failed" | "preempted" (budget exhausted)
    status: str = "ok"
    attempts: int = 1
    preemptions: int = 0
    # one dict per attempt: {"status", "error"?, "step"?, "resumed_step"?,
    # "ckpt_save_s"?, "nonretryable"?, "goodput", "event"?, "pool"?,
    # "plan_fingerprint"?}
    attempt_log: list = dataclasses.field(default_factory=list)
    # the attempts' goodput ledgers summed (train/metrics.py)
    goodput: dict = dataclasses.field(default_factory=dict)


def _cause_chain(e: BaseException):
    """Explicit causes only (ray's .cause / raise-from __cause__)."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        yield e
        e = getattr(e, "cause", None) or e.__cause__


def _find_preempted(e: BaseException):
    from gke_ray_train_tpu_torch.train.preempt import Preempted
    for x in _cause_chain(e):
        if isinstance(x, Preempted) or type(x).__name__ == "Preempted":
            return x
    return None


def _is_nonretryable(e: BaseException) -> bool:
    for x in _cause_chain(e):
        # outermost first: a retryable wrapper vouches for its cause
        if type(x).__name__ in _RETRYABLE_NAMES:
            return False
        if isinstance(x, NONRETRYABLE_TYPES) \
                or type(x).__name__ in _NONRETRYABLE_NAMES:
            return True
    return False


def _release_attempt(e: Optional[BaseException]) -> None:
    """Drop what a failed attempt left alive: the frames of every
    exception in its chain (causes and contexts; they hold the train
    state), then collect and hand the card's cached blocks back."""
    seen = set()
    stack = [e]
    while stack:
        x = stack.pop()
        if x is None or id(x) in seen:
            continue
        seen.add(id(x))
        if x.__traceback__ is not None:
            traceback.clear_frames(x.__traceback__)
            x.__traceback__ = None
        stack += [x.__cause__, x.__context__, getattr(x, "cause", None)]
    gc.collect()
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _refuse_unported(config: dict) -> None:
    """The telemetry run and the autotune overlay (item 9) raise
    where the config or the environment turns them on."""
    def on(key):
        v = config.get(key, os.environ.get(key))
        if v is None:
            return False
        v = str(v).strip().lower()
        if key in _ITEM9_PATHS:
            return v != ""
        return v not in ("", "0", "false", "no", "off")
    asked = [k for k in _ITEM9_FLAGS + _ITEM9_PATHS if on(k)]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: the telemetry run and the autotune "
            "overlay are not ported yet (ROADMAP queue 1 item 9); unset "
            "them")


def _run_worker(fn: Callable, config: dict, env: Dict[str, str],
                beat_fn: Optional[Callable] = None) -> dict:
    """One worker's attempt: returns {"metrics", "resumed_step",
    "goodput", "plan_fingerprint"} (the attempt's metadata rides the
    payload: on the Ray path the worker's context is in another
    process)."""
    os.environ.update(env)
    from gke_ray_train_tpu_torch.parallel.mesh import is_distributed
    from gke_ray_train_tpu_torch.plan import ExecutionPlan, PlanError
    from gke_ray_train_tpu_torch.rayint.context import get_context
    from gke_ray_train_tpu_torch.train import preempt
    _refuse_unported(config)
    fingerprint = None
    try:
        fingerprint = ExecutionPlan.resolve(config).fingerprint()
    except PlanError as e:
        # a config in another dialect (the pre-train entry's) resolves
        # its own plan in the worker
        logger.warning("worker-level plan resolution failed (%s); the "
                       "entry's own plan still applies", e)
    # KERNELCHECK (config over env), scoped to the attempt
    prev_kernelcheck = os.environ.get("KERNELCHECK")
    if "KERNELCHECK" in config:
        os.environ["KERNELCHECK"] = str(config["KERNELCHECK"])
    ctx = get_context()
    ctx.resumed_step = None
    ctx.goodput = None
    ctx.plan_fingerprint = fingerprint
    ctx.set_heartbeat_sink(beat_fn)
    preempt.reset()     # a retry must not inherit the last preemption
    preempt.install()
    made_group = not is_distributed()
    try:
        ret = fn(config)
        reported = ctx.last_reported
        return {"metrics": ret if ret is not None else (reported or {}),
                "resumed_step": ctx.resumed_step,
                "goodput": ctx.goodput,
                "plan_fingerprint": ctx.plan_fingerprint}
    finally:
        # a finished or failed worker is never stalled
        ctx.heartbeat_done()
        # outside an attempt nothing reads the preemption flag
        preempt.uninstall()
        # a group the attempt made dies with it; the next attempt joins
        # its own world
        if made_group and is_distributed():
            import torch.distributed as dist
            dist.destroy_process_group()
        if "KERNELCHECK" in config:
            if prev_kernelcheck is None:
                os.environ.pop("KERNELCHECK", None)
            else:
                os.environ["KERNELCHECK"] = prev_kernelcheck


class TorchTrainer:
    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 use_ray: Optional[bool] = None):
        self.fn = train_loop_per_worker
        # copied: the injections below must not leak into the caller's
        self.config = dict(train_loop_config or {})
        # `ray job submit --env PREFETCH_BATCHES=N` tunes the prefetch
        # depth; an explicit config value wins
        if "PREFETCH_BATCHES" in os.environ and \
                "PREFETCH_BATCHES" not in self.config:
            self.config["PREFETCH_BATCHES"] = \
                int(os.environ["PREFETCH_BATCHES"])
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.use_ray = (_HAS_RAY and self.scaling.num_workers >= 1
                        if use_ray is None else use_ray)
        # surviving rank count of the last elastic pool change; when set,
        # every later attempt runs that many workers, told so in
        # ELASTIC_N_DEVICES
        self._pool_override: Optional[int] = None

    # -- elastic knobs -------------------------------------------------
    def _elastic(self) -> bool:
        if self.run_config.elastic is not None:
            return bool(self.run_config.elastic)
        from gke_ray_train_tpu_torch.rayint.elastic import elastic_enabled
        return elastic_enabled(self.config)

    def _min_devices(self) -> int:
        if self.run_config.min_devices is not None:
            return max(int(self.run_config.min_devices), 1)
        from gke_ray_train_tpu_torch.rayint.elastic import min_devices
        return min_devices(self.config)

    def _pool_env(self) -> Dict[str, str]:
        """The per-attempt worker env of an elastic pool change."""
        from gke_ray_train_tpu_torch.rayint.elastic import (
            FULL_POOL_ENV, POOL_ENV)
        env: Dict[str, str] = {}
        # a RunConfig(elastic=True) opt-in must reach the workers' gate
        if self.run_config.elastic:
            env["ELASTIC"] = "1"
        if self._pool_override is not None:
            env[POOL_ENV] = str(self._pool_override)
            env[FULL_POOL_ENV] = str(self.scaling.num_workers)
            return env
        # the local path shares os.environ across attempts
        os.environ.pop(POOL_ENV, None)
        os.environ.pop(FULL_POOL_ENV, None)
        return env

    @staticmethod
    def _probe_pool() -> Optional[int]:
        """The pool after a failure that carried no notice: the fault
        registry's emulated pool in this process, else None."""
        try:
            from gke_ray_train_tpu_torch.testing.faults import current_pool
            return current_pool()
        except Exception:  # noqa: BLE001 - the probe is best-effort
            return None

    def _slice_map(self, n: int) -> Optional[Dict[int, int]]:
        """Rank → slice of ``n`` workers through the one contract
        function, ``NUM_SLICES`` from the config, else the environment
        (JAX :604-620); None where that is one domain (no slice
        identity to report)."""
        from gke_ray_train_tpu_torch.parallel.mesh import slice_assignments
        try:
            num_slices = int(self.config.get(
                "NUM_SLICES", os.environ.get("NUM_SLICES", "1")))
        except (TypeError, ValueError):
            num_slices = 1
        assign = slice_assignments(range(n), num_slices)
        return dict(enumerate(assign)) if len(set(assign)) > 1 else None

    # -- local ---------------------------------------------------------
    def _fit_local(self) -> tuple:
        """One in-process worker. Its rank and world are this process's
        (one rank, or the rank torchrun started)."""
        from gke_ray_train_tpu_torch.rayint.context import get_context
        from gke_ray_train_tpu_torch.rayint.supervisor import (
            HeartbeatBoard, HeartbeatTimeout, Watchdog)
        env = self._pool_env()
        hb = self.run_config.heartbeat_timeout_s
        board = HeartbeatBoard() if hb else None
        wd = Watchdog(board, hb).start() if hb else None
        # the outer try covers the cleanup too: a watchdog SIGINT landing
        # while it runs must still be translated
        try:
            try:
                out = _run_worker(self.fn, self.config, env,
                                  beat_fn=board.beat if board else None)
            finally:
                if wd is not None:
                    wd.stop()
                get_context().set_heartbeat_sink(None)
            return Result(metrics=out["metrics"]), out
        except KeyboardInterrupt:
            # the watchdog interrupts the main thread on a stall; a real
            # Ctrl-C (no stall recorded) re-raises
            if wd is not None and wd.stalled_info:
                raise HeartbeatTimeout(wd.stalled_info, hb) from None
            raise

    # -- ray ----------------------------------------------------------
    @staticmethod
    def _kill_workers(workers) -> None:
        for w in workers:
            try:
                ray.kill(w)
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    def _get_result(future, rank: int, ips: list):
        """ray.get with the failing rank and node named; ``Preempted``
        passes through for fit()'s classification."""
        try:
            return ray.get(future)
        except Exception as e:  # noqa: BLE001
            if _find_preempted(e) is not None:
                raise
            cause = getattr(e, "cause", None) or e.__cause__ or e
            raise RuntimeError(
                f"worker rank {rank} (node {ips[rank]}) failed: "
                f"{type(cause).__name__}: {cause}") from e

    @staticmethod
    def _rendezvous(ips: list, gpu_ids: list, port: int) -> list:
        """Each worker's rendezvous env: worker 0's node hosts the store;
        a node's workers share its cards in ``CUDA_VISIBLE_DEVICES``
        (Ray gives each actor only its own) and take ``LOCAL_RANK`` as
        their card's index there."""
        n = len(ips)
        envs = []
        for i in range(n):
            peers = [j for j in range(n) if ips[j] == ips[i]]
            env = {"MASTER_ADDR": str(ips[0]), "MASTER_PORT": str(port),
                   "WORLD_SIZE": str(n), "RANK": str(i),
                   "LOCAL_WORLD_SIZE": str(len(peers)),
                   "LOCAL_RANK": str(peers.index(i))}
            shared = sorted({str(g) for j in peers for g in gpu_ids[j]},
                            key=lambda g: (len(g), g))
            if shared and gpu_ids[i]:
                env["CUDA_VISIBLE_DEVICES"] = ",".join(shared)
                env["LOCAL_RANK"] = str(shared.index(str(gpu_ids[i][0])))
            envs.append(env)
        return envs

    def _fit_ray(self) -> tuple:
        if not ray.is_initialized():
            ray.init(address=os.environ.get("RAY_ADDRESS", "auto"))
        n = self._pool_override or self.scaling.num_workers
        resources = dict(self.scaling.resources_per_worker)
        num_cpus = resources.pop("CPU", 1)
        # Ray takes cards as num_gpus, never as a custom resource
        num_gpus = resources.pop("GPU", 0)

        @ray.remote(max_restarts=0)
        class Worker:
            def node_ip(self):
                return ray.util.get_node_ip_address()

            def gpu_ids(self):
                get = getattr(ray, "get_gpu_ids", None)
                return list(get()) if get is not None else []

            def free_port(self):
                # free now on worker 0's node, bound by rank 0's store
                # moments later
                import socket
                s = socket.socket()
                s.bind(("", 0))
                port = s.getsockname()[1]
                s.close()
                return port

            def run(self, fn, config, env, supervisor=None):
                beat = None
                if supervisor is not None:
                    def beat(rank, step, done):
                        # fire-and-forget
                        supervisor.beat.remote(rank, step, done)
                return _run_worker(fn, config, env, beat_fn=beat)

        hb_timeout = self.run_config.heartbeat_timeout_s
        slice_map = self._slice_map(n)
        supervisor = None
        if hb_timeout:
            from gke_ray_train_tpu_torch.rayint.supervisor import (
                HeartbeatTimeout, Supervisor)
            supervisor = ray.remote(Supervisor).options(num_cpus=0).remote()
            if slice_map:
                supervisor.set_slices.remote(slice_map)

        bundle = dict(resources, CPU=num_cpus)
        if num_gpus:
            bundle["GPU"] = num_gpus
        pg = ray.util.placement_group([dict(bundle) for _ in range(n)],
                                      strategy=self.scaling.placement_strategy)
        try:
            ray.get(pg.ready())
            try:
                from ray.util.scheduling_strategies import (
                    PlacementGroupSchedulingStrategy)

                def sched(i):
                    return PlacementGroupSchedulingStrategy(
                        placement_group=pg, placement_group_bundle_index=i)
            except ImportError:  # very old ray: best-effort scheduling
                def sched(i):
                    return None

            workers = [
                Worker.options(resources=resources, num_cpus=num_cpus,
                               num_gpus=num_gpus,
                               scheduling_strategy=sched(i)).remote()
                for i in range(n)]
            ips = ray.get([w.node_ip.remote() for w in workers])
            gpus = ray.get([w.gpu_ids.remote() for w in workers])
            port = None
            for port_try in range(3):
                try:
                    port = int(ray.get(workers[0].free_port.remote()))
                    break
                except Exception as e:  # noqa: BLE001 - transient RPC/bind
                    logger.warning(
                        "rendezvous port discovery attempt %d/3 failed "
                        "(%s: %s); retrying", port_try + 1,
                        type(e).__name__, e)
                    time.sleep(0.2 * (2 ** port_try))
            if port is None:
                port = DEFAULT_MASTER_PORT
                logger.error(
                    "rendezvous port discovery failed after 3 attempts; "
                    "FALLING BACK to fixed port %d — this COLLIDES when "
                    "another job's store shares the node", port)
            # the launching process's knobs ride to the workers explicitly
            from gke_ray_train_tpu_torch.plan import CONFIG_KEYS
            forward = sorted(set(CONFIG_KEYS.values()) | {
                "ELASTIC", "MIN_DEVICES", "KERNELCHECK", "ASYNC_CKPT",
                "PEER_REPLICATION", "CKPT_COMMIT_TIMEOUT_S",
                "CKPT_STORAGE_DELAY_S", "FAULT_SPEC"})
            env_base = {k: os.environ[k] for k in forward
                        if k in os.environ}
            env_base.update(self._pool_env())
            rdzv = self._rendezvous(ips, gpus, port)
            futures = [
                w.run.remote(self.fn, self.config, {**env_base, **rdzv[i]},
                             supervisor)
                for i, w in enumerate(workers)]
            timeout = self.run_config.worker_timeout_s
            if timeout is not None or supervisor is not None:
                # supervised wait: a crashed rank surfaces at once, a
                # stalled one by its heartbeat, a long attempt by the
                # wall clock; each kills every worker
                deadline = (time.monotonic() + timeout
                            if timeout is not None else None)
                slices = [t / 4.0 for t in (timeout, hb_timeout)
                          if t is not None and t > 0]
                poll_s = max(0.005, min(min(slices, default=5.0), 5.0))
                while True:
                    done, pending = ray.wait(futures,
                                             num_returns=len(futures),
                                             timeout=poll_s)
                    if not pending:
                        break
                    # a crash is the root cause its wedged partners hide;
                    # a preempted rank's partners are still saving
                    for i, f in enumerate(futures):
                        if f not in done:
                            continue
                        try:
                            ray.get(f)
                        except Exception as e:  # noqa: BLE001
                            if _find_preempted(e) is not None:
                                continue
                            self._kill_workers(workers)
                            self._get_result(f, i, ips)  # raises wrapped
                    if supervisor is not None:
                        stalled = ray.get(
                            supervisor.stalled.remote(hb_timeout))
                        if stalled:
                            self._kill_workers(workers)
                            raise HeartbeatTimeout(stalled, hb_timeout,
                                                   slice_map=slice_map)
                    if deadline is not None and \
                            time.monotonic() >= deadline:
                        stalled_idx = sorted(
                            i for i, f in enumerate(futures)
                            if f in pending)
                        self._kill_workers(workers)
                        raise TimeoutError(
                            f"worker(s) {stalled_idx} still running after "
                            f"{timeout}s (others done: {len(done)}/{n}); "
                            "killed all workers for retry-with-resume")
            results = [self._get_result(f, i, ips)
                       for i, f in enumerate(futures)]
        finally:
            # a placement group outlives its handle: a retry would wait
            # on resources the last attempt still reserves
            try:
                ray.util.remove_placement_group(pg)
            except Exception:  # noqa: BLE001 - cleanup is best-effort
                pass
        return Result(
            metrics=results[0]["metrics"] if results else {},
            worker_metrics=[r["metrics"] for r in results]), \
            (results[0] if results else {})

    def _local_attempt_note(self, p) -> tuple:
        """(ledger, plan fingerprint) of a failed or preempted attempt:
        ``Preempted`` carries its ledger; on the local path the loop
        parked both on the context even when the attempt crashed."""
        led = getattr(p, "ledger", None) if p is not None else None
        fp = None
        if not self.use_ray:
            from gke_ray_train_tpu_torch.rayint.context import get_context
            ctx = get_context()
            led = led if led is not None else ctx.goodput
            fp = ctx.plan_fingerprint
        return led, fp

    def fit(self) -> Result:
        from gke_ray_train_tpu_torch.train.metrics import (
            finish_ledger, sum_ledgers)
        fc = self.run_config.failure_config
        backoff_base = self.run_config.retry_backoff_s
        if backoff_base is None:
            backoff_base = float(os.environ.get("RETRY_BACKOFF_S", "1.0"))
        elastic = self._elastic()
        min_dev = self._min_devices()
        failures = 0
        preemptions = 0
        attempt = 0
        attempt_log: list = []

        def finalize(result: Result) -> Result:
            result.attempts = attempt
            result.preemptions = preemptions
            result.attempt_log = attempt_log
            result.goodput = sum_ledgers(
                [e["goodput"] for e in attempt_log if "goodput" in e])
            return result

        def classify_pool(pool, entry, exc=None) -> Optional[Result]:
            """Did the pool change? ``pool`` is the preemption notice's,
            else the fault registry's is read, else, for a heartbeat
            stall whose stalled ranks all sit on one slice, the other
            slices' workers. Records the shrink / grow on the entry and
            arms the next attempt; a terminal Result when the survivors
            are below MIN_DEVICES."""
            if pool is None:
                pool = self._probe_pool()
            if pool is None and exc is not None:
                from gke_ray_train_tpu_torch.rayint.supervisor import (
                    HeartbeatTimeout, slice_shrink_pool)
                for x in _cause_chain(exc):
                    if isinstance(x, HeartbeatTimeout) \
                            and x.uniform_slice is not None:
                        entry["slice"] = x.uniform_slice
                        per = float(self.scaling.resources_per_worker
                                    .get("GPU", 0))
                        if per > 0:
                            pool = slice_shrink_pool(
                                x.uniform_slice, x.slice_map, per)
                        break
            if pool is None or pool == self._pool_override or not elastic:
                return None
            prev = self._pool_override
            event = "shrink" if prev is None or pool < prev else "grow"
            entry["event"] = event
            entry["pool"] = int(pool)
            if pool < min_dev:
                msg = (f"device pool shrank to {pool} (< MIN_DEVICES="
                       f"{min_dev}); refusing to re-form — raise the "
                       "floor knowingly or wait for capacity")
                logger.error("%s", msg)
                entry["status"] = "failed"
                entry["error"] = msg
                return finalize(Result(metrics={}, error=msg,
                                       status="failed"))
            self._pool_override = int(pool)
            logger.warning(
                "elastic %s event: next attempt re-forms on %d ranks "
                "(the restore reshards)", event, pool)
            return None

        while True:
            attempt += 1
            t_attempt = time.perf_counter()
            try:
                result, out = self._fit_ray() if self.use_ray \
                    else self._fit_local()
                entry = {
                    "status": "ok",
                    "resumed_step": out.get("resumed_step"),
                    "goodput": finish_ledger(
                        out.get("goodput"),
                        time.perf_counter() - t_attempt)}
                if out.get("plan_fingerprint"):
                    entry["plan_fingerprint"] = out["plan_fingerprint"]
                if self._pool_override is not None:
                    entry["pool"] = self._pool_override
                attempt_log.append(entry)
                return finalize(result)
            except Exception as e:  # noqa: BLE001 - classified below
                wall = time.perf_counter() - t_attempt
                p = _find_preempted(e)
                led, fp = self._local_attempt_note(p)
                goodput = finish_ledger(led, wall)
                msg = str(e)
                if p is not None:
                    # saved in its grace window: its own budget
                    preemptions += 1
                    entry = {
                        "status": "preempted",
                        "step": getattr(p, "step", None),
                        "resumed_step": getattr(p, "resumed_step", None),
                        "ckpt_save_s": getattr(p, "save_s", None),
                        "goodput": goodput}
                    if fp:
                        entry["plan_fingerprint"] = fp
                    attempt_log.append(entry)
                    pool = getattr(p, "pool", None)
                    del p
                    _release_attempt(e)
                    stop = classify_pool(pool, entry)
                    if stop is not None:
                        return stop
                    if preemptions > fc.max_preemptions:
                        logger.error(
                            "preemption budget exhausted "
                            "(max_preemptions=%d): %s",
                            fc.max_preemptions, msg)
                        return finalize(Result(metrics={}, error=msg,
                                               status="preempted"))
                    logger.warning(
                        "attempt %d preempted (%s); resuming from the "
                        "saved checkpoint (preemption %d/%d; max_failures "
                        "budget untouched)", attempt, msg, preemptions,
                        fc.max_preemptions)
                    continue  # at once: the checkpoint is durable
                if _is_nonretryable(e):
                    logger.exception(
                        "attempt %d failed with non-retryable %s; NOT "
                        "retrying (a deterministic error fails "
                        "identically every attempt)", attempt,
                        type(e).__name__)
                    entry = {"status": "failed", "error": msg,
                             "nonretryable": True, "goodput": goodput}
                    if fp:
                        entry["plan_fingerprint"] = fp
                    attempt_log.append(entry)
                    _release_attempt(e)
                    return finalize(Result(metrics={}, error=msg,
                                           status="failed"))
                entry = {"status": "failed", "error": msg,
                         "goodput": goodput}
                if fp:
                    entry["plan_fingerprint"] = fp
                attempt_log.append(entry)
                logger.exception("training attempt %d failed", attempt)
                _release_attempt(e)
                # a failure whose post-mortem shows the pool changed is a
                # shrink, not a max_failures burn
                stop = classify_pool(None, entry, e)
                if stop is not None:
                    return stop
                if entry.get("event"):
                    entry["status"] = "preempted"
                    preemptions += 1
                    if preemptions > fc.max_preemptions:
                        logger.error(
                            "preemption budget exhausted "
                            "(max_preemptions=%d): %s",
                            fc.max_preemptions, msg)
                        return finalize(Result(metrics={}, error=msg,
                                               status="preempted"))
                    logger.warning(
                        "attempt %d lost to a pool change (%s); "
                        "re-forming on %d ranks (preemption %d/%d; "
                        "max_failures budget untouched)", attempt, msg,
                        entry["pool"], preemptions, fc.max_preemptions)
                    continue
                failures += 1
                logger.warning("failure %d/%d", failures, fc.max_failures)
                if failures > fc.max_failures:
                    return finalize(Result(metrics={}, error=msg,
                                           status="failed"))
                # exponential backoff + jitter: a mass restart must not
                # stampede the rendezvous
                delay = min(backoff_base * (2 ** (failures - 1)), 60.0)
                delay *= 0.5 + random.random()
                if delay > 0:
                    logger.info("retrying in %.1fs (backoff + jitter)",
                                delay)
                    time.sleep(delay)
