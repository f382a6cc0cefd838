"""Serving replicas behind one deployment (counterpart of
``gke_ray_train_tpu/rayint/serving.py``).

One :class:`ServeReplica` per replica, each owning one
``serve/engine.py::BatchEngine``; the
:class:`ServeDeployment` scatters a request batch round-robin over the
replicas and gathers the completions back in the callers' order, each
replica batching its share continuously. The JAX package's replica is a
TPU host group; here it is a card (or, in process, an engine on the
caller's card).

Liveness rides the trainer's heartbeat board (``rayint/supervisor.py``):
every engine iteration beats ``(replica rank, iteration)`` to a
``Supervisor`` actor (Ray) or an in-process ``HeartbeatBoard``, so a
replica wedged mid-decode is named by the same board that watches
training ranks (:meth:`ServeDeployment.stalled`). The JAX replica's AOT
cold start (deserialized executables) has no counterpart: the port's
engine runs eagerly.

Ray is optional at import time: without it, or with ``use_ray=False``,
the replicas are in-process objects, which is also the unit-test path.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

try:  # pragma: no cover - exercised only with Ray installed
    import ray
    _HAS_RAY = True
except ImportError:
    ray = None
    _HAS_RAY = False


def _completion_payload(c) -> Dict[str, Any]:
    """A Completion as a plain dict (actor results cross processes)."""
    return {
        "rid": c.rid,
        "tokens": np.asarray(c.tokens).tolist(),
        "generated": np.asarray(c.generated).tolist(),
        "prompt_len": int(c.prompt_len),
        "length": int(c.length),
        "bucket": int(c.bucket),
        "finish_reason": c.finish_reason,
        "first_token_s": float(c.first_token_s),
        "done_s": float(c.done_s),
        "adapter_id": c.adapter_id,
    }


class ServeReplica:
    """Actor body: ``ray.remote(ServeReplica)`` at deploy time. Zero-arg
    constructible; :meth:`build` makes the engine, so actor creation
    stays cheap and the factory travels as a task argument."""

    def __init__(self):
        self._engine = None
        self._rank = 0

    def build(self, engine_factory: Callable[[], Any], *, rank: int = 0,
              supervisor=None, warm: bool = True) -> Dict[str, Any]:
        """Make (and by default warm up) this replica's engine;
        ``engine_factory() -> BatchEngine`` runs in the replica's
        process. With a ``supervisor`` (an actor handle or a board) every
        engine iteration beats ``(rank, iteration)`` to it."""
        self._rank = int(rank)
        self._engine = engine_factory()
        if supervisor is not None:
            if hasattr(supervisor, "beat") and hasattr(
                    getattr(supervisor, "beat"), "remote"):
                self._engine.set_heartbeat(
                    lambda it: supervisor.beat.remote(self._rank, it))
            else:  # local path: a HeartbeatBoard
                self._engine.set_heartbeat(
                    lambda it: supervisor.beat(self._rank, it))
        if warm:
            self._engine.warm_up()
        return {"rank": self._rank, "warm": bool(warm)}

    def serve(self, requests: Sequence[Dict[str, Any]]
              ) -> List[Dict[str, Any]]:
        """Batch ``requests`` (dicts: rid / token_ids / max_new_tokens /
        optional adapter_id) to completion; payloads in submit order."""
        from gke_ray_train_tpu_torch.serve.engine import Request
        reqs = [Request(rid=str(r["rid"]),
                        token_ids=np.asarray(r["token_ids"], np.int32),
                        max_new_tokens=int(r.get("max_new_tokens", 32)),
                        adapter_id=r.get("adapter_id"))
                for r in requests]
        return [_completion_payload(c)
                for c in self._engine.run_until_drained(reqs)]

    def stats(self) -> Dict[str, Any]:
        return self._engine.stats()


class ServeDeployment:
    """The deployment: N replicas and one heartbeat sink.

    ``engine_factory`` must be self-contained (weights, plan, the
    ``BatchEngine``): on the Ray path it runs inside each replica's
    actor. ``resources_per_replica`` follows the trainer's one card a
    worker (``{"GPU": 1}``)."""

    def __init__(self, engine_factory: Callable[[], Any], *,
                 num_replicas: int = 1,
                 resources_per_replica: Optional[Dict[str, float]] = None,
                 use_ray: Optional[bool] = None):
        self.engine_factory = engine_factory
        self.num_replicas = int(num_replicas)
        self.resources = dict(resources_per_replica or {})
        self.use_ray = _HAS_RAY if use_ray is None else use_ray
        self._replicas: List[Any] = []
        self._supervisor = None
        self._board = None
        self._rr = 0

    # -- lifecycle -----------------------------------------------------

    def start(self, *, warm: bool = True) -> List[Dict[str, Any]]:
        """Make the supervisor and the replicas and build every engine;
        one info dict per replica."""
        if self.use_ray:
            from gke_ray_train_tpu_torch.rayint.supervisor import Supervisor
            if not ray.is_initialized():  # pragma: no cover - cluster
                ray.init()
            self._supervisor = ray.remote(Supervisor).options(
                num_cpus=0).remote()
            actor_cls = ray.remote(ServeReplica)
            res = dict(self.resources)
            opts: Dict[str, Any] = {}
            # Ray takes cards as num_gpus, never as a custom resource
            if "GPU" in res:
                opts["num_gpus"] = res.pop("GPU")
            if res:
                opts["resources"] = res
            self._replicas = [actor_cls.options(**opts).remote()
                              for _ in range(self.num_replicas)]
            infos = ray.get([
                r.build.remote(self.engine_factory, rank=i,
                               supervisor=self._supervisor, warm=warm)
                for i, r in enumerate(self._replicas)])
        else:
            from gke_ray_train_tpu_torch.rayint.supervisor import (
                HeartbeatBoard)
            self._board = HeartbeatBoard()
            self._replicas = [ServeReplica()
                              for _ in range(self.num_replicas)]
            infos = [r.build(self.engine_factory, rank=i,
                             supervisor=self._board, warm=warm)
                     for i, r in enumerate(self._replicas)]
        logger.info("serve deployment up: %d replica(s), %s",
                    self.num_replicas,
                    "ray actors" if self.use_ray else "in-process")
        return infos

    def shutdown(self) -> None:
        if self.use_ray:
            for actor in self._replicas + (
                    [self._supervisor] if self._supervisor is not None
                    else []):
                try:
                    ray.kill(actor)
                except Exception:  # noqa: BLE001 - teardown best-effort
                    pass
        self._replicas = []
        self._supervisor = None
        self._board = None

    # -- request path --------------------------------------------------

    def serve(self, requests: Sequence[Dict[str, Any]]
              ) -> List[Dict[str, Any]]:
        """Scatter round-robin, gather in the callers' order; on the Ray
        path the replicas run concurrently."""
        if not self._replicas:
            raise RuntimeError("deployment not started — call start()")
        # duplicate rids scattered onto different replicas would dodge
        # the engine's per-rid guard and drop a completion below
        rids = [str(r["rid"]) for r in requests]
        if len(set(rids)) != len(rids):
            dupes = sorted({r for r in rids if rids.count(r) > 1})
            raise ValueError(f"duplicate request rids {dupes} — rids "
                             "must be unique per batch")
        shares: List[List[Dict[str, Any]]] = [
            [] for _ in self._replicas]
        order: Dict[str, int] = {}
        for i, req in enumerate(requests):
            shares[(self._rr + i) % len(self._replicas)].append(req)
            order[str(req["rid"])] = i
        self._rr = (self._rr + len(requests)) % len(self._replicas)
        if self.use_ray:
            futs = [r.serve.remote(share)
                    for r, share in zip(self._replicas, shares) if share]
            batches = ray.get(futs)
        else:
            batches = [r.serve(share)
                       for r, share in zip(self._replicas, shares)
                       if share]
        out: List[Optional[Dict[str, Any]]] = [None] * len(requests)
        for batch in batches:
            for payload in batch:
                out[order[payload["rid"]]] = payload
        return [p for p in out if p is not None]

    # -- health --------------------------------------------------------

    def stalled(self, timeout_s: float):
        """Replicas with no engine-iteration progress for ``timeout_s``,
        in the training watchdog's StallInfo shape."""
        if self.use_ray:
            return ray.get(self._supervisor.stalled.remote(timeout_s)) \
                if self._supervisor is not None else []
        return self._board.stalled(timeout_s) if self._board else []

    def board_snapshot(self) -> Dict[int, dict]:
        """The board's per-replica last iteration and age."""
        if self.use_ray:
            return ray.get(self._supervisor.snapshot.remote()) \
                if self._supervisor is not None else {}
        return self._board.snapshot() if self._board else {}

    def stats(self) -> List[Dict[str, Any]]:
        if self.use_ray:
            return ray.get([r.stats.remote() for r in self._replicas])
        return [r.stats() for r in self._replicas]
