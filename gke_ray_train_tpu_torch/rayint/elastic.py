"""Elastic mesh re-formation, the worker's half (counterpart of
``gke_ray_train_tpu/rayint/elastic.py``, the port's own copy).

The trainer's retry loop (``rayint/trainer.py``) classifies a pool
change (a spot shrink, a node returning) after an attempt ends, starts
the next attempt's workers on the surviving number of ranks, and tells
them so in their environment: ``ELASTIC_N_DEVICES`` (the survivors) and
``ELASTIC_FULL_POOL`` (the pool the job's mesh was declared for; the
JAX package reads it off its ``TOPOLOGY``). A worker then:

- :func:`elastic_devices` — the ranks this attempt may use: the world
  (``WORLD_SIZE``), or the survivors where the trainer marked the pool
  shrunken. The JAX package truncates its device list; here the pool is
  the world of ranks, one a card.
- :func:`maybe_replan` — re-resolves the declared mesh on the survivors
  through ``plan.py::replan`` (data and fsdp reflow, ``model`` is
  structural, the global batch is kept) and logs it. A no-op when the
  pool matches the declaration or elasticity is off. The restore then
  reshards (``ckpt/manager.py::restore_resharded``).

Knobs (env or flat config, in ``config.py``'s KNOWN_KEYS):
``ELASTIC=1`` opts a job in (default off); ``MIN_DEVICES=N`` floors the
pool the trainer re-forms on (default 1).

Stdlib only until a plan is resolved.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

logger = logging.getLogger(__name__)

# per-attempt worker env the trainer injects after a pool change
POOL_ENV = "ELASTIC_N_DEVICES"
FULL_POOL_ENV = "ELASTIC_FULL_POOL"


def _knob(name: str, config=None) -> Optional[str]:
    if config is not None and name in config:
        return str(config[name])
    return os.environ.get(name)


def elastic_enabled(config=None) -> bool:
    v = _knob("ELASTIC", config)
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def min_devices(config=None) -> int:
    v = _knob("MIN_DEVICES", config)
    try:
        return max(int(v), 1) if v is not None else 1
    except ValueError:
        logger.warning("MIN_DEVICES=%r is not an int; using 1", v)
        return 1


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        logger.warning("%s=%r is not an int; ignoring it", name, raw)
        return None


def elastic_devices(world: Optional[int] = None) -> int:
    """The number of ranks this attempt runs on: ``world`` (default
    ``WORLD_SIZE``), cut to ``$ELASTIC_N_DEVICES`` when the trainer
    marked the pool shrunken."""
    if world is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    n = _env_int(POOL_ENV)
    if n is not None and 0 < n < world:
        return n
    return world


def maybe_replan(mesh, per_device_batch: int, *, world: Optional[int] = None,
                 config=None, model_cfg=None,
                 log: Optional[logging.Logger] = None) -> Tuple[object, int]:
    """(mesh config, per-device batch) for this attempt: the declared
    ``MeshConfig`` re-resolved on the surviving ranks when elasticity is
    on and the trainer issued a pool notice, else the declaration
    resolved over the world. Raises ``PlanError`` when no reflow fits."""
    from gke_ray_train_tpu_torch.plan import replan
    n = elastic_devices(world)
    full = _env_int(FULL_POOL_ENV)
    # re-form only on a trainer-issued notice: a declared mesh that
    # differs from the world is not an elastic event
    if not os.environ.get(POOL_ENV) or full is None or n == full \
            or not elastic_enabled(config):
        return mesh.resolve(n), per_device_batch
    new, pdb = replan(mesh, n, chips=full, per_device_batch=per_device_batch,
                      model_cfg=model_cfg)
    (log or logger).warning(
        "elastic re-formation: pool %d -> %d ranks; mesh %s -> %s, "
        "per_device_batch %d -> %d", full, n, mesh.resolve(full).shape,
        new.shape, per_device_batch, pdb)
    return new, pdb
