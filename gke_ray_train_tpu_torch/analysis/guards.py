"""Runtime guards of the training loop (counterpart of the part of
``gke_ray_train_tpu/analysis/guards.py`` that ``run_training`` uses).

- ``TRANSFER_GUARD=log|disallow`` runs the hot loop under
  ``torch.cuda.set_sync_debug_mode("warn" | "error")``: a call that makes
  the host wait for the card (``.item()``, ``float(t)``, ``.cpu()``, a
  pageable host-to-device copy, a boolean-mask index) warns or raises at
  its call site instead of silently serializing the step pipeline. The
  loop's sanctioned waits (the batched metrics fetch, the first step's
  synchronize, eval, checkpoint saves) run inside :func:`allow_transfers`.
  Two differences from JAX's ``transfer_guard_device_to_host``: the mode
  is process-wide, not thread-local, so the prefetch thread runs under
  it too (its pinned ``non_blocking`` copies, ``wait_event`` and
  ``record_stream`` do not synchronize; a pageable copy would be flagged
  as it would be on the loop's thread); and it flags host waits in both
  directions, since a synchronous host-to-device copy stalls the host
  the same way. Without CUDA the guard does nothing, as JAX's does on
  its CPU backend.
- ``DIVERGENCE_GUARD=1`` checks that every rank runs the same step
  program. A single process has nothing to compare (JAX returns at one
  process too); a ``torch.distributed`` world above 1 raises
  ``NotImplementedError``: multi-card training is ROADMAP queue 1 item 5.
- ``RECOMPILE_LIMIT`` has no counterpart: the port runs eagerly and
  compiles nothing.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Optional

from gke_ray_train_tpu_torch.device import world_size

logger = logging.getLogger(__name__)

# TRANSFER_GUARD mode -> torch.cuda.set_sync_debug_mode argument
_SYNC_DEBUG_MODES = {"log": "warn", "disallow": "error"}


def _knob(name: str, config: Optional[dict] = None) -> Optional[str]:
    """Config key wins over env (the precedence of every other knob)."""
    if config is not None and name in config:
        return str(config[name])
    return os.environ.get(name)


# ---------------------------------------------------------------------------
# transfer guard
# ---------------------------------------------------------------------------

def transfer_guard_mode(config: Optional[dict] = None) -> Optional[str]:
    raw = (_knob("TRANSFER_GUARD", config) or "").strip().lower()
    if raw in ("", "0", "off", "false", "allow"):
        return None
    if raw in ("log", "disallow"):
        return raw
    logger.warning("TRANSFER_GUARD=%r not recognized "
                   "(expected log|disallow|off); guard disabled", raw)
    return None


@contextlib.contextmanager
def _sync_debug_mode(mode: str):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block, then the
    previous mode again; nothing without CUDA."""
    import torch
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def transfer_guard_ctx(mode: Optional[str]):
    """Context manager enforcing ``mode`` (None, "log" or "disallow") on
    host waits for the card, process-wide."""
    if mode is None:
        return contextlib.nullcontext()
    return _sync_debug_mode(_SYNC_DEBUG_MODES[mode])


def allow_transfers():
    """The allow-list: wrap the loop's sanctioned waits on the card
    (batched metrics fetch, synchronize, eval, checkpoint save)."""
    return _sync_debug_mode("default")


# ---------------------------------------------------------------------------
# divergence guard
# ---------------------------------------------------------------------------

def divergence_guard_enabled(config: Optional[dict] = None) -> bool:
    raw = (_knob("DIVERGENCE_GUARD", config) or "").strip().lower()
    return raw not in ("", "0", "off", "false")


# ---------------------------------------------------------------------------
# the bundle run_training consumes
# ---------------------------------------------------------------------------

class RuntimeGuards:
    """Resolved guard configuration for one training run."""

    def __init__(self, *, transfer_mode: Optional[str] = None,
                 divergence: bool = False):
        self.transfer_mode = transfer_mode
        self.divergence = divergence

    @staticmethod
    def from_config(config: Optional[dict] = None) -> "RuntimeGuards":
        """Env / config resolution (config key wins); the default
        ``run_training`` builds when handed no guards."""
        return RuntimeGuards(
            transfer_mode=transfer_guard_mode(config),
            divergence=divergence_guard_enabled(config))

    def transfer_ctx(self):
        return transfer_guard_ctx(self.transfer_mode)

    def check_divergence(self, step_fn, state, batch,
                         label: str = "train_step") -> None:
        if self.divergence and world_size() > 1:
            raise NotImplementedError(
                f"DIVERGENCE_GUARD across {world_size()} ranks ({label}): "
                "multi-card training is not ported yet (ROADMAP queue 1 "
                "item 5)")

    def __repr__(self) -> str:  # pragma: no cover - logging nicety
        return (f"RuntimeGuards(transfer={self.transfer_mode or 'off'}, "
                f"divergence={'on' if self.divergence else 'off'})")
