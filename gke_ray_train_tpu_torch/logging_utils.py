"""Warn-once for fallbacks that depend on a shape.

A fallback warning (dense-mask attention instead of the flash kernel,
dense prefill) fires once per distinct key, not once per step and not
never. Counterpart of ``gke_ray_train_tpu/logging_utils.py::warn_once``.
"""

from __future__ import annotations

import logging

_seen: set = set()


def warn_once(logger: logging.Logger, key, msg: str, *args) -> None:
    """Emit ``logger.warning(msg, *args)`` the first time ``key`` is
    seen; later calls with the same key are silent. Tests may clear
    ``_seen`` (monkeypatch) to re-arm."""
    if key in _seen:
        return
    _seen.add(key)
    logger.warning(msg, *args)
